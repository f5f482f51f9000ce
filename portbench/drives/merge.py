"""The ``merge`` drive: n trained sub-models merged by
``repro_torch.core.merge.get_merger(<merger>).merge``, back to back.

Set-up makes the corpus and the division from the seed (the traffic's
``strategy``: ``random`` gives each sub-model its own vocabulary, so the
presence masks miss words), then the benchmark's own plain reference trains
the n sub-models for ``epochs`` epochs on the card (CDF draws, the SGNS
step of ``portbench/reference``). Those tables and masks are the input both
sides get. One merge warms up; the window merges again and again. A merge
drawn from the seed among the first ``sampled_merges`` of the window is
kept; once the window has closed, the plain reference's ALiR merges the
same sub-models and the kept merge's table, valid mask and per-sub-model
maps are compared with it, after the orthogonal map that best aligns the
two tables.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.harness import corpus as data
from portbench.drives.train import make_corpus, noise_tables, seeds_of, worker_vocabs
from portbench.reference import alir as ref_alir
from portbench.reference import sgns as ref
from portbench.reference import threefry


def train_submodels(config: dict, traffic: dict, seed: int, device):
    """``(models (n, V, d) float32, mask (n, V) bool)`` on ``device``: the
    plain reference's SGNS over each worker's sample, ``epochs`` epochs."""
    sg, dv = config["sgns"], config["division"]
    model, corpus = make_corpus(config, seed)
    div_seed, key_seed = seeds_of(seed, 4)[2:]
    strategy = traffic["strategy"]
    vocabs, mask = worker_vocabs(config, model, corpus, strategy, div_seed)
    n, V, d, B, K = dv["num_workers"], vocabs[0].size, sg["dim"], sg["batch"], sg["negatives"]
    steps = data.epoch_steps(corpus, vocabs, strategy, dv["rate"], sg["window"],
                             sg["subsample_t"], div_seed, B)
    epochs = traffic["epochs"]
    centers, contexts = data.pair_pool(corpus, vocabs, strategy, dv["rate"], sg["window"],
                                       sg["subsample_t"], div_seed, steps, B)
    cdf = torch.from_numpy(noise_tables(vocabs, "cdf")["cdf"]).to(device)
    init_key, train_key = threefry.fold_in(threefry.PRNGKey(key_seed), np.arange(2))
    W = ref.init_tables(init_key, n, V, d, device).view(n * V, d)
    C = torch.zeros_like(W)
    off = (torch.arange(n, device=device) * V)[:, None]
    cen = torch.from_numpy(centers).to(device).long() + off[:, :, None]
    ctx = torch.from_numpy(contexts).to(device).long() + off[:, :, None]
    seeds = ref.chunk_step_seeds(train_key, n, steps * epochs)
    for i in range(steps * epochs):
        negs = ref.draw_cdf(seeds[:, i], cdf, B, K) + off[:, :, None]
        lr = ref.linear_lr(i, steps * epochs, sg["lr"], sg["lr_min"])
        ref.sgns_step_(W, C, cen[:, i % steps], ctx[:, i % steps], negs, lr)
    del C
    return W.view(n, V, d), torch.from_numpy(mask).to(device)


class Drive:
    """Set-up, window and check of one merge cell."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device

    def _merger(self):
        from repro_torch.core.merge import get_merger

        t = self.traffic
        return get_merger(t["merger"], device=self.device, max_iters=t["max_iters"],
                          tol=t["tol"], seed=self.merge_seed)

    def setup(self) -> None:
        from repro_torch.core.merge import StackedModels

        self.models, self.mask = train_submodels(self.config, self.traffic, self.seed,
                                                 self.device)
        self.merge_seed, keep = seeds_of(self.seed, 6)[4:]
        self.keep = keep % self.traffic["sampled_merges"]
        self.merger = self._merger()
        self.stacked = StackedModels(models=self.models, mask=self.mask)
        self.merger.merge(self.stacked)
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float, tracer) -> dict:
        merges, kept = 0, None
        t0 = time.perf_counter()
        with tracer.span("portbench.window"):
            while True:
                with tracer.span("portbench.merge"):
                    res = self.merger.merge(self.stacked)
                if merges <= self.keep:
                    kept = res
                merges += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            self._sync()
        wall = time.perf_counter() - t0
        self.kept = (kept.emb, kept.valid, kept.transforms)
        self.kept_index = min(self.keep, merges - 1)
        self.window_counts = {"merges": merges, "wall_s": wall}
        return {"merge_s": wall / merges, "attempted": merges}

    def release(self) -> None:
        del self.merger, self.stacked

    def check(self) -> dict:
        return compare_merge(self.kept, self.models, self.mask, self.merge_seed, self.traffic)

    def counts(self) -> dict:
        return dict(self.window_counts)


def reference_merge(models, mask, merge_seed: int, traffic: dict, tf32: bool = False):
    """The plain reference's ALiR of the sub-models, its matrix products in
    float32 (``tf32=True`` lets them use TF32: the control)."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return ref_alir.alir(models, mask, threefry.PRNGKey(merge_seed),
                             max_iters=traffic["max_iters"], tol=traffic["tol"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def compare_merge(prog, models, mask, merge_seed: int, traffic: dict, refr=None) -> dict:
    """The program's ``(table, valid, maps)`` against the reference's."""
    Yp, vp, Wp = prog
    Yr, vr, Wr = refr if refr is not None else reference_merge(models, mask, merge_seed, traffic)
    mismatch = int((vp.bool() != vr).sum())
    gap, R = ref_alir.row_gap(Yp, Yr, vr)
    maps = torch.linalg.vector_norm((Wp @ R - Wr).double(), dim=(1, 2)) / \
        torch.linalg.vector_norm(Wr.double(), dim=(1, 2))
    return {"valid_mismatch": float(mismatch), "merge_row_gap": gap,
            "merge_map_gap": float(maps.max())}


def control_readings(config: dict, traffic: dict, seed: int, device) -> dict:
    """``{variant: readings}`` of a merge cell without the program: the
    control (the reference with TF32 matrix products) and one row of the
    merged table altered where it is produced."""
    models, mask = train_submodels(config, traffic, seed, device)
    merge_seed, keep = seeds_of(seed, 6)[4:]
    sound = reference_merge(models, mask, merge_seed, traffic)
    control = reference_merge(models, mask, merge_seed, traffic, tf32=True)
    Y, valid, Ws = sound
    rows = valid.nonzero().flatten()
    altered = Y.clone()
    r = int(rows[keep % len(rows)])
    altered[r] = -altered[r]
    return {"control_tf32": compare_merge(control, models, mask, merge_seed, traffic, sound),
            "fault_altered_row": compare_merge((altered, valid, Ws), models, mask, merge_seed,
                                               traffic, sound)}
