"""The ``train`` drive: n sub-models trained on a staged pool of pair
chunks through ``repro_torch.core.async_trainer.AsyncShardTrainer.epoch``.

Set-up makes the corpus, the division, the pool (``pool_chunks`` chunks of
``steps_per_chunk`` steps, the first of every worker's epoch-0 stream) and
the noise tables from the seed, stages them on the card, builds the
trainer and its tables (``init``), and drives the checked steps through
``epoch``: steps 1 to 3 on the first rows of pool chunk 0 (a one-step
call, then a two-step one), then one whole chunk of the window's shape,
pool chunk 1 under its own chunk key, which also warms the window's shapes.
It keeps what they did and hands the same trainer to the window, which
replays the pool chunk after chunk with a fresh chunk key each, the step
counter running on. Once the window has closed, the plain reference
follows the same 3 + ``steps_per_chunk`` steps from the same inputs, on the
rows they touch, and the two are compared by each step's loss, the first
gradient's norm of each table (from the change one step made), and the
norm of each table's change after three steps and after the chunk.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from portbench.harness import corpus as data
from portbench.harness import counts as yard
from portbench.reference import sgns as ref
from portbench.reference import threefry

#: The first checked steps: a one-step call, then a two-step one; a whole
#: chunk follows them.
CHECK_CALLS = (1, 2)
WINDOW_KEYS = 1 << 14


@dataclass
class TrainInputs:
    n: int
    V: int
    d: int
    B: int
    K: int
    lr: float
    lr_min: float
    total_steps: int
    sampler: str                 # "alias" (K2's draw) or "cdf"
    centers: np.ndarray          # (n, P, B) int32 pool
    contexts: np.ndarray
    table: dict                  # {"prob", "alias"} or {"cdf"}: (n, V) numpy
    init_key: np.ndarray         # (2,) uint32
    check_keys: np.ndarray       # (len(CHECK_CALLS), 2)
    chunk_key: np.ndarray        # the checked chunk's key
    window_keys: np.ndarray      # (WINDOW_KEYS, 2)
    steps_per_chunk: int

    @property
    def chunks(self) -> int:
        return self.centers.shape[1] // self.steps_per_chunk


def seeds_of(seed: int, k: int) -> list[int]:
    """``k`` 63-bit integers drawn from the run's seed."""
    ss = np.random.SeedSequence((0xBE7C, int(seed)))
    return [int(x) >> 1 for x in ss.generate_state(k, dtype=np.uint64)]


def make_corpus(config: dict, seed: int):
    c = config["corpus"]
    s_model, s_corpus = seeds_of(seed, 2)
    model = data.SemanticCorpusModel.create(
        c["vocab_size"], num_topics=c["num_topics"], num_features=c["num_features"],
        latent_dim=c["latent_dim"], zipf_a=c["zipf_a"], beta=c["beta"], seed=s_model)
    return model, model.generate(c["num_sentences"], c["mean_sentence_len"], seed=s_corpus)


def worker_vocabs(config: dict, model, corpus, strategy: str, div_seed: int):
    """Each worker's vocabulary in the table's ids, and presence ``(n, V)``."""
    dv = config["division"]
    n = dv["num_workers"]
    if dv["vocabulary"] == "ranked":
        if strategy != "shuffle":
            raise ValueError("a ranked vocabulary is shared: it needs the shuffle division")
        v = data.rank_vocab(corpus, model)
        return [v] * n, np.ones((n, v.size), dtype=bool)
    vocabs, _, mask = data.build_worker_vocabs(
        corpus, model.vocab_size, strategy, n, dv["rate"], dv["max_vocab"],
        dv["base_min_count"], div_seed)
    return vocabs, mask


def noise_tables(vocabs, sampler: str) -> dict:
    """Stacked per-worker unigram^0.75 tables, one build a distinct vocabulary."""
    built: dict[int, tuple] = {}
    rows = []
    for v in vocabs:
        if id(v) not in built:
            built[id(v)] = (data.noise_alias(v.counts) if sampler == "alias"
                            else (data.noise_cdf(v.counts),))
        rows.append(built[id(v)])
    if sampler == "alias":
        return {"prob": np.stack([r[0] for r in rows]), "alias": np.stack([r[1] for r in rows])}
    return {"cdf": np.stack([r[0] for r in rows])}


def make_inputs(config: dict, traffic: dict, seed: int) -> TrainInputs:
    sg, dv = config["sgns"], config["division"]
    model, corpus = make_corpus(config, seed)
    div_seed, key_seed = seeds_of(seed, 4)[2:]
    strategy = dv["strategy"]
    vocabs, _ = worker_vocabs(config, model, corpus, strategy, div_seed)
    S, P = traffic["steps_per_chunk"], traffic["pool_chunks"]
    if P < 2:
        raise ValueError("the pool needs two chunks or more: chunk 1 is the checked chunk")
    centers, contexts = data.pair_pool(corpus, vocabs, strategy, dv["rate"], sg["window"],
                                       sg["subsample_t"], div_seed, S * P, sg["batch"])
    base = threefry.PRNGKey(key_seed)
    keys = threefry.fold_in(base, np.arange(4 + WINDOW_KEYS))
    return TrainInputs(
        n=dv["num_workers"], V=vocabs[0].size, d=sg["dim"], B=sg["batch"], K=sg["negatives"],
        lr=sg["lr"], lr_min=sg["lr_min"], total_steps=sg["epochs"] * S * P,
        sampler=traffic["sampler"], centers=centers, contexts=contexts,
        table=noise_tables(vocabs, traffic["sampler"]), init_key=keys[0],
        check_keys=keys[1:3], chunk_key=keys[3], window_keys=keys[4:], steps_per_chunk=S)


# ---------------------------------------------------------------------------
# Readings of the checked steps
# ---------------------------------------------------------------------------
@dataclass
class Checked:
    """What the checked steps did: each step's loss ``(n, 3 + S)``, the
    first gradient's norm and each table's change after three steps and
    after the chunk, each ``(2n,)`` (W of every worker, then C)."""

    losses: np.ndarray
    grad: np.ndarray
    change3: np.ndarray
    change: np.ndarray


def _lrs(inp: TrainInputs) -> list[float]:
    return [float(ref.linear_lr(i, inp.total_steps, inp.lr, inp.lr_min))
            for i in range(sum(CHECK_CALLS) + inp.steps_per_chunk)]


def _table_norms(after: torch.Tensor, before: torch.Tensor) -> np.ndarray:
    """Each worker's ‖after − before‖ over its whole table, in float64."""
    return np.array([float(torch.linalg.vector_norm(after[w] - before[w], dtype=torch.float64))
                     for w in range(after.shape[0])])


def port_checked_steps(trainer, params: dict, inp: TrainInputs, pool, table) -> Checked:
    """Drives the port's checked steps through ``epoch``: steps 1 to 3 on
    the first rows of pool chunk 0, then pool chunk 1 whole; ``params``
    are updated in place."""
    cen, ctx = pool[0]
    W0, C0 = params["W"].clone(), params["C"].clone()

    def changed():
        return np.concatenate([_table_norms(params["W"], W0), _table_norms(params["C"], C0)])

    losses, grad, at = [], None, 0
    for call, steps in enumerate(CHECK_CALLS):
        params, cl = trainer.epoch(params, cen[:, at:at + steps], ctx[:, at:at + steps], table,
                                   inp.check_keys[call], step0=at)
        losses.append(cl.float().cpu().numpy())
        if grad is None:
            grad = changed() / _lrs(inp)[0]
        at += steps
    change3 = changed()
    params, cl = trainer.epoch(params, *pool[1], table, inp.chunk_key, step0=at)
    losses.append(cl.float().cpu().numpy())
    change = changed()
    del W0, C0
    return Checked(np.concatenate(losses, axis=1), grad, change3, change)


def _checked_seeds(inp: TrainInputs) -> np.ndarray:
    """``(n, 3 + S, 2)`` step seeds of the checked steps."""
    calls = [ref.chunk_step_seeds(inp.check_keys[c], inp.n, s) for c, s in enumerate(CHECK_CALLS)]
    calls.append(ref.chunk_step_seeds(inp.chunk_key, inp.n, inp.steps_per_chunk))
    return np.concatenate(calls, axis=1)


def _checked_pairs(inp: TrainInputs) -> tuple[np.ndarray, np.ndarray]:
    """``(n, 3 + S, B)`` centers and contexts of the checked steps."""
    first, S = sum(CHECK_CALLS), inp.steps_per_chunk
    pick = np.r_[0:first, S:2 * S]
    return inp.centers[:, pick], inp.contexts[:, pick]


def reference_checked_steps(inp: TrainInputs, device, dtype=torch.float32,
                            fault: str | None = None, rows_a_call: int = 16384) -> Checked:
    """The plain reference's checked steps from the same inputs, on the rows
    they touch. ``dtype`` is the tables' type (the control runs it in
    bfloat16); ``fault="half_batch"`` leaves out the second half of every
    batch (the fault test's stand-in for the program)."""
    n, V, d, B, K = inp.n, inp.V, inp.d, inp.B, inp.K
    lrs = _lrs(inp)
    steps, first = len(lrs), sum(CHECK_CALLS)
    seeds = _checked_seeds(inp)
    table = {k: torch.from_numpy(v).to(device) for k, v in inp.table.items()}
    table = table["cdf"] if inp.sampler == "cdf" else table
    off = (torch.arange(n, device=device) * V)[:, None]
    centers, contexts = _checked_pairs(inp)
    cen = torch.from_numpy(centers).to(device).long()
    ctx = torch.from_numpy(contexts).to(device).long()
    negs = torch.stack([ref.draw(inp.sampler, seeds[:, i], table, B, K)
                        for i in range(steps)], dim=1)                       # (n, T, B, K)
    rows_w, rw = torch.unique(cen + off[:, :, None], return_inverse=True)
    c_keys = torch.cat([(ctx + off[:, :, None]).reshape(n, -1),
                        (negs + off[:, :, None, None]).reshape(n, -1)], 1)
    del negs
    rows_c, rc = torch.unique(c_keys, return_inverse=True)
    del c_keys
    rx = rc[:, :steps * B].view(n, steps, B)
    rn = rc[:, steps * B:].view(n, steps, B, K)
    W = torch.empty((len(rows_w), d), dtype=dtype, device=device)
    for a in range(0, len(rows_w), rows_a_call):
        W[a:a + rows_a_call] = ref.init_rows(inp.init_key, n, V, d, rows_w[a:a + rows_a_call])
    C = torch.zeros((len(rows_c), d), dtype=dtype, device=device)
    W0 = W.float().clone()
    keep = B // 2 if fault == "half_batch" else B

    def norms(T, T0, rows):
        sq = ((T.float() - T0).double() ** 2).sum(1) if T0 is not None else \
            (T.double() ** 2).sum(1)
        out = torch.zeros(n, dtype=torch.float64, device=device)
        return out.index_add_(0, rows // V, sq).sqrt().cpu().numpy()

    def changed():
        return np.concatenate([norms(W, W0, rows_w), norms(C, None, rows_c)])

    losses, grad, change3 = [], None, None
    for i, lr in enumerate(lrs):
        losses.append(ref.sgns_step_(W, C, rw[:, i, :keep], rx[:, i, :keep],
                                     rn[:, i, :keep], lr).cpu().numpy())
        if i == 0:
            grad = changed() / lr
        if i == first - 1:
            change3 = changed()
    return Checked(np.stack(losses, axis=1), grad, change3, changed())


def leaf_gap(prog: np.ndarray, refn: np.ndarray) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    scale = np.maximum(refn, np.median(refn))
    if not np.all(scale > 0):
        raise ValueError("the reference's norms are all zero")
    return float(np.max(np.abs(prog - refn) / scale))


def compare(prog: Checked, refr: Checked) -> dict:
    """Every checked step's loss; the first gradient; each table's change
    after three steps and after the chunk, the worse of the two."""
    return {"loss_gap": float(np.max(np.abs(prog.losses - refr.losses) / np.abs(refr.losses))),
            "grad_gap": leaf_gap(prog.grad, refr.grad),
            "change_gap": max(leaf_gap(prog.change3, refr.change3),
                              leaf_gap(prog.change, refr.change))}


def control_readings(config: dict, traffic: dict, seed: int, device) -> dict:
    """``{variant: readings}`` of a training cell without the program: the
    control (the reference with bfloat16 tables), a step that leaves out
    half the batch and a step that leaves the tables unchanged (every
    change reads 1 by the measure itself)."""
    inp = make_inputs(config, traffic, seed)
    sound = reference_checked_steps(inp, device)
    zero = np.zeros_like(sound.grad)
    return {"control_bfloat16": compare(reference_checked_steps(inp, device, torch.bfloat16),
                                        sound),
            "fault_half_batch": compare(reference_checked_steps(inp, device, fault="half_batch"),
                                        sound),
            "fault_unchanged": compare(Checked(sound.losses, zero, zero, zero), sound)}


# ---------------------------------------------------------------------------
# The drive
# ---------------------------------------------------------------------------
class Drive:
    """Set-up, window and check of one training cell."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device

    def setup(self) -> None:
        from repro_torch.core.async_trainer import AsyncShardTrainer
        from repro_torch.core.sgns import SGNSConfig

        inp = self.inputs = make_inputs(self.config, self.traffic, self.seed)
        dev, S = self.device, inp.steps_per_chunk
        self.pool = [(torch.from_numpy(inp.centers[:, k * S:(k + 1) * S].copy()).to(dev),
                      torch.from_numpy(inp.contexts[:, k * S:(k + 1) * S].copy()).to(dev))
                     for k in range(inp.chunks)]
        t = {k: torch.from_numpy(v).to(dev) for k, v in inp.table.items()}
        self.table = t["cdf"] if inp.sampler == "cdf" else t
        sg = self.config["sgns"]
        cfg = SGNSConfig(vocab_size=inp.V, dim=inp.d, window=sg["window"], negatives=inp.K,
                         lr=inp.lr, lr_min=inp.lr_min)
        self.trainer = AsyncShardTrainer(cfg=cfg, num_workers=inp.n,
                                         total_steps=inp.total_steps,
                                         engine=self.traffic["engine"], device=dev)
        self.params = self.trainer.init(inp.init_key)
        self.checked = port_checked_steps(self.trainer, self.params, inp, self.pool, self.table)
        self.step = sum(CHECK_CALLS) + S
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float, tracer) -> dict:
        inp, S = self.inputs, self.inputs.steps_per_chunk
        chunks = 0
        t0 = time.perf_counter()
        with tracer.span("portbench.window"):
            while True:
                cen, ctx = self.pool[chunks % inp.chunks]
                with tracer.span("portbench.epoch"):
                    self.params, losses = self.trainer.epoch(
                        self.params, cen, ctx, self.table,
                        inp.window_keys[chunks % WINDOW_KEYS], step0=self.step)
                self.step += S
                chunks += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            self._sync()
        wall = time.perf_counter() - t0
        self.last_losses = losses
        steps = chunks * S
        self.window_counts = {"steps": steps, "chunks": chunks, "wall_s": wall,
                              "pairs_per_step": inp.n * inp.B}
        return {"train_pairs_per_s": steps * inp.n * inp.B / wall, "attempted": steps}

    def release(self) -> None:
        """Frees the program's state; keeps the inputs and the readings."""
        self.nonfinite = int((~torch.isfinite(self.last_losses)).sum())
        del self.params, self.trainer, self.pool, self.table, self.last_losses

    def check(self) -> dict:
        out = compare(self.checked, reference_checked_steps(self.inputs, self.device))
        out["nonfinite_window_losses"] = float(self.nonfinite)
        return out

    def counts(self, sample_steps: int = 8) -> dict:
        """The window's counts and the step's least time: ``step_bytes`` of
        ``sample_steps`` steps of the pool under the window's first keys (the
        reference's draw of their negatives), averaged."""
        inp = self.inputs
        dev = self.device
        t = {k: torch.from_numpy(v).to(dev) for k, v in inp.table.items()}
        table = t["cdf"] if inp.sampler == "cdf" else t
        seeds = ref.chunk_step_seeds(inp.window_keys[0], inp.n, sample_steps)
        nbytes = []
        for i in range(sample_steps):
            ids = ref.draw(inp.sampler, seeds[:, i], table, inp.B, inp.K)
            cen = torch.from_numpy(inp.centers[:, i]).to(dev)
            ctx = torch.from_numpy(inp.contexts[:, i]).to(dev).long()
            nbytes.append(yard.step_bytes(cen, ctx, ids, inp.d))
        flops = yard.sgns_model_flops(inp.n * inp.B, inp.K, inp.d)
        least, t_bytes, t_flops = yard.least_step_seconds(float(np.mean(nbytes)), flops)
        return {**self.window_counts, "step_bytes": float(np.mean(nbytes)),
                "step_flops": flops, "least_step_s": least, "bytes_term_s": t_bytes,
                "flops_term_s": t_flops}
