#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py                      # every phase, one GPU
    python3 chip_smoke.py --phases build,k1,k2

Phases:

1. ``build`` — compile the CUDA sources under ``src/repro_torch/csrc`` with
   ``nvcc`` (one process per source, all at once) and print the build time
   and ptxas's register/spill report.
2. ``k1`` — K1 (``sample_negatives``) against its plain torch version on the
   GPU at V = 300,000 (alias table of a Zipf(1.0) distribution), ids of
   shape (4, 1024, 5): the ids must be bitwise equal.
3. ``k2`` — one K2 step (``sgns_fused_step``) against its plain version at
   V = 300,000, d = 500, K = 5, B = 1024, n = 4: ids bitwise equal, W′, C′
   and the per-pair loss within tolerance, and two K2 runs from the same
   inputs bitwise identical.
4. ``main`` — the port's main path through its entry points at the
   configuration of ``examples/train_w2v_100m.py``: ``train_submodels``
   (10 workers, d = 500, 1 epoch of 64 steps), ``merge(..., "alir_pca")``
   and ``evaluate_all``. The kernel launch counts are reset just before and
   read just after training; K2 and K1 must each have launched once per
   step, and every sub-model's W must have left its init.
5. ``time`` — at the main path's shapes (n = 10, V = 89,611, its noise
   table), each kernel held against its plain version (K1 ids bitwise,
   K2 ids bitwise and W′, C′ and loss within tolerance), then both timed
   with CUDA events, beside the least time the card could take.
6. ``profile`` — the main path's training again under ``torch.profiler``:
   device time per step by kernel and the device's idle share of the
   training loop (summary printed; ``chiprun_out/profile_main*.json``).

It prints a ``{"kernels": [...]}`` JSON line, then the card's name and power
limit as ``nvidia-smi`` reports them, then ``{"ok": true, ...}`` last. Any
failing phase raises and the script exits non-zero. Without a CUDA device,
or outside a checkout of the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32 outside
# the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12

# Tolerances of K2 against its plain version on the card. The two reduce
# the dot products in different orders, and the plain version's CUDA
# index_add_ accumulates duplicate rows with atomics in no fixed order;
# values are O(1), so a few float32 ulps per addend over a hot row's
# hundreds of addends stays under these bounds.
K2_TABLE_ATOL = 1e-5
K2_LOSS_ATOL = 1e-4

PHASES = ("build", "k1", "k2", "main", "time", "profile")
REPLACES = {
    "sample_negatives": "src/repro/kernels/sgns_fused.py:197",
    "sgns_fused_step": "src/repro/kernels/sgns_fused.py:105",
}
SOURCES = {
    "sample_negatives": "src/repro_torch/csrc/sample_negatives.cu",
    "sgns_fused_step": "src/repro_torch/csrc/sgns_fused_step.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def zipf_alias_table(V: int, n: int, device, a: float = 1.0) -> dict:
    """Stacked ``(n, V)`` alias table of a Zipf(a) distribution by rank."""
    import numpy as np
    import torch
    from repro_torch.core.distributions import build_alias_table

    p = np.arange(1, V + 1, dtype=np.float64) ** (-a)
    prob, alias = build_alias_table(p / p.sum())
    return {"prob": torch.tensor(prob, dtype=torch.float32, device=device)
            .expand(n, V).contiguous(),
            "alias": torch.tensor(alias, dtype=torch.int32, device=device)
            .expand(n, V).contiguous()}


def seeds_for(n: int, seed: int, device):
    from repro_torch import prng
    from repro_torch.kernels.sgns_fused import seed_tensor

    return seed_tensor(prng.split(prng.PRNGKey(seed), n), device)


# ---------------------------------------------------------------------------
def phase_build() -> dict:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    report = build.build_all()
    log(f"[build] nvcc {' '.join(build.NVCC_FLAGS)}: "
        f"{time.perf_counter() - t0:.1f} s wall for {len(report)} sources")
    for name, r in report.items():
        log(f"[build]   {name}: {r['seconds']:.1f} s -> {r['path']}")
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]     {line.strip()}")
    return report


def _check_k1(tag, seeds, table, shape) -> float:
    """K1 against its plain version on the same inputs: bitwise."""
    import torch
    from repro_torch.kernels.sgns_fused import sample_negatives, sample_negatives_plain

    ids = sample_negatives(seeds, table["prob"], table["alias"], shape)
    ref = sample_negatives_plain(seeds, table["prob"], table["alias"], shape)
    torch.cuda.synchronize(ids.device)
    mismatches = int((ids != ref).sum())
    log(f"[{tag}] K1 V={table['prob'].shape[-1]} ids {tuple(ids.shape)}: {mismatches} "
        f"mismatches against the plain version; ids span "
        f"[{int(ids.min())}, {int(ids.max())}]")
    if mismatches:
        raise RuntimeError(f"K1 is not bitwise equal to its plain version "
                           f"({mismatches} ids differ)")
    return 0.0


def phase_k1(device, V=300_000, shape=(1024, 5), n=4) -> dict:
    table = zipf_alias_table(V, n, device)
    return {"max_abs_err": _check_k1("k1", seeds_for(n, 0, device), table, shape)}


def _k2_inputs(device, V, d, B, n, seed=0):
    import torch
    from repro_torch.kernels.sgns_fused import sample_negatives_plain

    table = zipf_alias_table(V, n, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    W = 0.1 * torch.randn((n, V, d), generator=gen, device=device)
    C = 0.1 * torch.randn((n, V, d), generator=gen, device=device)
    # Zipf-distributed centers/contexts: hot rows repeat, as in real batches
    centers = sample_negatives_plain(seeds_for(n, 1, device), table["prob"],
                                     table["alias"], (B,))
    contexts = sample_negatives_plain(seeds_for(n, 2, device), table["prob"],
                                      table["alias"], (B,))
    return W, C, centers, contexts, table, seeds_for(n, 3, device)


def _check_k2(tag, W, C, centers, contexts, table, seeds, lr, K,
              repeat=False) -> float:
    """One K2 step against one plain step from clones of the same inputs:
    ids bitwise equal, W′/C′/loss within tolerance, C updated; with
    ``repeat``, a second K2 run must be bitwise identical to the first."""
    import torch
    from repro_torch.kernels.sgns_fused import sgns_fused_step, sgns_fused_step_plain

    runs = []
    for _ in range(2 if repeat else 1):
        p = {"W": W.clone(), "C": C.clone()}
        runs.append(sgns_fused_step(p, centers, contexts, table, seeds, lr,
                                    negatives=K))
    plain = {"W": W.clone(), "C": C.clone()}
    plain, loss_p, ids_p = sgns_fused_step_plain(plain, centers, contexts, table,
                                                 seeds, lr, negatives=K)
    torch.cuda.synchronize(W.device)
    p1, l1, i1 = runs[0]
    id_mismatch = int((i1 != ids_p).sum())
    err_w = float((p1["W"] - plain["W"]).abs().max())
    err_c = float((p1["C"] - plain["C"]).abs().max())
    err_l = float((l1 - loss_p).abs().max())
    moved = float((p1["C"] - C).abs().max())
    n, V, d = W.shape
    msg = (f"[{tag}] K2 n={n} V={V} d={d} B={centers.shape[1]} K={K}: ids "
           f"{id_mismatch} mismatches; max |ΔW′| {err_w:.3e}, max |ΔC′| {err_c:.3e} "
           f"(tol {K2_TABLE_ATOL:g}; largest C update {moved:.3e}); max |Δloss| "
           f"{err_l:.3e} (tol {K2_LOSS_ATOL:g})")
    same = True
    if repeat:
        p2, l2, i2 = runs[1]
        same = (torch.equal(p1["W"], p2["W"]) and torch.equal(p1["C"], p2["C"])
                and torch.equal(l1, l2) and torch.equal(i1, i2))
        msg += f"; repeat run bitwise identical: {same}"
    log(msg)
    if id_mismatch:
        raise RuntimeError("K2's negatives differ from the plain version's")
    if err_w > K2_TABLE_ATOL or err_c > K2_TABLE_ATOL or err_l > K2_LOSS_ATOL:
        raise RuntimeError("K2 disagrees with its plain version beyond tolerance")
    if not same:
        raise RuntimeError("two K2 runs from the same inputs differ")
    if not math.isfinite(moved) or moved == 0.0:
        raise RuntimeError("K2 left the C table unchanged")
    return max(err_w, err_c, err_l)


def phase_k2(device, V=300_000, d=500, B=1024, n=4, K=5, lr=0.025) -> dict:
    W, C, centers, contexts, table, seeds = _k2_inputs(device, V, d, B, n)
    log(f"[k2] tables {2 * W.numel() * 4 / 1e9:.1f} GB (+ copies for the plain "
        f"and repeat runs)")
    return {"max_abs_err": _check_k2("k2", W, C, centers, contexts, table, seeds,
                                     lr, K, repeat=True)}


def phase_main(device, num_workers=10, dim=500, steps=64, steps_per_chunk=32):
    import numpy as np
    import torch
    from repro_torch.core.driver import train_submodels
    from repro_torch.core.merge import merge
    from repro_torch import prng
    from repro_torch.core.sgns import SGNSConfig, init_params
    from repro_torch.data.corpus import SemanticCorpusModel
    from repro_torch.eval.benchmarks import BenchmarkSuite, evaluate_all
    from repro_torch.kernels import sgns_fused

    vocab = 100_000
    t0 = time.perf_counter()
    gen = SemanticCorpusModel.create(vocab_size=vocab, num_topics=64, seed=0)
    corpus = gen.generate(num_sentences=120_000, seed=1)
    suite = BenchmarkSuite.from_model(gen, top_words=min(20_000, vocab))
    log(f"[main] corpus: {corpus.num_sentences} sentences, {corpus.num_tokens} "
        f"tokens ({time.perf_counter() - t0:.1f} s)")

    cfg = SGNSConfig(vocab_size=0, dim=dim, window=5, negatives=5)
    train_kw = dict(strategy="shuffle", num_workers=num_workers, cfg=cfg, epochs=1,
                    batch_size=1024, window=5, max_vocab=vocab, base_min_count=10,
                    max_steps_per_epoch=steps, steps_per_chunk=steps_per_chunk,
                    engine="fused")
    sgns_fused.reset_launch_counts()
    t0 = time.perf_counter()
    res = train_submodels(corpus, vocab, device=device, **train_kw)
    launches = dict(sgns_fused.LAUNCHES)
    wall = time.perf_counter() - t0
    V = res.union_vocab.size
    taken = res.timings["steps_per_epoch"]
    log(f"[main] trained {num_workers} x {V} x {dim} sub-models: {taken} steps, "
        f"vocab {res.timings['vocab_s']:.2f} s, init {res.timings['init_s']:.2f} s, train {res.timings['train_s']:.3f} s "
        f"({res.timings['chunk_wait_s']:.3f} s blocked on chunks), setup+init+train "
        f"{wall:.1f} s")
    for k, cl in enumerate(res.chunk_losses):
        log(f"[main]   chunk {k} mean loss per worker: "
            + " ".join(f"{x:.7f}" for x in cl.mean(axis=1)))
    log(f"[main] launches during training: {launches}")
    if launches["sgns_fused_step"] != taken or launches["sample_negatives"] != taken:
        raise RuntimeError(f"expected {taken} launches of each kernel, got {launches}")
    if not all(np.isfinite(c).all() for c in res.chunk_losses):
        raise RuntimeError("non-finite training loss")
    # C starts at zero, so every logit of the first step is 0 and its loss
    # is exactly (K + 1)·log 2 per pair.
    first = res.chunk_losses[0][:, 0]
    plateau = (cfg.negatives + 1) * math.log(2.0)
    if np.abs(first - plateau).max() > 1e-5:
        raise RuntimeError(f"first-step loss {first} != (K+1)·log 2 = {plateau}")
    if not torch.isfinite(res.stacked.models).all():
        raise RuntimeError("non-finite sub-model tables")
    # dW is a sum of C rows and C starts at zero, so W leaves its init only
    # if K2's updates of C landed (and then W's).
    keys = prng.split(prng.PRNGKey(cfg.seed), num_workers)
    cfg_v = replace(cfg, vocab_size=V)
    moved = [float((res.stacked.models[i] - init_params(k, cfg_v, device=device)["W"])
                   .abs().max()) for i, k in enumerate(keys)]
    log("[main] max |W - W_init| per worker: " + " ".join(f"{m:.3e}" for m in moved))
    if not all(math.isfinite(m) and m > 0.0 for m in moved):
        raise RuntimeError("a sub-model's W never left its init: C was not updated")

    t0 = time.perf_counter()
    emb, valid = merge(res.stacked, "alir_pca", out_dim=dim, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    merge_s = time.perf_counter() - t0
    emb_np, valid_np = emb.cpu().numpy(), valid.cpu().numpy()
    log(f"[main] ALiR merge of {num_workers} x ({V}, {dim}): {merge_s:.2f} s")
    if emb_np.shape != (V, dim) or not np.isfinite(emb_np).all():
        raise RuntimeError(f"bad merged table: shape {emb_np.shape}")
    if int(valid_np.sum()) != V:
        raise RuntimeError("shuffle's merged table must cover the whole vocabulary")
    scores = evaluate_all(emb_np, valid_np, res.union_vocab, suite)
    log(f"[main] merged model: sim rho={scores['similarity']:.3f} "
        f"analogy={scores['analogy']:.3f} purity={scores['categorization']:.3f}")
    return {"launches": launches, "steps": taken, "counts": res.union_vocab.counts,
            "V": V, "n": num_workers, "dim": dim, "B": 1024, "K": cfg.negatives,
            "lr": cfg.lr, "corpus": corpus, "vocab": vocab, "train_kw": train_kw}


# ---------------------------------------------------------------------------
def _time_ms(fn, device, reps: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def phase_time(device, main: dict) -> dict:
    """Checks, then times, each kernel and its plain version at the main
    path's shapes: its noise table (the shuffle vocabulary's unigram^0.75
    alias table, shared by all workers), ids drawn from its unigram
    distribution, random tables. The checks run first, on clones, since
    the timing loops update the tables in place."""
    import numpy as np
    import torch
    from repro_torch.data.pairs import build_noise_table
    from repro_torch.kernels.sgns_fused import (
        sample_negatives, sample_negatives_plain, sgns_fused_step,
        sgns_fused_step_plain)

    n, V, d, B, K, lr = (main[k] for k in ("n", "V", "dim", "B", "K", "lr"))
    one = build_noise_table(main["counts"], kind="alias")
    table = {k: v.to(device).expand(n, V).contiguous() for k, v in one.items()}
    seeds = seeds_for(n, 5, device)
    gen = torch.Generator(device=device).manual_seed(7)
    uni = torch.tensor(main["counts"], dtype=torch.float32, device=device)
    centers = torch.multinomial(uni, n * B, replacement=True, generator=gen) \
        .view(n, B).to(torch.int32)
    contexts = torch.multinomial(uni, n * B, replacement=True, generator=gen) \
        .view(n, B).to(torch.int32)
    W = 0.1 * torch.randn((n, V, d), generator=gen, device=device)
    C = 0.1 * torch.randn((n, V, d), generator=gen, device=device)

    out = {}
    k1_err = _check_k1("time", seeds, table, (B, K))
    k2_err = _check_k2("time", W, C, centers, contexts, table, seeds, lr, K)
    # K1 at the step's draw shape (n, B, K)
    draws = n * B * K
    k1 = _time_ms(lambda: sample_negatives(seeds, table["prob"], table["alias"],
                                           (B, K)), device, reps=200)
    k1p = _time_ms(lambda: sample_negatives_plain(seeds, table["prob"],
                                                  table["alias"], (B, K)),
                   device, reps=50)
    k1_bytes = draws * (4 + 4 + 4) + n * 8          # prob+alias read, id written
    k1_flops = draws * 2                            # u·V and the compare
    out["sample_negatives"] = _bound(k1, k1p, k1_bytes, k1_flops)
    out["sample_negatives"]["max_abs_err"] = k1_err

    # K2: the whole step (K1 draw, planning sorts, both phases)
    pk = {"W": W.clone(), "C": C.clone()}
    k2 = _time_ms(lambda: sgns_fused_step(pk, centers, contexts, table, seeds, lr,
                                          negatives=K), device, reps=20)
    del pk
    pp = {"W": W.clone(), "C": C.clone()}
    k2p = _time_ms(lambda: sgns_fused_step_plain(pp, centers, contexts, table,
                                                 seeds, lr, negatives=K),
                   device, reps=10)
    del pp
    ids = sample_negatives(seeds, table["prob"], table["alias"], (B, K))
    uniq_w = sum(int(torch.unique(centers[w]).numel()) for w in range(n))
    uniq_c = sum(int(torch.unique(torch.cat([contexts[w], ids[w].reshape(-1)]))
                     .numel()) for w in range(n))
    row = d * 4
    k2_bytes = (2 * row * (uniq_w + uniq_c)        # touched rows read + written
                + n * B * (4 + 4 + 4)              # centers, contexts, loss
                + n * B * K * 8 + n * 8)           # drawn table entries, seeds
    # dots 2d(K+1), dW 2d(K+1), dC d(K+1), apply 2d(K+1) C + 2d W, per pair
    k2_flops = n * B * d * (7 * (K + 1) + 2)
    out["sgns_fused_step"] = _bound(k2, k2p, k2_bytes, k2_flops)
    out["sgns_fused_step"]["max_abs_err"] = k2_err
    out["sgns_fused_step"]["touched_rows"] = {"W": uniq_w, "C": uniq_c,
                                              "gathered": n * B * (K + 2)}
    for name, r in out.items():
        log(f"[time] {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms), "
            f"bound {r['bound_ms']:.5f} ms by {r['bound_by']} "
            f"({r['bytes']} B, {r['flops']} flop)")
    log(f"[time] K2 touched rows per step: {out['sgns_fused_step']['touched_rows']}")
    del W, C
    torch.cuda.empty_cache()
    return out


def phase_profile(device, main: dict) -> None:
    """The main path's training once more under torch.profiler: the
    device's busy time inside the driver's ``repro_torch.train_loop``
    span (the union of kernel and copy intervals), its idle share, and
    device time per step by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.driver import train_submodels

    groups = (("K2 phase 1", "sgns_pairs_kernel"), ("K2 apply", "sgns_apply_kernel"),
              ("K1", "sample_negatives_kernel"), ("planning sorts", "sort"),
              ("copies", "memcpy"))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = train_submodels(main["corpus"], main["vocab"], device=device,
                              **main["train_kw"])
        torch.cuda.synchronize(device)
    events = list(prof.events())
    loop = next(e for e in events if e.name == "repro_torch.train_loop")
    t0, t1 = loop.time_range.start, loop.time_range.end
    spans, by_kernel = [], {}
    for e in events:
        if (e.device_type != DeviceType.CUDA or "Command Buffer" in e.name
                or e.name.startswith("repro_torch.")):      # annotations
            continue
        s, f = max(e.time_range.start, t0), min(e.time_range.end, t1)
        if f <= s:
            continue
        spans.append((s, f))
        k = by_kernel.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += f - s
    busy, end = 0.0, t0
    for s, f in sorted(spans):
        if f > end:
            busy += f - max(s, end)
            end = f
    steps = res.timings["steps_per_epoch"]
    per_step = {g: 0.0 for g, _ in groups}
    per_step["other"] = 0.0
    for name, (_, us) in by_kernel.items():
        g = next((g for g, pat in groups if pat in name.lower()), "other")
        per_step[g] += us / steps
    window = t1 - t0
    summary = {"steps": steps, "train_loop_us": window, "device_busy_us": busy,
               "idle_share": 1.0 - busy / window,
               "chunk_wait_s": res.timings["chunk_wait_s"],
               "device_us_per_step": per_step,
               "kernels": sorted(({"name": n, "count": c, "device_us": us}
                                  for n, (c, us) in by_kernel.items()),
                                 key=lambda k: -k["device_us"])}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_main.json").write_text(json.dumps(summary, indent=1))
    prof.export_chrome_trace(str(out / "profile_main_trace.json"))
    log(f"[profile] train loop {window / 1e3:.1f} ms for {steps} steps "
        f"({window / steps / 1e3:.3f} ms/step), of which {res.timings['chunk_wait_s'] * 1e3:.1f}"
        f" ms blocked on chunks; device busy {busy / 1e3:.1f} ms, idle share "
        f"{summary['idle_share']:.3f}")
    for g, v in per_step.items():
        log(f"[profile]   {g}: {v:.1f} us/step")


def _bound(ms, plain_ms, nbytes, flops) -> dict:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "bytes": int(nbytes), "flops": int(flops),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if {"time", "profile"} & set(phases) and "main" not in phases:
        ap.error("the time and profile phases need the main phase")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              f"(no src/repro_torch)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    device = torch.device("cuda", 0)
    gpu = nvidia_smi_line()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"on {torch.cuda.get_device_name(0)} ({gpu})")

    t_start = time.perf_counter()
    results: dict = {}
    if "build" in phases:
        phase_build()
    if "k1" in phases:
        results["k1"] = phase_k1(device)
    if "k2" in phases:
        results["k2"] = phase_k2(device)
        torch.cuda.empty_cache()
    if "main" in phases:
        results["main"] = phase_main(device)
        torch.cuda.empty_cache()
    if "time" in phases:
        results["time"] = phase_time(device, results["main"])
    if "profile" in phases:
        phase_profile(device, results["main"])

    if {"k1", "k2", "main", "time"} <= set(phases):
        kernels = []
        for name in ("sample_negatives", "sgns_fused_step"):
            t = results["time"][name]
            kernels.append({
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name],
                "launches": results["main"]["launches"][name],
                # against the plain version at the main path's shapes
                "max_abs_err": t["max_abs_err"],
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"],
                # no single PyTorch call computes either function
                # (torch.multinomial draws other ids from the distribution)
                "library_ms": None,
            })
        print(json.dumps({"kernels": kernels}), flush=True)
    log(f"[env] phases {','.join(phases)} done in {time.perf_counter() - t_start:.1f} s")
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
