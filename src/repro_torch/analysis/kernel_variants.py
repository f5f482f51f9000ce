"""What holds K7, K4b, K3 and K1 back: each timed beside patched copies of
itself.

    PYTHONPATH=src python -m repro_torch.analysis.kernel_variants
    PYTHONPATH=src python -m repro_torch.analysis.kernel_variants --libs sgns_row_grads

Builds copies of ``csrc/swa_decode.cu``, ``csrc/sgns_fused_hbm.cu``,
``csrc/sgns_row_grads.cu`` and ``csrc/sample_negatives.cu`` with one part
changed (one ``nvcc`` per copy, all at once, into
``build/kernel_variants/``), loads each in place of the kernel's library,
and times the wrapper's call with CUDA events and the kernels' device time
with ``torch.profiler``:

* K7 at the decode path's shape (B = 4, W = 4096, 32 query heads over 8
  KV heads, D = 80, float32, random q, k, v): ``base`` (the kernel as it
  is), ``no-math`` (the consumers wait for each stage and release it
  without computing: the memory pipeline alone) and ``no-copies`` (the
  producer arrives on each stage without copying: the math alone);
* K4b at the main path's shapes (n = 10, V = 89,611, d = 500, B = 1024,
  K = 5; Zipf(1) ids): ``base`` and ``no-barrier`` (the cluster barrier
  of each pair taken out: the exchange of partial sums still happens,
  unordered; the link without its barrier);
* K3 at the ``random`` path's shape (N = n·B = 10,240 pairs, d = 500,
  K = 5, random rows): ``base`` (tiles of ``kTilePairs`` = 8 pairs through
  a ring of ``kStages`` = 2 stages), the other tile and ring sizes of the
  sweep (``p2s2`` … ``p4s3``: pairs a tile and stages, the same bits), and
  ``first`` — the first design (one warp a pair, its rows read twice in
  place, 8 pairs a CTA), which the kernel keeps for rows too long to
  stage: the patch takes that path at every shape (the same bits);
* K1 at the main path's draw (n = 10, V = 89,611, 1,024 × 5 draws a
  worker): ``base`` and ``empty`` (the same launch with its body taken
  out: the launch floor a draw of this size sits on).

``no-math``, ``no-copies``, ``no-barrier`` and ``empty`` compute wrong
results; only their times mean something. The other variants must keep
every bit (``main`` checks K3's against ``base``). The kernels themselves
carry no patch.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.distributions import build_alias_table
from repro_torch.kernels import build, sgns_fused
from repro_torch.kernels import swa_decode as S

VARIANTS = {
    "swa_decode": {
        "base": {},
        "no-math": {"    for (int g0row = sub; g0row < rows; g0row += step * TR) {":
                    "    for (int g0row = sub; g0row < 0; g0row += step * TR) {"},
        "no-copies": {
            "        mbar_arrive_expect_tx(&full[s], 2 * bytes);": "        mbar_arrive(&full[s]);",
            "        bulk_load(ring + s * 2 * half, k + off, bytes, &full[s]);\n": "",
            "        bulk_load(ring + s * 2 * half + half, v + off, bytes, &full[s]);\n": ""},
    },
    "sgns_fused_hbm": {
        "base": {},
        "no-barrier": {"        cluster_arrive_release();\n        cluster_wait_acquire();\n": ""},
    },
    "sgns_row_grads": {
        "base": {},
        **{f"p{p}s{st}": {"constexpr int kTilePairs = 8;": f"constexpr int kTilePairs = {p};",
                          "constexpr int kStages = 2;": f"constexpr int kStages = {st};"}
           for p, st in ((2, 2), (2, 4), (4, 2), (4, 3))},
        "first": {"  const bool staged = a.ring.tile > 0;": "  const bool staged = false;"},
    },
    "sample_negatives": {
        "base": {},
        "empty": {"  if (i >= per_worker) return;": "  if (i >= 0) return;"},
    },
}


def patched_source(lib: str, name: str) -> str:
    """The source of ``lib`` with variant ``name``'s parts taken out;
    raises if a patch no longer applies."""
    text = (build.CSRC / build.SOURCES[lib]).read_text()
    for a, b in VARIANTS[lib][name].items():
        if a not in text:
            raise RuntimeError(f"{lib} {name}: the patch does not apply: {a!r}")
        text = text.replace(a, b)
    return text


def build_variants(out: Path, wanted: dict | None = None) -> dict:
    """``{(library, variant): path}`` for ``wanted`` (``{library:
    [variant, ...]}``; every variant by default), one ``nvcc`` per copy,
    all at once; raises if a build fails."""
    procs = {}
    for lib, variants in (wanted or VARIANTS).items():
        src = build.SOURCES[lib]
        for name in variants:
            d = out / f"{lib}-{name}"
            d.mkdir(parents=True, exist_ok=True)
            for f in build.HEADERS:
                shutil.copy(build.CSRC / f, d / f)
            (d / src).write_text(patched_source(lib, name))
            lib_path = d / f"lib{lib}.so"
            cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(d), "-o", str(lib_path),
                   str(d / src)]
            procs[(lib, name)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True),
                                  lib_path)
    paths = {}
    for key, (proc, lib_path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        paths[key] = lib_path
    return paths


def use(lib: str, path: Path) -> None:
    """Route the wrappers' calls of ``lib`` to the library at ``path``
    (``build.library_path(lib)``: back to the kernel itself)."""
    build._libs[lib] = ctypes.CDLL(str(path))
    for key in [k for k in sgns_fused._entry_points if k[0] == lib]:
        del sgns_fused._entry_points[key]
    S._parts.cache_clear()


def _time_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_us(fn, calls: int, pattern: str) -> dict:
    """Device µs a call of each kernel whose name holds ``pattern``, from
    ``torch.profiler`` over ``calls`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {re.search(pattern + r"\w*", e.key).group(0): e.device_time_total / e.count
            for e in prof.key_averages() if pattern in e.key}


def main(argv=None) -> int:
    from repro_torch.kernels import sgns_fused_hbm as H
    from repro_torch.kernels import sgns_update as U

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--libs", default=",".join(VARIANTS),
                    help=f"comma-separated subset of {','.join(VARIANTS)}")
    libs = [x for x in ap.parse_args(argv).libs.split(",") if x]
    device = torch.device("cuda", 0)
    out_line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} ({out_line})", flush=True)
    out = build.build_dir().parent / "kernel_variants"
    paths = build_variants(out, {lib: VARIANTS[lib] for lib in libs})
    gen = torch.Generator(device=device).manual_seed(0)

    if "swa_decode" in libs:
        B, W, Hq, Hkv, D = 4, 4096, 32, 8, 80
        q = torch.randn((B, Hq, D), generator=gen, device=device)
        k = torch.randn((B, W, Hkv, D), generator=gen, device=device)
        v = torch.randn((B, W, Hkv, D), generator=gen, device=device)
        for name in VARIANTS["swa_decode"]:
            use("swa_decode", paths[("swa_decode", name)])
            call = lambda: S.swa_decode(q, k, v, chunk=512)     # noqa: E731
            ms = _time_ms(call, reps=200)
            dev = device_us(call, 20, "swa_")
            print(f"K7 {name}: {ms:.4f} ms a call; device us a call: "
                  + ", ".join(f"{n} {t:.1f}" for n, t in dev.items()), flush=True)
        del q, k, v

    n, V, d, Bp, K = 10, 89_611, 500, 1024, 5
    p = np.arange(1, V + 1, dtype=np.float64) ** -1.0
    prob, alias = build_alias_table(p / p.sum())
    table = {"prob": torch.tensor(prob, dtype=torch.float32, device=device).expand(n, V)
             .contiguous(),
             "alias": torch.tensor(alias, dtype=torch.int32, device=device).expand(n, V)
             .contiguous()}
    seeds = [sgns_fused.seed_tensor(prng.split(prng.PRNGKey(s), n), device) for s in (1, 2, 3)]
    if "sgns_fused_hbm" in libs:
        cen = sgns_fused.sample_negatives_plain(seeds[0], table["prob"], table["alias"], (Bp,))
        ctx = sgns_fused.sample_negatives_plain(seeds[1], table["prob"], table["alias"], (Bp,))
        Wt = 0.1 * torch.randn((n, V, d), generator=gen, device=device)
        Ct = 0.1 * torch.randn((n, V, d), generator=gen, device=device)
        for name in VARIANTS["sgns_fused_hbm"]:
            use("sgns_fused_hbm", paths[("sgns_fused_hbm", name)])
            params = {"W": Wt.clone(), "C": Ct.clone()}
            ms = _time_ms(lambda: H.sgns_fused_hbm_step(params, cen, ctx, table, seeds[2], 0.025,
                                                        negatives=K, sequential=True), reps=10)
            print(f"K4b {name}: {ms:.4f} ms a call", flush=True)
        del Wt, Ct, params

    if "sgns_row_grads" in libs:
        N = n * Bp
        rows = [0.1 * torch.randn(shape, generator=gen, device=device)
                for shape in ((N, d), (N, d), (N, K, d))]
        ref = None
        names = list(VARIANTS["sgns_row_grads"]) + ["base"]      # base first and last
        for name in names:
            use("sgns_row_grads", paths[("sgns_row_grads", name)])
            got = U.sgns_row_grads(*rows)
            torch.cuda.synchronize()
            ref = got if ref is None else ref
            same = all(torch.equal(a, b) for a, b in zip(got, ref))
            call = lambda: U.sgns_row_grads(*rows)               # noqa: E731
            ms = _time_ms(call, reps=50)
            dev = device_us(call, 20, "row_grads_")
            print(f"K3 {name} (N={N}, d={d}, K={K}): {ms:.4f} ms a call; device us a call: "
                  + ", ".join(f"{k_} {t:.1f}" for k_, t in dev.items())
                  + f"; bitwise base's: {same}", flush=True)
            if not same:
                raise SystemExit(f"K3 {name} does not keep base's bits")
        del rows, ref, got

    if "sample_negatives" in libs:
        for name in list(VARIANTS["sample_negatives"]) + ["base"]:
            use("sample_negatives", paths[("sample_negatives", name)])
            call = lambda: sgns_fused.sample_negatives(seeds[2], table["prob"],  # noqa: E731
                                                       table["alias"], (Bp, K))
            ms = _time_ms(call, reps=200)
            dev = device_us(call, 50, "sample_negatives")
            print(f"K1 {name} (n={n}, {Bp} x {K} draws a worker): {ms:.4f} ms a call; device "
                  "us a call: " + ", ".join(f"{k_} {t:.2f}" for k_, t in dev.items()),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
