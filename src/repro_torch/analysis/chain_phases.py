"""Where K5's time goes: the block-chain kernel's phases timed on the card.

    PYTHONPATH=src python -m repro_torch.analysis.chain_phases
    PYTHONPATH=src python -m repro_torch.analysis.chain_phases --variants base,ahead4,k6

Builds copies of ``csrc/sgns_pipe.cuh`` (one ``nvcc`` per variant, all at
once, into ``build/chain_phases/``) with a ``%globaltimer`` stamp after each
group barrier of the persistent kernel, written by the first CTA of each
worker's group, and runs each variant on one step at the main path's shapes
(n = 10, V = 89,611, d = 500, B = 1024, K = 5, blk = 256) with Zipf(1)
centers, contexts and negatives (a heavier skew than the trainer's, so the
hot rows' runs are long) and at ``@zipf50k``'s (n = 1, V = 50,000, d = 512,
B = 8,192, blk = 128). It prints, per variant and shape, the launch's time
(CUDA events, 20 launches), the stamped time inside the kernel, the pairs
and the applies phases summed over the blocks (each up to its barrier), and
whether the tables and loss are bitwise K4a's. The stamps cost one store a
phase a group.

Variants: ``base`` (the kernel as it is), ``ahead4``/``ahead16`` (kAhead,
the addend chunks staged per batch), ``k6`` (K6 at hot_rows 256 with its
policies), ``k6-cold-normal`` (K6 with cold rows at normal L2 priority
instead of evict_first), ``barriers`` (phases emptied: the barriers' cost).
The kernel itself carries no stamps; only these copies do.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.sgns_fused import _ptr, _stream, sample_negatives_plain, seed_tensor

STAMP = ('if (threadIdx.x == 0 && blockIdx.x % a.group_ctas == 0 && g < 64 && arrivals < 255)'
         ' { unsigned long long t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));'
         ' g_stamps[g][arrivals] = t; }')
BARRIER = "group_barrier(counter, ++arrivals * a.group_ctas);"
VARIANTS = {
    "base": {},
    "ahead4": {"ahead": 4},
    "ahead16": {"ahead": 16},
    "k6": {"tiered": True},
    "k6-cold-normal": {"tiered": True, "cold": "evict_normal"},
    "barriers": {"empty": True},
}


def _patch(src: str, ahead=None, cold=None, empty=False) -> str:
    """``sgns_pipe.cuh`` with the stamps (and a variant's change)."""
    def sub(old, new, count=1):
        nonlocal src
        if src.count(old) != count:
            raise RuntimeError(f"sgns_pipe.cuh no longer holds {old!r} {count} time(s)")
        src = src.replace(old, new)

    sub("namespace sgns {\n",
        "namespace sgns {\n__device__ unsigned long long g_stamps[64][256];\n")
    sub(f"if (b + 1 < nblocks) {BARRIER}", f"if (b + 1 < nblocks) {{ @@ {STAMP} }}")
    sub(BARRIER, f"{BARRIER} {STAMP}")
    sub("@@", BARRIER)
    sub("  for (int w = g; w < a.n; w += a.groups) {",
        "  { const int arrivals = 0; " + STAMP + " }\n  for (int w = g; w < a.n; w += a.groups) {")
    sub("    if constexpr (TIERED) release_hot(a, w, gwarp, gwarps, lane);\n  }\n}",
        "    if constexpr (TIERED) release_hot(a, w, gwarp, gwarps, lane);\n  }\n"
        "  __syncthreads();\n  ++arrivals;\n  " + STAMP + "\n}")
    if ahead is not None:
        sub("constexpr int kAhead = 8;", f"constexpr int kAhead = {ahead};")
    if cold is not None:
        sub("createpolicy.fractional.L2::evict_first.b64",
            f"createpolicy.fractional.L2::{cold}.b64")
    if empty:
        sub("      chain_pairs<VEC, TIERED>(", "      if (false) chain_pairs<VEC, TIERED>(")
        sub("      chain_applies<VEC, TIERED>(", "      if (false) chain_applies<VEC, TIERED>(")
    return src


def build_variants(names) -> dict:
    """One patched library per variant, built in parallel."""
    root = build.build_dir().parent / "chain_phases"
    procs = {}
    for name in names:
        v = VARIANTS[name]
        d = root / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        (d / "sgns_pipe.cuh").write_text(_patch((d / "sgns_pipe.cuh").read_text(),
                                                v.get("ahead"), v.get("cold"),
                                                v.get("empty", False)))
        cu = "sgns_fused_tiered.cu" if v.get("tiered") else "sgns_fused_pipe.cu"
        with open(d / cu, "a") as f:
            f.write('\nextern "C" int stamps_read(void* dst) { return static_cast<int>('
                    'cudaMemcpyFromSymbol(dst, sgns::g_stamps, sizeof(sgns::g_stamps))); }\n')
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(d), "-o", str(d / "lib.so"),
               str(d / cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), d / "lib.so")
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        L = ctypes.CDLL(str(lib))
        fn = L.sgns_tiered_launch if VARIANTS[name].get("tiered") else L.sgns_pipe_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        L.stamps_read.argtypes = [ctypes.c_void_p]
        libs[name] = (L, fn)
    return libs


def _inputs(n, V, d, B, device):
    """Random tables and Zipf(1) ids of n workers (centers, contexts, and
    an alias table the negatives are drawn from)."""
    from repro_torch import prng
    from repro_torch.core.distributions import build_alias_table

    p = np.arange(1, V + 1, dtype=np.float64) ** -1.0
    prob, alias = build_alias_table(p / p.sum())
    table = {"prob": torch.tensor(prob, dtype=torch.float32, device=device).expand(n, V)
             .contiguous(),
             "alias": torch.tensor(alias, dtype=torch.int32, device=device).expand(n, V)
             .contiguous()}
    seeds = [seed_tensor(prng.split(prng.PRNGKey(s), n), device) for s in range(4)]
    gen = torch.Generator(device=device).manual_seed(0)
    W = 0.1 * torch.randn((n, V, d), generator=gen, device=device)
    C = 0.1 * torch.randn((n, V, d), generator=gen, device=device)
    cen = sample_negatives_plain(seeds[1], table["prob"], table["alias"], (B,))
    ctx = sample_negatives_plain(seeds[2], table["prob"], table["alias"], (B,))
    return W, C, cen, ctx, table, seeds[3]


def _time_ms(fn, reps=20) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run(names, shapes=((10, 89_611, 500, 1024, 256), (1, 50_000, 512, 8192, 128))) -> list:
    from repro_torch.kernels.sgns_fused_hbm import block_sorts, sgns_fused_hbm_step

    device = torch.device("cuda", 0)
    libs = build_variants(names)
    rows = []
    for n, V, d, B, blk in shapes:
        W, C, cen, ctx, table, seeds = _inputs(n, V, d, B, device)
        ref, ref_loss, ids = sgns_fused_hbm_step({"W": W.clone(), "C": C.clone()}, cen, ctx,
                                                 table, seeds, 0.025, negatives=5,
                                                 block_pairs=blk)
        blk = min(blk, B)
        nb = -(-B // blk)
        runs = block_sorts(cen, ctx, ids, blk, V)
        for name, (L, fn) in libs.items():
            hot = 256 if VARIANTS[name].get("tiered") else 0
            f32 = dict(dtype=torch.float32, device=device)

            def launch(p):
                loss = torch.empty((n, B), **f32)
                scratch = [torch.empty((n, blk, 6), **f32), torch.empty((n, blk, d), **f32),
                           torch.empty((n, blk, d), **f32),
                           torch.empty((n,), dtype=torch.int32, device=device)]
                err = fn(_ptr(p["W"]), _ptr(p["C"]), _ptr(loss), _ptr(cen), _ptr(ctx),
                         _ptr(ids), *[_ptr(r) for r in runs], *[_ptr(t) for t in scratch],
                         n, V, d, B, 5, blk, hot, -0.025, 1, _stream(device))
                if err:
                    raise RuntimeError(f"{name}: launch failed with error {err}")
                return loss

            p = {"W": W.clone(), "C": C.clone()}
            loss = launch(p)
            torch.cuda.synchronize()
            same = torch.equal(loss, ref_loss) and all(torch.equal(p[k], ref[k]) for k in "WC")
            ms = _time_ms(lambda: launch(p))
            stamps = np.zeros((64, 256), dtype=np.uint64)
            L.stamps_read(stamps.ctypes.data)
            t = stamps[:min(n, 64), :2 * nb + 1].astype(np.int64)
            phase = np.diff(t, axis=1).mean(0) / 1e3
            row = {"variant": name, "n": n, "B": B, "blk": blk, "ms": ms,
                   "in_kernel_us": float((t[:, -1] - t[:, 0]).mean() / 1e3),
                   "pairs_us": float(phase[0::2].sum()), "applies_us": float(phase[1::2].sum()),
                   "bitwise_k4a": bool(same)}
            rows.append(row)
            print(f"{name} n={n} B={B} blk={blk}: {ms:.4f} ms a launch; in the kernel "
                  f"{row['in_kernel_us']:.1f} us: pairs {row['pairs_us']:.1f}, applies "
                  f"{row['applies_us']:.1f} us over {nb} blocks; bitwise K4a's: {same}",
                  flush=True)
            del p
        del W, C, ref
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help=f"comma-separated subset of {','.join(VARIANTS)}")
    args = ap.parse_args(argv)
    names = [v for v in args.variants.split(",") if v]
    unknown = set(names) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    if not torch.cuda.is_available():
        raise SystemExit("chain_phases: no CUDA device is available")
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(out, flush=True)
    run(names)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
