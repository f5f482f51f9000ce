"""What holds K2 and K4a back: their launch timed beside patched copies.

    PYTHONPATH=src python -m repro_torch.analysis.block_step_variants
    PYTHONPATH=src python -m repro_torch.analysis.block_step_variants --variants base,stamps

Builds copies of ``csrc/sgns_block_step.cuh`` with one change each (one
``nvcc`` per copy and source, all at once, into
``build/block_step_variants/``), loads each in place of the K2 and K4a
libraries, and times the launch alone on the device (CUDA events around 20
launches, each drawing its negatives from the same seeds, all enqueued
while a sleep kernel holds the stream, so no host gap is counted) at the
main path's shapes (n = 10, V = 89,611, d = 500, B = 1024, K = 5; Zipf(1)
centers, contexts and noise table): K2 with one block, K4a with blocks of
256. Variants:

* ``base`` — the kernel as it is;
* ``lsu-apply`` / ``lsu-pairs`` / ``lsu-both`` — the applies' addend
  slices, the pairs' rows, or both, copied by each lane's own 16-byte
  ``cp.async`` instead of bulk copies (the same bits: checked against
  ``base``); the patch brings the per-lane copy loop the kernel no longer
  carries on the 16-byte path;
* ``split8`` … ``split128`` / ``nosplit`` — runs of at least 8, 16, 64 or
  128 addends (``kSplitRuns``, 32 in the kernel), or none, applied alone
  in chunks of 32 columns (the same bits);
* ``stages6`` / ``stages8`` — the apply ring 6 or 8 stages deep, not 4
  (the same bits);
* ``window16`` / ``window64`` — the short runs grouped by windows of 16 or
  64 sorted positions, not 32: more, shorter items or fewer, longer ones
  (the same bits);
* ``no-pairs`` / ``no-applies`` — one phase taken out (wrong results):
  the other phases, the barriers and the sort without it;
* ``items`` / ``items-nosplit`` — each apply item of worker 0's first
  block timed (the same bits), with hot runs split or not: how many, the
  longest, the last to end;
* ``stamps`` — the kernel with ``%globaltimer`` stamps written by thread 0
  of each CTA (the same bits): inside each sort task (after its keys are
  loaded and drawn, its radix passes, its rows and its items: the draw and
  sort's end), in each drawing CTA when its draw is written (before its
  release), and, for each block, after the
  pairs, after the barrier and after the applies, and after the barrier
  that ends the block (``analysis/dma_model.check_timeline`` holds these
  marks to the launch's phase order). For the first group (K2: worker 0's only block) it
  prints when each step of the first block ended, in µs from the launch's
  first stamp; and, averaged over the groups' first CTAs, the pairs and
  the applies phases summed over the blocks, each up to the barrier that
  ends it, as ``chain_phases`` measures K5's.

Prints one line a variant and shape. The kernel itself carries no
patch.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.distributions import build_alias_table
from repro_torch.kernels import build, sgns_fused
from repro_torch.kernels.sgns_block_step import run_block_step

HEADER = "sgns_block_step.cuh"
# the per-lane 16-byte copy the lsu-* patches use
_LSU = {"namespace sgns {\n\nconstexpr int kWarpBytes":
        "namespace sgns {\n\n__device__ __forceinline__ void copy16(float* dst, const float* "
        "src) {\n  asm volatile(\"cp.async.cg.shared.global [%0], [%1], 16;\" ::\"r\"("
        "sm90::smem_u32(dst)), \"l\"(src) : \"memory\");\n}\n\nconstexpr int kWarpBytes"}
_LSU_PAIRS = {
    "    if constexpr (BULK) {\n      if (lane == 0) sm90::mbar_arrive_expect_tx(&bar[st], "
    "static_cast<unsigned>(row_floats)":
        "    if constexpr (false) {\n      if (lane == 0) sm90::mbar_arrive_expect_tx(&bar[st], "
        "static_cast<unsigned>(row_floats)",
    "        for (int e = lane; e < d; e += 32) sm90::copy4(stage + r * d + e, row[r] + e);\n":
        "        for (int e = lane * VEC; e < d; e += 32 * VEC) {\n"
        "          if constexpr (VEC == 4) copy16(stage + r * d + e, row[r] + e);\n"
        "          else sm90::copy4(stage + r * d + e, row[r] + e);\n        }\n",
    "  auto wait = [&](int st, bool newer) {\n    if constexpr (BULK) {":
        "  auto wait = [&](int st, bool newer) {\n    if constexpr (false) {",
}
_LSU_APPLY = {
    "    const Meta& m = v / spf == fc ? cur : nxt;\n    if constexpr (BULK) {":
        "    const Meta& m = v / spf == fc ? cur : nxt;\n    if constexpr (false) {",
    "          sm90::copy4(slot(st, i, false) + lane, adds + src + lane);\n          if (hd) {\n"
    "            sm90::copy4(slot(st, i, true) + lane, table + static_cast<long long>(key) * d + "
    "col);\n          }\n":
        "          const float* row = table + static_cast<long long>(key) * d + col;\n"
        "          for (int e = 0; e < nv; e += (nv > 1 ? 4 : 1)) {\n"
        "            if (nv > 1) {\n"
        "              copy16(slot(st, i, false) + lane * nv + e, adds + src + lane * nv + e);\n"
        "              if (hd) copy16(slot(st, i, true) + lane * nv + e, row + e);\n"
        "            } else {\n"
        "              sm90::copy4(slot(st, i, false) + lane, adds + src + lane);\n"
        "              if (hd) sm90::copy4(slot(st, i, true) + lane, row);\n"
        "            }\n          }\n",
    "    if (v < nsub || !BULK) issue(v);": "    issue(v);",
    "    const int st = u % kStages;\n    if constexpr (BULK) {":
        "    const int st = u % kStages;\n    if constexpr (false) {",
    "    } else if (!BULK) {\n      sm90::copy_commit();": "    } else {\n      sm90::copy_commit();",
    "  if constexpr (!BULK) sm90::copy_wait<0>();": "  sm90::copy_wait<0>();",
}
_SPLIT = "constexpr int kSplitRuns = 32;"
_NOSPLIT = {_SPLIT: "constexpr int kSplitRuns = 1 << 30;"}
_ITEMS = {
    "namespace sgns {\n\nconstexpr int kWarpBytes":
        "namespace sgns {\n\n__device__ unsigned long long g_items[65536][4];\n"
        "__device__ __forceinline__ unsigned long long gtime() {\n"
        "  unsigned long long t;\n"
        "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
        "  return t;\n}\n\nconstexpr int kWarpBytes",
    "    if (t >= n_c + n_w) break;\n    if (t < n_w) {\n":
        "    if (t >= n_c + n_w) break;\n    const unsigned long long ts0 = gtime();\n"
        "    if (t < n_w) {\n",
    "                             phase);\n    }\n  }\n}":
        "                             phase);\n    }\n"
        "    if (lane == 0 && w == 0 && b == 0 && t < 65536) {\n"
        "      const int4 it = t < n_w ? a.items[(slot + 1) * a.item_cap + t]\n"
        "                              : a.items[slot * a.item_cap + (t - n_w)];\n"
        "      g_items[t][0] = ts0;\n      g_items[t][1] = gtime();\n"
        "      g_items[t][2] = (static_cast<unsigned long long>(it.y) << 32) | "
        "static_cast<unsigned>(it.w);\n"
        "      g_items[t][3] = (static_cast<unsigned long long>(t < n_w ? 0 : 1) << 32) | "
        "blockIdx.x;\n    }\n  }\n}",
}
VARIANTS = {
    "base": {},
    "lsu-apply": {**_LSU, **_LSU_APPLY},
    "lsu-pairs": {**_LSU, **_LSU_PAIRS},
    "lsu-both": {**_LSU, **_LSU_APPLY, **_LSU_PAIRS},
    **{f"split{t}": {_SPLIT: f"constexpr int kSplitRuns = {t};"} for t in (8, 16, 64, 128)},
    "nosplit": _NOSPLIT,
    "stages6": {"constexpr int kStages = 4;": "constexpr int kStages = 6;"},
    "stages8": {"constexpr int kStages = 4;": "constexpr int kStages = 8;"},
    "window16": {"constexpr int kItemWindow = 32;": "constexpr int kItemWindow = 16;"},
    "window64": {"constexpr int kItemWindow = 32;": "constexpr int kItemWindow = 64;"},
    "no-pairs": {"      if (rank >= first) {\n": "      if (false) {\n"},
    "no-applies": {"      applies_phase<BULK>(a, w, b, p0, lane, region, bar, phase);\n": ""},
    "items": _ITEMS,
    "items-nosplit": {**_ITEMS, **_NOSPLIT},
    "stamps": {
        "namespace sgns {\n\nconstexpr int kWarpBytes":
            "namespace sgns {\n\n__device__ unsigned long long g_stamps[1024][64];\n"
            "__device__ __forceinline__ void stamp(int k) {\n"
            "  if (threadIdx.x != 0 || blockIdx.x >= 1024 || k >= 64) return;\n"
            "  unsigned long long t;\n"
            "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
            "  g_stamps[blockIdx.x][k] = t;\n}\n\nconstexpr int kWarpBytes",
        "  __syncthreads();\n  int* order = cta_radix_sort(":
            "  __syncthreads();\n  stamp(1);\n  int* order = cta_radix_sort(",
        "  int* rows_out = (c_table ? a.c_rows : a.w_rows)":
            "  stamp(2);\n  int* rows_out = (c_table ? a.c_rows : a.w_rows)",
        "  __syncthreads();\n  int* spos = order == ids":
            "  __syncthreads();\n  stamp(3);\n  int* spos = order == ids",
        "a.n_items + slot);\n  __syncthreads();\n}":
            "a.n_items + slot);\n  __syncthreads();\n  stamp(4);\n}",
        # a drawing CTA's draw written, before its release on `drawn`
        "    __threadfence();\n    asm volatile(\"red.release.gpu.global.add.s32 [%0], 1;\" : "
        ": \"l\"(a.drawn + w)":
            "    stamp(5);\n    __threadfence();\n    asm volatile(\"red.release.gpu.global.add."
            "s32 [%0], 1;\" : : \"l\"(a.drawn + w)",
        "  __syncthreads();\n  unsigned phase = 0;\n":
            "  __syncthreads();\n  stamp(0);\n  unsigned phase = 0;\n",
        # block b: 8 + 4 b pairs done, 9 + 4 b past the barrier, 10 + 4 b
        # applies done, 11 + 4 b past the barrier that ends the block
        "      sm90::fence_proxy_async();\n      sm90::group_barrier(counter, ++arrivals * "
        "a.group_ctas);\n      sm90::fence_proxy_async();\n      applies_phase<BULK>(a, w, b, "
        "p0, lane, region, bar, phase);\n      if (b + 1 < a.nblocks) {\n"
        "        sm90::fence_proxy_async();\n        sm90::group_barrier(counter, ++arrivals * "
        "a.group_ctas);\n":
            "      __syncthreads();\n      stamp(8 + 4 * b);\n"
            "      sm90::fence_proxy_async();\n      sm90::group_barrier(counter, ++arrivals * "
            "a.group_ctas);\n      stamp(9 + 4 * b);\n      sm90::fence_proxy_async();\n"
            "      applies_phase<BULK>(a, w, b, p0, lane, region, bar, phase);\n"
            "      __syncthreads();\n      stamp(10 + 4 * b);\n      if (b + 1 < a.nblocks) {\n"
            "        sm90::fence_proxy_async();\n        sm90::group_barrier(counter, ++arrivals * "
            "a.group_ctas);\n        stamp(11 + 4 * b);\n",
    },
}
INEXACT = ("no-pairs", "no-applies")   # the variants that change the results
STAMP_NAMES = {5: "draw written", 1: "keys drawn", 2: "sort passes", 3: "sort rows out",
               4: "draw+sort end", 8: "pairs(0)", 9: "barrier", 10: "applies(0)"}
LIBS = {"K2": ("sgns_fused_step", "sgns_fused_step_launch", "sgns_fused_step"),
        "K4a": ("sgns_fused_hbm", "sgns_hbm_chain_launch", "sgns_fused_hbm_step")}


def patched_header(name: str) -> str:
    """``sgns_block_step.cuh`` with variant ``name``'s change; raises if a
    patch no longer applies."""
    text = (build.CSRC / HEADER).read_text()
    for a, b in VARIANTS[name].items():
        if text.count(a) != 1:
            raise RuntimeError(f"{name}: the patch does not apply: {a!r}")
        text = text.replace(a, b)
    return text


def build_variants(names, out: Path) -> dict:
    """``{(variant, library): path}``, one ``nvcc`` per copy, all at once."""
    procs = {}
    for name in dict.fromkeys(names):
        d = out / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        (d / HEADER).write_text(patched_header(name))
        for lib, _, _ in LIBS.values():
            if name == "stamps" or name.startswith("items"):
                sym = "g_stamps" if name == "stamps" else "g_items"
                with open(d / build.SOURCES[lib], "a") as f:
                    f.write(f'\nextern "C" int stamps_read(void* dst) {{ return static_cast<int>('
                            f'cudaMemcpyFromSymbol(dst, sgns::{sym}, sizeof(sgns::{sym}))); }}\n')
            path = d / f"lib{lib}.so"
            cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(d), "-o", str(path),
                   str(d / build.SOURCES[lib])]
            procs[(name, lib)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True), path)
    paths = {}
    for key, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        paths[key] = path
    return paths


def _use(lib: str, path: Path) -> None:
    """Route the wrappers' calls of ``lib`` to the library at ``path``."""
    build._libs[lib] = ctypes.CDLL(str(path))
    for key in [k for k in sgns_fused._entry_points if k[0] == lib]:
        del sgns_fused._entry_points[key]


def _timeline(lib: str, blk: int, n: int, d: int, B: int, K: int) -> dict:
    """The last launch's stamps. For the first group's CTAs, per step of the
    first block, the earliest and latest CTA to end it, in µs from the
    launch's first stamp (0 where no CTA of the group stamped); and, over
    the groups' first CTAs, the pairs and applies phases summed over the
    blocks, each up to the barrier that ends it (the first pairs phase
    holds the sort), as ``chain_phases`` measures K5's."""
    from repro_torch.kernels.sgns_block_step import _sms, geometry

    stamps = np.zeros((1024, 64), dtype=np.uint64)
    err = build._libs[lib].stamps_read(ctypes.c_void_p(stamps.ctypes.data))
    if err:
        raise RuntimeError(f"stamps_read failed with {err}")
    geo = geometry(n, d, B, K, blk, _sms(torch.device("cuda", 0)))
    g = stamps[:geo.group_ctas].astype(np.int64)
    t0 = int(g[:, 0][g[:, 0] > 0].min())
    out = {}
    for k, label in STAMP_NAMES.items():
        col = g[:, k][g[:, k] > 0]
        out[label] = [float((col.min() - t0) / 1e3), float((col.max() - t0) / 1e3)] \
            if len(col) else [0.0, 0.0]
    print("    first group, µs from the launch's first stamp (earliest, latest CTA): "
          + "; ".join(f"{k} {a:.1f}-{b:.1f}" for k, (a, b) in out.items()), flush=True)
    firsts = stamps[[c * geo.group_ctas for c in range(min(geo.groups, 1024 // geo.group_ctas))]]
    t = firsts.astype(np.int64)
    nb = geo.nblocks
    pairs = applies = 0.0
    for b in range(nb):
        start = t[:, 0] if b == 0 else t[:, 11 + 4 * (b - 1)]
        end = t[:, 11 + 4 * b] if b + 1 < nb else t[:, 10 + 4 * b]
        pairs += float((t[:, 9 + 4 * b] - start).mean()) / 1e3
        applies += float((end - t[:, 9 + 4 * b]).mean()) / 1e3
    total = float((t[:, 10 + 4 * (nb - 1)] - t[:, 0]).mean()) / 1e3
    out["phases_us"] = {"pairs": pairs, "applies": applies, "in_kernel": total}
    print(f"    groups' first CTAs: in the kernel {total:.1f} us: pairs {pairs:.1f}, applies "
          f"{applies:.1f} us over {nb} blocks", flush=True)
    return out


def _item_times(lib: str) -> dict:
    """The last launch's apply items of worker 0's first block: how many,
    when the last ended (µs from the first one's start), and the items that
    took longest and ended last, each as (table, positions, columns, CTA,
    start, end)."""
    rec = np.zeros((65536, 4), dtype=np.uint64)
    err = build._libs[lib].stamps_read(ctypes.c_void_p(rec.ctypes.data))
    if err:
        raise RuntimeError(f"stamps_read failed with {err}")
    rec = rec[rec[:, 1] > 0].astype(np.int64)
    t0 = rec[:, 0].min()
    rows = [("W" if r[3] >> 32 == 0 else "C", int(r[2] >> 32), int(r[2] & 0xFFFFFFFF),
             int(r[3] & 0xFFFFFFFF), (r[0] - t0) / 1e3, (r[1] - t0) / 1e3) for r in rec]
    longest = sorted(rows, key=lambda x: x[5] - x[4], reverse=True)[:6]
    last = sorted(rows, key=lambda x: x[5], reverse=True)[:6]
    fmt = lambda x: f"{x[0]} len {x[1]} cols {x[2]} cta {x[3]} {x[4]:.1f}-{x[5]:.1f}"
    print(f"    worker 0, block 0: {len(rows)} items, the last ending at {last[0][5]:.1f} us; "
          f"mean {np.mean([x[5] - x[4] for x in rows]):.1f} us an item", flush=True)
    print("    longest: " + "; ".join(fmt(x) for x in longest), flush=True)
    print("    last:    " + "; ".join(fmt(x) for x in last), flush=True)
    return {"count": len(rows), "longest": longest, "last": last}


def _time_ms(fn, reps: int = 20) -> float:
    """Device ms a call: the calls are enqueued behind a sleep kernel
    (~50 ms), so the events see the launches back to back."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    names = [v for v in args.variants.split(",") if v]
    device = torch.device("cuda", 0)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} ({gpu})", flush=True)
    paths = build_variants(names, build.build_dir().parent / "block_step_variants")

    n, V, d, B, K = 10, 89_611, 500, 1024, 5
    p = np.arange(1, V + 1, dtype=np.float64) ** -1.0
    prob, alias = build_alias_table(p / p.sum())
    table = {"prob": torch.tensor(prob, dtype=torch.float32, device=device).expand(n, V)
             .contiguous(),
             "alias": torch.tensor(alias, dtype=torch.int32, device=device).expand(n, V)
             .contiguous()}
    seeds = [sgns_fused.seed_tensor(prng.split(prng.PRNGKey(s), n), device) for s in (1, 2, 3)]
    cen = sgns_fused.sample_negatives_plain(seeds[0], table["prob"], table["alias"], (B,))
    ctx = sgns_fused.sample_negatives_plain(seeds[1], table["prob"], table["alias"], (B,))
    gen = torch.Generator(device=device).manual_seed(0)
    W0 = 0.1 * torch.randn((n, V, d), generator=gen, device=device)
    C0 = 0.1 * torch.randn((n, V, d), generator=gen, device=device)

    results, ref = {}, {}
    for name in names:
        for label, blk in (("K2", B), ("K4a", 256)):
            lib, sym, counter = LIBS[label]
            _use(lib, paths[(name, lib)])
            params = {"W": W0.clone(), "C": C0.clone()}
            loss, ids = run_block_step(lib, sym, counter, params, cen, ctx, table, seeds[2],
                                       0.025, blk, K)
            torch.cuda.synchronize()
            same = None
            if name not in INEXACT:
                out = (loss, ids, params["W"], params["C"])
                ref.setdefault(label, out)
                same = all(torch.equal(a, b) for a, b in zip(out, ref[label]))
            pk = {"W": W0.clone(), "C": C0.clone()}
            ms = _time_ms(lambda: run_block_step(lib, sym, counter, pk, cen, ctx, table,
                                                 seeds[2], 0.025, blk, K))
            del params, pk
            results[f"{name}/{label}"] = {"ms": ms, "bitwise_base": same}
            print(f"{name:10s} {label:3s} (block_pairs={blk}): launch alone {ms:.4f} ms"
                  + ("" if same is None else f"; bitwise base's: {same}"), flush=True)
            if name == "stamps":
                results[f"{name}/{label}"]["timeline"] = _timeline(lib, blk, n, d, B, K)
            if name.startswith("items"):
                results[f"{name}/{label}"]["items"] = _item_times(lib)
    bad = [k for k, r in results.items() if r["bitwise_base"] is False]
    if bad:
        raise SystemExit(f"variants that should keep every bit did not: {bad}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
