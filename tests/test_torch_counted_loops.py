"""``repro_torch.launch.op_cost.counted_loops`` — the dry run's counted loops
(the counterpart of ``repro.launch.hlo_cost``'s ``while`` body counted once
and multiplied by its trip count) — on the CPU.

* without a mesh: a toy loop's counted trace (forward and backward, a y
  aliasing the carry, per-trip parameters) equals the unrolled one; a loop
  whose trips differ (their parameters, their carry, trip n − 1's work)
  raises; :func:`repro_torch.models.loops.trips` without the mode is the
  plain loop;
* on a fake 4 × 4 group (meta shards; each case a process of its own, three
  at once): reduced jamba-1.5-large-398b (the cycle and Mamba's chunks),
  xlstm-1.3b (S = 512, a multiple of 256 above it: sLSTM's segments and
  steps, prefill and train; S = 1,024: mLSTM's chunks; mLSTM's step scan),
  llama3-8b (the cycle and the microbatches) and deepseek-v2-lite-16b (the
  cycle after a prefix layer) traced by ``Case.run(counted=True)`` against
  ``counted=False``: flops, matmul flops, bytes, collective bytes and counts
  by kind, ops and the peak live bytes exactly equal, nothing replicated.
  The peak is held exact: the skipped trips' kept bytes are laid out at
  each trip boundary, the skipped backward windows' peak is trip 1's rise
  above its start from the highest of their starts, and every case here
  agrees to the byte.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest
import torch

from repro_torch.launch import op_cost
from repro_torch.models import loops

ROOT = Path(__file__).resolve().parents[1]


def _cost(c: op_cost.Cost) -> tuple:
    return c.work() + (c.peak_bytes,)


def _toy(counted: bool, n: int = 7, widths=None):
    """A loop of ``n`` trips: each multiplies the carry by its own weight
    (``widths[i]`` wide), adds a shared bias, and yields the carry itself
    (as sLSTM's h) and a reduction; the ys are stacked and the loss is
    backpropagated. Returns the mode."""
    gen = torch.Generator().manual_seed(0)
    widths = widths or [16] * n
    ws = [torch.randn(16, k, generator=gen, requires_grad=True) for k in widths]
    bias = torch.randn(16, generator=gen, requires_grad=True)
    x = torch.randn(4, 16, generator=gen, requires_grad=True)

    def trip(h, i):
        h = torch.tanh(h @ ws[i] + bias)
        return h, (h, h.sum(-1))

    mode = op_cost.CostMode()
    with mode, (op_cost.counted_loops(mode) if counted else torch.enable_grad()):
        mode.track([x, bias] + ws)
        h, ys = loops.trips(trip, [x * 1.0], n, params=lambda i: [ws[i]])
        loss = torch.stack([y[0] for y in ys]).sum() + torch.stack([y[1] for y in ys]).sum()
        torch.autograd.grad(loss + h.sum(), [x, bias] + ws)
    return mode


def test_counted_toy_loop_is_the_unrolled_loop():
    """Forward and backward of a 7-trip loop (a y that is the carry, a
    shared bias whose gradient sums over the trips, a weight a trip):
    every count and the peak as unrolled, and the work is not vacuous."""
    full, counted = _toy(False), _toy(True)
    assert _cost(counted.cost) == _cost(full.cost)
    assert full.cost.matmul_flops == 3 * 7 * 2 * 4 * 16 * 16


@pytest.mark.parametrize("fault", ["params", "carry", "last_trip"])
def test_counted_loop_raises_where_trips_differ(fault):
    """Trips whose own parameters differ in shape, whose carry changes from
    trip to trip, or whose last trip's work differs from trip 1's make the
    counted loop raise rather than charge copies of trip 1."""
    mode = op_cost.CostMode()
    x, w = torch.randn(4, 16), torch.randn(16, 16)

    if fault == "params":
        with pytest.raises(RuntimeError, match="parameters differ"):
            _toy(True, widths=[16] * 4 + [8] + [16] * 2)
        return

    def trip(h, i):
        if fault == "carry":                 # a column more each trip
            return torch.cat([h, h[:, :1]], dim=1), None
        h = h @ w
        if i == 5:
            h = h + 1
        return h, None

    with mode, op_cost.counted_loops(mode), pytest.raises(RuntimeError, match="counted loop"):
        loops.trips(trip, [x], 6)


def test_trips_without_the_mode_is_the_plain_loop():
    """Without a counted loop installed (every real run), :func:`trips`
    runs every trip in order from the handed-over carry and empties the
    box."""
    box, seen = [torch.zeros(3)], []

    def trip(c, i):
        seen.append(i)
        return c + i, c.sum()

    out, ys = loops.trips(trip, box, 5)
    assert box == [] and seen == list(range(5))
    assert out.tolist() == [10.0] * 3 and [float(y) for y in ys] == [0, 0, 3, 9, 18]


_CHILD = r"""
import json, sys, torch
from dataclasses import replace
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun
dryrun.join_fake_group(16)
mesh = DeviceMesh("cpu", torch.arange(16).view(4, 4), mesh_dim_names=("data", "model"))
arch, kind, S, B, over = json.loads(sys.argv[1])
cfg = get_config(arch).reduced()
ssm = over.pop("ssm", None)
cfg = cfg.with_overrides(num_cycles=0, **{k: tuple(v) if isinstance(v, list) else v
                                         for k, v in over.items()})
if ssm:
    cfg = cfg.with_overrides(ssm=replace(cfg.ssm, **ssm))
out = {}
for counted in (False, True):
    case, meta = dryrun.build_case(arch, InputShape("c", S, B, kind), mesh, cfg=cfg)
    mode = case.run(counted=counted)
    c = mode.cost
    out[str(counted)] = {"work": c.work(), "peak": c.peak_bytes, "fallbacks": dict(mode.fallbacks),
                         "microbatches": meta.get("microbatches"), "cycles": cfg.resolved_num_cycles}
print(json.dumps(out))
"""

# name: (arch, kind, S, B, config overrides)
CASES = {
    "jamba": ("jamba-1.5-large-398b", "train", 2048, 4,
              {"cycle_codes": ["M-E"], "num_layers": 4}),
    "xlstm_prefill": ("xlstm-1.3b", "prefill", 512, 4,
                      {"cycle_codes": ["m", "s"], "num_layers": 2}),
    "xlstm_slstm": ("xlstm-1.3b", "train", 512, 4, {"cycle_codes": ["m", "s"], "num_layers": 2}),
    "xlstm_mlstm_chunks": ("xlstm-1.3b", "train", 1024, 4,
                           {"cycle_codes": ["m"], "num_layers": 1}),
    "xlstm_mlstm_steps": ("xlstm-1.3b", "train", 8, 4,
                          {"cycle_codes": ["m"], "num_layers": 4, "ssm": {"mlstm_chunk": 0}}),
    "llama3": ("llama3-8b", "train", 64, 16, {"num_layers": 6}),
    "deepseek": ("deepseek-v2-lite-16b", "train", 32, 4, {"num_layers": 5}),
}


@pytest.fixture(scope="module")
def traced():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}

    def one(case):
        res = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(case)],
                             capture_output=True, text=True, env=env, cwd=str(ROOT),
                             timeout=600)
        return res.returncode, res.stdout, res.stderr

    with ThreadPoolExecutor(3) as pool:
        return dict(zip(CASES, pool.map(one, CASES.values())))


@pytest.mark.parametrize("name", sorted(CASES))
def test_counted_trace_is_the_unrolled_trace(traced, name):
    """Reduced ``name`` on a fake 4 × 4 group, traced with the counted loops
    (trips 0, 1 and n − 1 run; trips 2 … n − 2 charged as trip 1) and
    unrolled: the same flops, matmul flops, bytes, collective bytes and
    counts by kind and ops, the same peak live bytes to the byte, and
    nothing replicated; each case has a loop of at least 4 trips."""
    rc, out, err = traced[name]
    assert rc == 0, err[-3000:]
    got = json.loads(out.strip().splitlines()[-1])
    full, counted = got["False"], got["True"]
    print(name, full["work"][:5], full["peak"], counted["peak"])
    assert counted["work"] == full["work"]
    assert counted["peak"] == full["peak"]
    assert full["fallbacks"] == counted["fallbacks"] == {}
    assert full["work"][1] > 0
