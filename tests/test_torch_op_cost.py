"""``repro_torch.launch.op_cost`` on the CPU, against ``repro.launch.hlo_cost``.

* a Python loop of 7 matmuls of 64 × 64 counts 7·2·64³ flops (the
  counterpart of ``tests/test_infra.py::test_hlo_cost_counts_loop_trips``:
  eager dispatch unrolls the loop the HLO model multiplies);
* ``shape_elems_bytes``' dtype table: the reference's names, and every
  torch dtype under its name;
* reduced smollm-360m and deepseek-v2-lite-16b (prefill, one decode step,
  and a training step with 2 microbatches and remat): the port's matmul
  flops within 1 % of the dot flops of the reference's ``HloCostModel``
  over the compiled step (``jax.jit(...).lower(...).compile().as_text()``);
  the totals are printed with their ratio;
* on a fake 4 × 4 mesh (a process of its own), reduced smollm-360m,
  deepseek-v2-lite-16b and llama3-8b: the matmul flops a rank times 16
  within 1 % of the same case traced without a mesh, on cases whose dims
  all divide, but for deepseek's products with weights its specs keep
  whole on ``model``, which each of the axis's ranks repeats; no point
  replicated (the microbatch split is the port's own gather); the same on
  reduced smollm-360m overridden to 6 query and 2 key/value heads, which
  the 4-way ``model`` axis does not divide.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import hlo_cost as jhlo
from repro.models import Model as JaxModel
from repro.optim import get_optimizer as jget_optimizer
from repro_torch import configs, convert
from repro_torch.launch import op_cost
from repro_torch.launch.dryrun import (
    RANK_RULE_ARCHS, RANK_RULE_RTOL, rank_rule_holds)
from repro_torch.models import Model
from repro_torch.optim import get_optimizer

ROOT = Path(__file__).resolve().parents[1]
B, S, CACHE = 4, 32, 48
MATMUL_RTOL = 0.01


def test_loop_of_matmuls_counts_every_trip():
    x, w = torch.randn(64, 64), torch.randn(64, 64)
    with op_cost.CostMode() as mode:
        for _ in range(7):
            x = x @ w
    assert mode.cost.matmul_flops == mode.cost.flops == 7 * 2 * 64 ** 3
    assert mode.cost.ops == 7
    assert mode.cost.bytes == 7 * 3 * 64 * 64 * 4       # two operands and the output


def test_dtype_table_is_the_reference():
    for name in jhlo._DTYPE_BYTES:
        assert op_cost.shape_elems_bytes((2, 3), name) == jhlo.shape_elems_bytes(
            f"{name}[2,3]"), name
    for dt, name in op_cost.TORCH_DTYPE_NAMES.items():
        assert op_cost.shape_elems_bytes((5, 7), dt) == (35, 35 * torch.empty(0, dtype=dt)
                                                         .element_size()), dt
        assert op_cost.shape_elems_bytes((5, 7), dt) == jhlo.shape_elems_bytes(f"{name}[5,7]")
    for dt in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
        assert dt in op_cost.TORCH_DTYPE_NAMES


def test_views_are_free_and_collectives_are_charged():
    x = torch.randn(8, 16)
    with op_cost.CostMode() as mode:
        y = x.view(16, 8).t().t().view(128)
        z = y + 1
    assert mode.cost.ops == 1 and mode.cost.flops == 128
    assert mode.cost.bytes == 2 * 128 * 4
    assert op_cost._collective_kind(torch.ops._c10d_functional.all_gather_into_tensor.default) \
        == "all-gather"
    assert op_cost._collective_kind(torch.ops.c10d.allreduce_.default) == "all-reduce"
    assert op_cost._collective_kind(torch.ops._c10d_functional.wait_tensor.default) is None
    del z


class _DotsOnly(jhlo.HloCostModel):
    """The reference's cost model with every flop but a dot's dropped."""

    def op_cost(self, op, comp, fused=False):
        c = super().op_cost(op, comp, fused=fused)
        if op.opcode not in ("dot", "while", "conditional", "fusion", "call",
                             "async-start", "async-done"):
            c.flops = 0.0
        return c


def _ref_dot_flops(fn, *args) -> float:
    text = jax.jit(fn).lower(*args).compile().as_text()
    return _DotsOnly(text).total().flops


def _cases(arch):
    """(kind, the reference's dot flops, the port's matmul flops) of prefill,
    one decode step and a training step with 2 microbatches and remat, on
    one converted init and the same tokens."""
    jcfg = jconfigs.get_config(arch).reduced().with_overrides(remat=True)
    tcfg = configs.get_config(arch).reduced().with_overrides(remat=True)
    jm = JaxModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tcfg.vocab_size, (B, S), dtype=np.int32)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    out = []

    # prefill
    from repro.models import transformer as jtf

    ref = _ref_dot_flops(lambda p, b: jtf.forward_logits(p, jcfg, b)[0], params,
                         {"tokens": batch["tokens"]})
    model = convert.from_jax_model_params(tcfg, params, device="cpu")
    with torch.no_grad(), op_cost.CostMode() as mode:
        model.forward_logits({"tokens": torch.from_numpy(toks)})
    out.append(("prefill", ref, mode.cost.matmul_flops))

    # one decode step against a cache of CACHE slots
    cache = jm.init_cache(B, CACHE)
    ref = _ref_dot_flops(jm.make_decode_step(), params, cache, batch["tokens"][:, :1],
                         jnp.int32(CACHE - 1))
    tcache = model.init_cache(B, CACHE)
    with op_cost.CostMode() as mode:
        model.decode_step(tcache, torch.from_numpy(toks[:, :1]), CACHE - 1, swa_kernel=False)
    out.append(("decode", ref, mode.cost.matmul_flops))

    # a training step: 2 microbatches, remat
    jopt = jget_optimizer(jcfg.train_optimizer)
    ref = _ref_dot_flops(jm.make_train_step(jopt, microbatches=2), params, jopt.init(params),
                         batch, jnp.int32(0))
    opt = get_optimizer(tcfg.train_optimizer)
    step = model.make_train_step(opt, microbatches=2)
    state = opt.init(model.param_tree())
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    with op_cost.CostMode() as mode:
        step(state, tb, 0)
    out.append(("train", ref, mode.cost.matmul_flops))
    return out


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v2-lite-16b"])
def test_matmul_flops_match_the_reference_dot_flops(arch):
    for kind, ref, port in _cases(arch):
        print(f"{arch} {kind}: reference dots {ref:.6e}, port matmuls {port:.6e}, "
              f"ratio {port / ref:.6f}")
        assert ref > 0 and abs(port - ref) <= MATMUL_RTOL * ref, (arch, kind, port, ref)


@pytest.mark.parametrize("arch", RANK_RULE_ARCHS)
def test_per_rank_flops_times_ranks_are_the_unsharded_flops(arch):
    """Reduced ``arch`` on a fake 4 x 4 group (``python -m
    repro_torch.launch.dryrun --rank-rule``, a process of its own, the
    check ``chip_smoke.py sharding`` runs on the card's host): a rank's
    matmul flops times 16 are the count traced without a mesh (the dry
    run's own count, and this process's), within ``MATMUL_RTOL``. The dense
    archs have no weight whole on ``model``, so nothing is excused; deepseek
    exceeds the count by its latent and rope down-projections and router,
    repeated by the axis's 4 ranks: by no more than 3 x their flops, which
    are more than none and at most 5 % of the count. Nothing is replicated
    where no rule placed it (the microbatch split is the port's own
    gather)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--rank-rule",
                          arch], capture_output=True, text=True, env=env, cwd=str(ROOT),
                         timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    cfg = configs.get_config(arch).reduced().with_overrides(dtype="bfloat16")
    model = Model(cfg, device="meta")
    toks = torch.empty((16, 32), dtype=torch.int32, device="meta")
    with torch.no_grad(), op_cost.CostMode() as mode:
        model.forward_logits({"tokens": toks})
    whole = {"prefill": mode.cost.matmul_flops}
    opt = get_optimizer(cfg.train_optimizer)
    step = model.make_train_step(opt, microbatches=got["train"]["microbatches"])
    with op_cost.CostMode() as mode:
        step(opt.init(model.param_tree()), {"tokens": toks, "labels": toks}, 0)
    whole["train"] = mode.cost.matmul_flops
    for kind, c in got.items():
        over = 16 * c["per_rank"] - whole[kind]
        print(f"{arch} {kind}: a rank {c['per_rank']:.6e} x 16 = {16 * c['per_rank']:.6e}; "
              f"no mesh {whole[kind]:.6e} (over {over / whole[kind]:+.4e}; excused "
              f"{c['excused']:.6e}); replicated {c['fallbacks']}")
        assert c["unsharded"] == whole[kind], kind
        if arch == "deepseek-v2-lite-16b":
            assert 0 < 3 * c["excused"] <= 0.05 * whole[kind], kind
        else:
            assert c["excused"] == 0, kind
        tol = MATMUL_RTOL * whole[kind]
        assert -tol <= over <= 3 * c["excused"] + tol, kind
        assert not c["fallbacks"], c["fallbacks"]
        assert rank_rule_holds(c), kind

_UNEVEN_CHILD = r"""
import json, torch
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun
dryrun.join_fake_group(16)
cfg = get_config("smollm-360m").reduced().with_overrides(num_heads=6, num_kv_heads=2)
out = dryrun.rank_rule("smollm-360m", cfg=cfg)
mesh = DeviceMesh("cpu", torch.arange(16).view(4, 4), mesh_dim_names=("data", "model"))
case, _ = dryrun.build_case("smollm-360m", InputShape("d", 32, 16, "decode"), mesh, cfg=cfg)
out["decode"] = {"fallbacks": dict(case.run().fallbacks)}
print(json.dumps({"cfg": [cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim],
                  "cases": out}))
"""


def test_uneven_query_heads_keep_the_rank_rule():
    """Reduced smollm-360m with 6 query heads and 2 key/value heads of 32
    on a fake 4 x 4 group (a process of its own): the queries' 192
    features split 48 a rank, a head and a half, so the split into heads is
    not a block of a feature shard. Its prefill and train step keep the
    rank rule (a rank's matmul flops x 16 the count without a mesh, within
    ``RANK_RULE_RTOL``, nothing excused) and, with a decode step, replicate
    nothing: the queries go over positions before their split
    (``ctx.shard_head_proj``), the attention's output over positions, then
    its features over ``model`` for the output projection
    (``ctx.shard_o_proj``), whose weight gradient no rank repeats."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", _UNEVEN_CHILD], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["cfg"] == [6, 2, 32]
    for kind, c in got["cases"].items():
        print(kind, c)
        assert c["fallbacks"] == {}, kind
        if kind != "decode":
            assert c["excused"] == 0 and rank_rule_holds(c), kind
            rel = (16 * c["per_rank"] - c["unsharded"]) / c["unsharded"]
            assert abs(rel) <= RANK_RULE_RTOL, (kind, rel)
