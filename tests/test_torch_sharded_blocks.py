"""The embedding's gradient and the MoE's dispatch buffers on each rank's
blocks (``repro_torch.sharding.ctx``), on the CPU.

* four gloo processes on a 2 × 2 ``("data", "model")`` mesh, real values
  (a ``FileStore`` under pytest's ``tmp_path``):

  - reduced llama3-8b and reduced smollm-360m (tied embeddings) from the
    reference's init: each rank's block of the ``embed`` gradient (the
    port's ``embedding_dense_backward`` rule; for smollm also the LM head's
    share) against the matching block of ``jax.grad`` of the reference's
    loss, 1e-6;
  - reduced deepseek-v2-lite-16b and qwen3-moe-30b-a3b's first MoE layer
    (``ctx.ExpertBlocks``): the output, the aux loss, the input's and every
    parameter's gradient against the same layer without a mesh, 1e-6, the
    routes (``top_idx``, ``keep``) bitwise;
  - an Adafactor step on two of reduced jamba's layers against none, 1e-6, each new
    parameter and state leaf in its own placements (``ctx.placed_as``);

* a fake group of 16 (4 × 4, meta shards; a process of its own): a reduced
  llama3 and smollm train step makes no op output of the whole ``(Vp, d)``
  table, the MoE train steps of reduced deepseek and qwen3-moe hold each
  rank's ``(G/4, E/4, C, d)`` block and no output of the whole buffer's
  size, and nothing is replicated.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import Model as JaxModel
from repro_torch.checkpoint.io import save_checkpoint

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 8
EMBED_ARCHS = ("llama3-8b", "smollm-360m")
MOE_ARCHS = ("deepseek-v2-lite-16b", "qwen3-moe-30b-a3b")
ATOL = 1e-6

_GLOO_CHILD = r"""
import json, sys, numpy as np, torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from repro_torch.checkpoint.io import load_checkpoint
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models.moe import MoE
from repro_torch.sharding import ctx
from repro_torch.sharding.rules import data_spec, to_placements
rank, store, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
embed_archs, moe_archs = json.loads(sys.argv[4]), json.loads(sys.argv[5])
torch.set_num_threads(1)
B, S = 4, 8
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank, world_size=4)
mesh = DeviceMesh("cpu", torch.arange(4).view(2, 2), mesh_dim_names=("data", "model"))
out, arrays = {}, {}


def placed(model):
    specs = model.param_specs(mesh)
    model.set_params({n: distribute_tensor(model.get_parameter(n).detach(), mesh,
                                           to_placements(s, mesh))
                      for n, s in specs.items()})


def batch_on(v):
    return distribute_tensor(v, mesh, to_placements(data_spec(tuple(v.shape), mesh), mesh))


for arch in embed_archs:
    tree, _ = load_checkpoint(f"{d}/{arch}.npz")
    toks = torch.from_numpy(np.load(f"{d}/{arch}_tokens.npy"))
    model = Model(get_config(arch).reduced(), device="cpu").load_param_tree(tree)
    placed(model)
    model.requires_grad_(True)
    with ctx.use_mesh_constraints(mesh) as mode:
        loss = model.loss_fn({"tokens": batch_on(toks), "labels": batch_on(toks)})
        (g,) = torch.autograd.grad(loss, [model.embed])
    shape, offset = compute_local_shape_and_global_offset(g.shape, mesh, g.placements)
    arrays[f"{arch}_block"] = g.to_local().detach().numpy()
    out[arch] = {"placements": str(g.placements), "param": str(model.embed.placements),
                 "offset": list(offset), "shape": list(shape), "fallbacks": dict(mode.fallbacks)}

for arch in moe_archs:
    cfg = get_config(arch).reduced()
    model = Model(cfg, key=None, device="cpu")
    tree, _ = load_checkpoint(f"{d}/{arch}.npz")
    model.load_param_tree(tree)
    name, moe = next((n, m) for n, m in model.named_modules() if isinstance(m, MoE))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(B, S, cfg.d_model, generator=gen)
    gy = torch.randn(B, S, cfg.d_model, generator=gen)
    kw = dict(capacity_factor=cfg.moe.capacity_factor, groups=2)
    params = [p for _, p in moe.named_parameters()]
    for p in params:
        p.requires_grad_(True)
    xs = x.clone().requires_grad_(True)
    r0 = []
    y0, aux0 = moe(xs, routes=r0, **kw)
    g0 = torch.autograd.grad((y0 * gy).sum() + aux0, [xs] + params)
    placed(model)
    params = [p for _, p in moe.named_parameters()]
    xd = batch_on(x).requires_grad_(True)
    r1, seen = [], []
    blocks = ctx.ExpertBlocks.dispatch

    def spy(self, xt, _f=blocks):
        buf = _f(self, xt)
        seen.append([list(buf.shape), list(buf.to_local().shape), str(buf.placements)])
        return buf

    ctx.ExpertBlocks.dispatch = spy
    with ctx.use_mesh_constraints(mesh) as mode, ctx.gathered_params(moe):
        y1, aux1 = moe(xd, routes=r1, **kw)
        g1 = torch.autograd.grad((y1 * batch_on(gy)).sum() + aux1, [xd] + params)
    ctx.ExpertBlocks.dispatch = blocks
    full = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
    errs = {"out": float((full(y1) - y0).abs().max()), "aux": abs(float(full(aux1)) - float(aux0))}
    for (pname, _), a, b in zip([("x", None)] + list(moe.named_parameters()), g1, g0):
        errs[f"grad {pname}"] = float((full(a) - b).abs().max())
    routes = all(torch.equal(full(a[k]), b[k]) for a, b in zip(r1, r0) for k in ("top_idx", "keep"))
    out[arch] = {"errs": errs, "routes": routes, "n_routes": len(r1), "buffers": seen,
                 "fallbacks": dict(mode.fallbacks), "layer": name}
# Adafactor (jamba's optimizer) on two of reduced jamba's stacked layers,
# the state placed by the reference's specs: a second step on the mesh vs none
from repro_torch import prng
from repro_torch.optim import get_optimizer
from repro_torch.sharding.rules import tree_param_specs, with_sharding
from repro_torch.tree import tree_map, tree_paths
model = Model(get_config("jamba-1.5-large-398b").reduced(), key=prng.PRNGKey(0), device="cpu")
opt = get_optimizer("adafactor")
gen = torch.Generator().manual_seed(2)
full = model.param_tree()["stack"]["cycle"]       # an M-D and an M-E layer, stacked
p0 = {"stack": {"cycle": {j: full[j] for j in ("0", "1")}}}
g = tree_map(lambda p: torch.randn(p.shape, generator=gen).to(p.dtype), p0)
p1, s1 = opt.update(g, opt.init(p0), p0, 0)
want, _ = opt.update(g, s1, p1, 1)
on = lambda t: with_sharding(t, tree_param_specs(t, mesh), mesh)
dp = on(p1)
with ctx.use_mesh_constraints(mesh) as mode:
    got, gs = opt.update(on(g), on(s1), dp, 1)
pairs = list(zip(tree_paths(got).values(), tree_paths(want).values(), tree_paths(dp).values()))
out["adafactor"] = {"err": max(float((a.full_tensor().float() - b.float()).abs().max())
                               for a, b, _ in pairs),
                    "moved": [str(a.placements) + " != " + str(c.placements)
                              for a, _, c in pairs if a.placements != c.placements],
                    "state_moved": sum(a.placements != b.placements for a, b in
                                       zip(tree_paths(gs).values(), tree_paths(on(s1)).values())),
                    "fallbacks": dict(mode.fallbacks), "leaves": len(pairs)}
np.savez(f"{d}/rank{rank}.npz", **arrays)
if rank == 0:
    print(json.dumps(out))
dist.destroy_process_group()
"""


def _reference(arch, d):
    """The reference's reduced init of ``arch`` saved for the children, its
    tokens, and ``jax.grad`` of its loss on them."""
    jcfg = jconfigs.get_config(arch).reduced()
    jm = JaxModel(jcfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    save_checkpoint(str(d / f"{arch}.npz"), params)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, S), dtype=np.int32)
    np.save(d / f"{arch}_tokens.npy", toks)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    return np.asarray(jax.grad(jm.loss_fn)(params, batch)["embed"])


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_blocks")
    ref = {arch: _reference(arch, d) for arch in EMBED_ARCHS}
    for arch in MOE_ARCHS:
        jcfg = jconfigs.get_config(arch).reduced()
        save_checkpoint(str(d / f"{arch}.npz"), jax.tree.map(
            np.asarray, JaxModel(jcfg).init(jax.random.PRNGKey(0))))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO_CHILD, str(r), str(d / "store"),
                               str(d), json.dumps(EMBED_ARCHS), json.dumps(MOE_ARCHS)],
                              env=env, cwd=str(ROOT), text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    got = json.loads(outs[0][0].strip().splitlines()[-1])
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]
    return got, ranks, ref


@pytest.mark.parametrize("arch", EMBED_ARCHS)
def test_each_rank_holds_its_block_of_the_embedding_gradient(gloo_runs, arch):
    """Each of the four ranks' block of the ``embed`` gradient (the
    vocabulary on ``model``, the features on ``data``: the parameter's
    placements) equals the matching block of ``jax.grad`` of the reference's
    loss within 1e-6; smollm-360m ties the LM head to the table, whose
    gradient adds into the same blocks. Nothing is replicated."""
    got, ranks, ref = gloo_runs
    for r in range(4):
        c = got[arch] if r == 0 else None
        block = ranks[r][f"{arch}_block"]
        if c is not None:
            assert c["placements"] == c["param"] == "(Shard(dim=1), Shard(dim=0))", c
            assert c["fallbacks"] == {}, c["fallbacks"]
        rows, cols = block.shape
        assert (rows, cols) == (ref[arch].shape[0] // 2, ref[arch].shape[1] // 2)
        # rank r = (data coordinate r // 2, model coordinate r % 2)
        r0, c0 = (r % 2) * rows, (r // 2) * cols
        np.testing.assert_allclose(block, ref[arch][r0:r0 + rows, c0:c0 + cols], atol=ATOL,
                                   err_msg=f"{arch} rank {r}")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_on_expert_blocks_matches_the_layer_without_a_mesh(gloo_runs, arch):
    """The first MoE layer of reduced ``arch`` on the 2 × 2 mesh (the buffer
    built on each rank's (group, expert) block, the combine read from the
    block holding each assignment, a partial sum over ``model``) against
    the same layer without a mesh, both with 2 dispatch groups: the output,
    the aux loss and every gradient within 1e-6, the routes bitwise, each
    rank's buffer ``(G/2, E/2, C, d)``, nothing replicated."""
    got, _, _ = gloo_runs
    c = got[arch]
    print(arch, c["layer"], c["errs"])
    assert c["fallbacks"] == {} and c["routes"] and c["n_routes"] == 1
    assert max(c["errs"].values()) <= ATOL, c["errs"]
    (whole, local, placements), = c["buffers"]
    assert local == [whole[0] // 2, whole[1] // 2] + whole[2:]
    assert placements == "(Shard(dim=0), Shard(dim=1))"


def test_adafactor_updates_each_parameter_in_its_own_layout(gloo_runs):
    """A second Adafactor step on reduced jamba's first two stacked layers
    (a Mamba mixer, an MLP, a MoE: the router and the experts) with the
    parameters, gradients and state placed by the reference's specs on the
    2 × 2 mesh: within 1e-6 of the step without a mesh, every new parameter
    in its parameter's placements and every new state leaf in its own (the
    factored statistics are combined in the layout the gradient's
    reductions give, ``ctx.placed_as``: mixing them with the state's left
    each version of DTensor to place the gradient-sized update, and one
    gathered it whole), nothing replicated."""
    got, _, _ = gloo_runs
    c = got["adafactor"]
    assert c["leaves"] > 10 and c["err"] <= ATOL, c
    assert c["moved"] == [] and c["state_moved"] == 0 and c["fallbacks"] == {}, c


_FAKE_CHILD = r"""
import json, math, torch
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun
from repro_torch.sharding import ctx
dryrun.join_fake_group(16)
mesh = DeviceMesh("cpu", torch.arange(16).view(4, 4), mesh_dim_names=("data", "model"))
out = {}
for arch in ("llama3-8b", "smollm-360m", "deepseek-v2-lite-16b", "qwen3-moe-30b-a3b"):
    cfg = get_config(arch).reduced()
    case, meta = dryrun.build_case(arch, InputShape("t", 32, 16, "train"), mesh, cfg=cfg)
    mode = dryrun.op_cost.CostMode()
    Vp, d = cfg.padded_vocab, cfg.d_model
    seen, blocks = [], ctx.ExpertBlocks.dispatch

    def spy(self, xt, _f=blocks):
        buf = _f(self, xt)
        seen.append([list(buf.shape), list(buf.to_local().shape)])
        return buf

    ctx.ExpertBlocks.dispatch = spy
    whole = math.inf
    if cfg.moe is not None:             # G = 4 groups of a microbatch's tokens
        m, ng = cfg.moe, 16 // meta["microbatches"] * 32 // 4
        whole = 4 * m.num_experts * max(1, round(m.capacity_factor * ng * m.top_k
                                                 / m.num_experts)) * d

    def keep(f, t, new):
        if t.dim() >= 2 and t.shape[0] == Vp and t.shape[-1] == d:
            return True
        # the whole buffer's elements as an activation: (G, rows, d) or (G, E, C, d)
        return new and t.dim() >= 3 and t.shape[-1] == d and t.numel() >= whole

    wide = dryrun.watch_outputs(mode, keep)
    case.run(mode, counted=False)
    ctx.ExpertBlocks.dispatch = blocks
    out[arch] = {"wide": [[op, list(s)] for op, s, *_ in wide], "buffers": seen, "whole": whole,
                 "fallbacks": dict(mode.fallbacks), "embed": str(case.model.embed.placements)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_runs():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", _FAKE_CHILD], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", EMBED_ARCHS)
def test_no_rank_holds_the_whole_embedding_gradient(fake_runs, arch):
    """A train step of reduced ``arch`` on a fake 4 × 4 group (meta shards):
    no op a rank runs, forward or backward, outputs a ``(Vp, d)`` tensor
    (DTensor's own rule made each rank's embedding gradient the whole
    table), and nothing is replicated."""
    c = fake_runs[arch]
    assert c["wide"] == [] and c["fallbacks"] == {}, c
    assert c["embed"] == "(Shard(dim=1), Shard(dim=0))"


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_each_rank_holds_its_block_of_the_moe_buffer(fake_runs, arch):
    """A train step of reduced ``arch`` on a fake 4 × 4 group: each of its
    dispatches (one a microbatch a MoE layer) holds the rank's ``(G/4, E/4,
    C, d)`` block of the ``(G, E, C, d)`` buffer, no op outputs a tensor of
    the whole buffer's size (the port built ``(G, E·C + Nk, d)`` whole), and
    nothing is replicated."""
    c = fake_runs[arch]
    assert c["buffers"] and c["fallbacks"] == {}, c
    for whole, local in c["buffers"]:
        assert local == [whole[0] // 4, whole[1] // 4] + whole[2:], (whole, local)
        assert math.prod(whole) == c["whole"]
    assert c["wide"] == [], c["wide"][:4]
