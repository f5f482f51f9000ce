"""``repro_torch.sharding`` (rules, ctx) against ``repro.sharding`` on the CPU.

* ``tests/test_infra.py``'s sharding cases, mirrored on the port;
* ``param_spec``/``tree_param_specs`` equal to the reference's spec for
  every leaf of every arch at full width — the port's ``param_tree`` on
  ``meta`` against ``jax.eval_shape`` of the reference's init, plus the
  ``adamw`` and ``adafactor`` states — on abstract meshes of 16 × 16 and
  2 × 16 × 16, with ``fsdp`` on and off; and ``Model.param_specs`` (a cycle
  layer's parameter: its stacked leaf's spec without the leading ``None``);
* ``cache_spec`` equal on every leaf of each arch's reference cache for
  ``decode_32k`` and ``long_500k``, and ``tree_cache_specs`` over the
  port's per-layer caches;
* ``to_placements``/``to_spec`` round trips;
* ``ctx`` on a fake 4 × 4 mesh (a process of its own): the placements each
  hook redistributes to equal the specs the reference's hooks pass to
  ``with_sharding_constraint`` (captured by patching it in this test only);
* ``ctx``'s rules on real values, four gloo processes on a 2 × 2 mesh: the
  LM loss on a vocabulary cut over ``model`` against the reference's
  ``lm_loss`` and its gradient, the pointwise operand rule's placements
  and values (a shard and a partial sum, the RMSNorm weight's product, the
  residual add), ops run on the blocks (a one-operand pointwise op, a pad,
  a scatter into a whole ``zeros``), and the split of queries whose heads
  ``model`` does not divide.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.models import Model as JaxModel
from repro.optim import get_optimizer as jget_optimizer
from repro.sharding import ctx as jctx
from repro.sharding import rules as jrules
from repro_torch import configs
from repro_torch.configs.registry import config_for_shape
from repro_torch.models import Model
from repro_torch.optim import get_optimizer
from repro_torch.sharding import rules
from repro_torch.sharding.rules import (
    abstract_mesh, cache_spec, data_spec, param_spec, to_placements, to_spec,
    tree_cache_specs, tree_param_specs)

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _ref_flat(spec_tree) -> dict:
    """The reference's spec tree → {path: spec as a tuple}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, P))
    return {jrules._path_names(path): tuple(s) for path, s in flat}


def _port_flat(spec_tree) -> dict:
    out = {}
    rules._map_with_path(lambda path, s: out.__setitem__(path, s), spec_tree)
    return out


# ------------------------------------------- tests/test_infra.py, mirrored
@pytest.fixture(scope="module")
def mesh16():
    return abstract_mesh((16, 16), ("data", "model"))


def test_param_spec_rules(mesh16):
    assert param_spec(("embed",), (128256, 4096), mesh16) == ("model", "data")
    assert param_spec(("stack", "cycle", "0", "attn", "wq"),
                      (32, 4096, 4096), mesh16) == (None, "data", "model")
    # non-divisible axes drop to replication: 15 heads → 960 still divides
    assert param_spec(("attn", "wq"), (960, 960), mesh16) == ("data", "model")
    # truly non-divisible: replicate that axis
    assert param_spec(("attn", "wk"), (960, 28 * 11), mesh16) == ("data", None)
    # expert params: expert-parallel
    assert param_spec(("ffn", "gate"), (128, 2048, 768), mesh16) == ("model", "data", None)
    # tiny 1-D params replicate
    assert param_spec(("norm",), (1024,), mesh16) == (None,)
    # optimizer state mirrors its parameter
    assert param_spec(("m", "stack", "cycle", "0", "ffn", "down"),
                      (32, 14336, 4096), mesh16) == (None, "model", "data")


def test_data_and_cache_specs(mesh16):
    assert data_spec((256, 4096), mesh16) == ("data", None)     # P(("data",), None)
    assert data_spec((1, 128), mesh16) == (None, None)   # batch 1: replicate
    # KV cache: batch over data, heads over model when divisible
    assert cache_spec((128, 32768, 16, 128), mesh16)[0] in ("data", ("data",))
    # batch-1 long-context cache: shard the sequence dim
    assert cache_spec((1, 524288, 8, 128), mesh16)[1] == "data"


def test_multipod_batch_axes():
    mesh = abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert data_spec((256, 4096), mesh) == (("pod", "data"), None)


# ------------------------------- every leaf of every arch, both packages
@pytest.fixture(scope="module")
def trees():
    """arch → (the reference's param/opt shape trees, the port's meta trees)."""
    return {}


def _trees(trees, arch):
    if arch not in trees:
        jcfg = jconfigs.get_config(arch)
        jparams = jax.eval_shape(JaxModel(jcfg).init, jax.random.PRNGKey(0))
        model = Model(configs.get_config(arch), device="meta")
        tparams = model.param_tree()
        ref = {"params": jparams}
        port = {"params": tparams}
        for name in ("adamw", "adafactor"):
            ref[name] = jax.eval_shape(jget_optimizer(name).init, jparams)
            port[name] = get_optimizer(name).init(tparams)
        trees[arch] = (ref, port, model)
    return trees[arch]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_equal_the_reference_for_every_leaf(trees, arch):
    ref, port, model = _trees(trees, arch)
    for mesh_name, (sizes, names) in MESHES.items():
        jmesh, tmesh = jrules.abstract_mesh(sizes, names), abstract_mesh(sizes, names)
        for fsdp in (True, False):
            for tree in ("params", "adamw", "adafactor"):
                want = _ref_flat(jrules.tree_param_specs(ref[tree], jmesh, fsdp=fsdp))
                got = _port_flat(tree_param_specs(port[tree], tmesh, fsdp=fsdp))
                assert got == want, (arch, mesh_name, fsdp, tree)
            # each parameter of the port's modules: its tree leaf's spec,
            # a cycle layer's without the stacked dim
            flat = _port_flat(tree_param_specs(port["params"], tmesh, fsdp=fsdp))
            per_param = model.param_specs(tmesh, fsdp)
            for name, path in model.param_paths().items():
                want = flat[path][1:] if "cycle" in path else flat[path]
                assert per_param[name] == want, (arch, name)


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
def test_cache_specs_equal_the_reference(shape_name):
    shape = configs.SHAPES[shape_name]
    for arch in configs.ARCH_IDS:
        ok, _ = jconfigs.supports_shape(jconfigs.get_config(arch), shape_name)
        if not ok:
            continue
        jcfg = jconfigs.config_for_shape(jconfigs.get_config(arch), shape_name)
        jm = JaxModel(jcfg)
        enc = shape.seq_len if jcfg.encoder_layers else None
        L = jm.decode_cache_len(shape)
        jcache = jax.eval_shape(lambda: jm.init_cache(shape.global_batch, L, enc_len=enc))
        tcfg = config_for_shape(configs.get_config(arch), shape_name)
        tcache = Model(tcfg, device="meta").init_cache(shape.global_batch, L, enc_len=enc)
        for sizes, names in MESHES.values():
            jmesh, tmesh = jrules.abstract_mesh(sizes, names), abstract_mesh(sizes, names)
            want = _ref_flat(jrules.tree_cache_specs(jcache, jmesh))
            # the same function on the same (stacked) shapes
            for path, leaf in jax.tree_util.tree_flatten_with_path(jcache)[0]:
                assert cache_spec(tuple(leaf.shape), tmesh) == \
                    want[jrules._path_names(path)], (arch, path)
            # the port's caches are per layer: each its own shape's spec
            for layer in tree_cache_specs(tcache, tmesh):
                for k, spec in layer.items():
                    assert isinstance(spec, tuple)
            for spec_layer, cache_layer in zip(tree_cache_specs(tcache, tmesh), tcache):
                for k, t in cache_layer.items():
                    assert spec_layer[k] == jrules.cache_spec(tuple(t.shape), jmesh)


# ------------------------------------------------------ placements ↔ specs
def _device_mesh(shape, names):
    """A DeviceMesh object with no process group: enough for placements."""
    return SimpleNamespace(mesh_dim_names=names, mesh=torch.zeros(shape))


@pytest.mark.parametrize("spec,shape", [
    ((("pod", "data"), None), (2, 4, 4)),
    (("model", "data"), (2, 4, 4)),
    ((None, "data", "model"), (2, 4, 4)),
    ((None, None), (2, 4, 4)),
    ((), (2, 4, 4)),
    ((("data",), None), (4, 4)),
    (("model", None, "data"), (4, 4)),
])
def test_to_placements_round_trips(spec, shape):
    from torch.distributed.tensor import Replicate, Shard

    names = ("pod", "data", "model")[-len(shape):]
    mesh = _device_mesh(shape, names)
    pl = to_placements(spec, mesh)
    assert len(pl) == len(names)
    for name, p in zip(names, pl):
        dims = [i for i, e in enumerate(spec)
                if e is not None and name in (e if isinstance(e, tuple) else (e,))]
        assert p == (Shard(dims[0]) if dims else Replicate())
    want = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)
    assert to_spec(pl, mesh, len(spec)) == want
    assert to_placements(want, mesh) == pl
    assert to_placements(to_spec(pl, mesh, len(spec)), mesh) == pl


def test_to_placements_refuses_axes_out_of_order():
    with pytest.raises(ValueError):
        to_placements((("data", "pod"),), _device_mesh((2, 4, 4), ("pod", "data", "model")))


# ------------------------------------------------ ctx on a fake 4 × 4 mesh
CTX_CASES = [
    ("shard_batch", (8, 32, 64), {}),
    ("shard_batch", (6, 32, 64), {}),
    ("shard_batch", (8, 32, 512), {"model_dim": -1}),
    ("shard_batch", (2, 32, 6), {"model_dim": -1}),
    ("shard_experts", (8, 16, 4), {}),
    ("shard_experts", (6, 16, 4), {}),
    ("shard_seq", (2, 64, 4), {}),
    ("shard_seq", (2, 6, 4), {}),
    ("shard_group_experts", (4, 8, 3, 16), {}),
    ("shard_group_experts", (3, 8, 3, 16), {}),
]
CTX_MESHES = {"4x4": ((4, 4), ("data", "model")),
              "2x2x4": ((2, 2, 4), ("pod", "data", "model"))}

_CTX_CHILD = r"""
import json, sys, torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.sharding import ctx
from repro_torch.sharding.rules import to_spec
cases, meshes = json.loads(sys.argv[1]), json.loads(sys.argv[2])
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
out = {}
for mname, (sizes, names) in meshes.items():
    mesh = DeviceMesh("cpu", torch.arange(16).view(sizes), mesh_dim_names=tuple(names))
    rows = []
    with ctx.use_mesh_constraints(mesh):
        counts = [ctx.batch_shard_count(), ctx.data_axis_size(), ctx.enabled()]
        for fn, shape, kw in cases:
            x = DTensor.from_local(torch.zeros(shape), mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
            y = getattr(ctx, fn)(x, **kw)
            rows.append([list(y.shape), [list(e) if isinstance(e, tuple) else e
                                         for e in to_spec(y.placements, mesh, len(shape))]])
        plain = ctx.shard_batch(torch.zeros(8, 4))
        rows.append(type(plain).__name__)
    counts.append(ctx.enabled())
    out[mname] = {"rows": rows, "counts": counts}
# views DTensor versions may refuse, done on the blocks: rank 0's block of
# the view is the view's block of the whole tensor under the placements made
from torch.distributed.tensor import Shard, distribute_tensor
from torch.distributed.tensor.placement_types import _StridedShard
mesh = DeviceMesh("cpu", torch.arange(16).view(4, 4), mesh_dim_names=("data", "model"))
views = []
for shape, pl, new in (((64, 12), [Shard(0), Replicate()], (8, 8, 12)),
                       ((8, 2, 96), [Shard(0), Shard(2)], (8, 2, 8, 12)),
                       ((8, 2, 8, 12), [Shard(0), Shard(2)], (8, 2, 96)),
                       ((8, 1, 32), [Replicate(), Shard(2)], (8, 32)),
                       ((8, 2, 12), [Replicate(), Shard(2)], (8, 2, 2, 6)),
                       ((8, 6), [Shard(1), Replicate()], (48,)),
                       # deepseek's MLA einsums: (batch, heads) flattened for the
                       # batched matmul, the batch on data (2 a rank), a head a
                       # rank on model; then split back
                       ((8, 4, 6, 5, 1), [Shard(0), Shard(1)], (32, 6, 5)),
                       ((32, 6, 5), [Shard(0), _StridedShard(0, split_factor=2)],
                        (8, 4, 6, 5, 1)),
                       # llama3's grouped key/value gradients: (batch, sequence)
                       # flattened with the sequence sharded on model; split back
                       ((8, 16, 24), [Shard(0), Shard(1)], (128, 24)),
                       ((128, 24), [Shard(0), _StridedShard(0, split_factor=2)],
                        (8, 16, 24)),
                       # a split of a sharded dim whose first output dim divides
                       ((32, 24), [Shard(0), Shard(1)], (32, 4, 6))):
    g = torch.arange(float(torch.Size(shape).numel())).view(shape)
    t = distribute_tensor(g, mesh, pl, src_data_rank=None)
    v = ctx._block_view(t, new)
    if v is None:
        views.append(None)
        continue
    want = distribute_tensor(g.view(new), mesh, v.placements, src_data_rank=None).to_local()
    views.append([str(v.placements), list(v.shape), bool(torch.equal(v.to_local(), want))])
out["views"] = views
print(json.dumps(out))
"""


def _norm(spec):
    """A spec with one-name tuples unwrapped (``("data",)`` ≡ ``"data"``)."""
    return tuple(e[0] if isinstance(e, (tuple, list)) and len(e) == 1 else
                 tuple(e) if isinstance(e, list) else e for e in spec)


def test_ctx_redistributes_to_the_reference_specs(monkeypatch):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", _CTX_CHILD, json.dumps(CTX_CASES),
                          json.dumps(CTX_MESHES)], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    captured = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: captured.append(tuple(spec)) or x)
    for mname, (sizes, names) in CTX_MESHES.items():
        jctx.enable(SimpleNamespace(axis_names=names, devices=np.empty(sizes)))
        try:
            counts = [jctx.batch_shard_count(), jctx.data_axis_size(), jctx.enabled()]
            for (fn, shape, kw), (gshape, gspec) in zip(CTX_CASES, got[mname]["rows"]):
                captured.clear()
                getattr(jctx, fn)(jnp.zeros(shape), **kw)
                want = captured[0] if captured else (None,) * len(shape)
                assert gshape == list(shape)
                assert _norm(gspec) == _norm(want), (mname, fn, shape, kw)
        finally:
            jctx.disable()
        assert got[mname]["counts"] == counts + [False]
        assert got[mname]["rows"][-1] == "Tensor"      # a plain tensor passes as it is
    views = got["views"]
    for v in views[:4]:
        assert v is not None and v[2], v       # block views, rank 0's block right
    assert views[0][1] == [8, 8, 12] and "Shard(dim=0)" in views[0][0]
    assert views[1][0].count("Shard(dim=2)") == 1
    assert views[4] is None            # 12 = 2 x 6 over 4 ways: not a block of the 2
    for v in views[5:]:
        assert v is not None and v[2], v       # strided or split blocks, rank 0's right
    assert views[5][0] == "(_StridedShard(dim=0, sf=8), Replicate())"   # 6 over 4: uneven
    assert views[6][0] == "(Shard(dim=0), _StridedShard(dim=0, sf=2))"
    assert views[7][0] == "(Shard(dim=0), Shard(dim=1))" and views[7][1] == [8, 4, 6, 5, 1]
    assert views[8][0] == "(Shard(dim=0), _StridedShard(dim=0, sf=2))"
    assert views[9][0] == "(Shard(dim=0), Shard(dim=1))"
    assert views[10][0] == "(Shard(dim=0), Shard(dim=1))"


_INDEX_PUT_CHILD = r"""
import json, torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.models.moe import MoE
from repro_torch.sharding import ctx
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
mesh = DeviceMesh("cpu", torch.arange(16).view(4, 4), mesh_dim_names=("data", "model"))
cfg = get_config("deepseek-v2-lite-16b").reduced()
m = cfg.moe
moe = MoE(prng.PRNGKey(0), cfg.d_model, m.d_ff_expert, m.num_experts, m.top_k, torch.float32,
          num_shared=m.num_shared)
gen = torch.Generator().manual_seed(0)
ruled = []
rule = ctx._port_indexing


def counted(func, args, kwargs):
    out = rule(func, args, kwargs)
    if func is not torch.ops.aten.index.Tensor:
        ruled.append([out is not None, [a is None for a in args[1]]])
    return out


ctx._port_indexing = counted
# the MoE's forward and backward, DTensor end to end
x = torch.randn(8, 16, cfg.d_model, generator=gen)
xd = distribute_tensor(x, mesh, [Shard(0), Replicate()]).requires_grad_(True)
with ctx.use_mesh_constraints(mesh) as mode:
    out, aux = moe(xd)
    torch.autograd.grad(out.sum() + aux, xd)
moe_fallbacks = dict(mode.fallbacks)
# its dispatch's gather of each assignment's token, xt[:, tok] (G = 4 groups
# of 32 tokens), and the gather's backward, the index_put with a None index:
# real values, rank 0's blocks against the same computation without a mesh
tok = torch.arange(32).repeat_interleave(m.top_k)
xt = torch.randn(4, 32, cfg.d_model, generator=gen)
gv = torch.randn(4, 32 * m.top_k, cfg.d_model, generator=gen)
xp = xt.clone().requires_grad_(True)
(gp,) = torch.autograd.grad(xp[:, tok], xp, gv)
xtd = distribute_tensor(xt, mesh, [Shard(0), Replicate()]).requires_grad_(True)
with ctx.use_mesh_constraints(mesh) as mode:
    vd = xtd[:, tok]
    (gd,) = torch.autograd.grad(vd, xtd, distribute_tensor(gv, mesh, vd.placements))
want_v = distribute_tensor(xt[:, tok], mesh, vd.placements).to_local()
want_g = distribute_tensor(gp, mesh, gd.placements).to_local()
print(json.dumps({"moe_fallbacks": moe_fallbacks, "gather_fallbacks": dict(mode.fallbacks),
                  "ruled": ruled, "grad": str(gd.placements),
                  "vals_ok": bool(torch.equal(vd.to_local(), want_v)),
                  "grad_ok": bool(torch.equal(gd.to_local(), want_g))}))
"""


def test_moe_index_put_runs_on_the_blocks():
    """The ``index_put`` with a ``None`` index (the backward of the MoE
    dispatch's ``xt[:, tok]``) on a fake 4 x 4 group: reduced deepseek's
    MoE forward and backward replicate nothing (under a mesh they run on
    each rank's expert blocks, ``ctx.ExpertBlocks``, whose gather of the
    tokens is local and reaches no DTensor ``index_put``), the port's rule
    places every such ``index_put``, and on real values rank 0's block of
    the gathered assignments and of their gradient is that block of the
    same computation without a mesh, the gradient sharded over the
    groups."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", _INDEX_PUT_CHILD], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["moe_fallbacks"] == {} and got["gather_fallbacks"] == {}
    none_index = [placed for placed, nones in got["ruled"] if nones[0]]
    assert len(none_index) == 1 and all(none_index), got["ruled"]   # the gather's
    assert got["vals_ok"] and got["grad_ok"], got
    assert got["grad"] == "(Shard(dim=0), Replicate())"


def test_ctx_is_the_identity_when_disabled():
    from repro_torch.sharding import ctx

    x = torch.zeros(8, 4)
    assert not ctx.enabled()
    for fn in (ctx.shard_batch, ctx.shard_experts, ctx.shard_seq, ctx.shard_group_experts):
        assert fn(x) is x
    assert ctx.shard_head_proj(x, 3) is x and ctx.shard_o_proj(x, 3) is x
    assert ctx.split_microbatches(x, 2).shape == (2, 4, 4)


# ------------------------------------------ ctx's rules on real values (gloo)
_GLOO_CHILD = r"""
import json, sys, numpy as np, torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from repro_torch.models.layers import lm_loss
from repro_torch.sharding import ctx
rank, store, npz = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank, world_size=4)
mesh = DeviceMesh("cpu", torch.arange(4).view(2, 2), mesh_dim_names=("data", "model"))
c = mesh.get_coordinate()
gen = torch.Generator().manual_seed(0)
aten = torch.ops.aten
out = {}
# the LM loss, the vocabulary cut over model
logits = torch.randn(4, 6, 32, generator=gen) * 3
labels = torch.randint(0, 32, (4, 6), generator=gen)
mask = (torch.rand(4, 6, generator=gen) > 0.2).float()
ld = distribute_tensor(logits, mesh, [Shard(0), Shard(2)]).requires_grad_(True)
with ctx.use_mesh_constraints(mesh) as mode:
    loss = lm_loss(ld, distribute_tensor(labels, mesh, [Shard(0), Replicate()]),
                   distribute_tensor(mask, mesh, [Shard(0), Replicate()]))
    (g,) = torch.autograd.grad(loss, ld)
out["loss"] = [str(g.placements), dict(mode.fallbacks)]
arrays = dict(logits=logits.numpy(), labels=labels.numpy(), mask=mask.numpy(),
              loss=np.float32(loss.full_tensor().detach()), grad=g.full_tensor().detach().numpy())


def partial(whole, k):      # model rank k of 2: half the value and a share of a zero sum
    noise = torch.randn(whole.shape, generator=torch.Generator().manual_seed(7))
    return whole / 2 + (k - 0.5) * noise


def cut(t, d):              # this data rank's half of dim d
    return t.chunk(2, d)[c[0]].contiguous()


cases = {}
# a shard and a partial sum: jamba's two kinds of S(1) + P add
a, b = torch.randn(2, 8, 4, generator=gen), torch.randn(2, 8, 4, generator=gen)
cases["shard_and_partial"] = (distribute_tensor(a, mesh, [Shard(1), Shard(2)]),
                              DTensor.from_local(partial(b, c[1]), mesh, [Replicate(), Partial()]),
                              a + b)
a, b = torch.randn(2, 8, generator=gen), torch.randn(2, 8, generator=gen)
cases["partial_and_nested_shard"] = (
    DTensor.from_local(cut(partial(a, c[1]), 1), mesh, [Shard(1), Partial()], shape=a.shape,
                       stride=a.stride()),
    distribute_tensor(b, mesh, [Replicate(), Shard(1)]), a + b)
# the RMSNorm weight's product and the residual add
x, w = torch.randn(4, 6, 8, generator=gen), torch.randn(8, generator=gen)
cases["norm_weight"] = (distribute_tensor(x, mesh, [Shard(0), Replicate()]),
                        distribute_tensor(w, mesh, [Replicate(), Shard(0)]), x * w)
y = torch.randn(4, 6, 8, generator=gen)
cases["residual"] = (distribute_tensor(x, mesh, [Shard(0), Replicate()]),
                     DTensor.from_local(cut(partial(y, c[1]), 0), mesh, [Shard(0), Partial()],
                                        shape=y.shape, stride=y.stride()), x + y)
for name, (p, q, want) in cases.items():
    mul = name == "norm_weight"
    with ctx.use_mesh_constraints(mesh) as mode:
        pp, qq = ctx._pointwise_operands(aten.mul.Tensor if mul else aten.add.Tensor, (p, q), {})
        r = p * q if mul else p + q
    out[name] = [str(pp.placements), str(qq.placements), str(r.placements),
                 float((r.full_tensor() - want).abs().max()), dict(mode.fallbacks)]
# ops the port runs on the blocks: a pointwise op 2.11 decomposes, the
# Mamba convolution's causal pad, the sort backward's scatter into a whole zeros
x = torch.randn(4, 6, 8, generator=gen)
idx = torch.argsort(torch.randn(4, 6, 8, generator=gen), dim=-1)
blocks = {"softplus": (lambda t: torch.nn.functional.softplus(t),
                       [distribute_tensor(x, mesh, [Shard(0), Shard(2)])]),
          "pad": (lambda t: torch.nn.functional.pad(t, (0, 0, 3, 0)),
                  [distribute_tensor(x, mesh, [Shard(0), Shard(2)])]),
          "cummax": (lambda t: torch.cummax(t, dim=1).values,
                     [distribute_tensor(x, mesh, [Shard(0), Shard(2)])]),
          "scatter": (lambda z, i, v: z.scatter(-1, i, v),
                      [torch.zeros(4, 6, 8), distribute_tensor(idx, mesh, [Shard(0), Shard(1)]),
                       distribute_tensor(x, mesh, [Shard(0), Shard(1)])])}
for name, (fn, operands) in blocks.items():
    with ctx.use_mesh_constraints(mesh) as mode:
        r = fn(*operands)
    want = fn(*[t.full_tensor() if isinstance(t, DTensor) else t for t in operands])
    out[name] = [str(r.placements), float((r.full_tensor() - want).abs().max()),
                 dict(mode.fallbacks)]
# queries whose heads model does not divide: 3 heads of 4 over 2 ranks
q = torch.randn(4, 6, 12, generator=gen)
with ctx.use_mesh_constraints(mesh) as mode:
    qd = ctx.shard_head_proj(distribute_tensor(q, mesh, [Shard(0), Shard(2)]), 3, True)
    v = qd.reshape(4, 6, 3, 4)
want = distribute_tensor(q.view(4, 6, 3, 4), mesh, v.placements).to_local()
out["query_heads"] = [str(qd.placements), str(v.placements),
                      bool(torch.equal(v.to_local(), want)), dict(mode.fallbacks)]
if rank == 0:
    np.savez(npz, **arrays)
    print(json.dumps(out))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def gloo_blocks(tmp_path_factory):
    """Rank 0's results and arrays of :data:`_GLOO_CHILD` on four gloo
    processes (a 2 × 2 ``("data", "model")`` mesh, a ``FileStore``)."""
    d = tmp_path_factory.mktemp("gloo_blocks")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO_CHILD, str(r), str(d / "store"),
                               str(d / "out.npz")], env=env, cwd=str(ROOT), text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(4)]
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
    return json.loads(outs[0][0].strip().splitlines()[-1]), dict(np.load(d / "out.npz"))


def test_lm_loss_on_a_vocabulary_cut_matches_the_reference(gloo_blocks):
    """``lm_loss`` on logits whose vocabulary is cut over ``model``
    (``ctx.vocab_parallel_ll``: each rank's block, the max, the sum and the
    picked logit all-reduced) against the reference's ``lm_loss`` and its
    ``jax.grad`` on the same values; the gradient keeps the vocabulary
    sharded and nothing is replicated."""
    from repro.models.layers import lm_loss as jlm_loss

    got, arr = gloo_blocks
    placements, fallbacks = got["loss"]
    assert placements == "(Shard(dim=0), Shard(dim=2))" and fallbacks == {}
    args = (jnp.asarray(arr["labels"]), jnp.asarray(arr["mask"]))
    want, grad = jax.value_and_grad(lambda lg: jlm_loss(lg, *args))(jnp.asarray(arr["logits"]))
    np.testing.assert_allclose(arr["loss"], np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(arr["grad"], np.asarray(grad), atol=1e-6)


POINTWISE_CASES = {
    # name: (operands after the rule, the output)
    "shard_and_partial": ("(Shard(dim=1), Shard(dim=2))",) * 3,
    "partial_and_nested_shard": ("(Shard(dim=1), Shard(dim=1))",) * 3,
    "norm_weight": ("(Shard(dim=0), Replicate())", "(Replicate(), Replicate())",
                    "(Shard(dim=0), Replicate())"),
    "residual": ("(Shard(dim=0), Replicate())",) * 3,
}


@pytest.mark.parametrize("case", sorted(POINTWISE_CASES))
def test_pointwise_operands_are_placed_alike_on_every_version(gloo_blocks, case):
    """``ctx._pointwise_operands`` on a 2 × 2 mesh, real values: a shard
    and a partial sum (jamba's ``S(1) + P`` adds, which DTensor 2.11
    replicates) reduce-scatter the partial sum to the shard's dim; the
    RMSNorm weight, sharded on ``model``, is gathered beside the whole
    activation (2.13 cut the activation); the residual add of a whole
    operand and a partial sum reduces the partial sum (2.13 kept it). The
    op then runs on those placements, its gathered result within 1e-6 of
    the same op without a mesh, nothing replicated."""
    got, _ = gloo_blocks
    p, q, out, err, fallbacks = got[case]
    assert (p, q, out) == POINTWISE_CASES[case]
    assert err <= 1e-6 and fallbacks == {}


BLOCK_CASES = {"softplus": "(Shard(dim=0), Shard(dim=2))",
               "cummax": "(Shard(dim=0), Shard(dim=2))",
               "pad": "(Shard(dim=0), Shard(dim=2))",
               "scatter": "(Shard(dim=0), Shard(dim=1))"}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_ops_run_on_the_blocks_on_every_version(gloo_blocks, case):
    """Ops the port runs on each rank's blocks on a 2 × 2 mesh, real
    values, within 1e-6 of the op without a mesh (a vectorised ``softplus``
    may round a block's tail otherwise), placed as their sharded operand
    and nothing replicated: a pointwise op of one operand (``softplus``,
    which DTensor 2.11 runs as its decomposition), a scan along an unsharded
    dim (``cummax``: 2.11 has no rule), ``constant_pad_nd`` on an
    unsharded dim (2.11 has no rule: jamba's causal convolution gathered
    its activation) and ``scatter`` into a plain whole ``zeros`` (2.11's
    ``sort`` backward; its DTensor gathers all three operands)."""
    got, _ = gloo_blocks
    placements, err, fallbacks = got[case]
    assert placements == BLOCK_CASES[case] and err <= 1e-6 and fallbacks == {}


def test_uneven_query_heads_split_on_the_blocks(gloo_blocks):
    """Queries of 3 heads of 4 (12 features over a ``model`` axis of 2: 6 a
    rank, a head and a half): ``ctx.shard_head_proj`` places the positions
    over ``model``, the split into heads is a view of each rank's block,
    rank 0's block equal to ``distribute_tensor`` of the whole split, and
    nothing is replicated."""
    got, _ = gloo_blocks
    proj, split, equal, fallbacks = got["query_heads"]
    assert proj == split == "(Shard(dim=0), Shard(dim=1))"
    assert equal and fallbacks == {}
