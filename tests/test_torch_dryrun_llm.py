"""The LLM dry run and the roofline's analysis half on the CPU, against the
reference (``repro.launch.dryrun``, ``repro.launch.roofline``), and the
trainer on a mesh.

* ``count_params``, ``active_params`` and ``model_flops_for`` equal for every
  arch at full width (the port's parameter tree on ``meta`` against
  ``jax.eval_shape`` of the reference's init), integers bitwise;
* ``apply_variant`` equal field by field for every variant; ``format_table``
  equal on the same rows;
* ``build_case`` on reduced configs over a fake 4 × 4 mesh (a process of
  its own): smollm-360m's train, prefill and decode, deepseek-v2-lite-16b's
  prefill and decode (its training step runs on the smoke mesh below); and
  the CLI's skip path;
* the LM loss on a fake 4 × 4 and 2 × 4 × 4 group: reduced qwen1.5-0.5b's
  train step holds no tensor as wide as the padded vocabulary, and adding
  the pod lowers a rank's peak;
* the CLI's ``--layers`` and ``--allocations`` on smollm-360m at full width,
  on both production meshes;
* ``train(mesh=make_smoke_mesh("cpu"))`` bitwise ``train(mesh=None)`` for a
  dense and an MoE reduced arch, and against the reference's
  ``train(mesh=make_smoke_mesh())`` from one step-0 checkpoint (PR 23's
  tolerance: losses rtol 1e-5).
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.launch import roofline as jrl
from repro.launch import train as jlm
from repro.models import Model as JaxModel
from repro_torch import configs
from repro_torch.launch import dryrun, roofline as rl
from repro_torch.launch import train as tlm
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import Model

ROOT = Path(__file__).resolve().parents[1]


def _reference_dryrun():
    """``repro.launch.dryrun``, imported with the environment as it was:
    the module sets ``XLA_FLAGS`` for 512 host devices when imported, which
    must reach no other test (jax here is already initialised)."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdryrun


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_counts_and_model_flops_equal_the_reference(arch):
    jcfg, tcfg = jconfigs.get_config(arch), configs.get_config(arch)
    jtree = jax.eval_shape(JaxModel(jcfg).init, jax.random.PRNGKey(0))
    ttree = Model(tcfg, device="meta").param_tree()
    assert rl.count_params(ttree) == jrl.count_params(jtree)
    assert rl.active_params(tcfg, ttree) == jrl.active_params(jcfg, jtree)
    for shape in configs.SHAPES.values():
        assert rl.model_flops_for(tcfg, ttree, shape) == jrl.model_flops_for(jcfg, jtree, shape)


VARIANTS = {
    "llama3-8b": ("no_remat", "remat_per_layer", "no_fsdp", "more_microbatch",
                  "less_microbatch"),
    "xlstm-1.3b": ("seq_mlstm", "no_slstm_segment", "mlstm_chunk_64"),
    "qwen3-moe-30b-a3b": ("ungrouped_moe", "capacity_2.0", "capacity_1.0"),
}


@pytest.mark.parametrize("arch", sorted(VARIANTS))
def test_apply_variant_equals_the_reference(arch):
    jdryrun = _reference_dryrun()
    for variant in VARIANTS[arch]:
        got = dryrun.apply_variant(configs.get_config(arch), variant, "train_4k")
        want = jdryrun.apply_variant(jconfigs.get_config(arch), variant, "train_4k")
        assert dataclasses.asdict(got) == dataclasses.asdict(want), variant
    for mod in (dryrun, jdryrun):
        with pytest.raises(ValueError):
            mod.apply_variant(configs.get_config(arch), "no_such_variant", "train_4k")


def test_format_table_equals_the_reference():
    rows = []
    for i, (arch, shape) in enumerate((("llama3-8b", "train_4k"),
                                       ("deepseek-v2-lite-16b", "decode_32k"))):
        cost = dataclasses.replace(
            __import__("repro_torch.launch.op_cost", fromlist=["Cost"]).Cost(),
            flops=3.1e15 * (i + 1), bytes=2.2e12 / (i + 1), peak_bytes=7.5e9 * (i + 2),
            coll_bytes={"all-gather": 1.5e11, "all-reduce": 2e10 * i},
            coll_counts={"all-gather": 100, "all-reduce": 7})
        rows.append(rl.analyze(arch, shape, cost, 256 * (i + 1), model_flops=1e18,
                               dtype="bfloat16").row())
    assert rl.format_table(rows) == jrl.format_table(rows)


_CASES_CHILD = r"""
import json, torch
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun
dryrun.join_fake_group(16)
mesh = DeviceMesh("cpu", torch.arange(16).view(4, 4), mesh_dim_names=("data", "model"))
out = {}
for arch, kinds in (("smollm-360m", ("train", "prefill", "decode")),
                    ("deepseek-v2-lite-16b", ("prefill", "decode"))):
    for kind, shape in (("train", InputShape("t", 32, 16, "train")),
                        ("prefill", InputShape("p", 32, 8, "prefill")),
                        ("decode", InputShape("d", 64, 8, "decode"))):
        if kind not in kinds:
            continue
        case, meta = dryrun.build_case(arch, shape, mesh, cfg=get_config(arch).reduced())
        mode = case.run()
        c = mode.cost
        out[f"{arch}/{kind}"] = {"flops": c.flops, "matmul": c.matmul_flops, "bytes": c.bytes,
                                 "peak": c.peak_bytes, "ops": c.ops,
                                 "colls": c.coll_counts, "fallbacks": mode.fallbacks,
                                 "kind": case.kind, "microbatches": meta.get("microbatches"),
                                 "local": list(next(case.model.parameters()).to_local().shape),
                                 "global": list(next(case.model.parameters()).shape)}
print(json.dumps(out))
"""


def test_build_case_traces_every_kind_on_a_fake_mesh():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", _CASES_CHILD], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert len(got) == 5
    for name, c in got.items():
        assert c["ops"] > 0 and c["matmul"] > 0 and c["flops"] >= c["matmul"], name
        assert c["bytes"] > 0 and c["peak"] > 0, name
        assert c["colls"].get("all-gather", 0) > 0, name       # the FSDP weight gathers
        assert name.split("/")[1] == c["kind"]
        # the embedding (V, d): V over model, d over data on 4 × 4
        assert c["local"] == [c["global"][0] // 4, c["global"][1] // 4], name
        # nothing replicated where no rule placed it (the microbatch split
        # is the port's own gather)
        assert c["fallbacks"] == {}, name
    assert got["smollm-360m/train"]["microbatches"] == 1


_LOSS_CHILD = r"""
import json, torch
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun
dryrun.join_fake_group(32)
cfg = get_config("qwen1.5-0.5b").reduced()
Vp = cfg.padded_vocab
out = {"vp": Vp}
for name, sizes, names in (("4x4", (4, 4), ("data", "model")),
                           ("2x4x4", (2, 4, 4), ("pod", "data", "model"))):
    mesh = DeviceMesh("cpu", torch.arange(16 * (len(sizes) - 1)).view(sizes),
                      mesh_dim_names=names)
    case, meta = dryrun.build_case("qwen1.5-0.5b", InputShape("t", 16, 32, "train"), mesh,
                                   cfg=cfg)
    mode = dryrun.op_cost.CostMode(pod_ranks=dryrun._pod_ranks(mesh))
    wide = dryrun.watch_outputs(mode, lambda f, t, new: t.dim() >= 2 and t.shape[-1] == Vp)
    case.run(mode)
    out[name] = {"peak": mode.cost.peak_bytes, "fallbacks": dict(mode.fallbacks),
                 "wide": [[op, list(shape)] for op, shape, *_ in wide], "reduce": mode.cost.coll_counts.get("all-reduce", 0)}
print(json.dumps(out))
"""


def test_the_lm_loss_keeps_the_vocabulary_sharded():
    """Reduced qwen1.5-0.5b (a padded vocabulary of 512 over d = 128) takes
    a train step on a fake 4 × 4 group and on 2 × 4 × 4 (a process of its
    own): no op output of a rank, collective or local, spans the whole
    padded vocabulary (DTensor's ``logsumexp`` gathered the logits, and its
    backward expanded a pod's batch), nothing is replicated, and the 2 × 4 ×
    4 rank's peak is at most the 4 × 4 rank's (half the batch a rank)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", _LOSS_CHILD], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["vp"] == 512
    for name in ("4x4", "2x4x4"):
        c = got[name]
        print(name, c["peak"], c["reduce"], c["wide"][:4])
        assert c["wide"] == [] and c["fallbacks"] == {}, name
        assert c["reduce"] > 0, name           # the loss's max, sum and pick
    assert got["2x4x4"]["peak"] <= got["4x4"]["peak"]


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_the_cli_cuts_layers_and_lists_allocations(tmp_path, multi_pod):
    """``--layers 1 --allocations 0.001`` on smollm-360m × ``decode_32k``
    at full width (a process of its own, a fake group of 256 or 512): the
    row says its cut and replicates nothing, and the listing names outputs
    of at least 1 MB (1e6 bytes) a rank, largest first, none past the live
    bytes counted after it."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = tmp_path / "rows.json"
    argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "smollm-360m",
            "--shape", "decode_32k", "--layers", "1", "--allocations", "0.001",
            "--json", str(out)] + (["--multi-pod"] if multi_pod else [])
    res = subprocess.run(argv, capture_output=True, text=True, env=env, cwd=str(ROOT),
                         timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    (row,) = json.loads(out.read_text())
    assert row["layers"] == 1 and row["fallbacks"] == {}
    assert row["chips"] == (512 if multi_pod else 256)
    assert ", 1 layers)" in res.stdout and "outputs of >= 0.001 GB a rank" in res.stdout
    listed = res.stdout.split("outputs of >= 0.001 GB a rank")[1].split("\n\n")[0]
    sizes = []
    for line in listed.splitlines()[1:]:
        gb, live = line.rsplit("(live ", 1)
        sizes.append(float(gb.split()[-1]))
        assert float(gb.split()[-1]) <= float(live.rstrip(")")) + 1e-9, line
    assert sizes and min(sizes) >= 0.001 and sizes == sorted(sizes, reverse=True), listed


def test_build_case_skips_where_the_reference_skips():
    jdryrun = _reference_dryrun()
    ok, why = jconfigs.supports_shape(jconfigs.get_config("seamless-m4t-large-v2"), "long_500k")
    assert not ok
    with pytest.raises(dryrun.SkipCase, match=why[:20]):
        dryrun.build_case("seamless-m4t-large-v2", "long_500k", None)
    assert issubclass(jdryrun.SkipCase, Exception)


def test_the_cli_prints_a_skipped_case_and_exits_0():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "seamless-m4t-large-v2", "--shape", "long_500k", "--multi-pod"],
                         capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "== seamless-m4t-large-v2 × long_500k: SKIP" in res.stdout


# --------------------------------------------------- the trainer on a mesh
@pytest.fixture
def group_of_one():
    """A gloo group of one for the smoke mesh, gone after the test."""
    assert not dist.is_initialized()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.usefixtures("group_of_one")
@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v2-lite-16b"])
def test_train_on_the_smoke_mesh_is_bitwise_the_run_without(arch):
    kw = dict(reduced=True, steps=2, batch=2, seq=16, lr=3e-3, ckpt_dir=None, ckpt_every=100,
              device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        plain_model, plain, _ = tlm.train(arch, **kw)
        model, losses, opt_state = tlm.train(arch, mesh=make_smoke_mesh("cpu"), **kw)
    assert losses == plain
    ours = dict(model.named_parameters())
    for name, p in plain_model.named_parameters():
        assert torch.equal(ours[name].full_tensor(), p), name
    from repro_torch.tree import tree_paths
    assert all(hasattr(v, "placements") for v in tree_paths(opt_state).values())


@pytest.mark.usefixtures("group_of_one")
def test_train_on_the_smoke_mesh_matches_the_reference(tmp_path):
    import jax as _jax

    from repro.checkpoint import save_checkpoint as jsave
    from repro.launch.mesh import make_smoke_mesh as jmake_smoke_mesh
    from repro.optim import get_optimizer as jget

    arch = "qwen1.5-0.5b"
    cfg = jconfigs.get_config(arch).reduced()
    params = JaxModel(cfg).init(_jax.random.PRNGKey(0))
    for pkg in ("repro", "port"):
        jsave(f"{tmp_path / pkg}/step_0.npz",
              {"params": params, "opt": jget(cfg.train_optimizer).init(params)}, step=0)
    kw = dict(reduced=True, steps=3, batch=2, seq=32, lr=3e-3, ckpt_every=100, resume=True)
    # make_smoke_mesh's 1 × 1 mesh with Auto axes: this jax's make_mesh
    # defaults to Explicit ones, under which the reference's constraints
    # are assertions its batches fail
    jmesh = _jax.make_mesh((1, 1), ("data", "model"),
                           axis_types=(_jax.sharding.AxisType.Auto,) * 2)
    assert jmesh.shape == jmake_smoke_mesh().shape
    # the reference's launcher enables its constraints without entering the
    # mesh, which this jax requires of a PartitionSpec constraint: the test
    # enters it
    with contextlib.redirect_stdout(io.StringIO()), _jax.set_mesh(jmesh):
        _, ref = jlm.train(arch, ckpt_dir=str(tmp_path / "repro"), mesh=jmesh, **kw)
    with contextlib.redirect_stdout(io.StringIO()):
        _, ours, _ = tlm.train(arch, ckpt_dir=str(tmp_path / "port"), device="cpu",
                               mesh=make_smoke_mesh("cpu"), **kw)
    np.testing.assert_allclose(ours, ref, rtol=1e-5)
