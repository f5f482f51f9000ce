"""Multi-process training on the CPU: gloo groups of 2 and 3 processes,
spawned with a file store under ``tmp_path`` and each joined with a time
limit, against the one-process run (the port's counterpart of
``tests/test_multihost.py``, whose cases are mirrored here too).

* Each rank trains its ``HostShardPlan`` block of 6 workers with no
  collective; its per-worker tables and chunk losses are bitwise the
  one-process ``train_submodels``' (``sparse``, ``fused`` — the kernels'
  plain versions — and ``rowgrad``), and after the merge phase's gathers
  every rank holds all sub-models, the epoch losses and the merged tables
  of the one-process run, bitwise.
* ``train_sgns --processes 2`` (two ranks, ``REPRO_TORCH_INIT_METHOD`` a
  file store) saves the one-process CLI's merged table bitwise, from rank
  0 alone; the JAX package's CLI on the same arguments (one process)
  agrees within the launchers' merge tolerance.
* The plan, the trainer's ``plan``, ``device_chunk``/``device_table`` and
  the driver's refusals, as the reference's multihost tests check them.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jload_checkpoint
from repro.launch import train_sgns as jtrain
from repro_torch.checkpoint import load_checkpoint
from repro_torch.core.async_trainer import AsyncShardTrainer
from repro_torch.core.driver import apply_merges, gather_submodels, train_submodels
from repro_torch.core.sgns import SGNSConfig, worker_mean
from repro_torch.data.corpus import SemanticCorpusModel
from repro_torch.data.pipeline import HostShardPlan
from repro_torch.launch.mesh import assemble_worker_array, multihost_train_kwargs, world

SRC = str(Path(__file__).resolve().parents[1] / "src")
W = 6
TIMEOUT_S = 120
KW = dict(num_workers=W, epochs=2, batch_size=64, window=3, max_vocab=None,
          base_min_count=2, max_steps_per_epoch=8, steps_per_chunk=4)
RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch.distributed as dist
    from repro_torch.core.driver import apply_merges, train_submodels
    from repro_torch.core.sgns import SGNSConfig
    from repro_torch.data.corpus import SemanticCorpusModel
    from repro_torch.launch.mesh import make_worker_group
    rank, size, store, out, engine, strategy = sys.argv[1:7]
    rank, size = int(rank), int(size)
    corpus = SemanticCorpusModel.create(vocab_size=300, seed=0).generate(num_sentences=1200, seed=1)
    group = make_worker_group(size, rank, device="cpu", store=dist.FileStore(store, size))
    res = train_submodels(corpus, 300, strategy, cfg=SGNSConfig(vocab_size=0, dim=16, window=3,
                          negatives=2), engine=engine, device="cpu", process_index=rank,
                          process_count=size, group=group, **KW)
    local = dict(W=res.stacked.models.numpy(), L=np.concatenate(res.chunk_losses, 1),
                 start=res.plan.start)
    res = apply_merges(res, ("concat", "alir_pca"), out_dim=16)
    np.savez(out, **local, gathered=res.stacked.models.numpy(),
             gathered_L=np.concatenate(res.chunk_losses, 1), losses=np.array(res.losses),
             **{"merged_" + k: v[0] for k, v in res.merged.items()})
""").replace("**KW", "**" + repr(KW))


def _spawn(argvs, env=None):
    """Start every rank (``argvs``: one argument list a process) at once;
    join each with a time limit; return their outputs."""
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1", **(env or {})}
    procs = [subprocess.Popen([sys.executable, *argv], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for argv in argvs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, text in zip(procs, outs):
        assert p.returncode == 0, text[-3000:]
    return outs


@pytest.fixture(scope="module")
def corpus():
    return SemanticCorpusModel.create(vocab_size=300, seed=0).generate(num_sentences=1200,
                                                                       seed=1)


@pytest.mark.parametrize("engine,strategy", [("sparse", "shuffle"), ("fused", "random"),
                                             ("rowgrad", "equal")])
def test_gloo_ranks_are_bitwise_the_one_process_run(corpus, tmp_path, engine, strategy):
    one = train_submodels(corpus, 300, strategy, cfg=SGNSConfig(vocab_size=0, dim=16, window=3,
                          negatives=2), engine=engine, device="cpu", **KW)
    W1 = one.stacked.models.numpy().copy()
    L1 = np.concatenate(one.chunk_losses, 1)
    one = apply_merges(one, ("concat", "alir_pca"), out_dim=16)
    runs = {size: [str(tmp_path / f"p{size}_r{r}.npz") for r in range(size)]
            for size in (2, 3)}
    # both groups at once, each through its own store
    _spawn([["-c", RANK, str(r), str(size), str(tmp_path / f"store{size}"), runs[size][r],
             engine, strategy] for size in runs for r in range(size)])
    for size, paths in runs.items():
        for r, path in enumerate(paths):
            got = np.load(path)
            plan = HostShardPlan(r, size, W)
            assert int(got["start"]) == plan.start
            np.testing.assert_array_equal(got["W"], W1[plan.start:plan.stop])
            np.testing.assert_array_equal(got["L"], L1[plan.start:plan.stop])
            np.testing.assert_array_equal(got["gathered"], W1)
            np.testing.assert_array_equal(got["gathered_L"], L1)
            assert list(got["losses"]) == one.losses
            for m in ("concat", "alir_pca"):
                np.testing.assert_array_equal(got["merged_" + m], one.merged[m][0])


def test_train_sgns_processes_two(tmp_path):
    """Two ranks of the CLI save the one-process CLI's merged table bitwise
    (rank 0 alone saves), and the JAX package's one-process CLI on the same
    arguments agrees within the launchers' merge tolerance."""
    from repro_torch.launch import train_sgns as ttrain

    args = ["--engine", "sparse", "--strategy", "random", "--workers", "2", "--epochs", "1",
            "--dim", "16", "--vocab", "400", "--sentences", "3000", "--merge", "concat"]
    one = tmp_path / "one.npz"
    ttrain.main(args + ["--device", "cpu", "--save", str(one)])
    ref = tmp_path / "ref.npz"
    jtrain.main(args + ["--save", str(ref)])
    saves = [tmp_path / f"rank{r}.npz" for r in range(2)]
    outs = _spawn([["-m", "repro_torch.launch.train_sgns", *args, "--device", "cpu",
                    "--processes", "2", "--process-index", str(r), "--save", str(saves[r])]
                   for r in range(2)],
                  env={"REPRO_TORCH_INIT_METHOD": f"file://{tmp_path / 'store'}"})
    assert "ingestion: host 0/2: workers [0, 1)" in outs[0]
    assert "ingestion: host 1/2: workers [1, 2)" in outs[1]
    assert all("vmem: sparse:cdf" in o for o in outs)
    assert saves[0].exists() and not saves[1].exists()
    got, meta = load_checkpoint(str(saves[0]))
    want, _ = load_checkpoint(str(one))
    for k in ("embedding", "valid", "word_ids"):
        np.testing.assert_array_equal(got[k], want[k])
    jwant, _ = jload_checkpoint(str(ref))
    np.testing.assert_array_equal(got["valid"], jwant["valid"])
    u, _, vt = np.linalg.svd(got["embedding"].T @ jwant["embedding"])
    assert float(np.abs(got["embedding"] @ (u @ vt) - jwant["embedding"]).max()) < 1e-4


def test_a_group_that_cannot_form_raises(tmp_path, monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("REPRO_TORCH_INIT_METHOD", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        multihost_train_kwargs(4, 2, process_index=0, device="cpu")
    assert multihost_train_kwargs(4, None) == (1, {})


# ------------------------------------------------ the reference's multihost cases
@pytest.mark.parametrize("process_count", (1, 2, 3, 8))
def test_hosts_cover_each_worker_exactly_once(process_count):
    plans = HostShardPlan.all_hosts(process_count, W)
    owned = [w for p in plans for w in p.workers]
    assert sorted(owned) == list(range(W))
    assert [p.start for p in plans] == sorted(p.start for p in plans)


def test_for_runtime_defaults_to_the_process_group():
    assert world() == (0, 1)
    assert HostShardPlan.for_runtime(5) == HostShardPlan(0, 1, 5)
    assert HostShardPlan.for_runtime(5, process_index=1, process_count=3) == \
        HostShardPlan(1, 3, 5)


def test_validate_for_mesh_rejects_uneven_blocks():
    HostShardPlan(0, 1, 4).validate_for_mesh()
    HostShardPlan(1, 2, 4).validate_for_mesh(2)
    with pytest.raises(ValueError, match="divide evenly"):
        HostShardPlan(0, 3, 8).validate_for_mesh()
    with pytest.raises(ValueError, match="world"):
        HostShardPlan(0, 2, 4).validate_for_mesh(4)


def test_assemble_worker_array_keeps_the_local_block():
    plan = HostShardPlan(1, 2, 4)
    local = np.arange(2 * 3, dtype=np.int32).reshape(2, 3)
    t = assemble_worker_array(plan, local, "cpu")
    assert isinstance(t, torch.Tensor) and np.array_equal(t.numpy(), local)
    with pytest.raises(ValueError, match="worker rows"):
        assemble_worker_array(plan, local[:1], "cpu")
    with pytest.raises(ValueError, match="divide evenly"):
        assemble_worker_array(HostShardPlan(0, 3, 4), local[:1], "cpu")


def test_trainer_plan_device_chunk_and_table():
    cfg = SGNSConfig(vocab_size=64, dim=8, negatives=2)
    plan = HostShardPlan(1, 2, 4)
    tr = AsyncShardTrainer(cfg=cfg, num_workers=4, total_steps=4, engine="sparse",
                           device="cpu", plan=plan)
    full = AsyncShardTrainer(cfg=cfg, num_workers=4, total_steps=4, engine="sparse",
                             device="cpu")
    from repro_torch import prng

    p, q = tr.init(prng.PRNGKey(0)), full.init(prng.PRNGKey(0))
    assert torch.equal(p["W"], q["W"][2:4])           # keys by global worker id
    c = np.arange(2 * 4 * 8, dtype=np.int32).reshape(2, 4, 8) % 64
    gc, gx = tr.device_chunk(c, c + 1)
    assert np.array_equal(gc.numpy(), c) and np.array_equal(gx.numpy(), c + 1)
    table = {"prob": np.ones((4, 64), np.float32), "alias": np.arange(4 * 64,
                                                                      dtype=np.int32).reshape(4, 64)}
    t = tr.device_table(table)
    assert np.array_equal(t["alias"].numpy(), table["alias"][2:4])
    with pytest.raises(ValueError, match="plan covers"):
        AsyncShardTrainer(cfg=cfg, num_workers=3, total_steps=4, device="cpu",
                          plan=HostShardPlan(0, 1, 2))


def test_driver_process_args_are_bitwise_single_process(corpus):
    kw = dict(cfg=SGNSConfig(vocab_size=0, dim=16, window=3, negatives=2), engine="sparse",
              device="cpu", **{**KW, "num_workers": 2, "epochs": 1})
    a = train_submodels(corpus, 300, "shuffle", **kw)
    b = train_submodels(corpus, 300, "shuffle", process_index=0, process_count=1, **kw)
    assert torch.equal(a.stacked.models, b.stacked.models) and a.losses == b.losses
    assert gather_submodels(b) is b


def test_driver_rejects_multiprocess_without_a_group(corpus):
    with pytest.raises(ValueError, match="make_worker_group"):
        train_submodels(corpus, 300, "shuffle", cfg=SGNSConfig(vocab_size=0, dim=8, window=3,
                        negatives=2), device="cpu", process_index=0, process_count=2,
                        **{**KW, "num_workers": 2})


@pytest.mark.parametrize("B", (1, 7, 64, 1024))
def test_worker_mean_is_fixed_order_and_close_to_mean(B):
    """A worker's mean loss does not depend on how many workers share the
    tensor (any row subset gives the same bits) and is the mean within
    float32 rounding."""
    g = torch.Generator().manual_seed(B)
    loss = torch.rand((6, B), generator=g) * 5
    full = worker_mean(loss)
    for lo, hi in ((0, 1), (2, 5), (3, 6)):
        assert torch.equal(worker_mean(loss[lo:hi].contiguous()), full[lo:hi])
    torch.testing.assert_close(full, loss.double().mean(1).float(), rtol=1e-6, atol=0)
