"""The port's contract checker (``repro_torch.analysis.contracts``) on the
CPU, mirroring ``tests/test_analysis.py``'s contract tests.

Parity rule: *zero collectives in training* — the train path makes no
``torch.distributed`` call, and the merge's one ``all_gather`` is the only
sanctioned collective. The recorder must not be vacuous: a planted
``all_reduce`` in a ``gloo`` group of one is caught, the merge Gram shows
exactly one all-gather, and the synchronized baselines show their
all-reduces (``make_sync_epoch``: 3 a step, one per gradient table and one
for the loss; ``make_periodic_sync_epoch``: 2 every ``sync_every`` steps
plus 1 for the losses an epoch). Names inside labels or strings are no
false positive. Every engine × sampler is certified collective-free over a
chunk, with its ``(V, d)`` tables updated in place (a transposing engine
fails), and so is one elastic ``run_worker``. The ``@zipf50k`` planner
traffic equals the committed baseline (read only), and a tampered copy is
caught.
"""

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import prng
from repro_torch.analysis.contracts import (
    C10D_COLLECTIVE_OPS, CollectiveRecorder, ContractViolation, certify_bench_traffic,
    certify_engine_contracts, certify_tables_in_place, certify_zero_collective,
    count_collective_ops, engine_matrix)
from repro_torch.core.async_trainer import make_periodic_sync_epoch, make_sync_epoch
from repro_torch.core.engine import SparseEngine, get_engine
from repro_torch.core.sgns import SGNSConfig
from repro_torch.data.pairs import build_noise_table
from repro_torch.sharding.merge import mesh_sharded_gram

CPU = "cpu"
V, D, NEG = 150, 16, 4


@pytest.fixture
def gloo_group(tmp_path):
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _planted(group):
    x = torch.ones(4)
    dist.all_reduce(x, group=group)
    return x


def test_planted_all_reduce_is_caught(gloo_group):
    """The regression the certifier exists for: one planted all_reduce is
    counted once (its dispatcher op, not the backend's label beside it)."""
    counts = count_collective_ops(_planted, gloo_group)
    assert counts == {"c10d::allreduce_": 1}
    assert set(counts) <= set(C10D_COLLECTIVE_OPS)
    with pytest.raises(ContractViolation, match="zero-collective"):
        certify_zero_collective(lambda: _planted(gloo_group), label="planted")
    with pytest.raises(ContractViolation, match="planted"):
        certify_zero_collective(counts, label="planted")


def test_every_collective_records_a_listed_c10d_op(gloo_group):
    """The names this build dispatches (gloo) are the listed ones."""
    x, out = torch.ones(4), torch.empty(4)

    def many():
        dist.all_reduce(x, group=gloo_group)
        dist.all_gather_into_tensor(out, x, group=gloo_group)
        dist.all_gather([out], x, group=gloo_group)
        dist.broadcast(x, 0, group=gloo_group)
        dist.barrier(group=gloo_group)

    counts = count_collective_ops(many)
    assert counts == {"c10d::allreduce_": 1, "c10d::_allgather_base_": 1,
                      "c10d::allgather_": 1, "c10d::broadcast_": 1, "c10d::barrier": 1}
    assert set(counts) <= set(C10D_COLLECTIVE_OPS)


def test_collective_names_in_strings_are_not_a_false_positive():
    """Labels and strings that mention collectives are not ops: only
    dispatcher ops in the c10d:: namespace count."""

    def looks_like_one():
        """The all_reduce that is not there (c10d::allreduce_, nccl)."""
        with torch.profiler.record_function("all_reduce_helper"):
            y = torch.ones(3) + 1
        with torch.profiler.record_function("c10d::allreduce_"):
            y = y * 2
        with torch.profiler.record_function("ncclAllReduce"):
            y = y - 1
        return "all-reduce-wrapper", y

    with CollectiveRecorder(cuda=False) as rec:
        looks_like_one()
    assert rec.counts == {} and rec.device_kernels == 0
    assert certify_zero_collective(looks_like_one) == {}


def test_merge_gram_is_the_one_intentional_collective(gloo_group):
    """The merge phase's sharded Gram is the one sanctioned collective:
    the recorder sees exactly one all-gather, and the certifier rejects it
    if pointed there."""
    rng = np.random.default_rng(5)
    A = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))

    def gram():
        return mesh_sharded_gram(A, A, gloo_group, num_shards=4)

    assert count_collective_ops(gram) == {"c10d::_allgather_base_": 1}
    with pytest.raises(ContractViolation, match="zero-collective"):
        certify_zero_collective(gram, label="merge-gram")


class TransposingEngine(SparseEngine):
    """A step whose tables come back re-laid out (transposed copies)."""

    def make_step(self, cfg, total_steps):
        inner = super().make_step(cfg, total_steps)

        def step(params, c, x, table, seeds, i):
            params, loss = inner(params, c, x, table, seeds, i)
            return {k: v.transpose(1, 2).contiguous() for k, v in params.items()}, loss

        return step


def test_transposing_engine_fails_the_in_place_certificate():
    with pytest.raises(ContractViolation, match="aliasing"):
        certify_tables_in_place(TransposingEngine(), vocab_size=96, dim=16,
                                negatives=2, batch=32, device=CPU)
    rep = certify_tables_in_place("sparse", vocab_size=96, dim=16, negatives=2,
                                  batch=32, device=CPU)
    assert rep.tables_in_place == 2 and rep.largest_copy == 0


def test_a_step_that_leaves_the_tables_untouched_fails():
    class Frozen(SparseEngine):
        def make_step(self, cfg, total_steps):
            def step(params, c, x, table, seeds, i):
                return params, torch.zeros(c.shape[0])
            return step

    with pytest.raises(ContractViolation, match="unchanged in its storage"):
        certify_tables_in_place(Frozen(), vocab_size=96, dim=16, negatives=2, batch=32,
                                device=CPU)


def test_bench_traffic_certificate_and_tamper_detection(tmp_path):
    """The committed @zipf50k baseline matches the port's planner; a
    tampered copy is caught (the committed file is only read)."""
    reports = certify_bench_traffic("BENCH_wallclock.json", device=CPU)
    assert {(r.engine, r.predicted_rows) for r in reports} == {
        ("pallas_fused_pipe@zipf50k", 91_386), ("pallas_fused_tiered@zipf50k", 59_692)}
    rows = json.load(open("BENCH_wallclock.json"))
    for r in rows:
        if r.get("engine") == "pallas_fused_tiered@zipf50k":
            r["hbm_rows_per_step"] += 2          # silent planner drift
    tampered = tmp_path / "BENCH_wallclock.json"
    tampered.write_text(json.dumps(rows))
    with pytest.raises(ContractViolation, match="traffic"):
        certify_bench_traffic(str(tampered), device=CPU)


def test_trainer_collective_helpers_delegate_to_contracts(gloo_group):
    from repro_torch.core import assert_no_collectives
    from repro_torch.core import count_collective_ops as core_counts

    with pytest.raises(AssertionError, match="zero-collective"):
        assert_no_collectives(lambda: _planted(gloo_group))
    assert core_counts(_planted, gloo_group) == {"c10d::allreduce_": 1}
    assert assert_no_collectives(lambda: torch.ones(2) * 2) == {}


# ------------------------------------------------- the train path, certified
@pytest.mark.parametrize("engine", engine_matrix(V),
                         ids=lambda e: e.describe() + ("-seq" if getattr(e, "sequential",
                                                                          False) else ""))
def test_every_engine_and_sampler_is_collective_free_and_in_place(engine):
    rep = certify_engine_contracts(engine, vocab_size=V, dim=D, negatives=NEG, steps=2,
                                   batch=8, device=CPU)
    assert rep.zero_collective and rep.in_place.tables_in_place == 2
    assert rep.in_place.largest_copy < V * D


def test_elastic_run_worker_is_collective_free(tmp_path):
    from repro_torch.core.driver import prepare_training
    from repro_torch.data.corpus import SemanticCorpusModel
    from repro_torch.elastic import ElasticRunner, WorkerStateStore

    corpus = SemanticCorpusModel.create(vocab_size=150, seed=0).generate(300, seed=1)
    setup = prepare_training(corpus, 150, "random", 2, SGNSConfig(vocab_size=0, dim=8,
                                                                  negatives=2),
                             epochs=1, batch_size=16, max_steps_per_epoch=4,
                             steps_per_chunk=2, subsample_t=None, engine="fused")
    runner = ElasticRunner(setup, WorkerStateStore(str(tmp_path)), device=CPU)
    with CollectiveRecorder() as rec:
        out = runner.run_worker(1)
    certify_zero_collective(rec.counts, label="elastic run_worker")
    assert runner.store.cursor(1).done(1) and np.isfinite(out["W"]).all()


# ------------------------------------ the synchronized baselines: non-vacuity
def _sync_world():
    rng = np.random.default_rng(3)
    counts = rng.zipf(1.3, V).astype(np.float64)
    params = {"W": torch.from_numpy(((rng.random((V, D)) - 0.5) / D).astype(np.float32)),
              "C": torch.from_numpy((0.02 * rng.normal(size=(V, D))).astype(np.float32))}
    c = torch.from_numpy(rng.integers(0, V, (3, 2, 8)).astype(np.int32))
    x = torch.from_numpy(rng.integers(0, V, (3, 2, 8)).astype(np.int32))
    return counts, params, c, x


@pytest.mark.parametrize("spec", ("dense", "fused"))
def test_sync_epoch_makes_three_all_reduces_a_step(gloo_group, spec):
    counts, params, c, x = _sync_world()
    cfg = SGNSConfig(vocab_size=V, dim=D, negatives=NEG)
    table = build_noise_table(counts, kind=get_engine(spec).table_kind)
    S = c.shape[0] * c.shape[1]
    for group, want in ((gloo_group, {"c10d::allreduce_": 3 * S}), (None, {})):
        epoch = make_sync_epoch(cfg, table, 12, group=group, engine=spec, device=CPU)
        got = count_collective_ops(epoch, dict(params), c.reshape(S, -1), x.reshape(S, -1),
                                   prng.PRNGKey(5), 0)
        assert got == want


@pytest.mark.parametrize("spec", ("dense", "fused"))
def test_periodic_sync_makes_two_all_reduces_a_sync_and_one_an_epoch(gloo_group, spec):
    counts, params, c, x = _sync_world()
    cfg = SGNSConfig(vocab_size=V, dim=D, negatives=NEG)
    table = build_noise_table(counts, kind=get_engine(spec).table_kind)
    outer = c.shape[0]
    for group, want in ((gloo_group, {"c10d::allreduce_": 2 * outer + 1}), (None, {})):
        epoch = make_periodic_sync_epoch(cfg, table, 12, sync_every=2, num_workers=2,
                                         group=group, engine=spec, device=CPU)
        assert count_collective_ops(epoch, dict(params), c, x, prng.PRNGKey(5), 0) == want
