"""The port's spans (``repro_torch.spans``): a shared null context while no
profiler runs, so no ``record_function`` is entered; under a profiler, each
span of the trainer, the engines, the driver and the ALiR merge as often as
the work it marks, each inside its parent; the tables and losses bitwise
the same either way; and the benchmark's record of a traced window
(``portbench/harness/trace.py``) the same with the port's spans as without
them."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import prng, spans
from repro_torch.core.async_trainer import AsyncShardTrainer
from repro_torch.core.driver import train_submodels
from repro_torch.core.merge import get_merger, stack_models
from repro_torch.core.sgns import SGNSConfig
from repro_torch.data.corpus import SemanticCorpusModel
from repro_torch.data.pairs import stack_noise_tables

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import trace  # noqa: E402

N, S, B, V, D = 2, 4, 32, 150, 16
CHUNKS = 2
ENGINES = ("fused", "rowgrad:cdf")
PATHS = ENGINES + ("merge", "driver")


def _trainer(engine):
    cfg = SGNSConfig(vocab_size=V, dim=D, negatives=4)
    return AsyncShardTrainer(cfg=cfg, num_workers=N, total_steps=CHUNKS * S, engine=engine,
                             device="cpu")


def _chunks():
    rng = np.random.default_rng(0)
    c = rng.integers(0, 40, (CHUNKS, N, S, B)).astype(np.int32)
    return c, ((c + 1) % 40).astype(np.int32)


def _train(engine):
    """Two chunks of ``AsyncShardTrainer.epoch``: the tables and the losses."""
    tr = _trainer(engine)
    counts = [np.random.default_rng(1).zipf(1.3, V).astype(np.float64)] * N
    table = stack_noise_tables(counts, kind=tr.engine.table_kind)
    table = ({k: torch.as_tensor(v) for k, v in table.items()} if isinstance(table, dict)
             else torch.as_tensor(table))
    params = tr.init(prng.PRNGKey(0))
    cen, ctx = _chunks()
    losses = []
    for k in range(CHUNKS):
        params, loss = tr.epoch(params, cen[k], ctx[k], table, prng.PRNGKey(10 + k),
                                step0=k * S)
        losses.append(loss)
    return params, torch.cat(losses, 1)


def _world(n=4, V=90, d=8, seed=5):
    """n rotated, noisy copies of one table, each missing some rows."""
    rng = np.random.default_rng(seed)
    Y = rng.normal(size=(V, d)).astype(np.float32)
    models, masks = [], []
    for _ in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(d, d)))
        mask = rng.random(V) >= 0.25
        mask[: d + 2] = True
        M = (Y @ q + 0.05 * rng.normal(size=(V, d))).astype(np.float32)
        M[~mask] = 9.9
        models.append(M)
        masks.append(mask)
    return stack_models(models, masks)


def _merge(max_iters=10, tol=1e-4):
    return get_merger("alir", device="cpu", max_iters=max_iters, tol=tol).merge(_world())


def _drive():
    corpus = SemanticCorpusModel.create(vocab_size=300, seed=0).generate(num_sentences=400,
                                                                         seed=1)
    return train_submodels(corpus, 300, "shuffle", 2, SGNSConfig(vocab_size=0, dim=16, window=3,
                                                                 negatives=2),
                           epochs=1, batch_size=32, max_vocab=None, base_min_count=2,
                           max_steps_per_epoch=6, steps_per_chunk=3, engine="sparse",
                           device="cpu")


RUN = {"fused": lambda: _train("fused"), "rowgrad:cdf": lambda: _train("rowgrad:cdf"),
       "merge": _merge, "driver": _drive}


def _profiled(fn, tmp_path):
    """``fn()`` under a CPU profiler: its result and the trace's events."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return out, json.loads(path.read_text())["traceEvents"]


def _spans(events):
    """The port's spans, ``{name: [(start, end)]}``."""
    out = {}
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e["name"].startswith("repro_torch.")):
            out.setdefault(e["name"], []).append((float(e["ts"]),
                                                  float(e["ts"]) + float(e["dur"])))
    return out


def _inside(child, parents):
    return any(s <= child[0] and child[1] <= e for s, e in parents)


def _rounds_run(disps, max_iters, tol):
    """Rounds of ALiR that ran, from its displacements: round i + 1 runs
    unless round i's displacement moved by less than ``tol``."""
    d = [float("inf")] + [float(x) for x in disps]
    for i in range(1, max_iters):
        if abs(d[i] - d[i - 1]) < tol:
            return i
    return max_iters


# --- no profiler: the shared null context, never a record_function --------
def _refuse_record_function(monkeypatch):
    def refused(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refused)


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    _refuse_record_function(monkeypatch)
    assert spans.span("repro_torch.epoch") is spans.span("repro_torch.merge")
    with spans.span("repro_torch.epoch") as inner:
        assert inner is None


def test_span_under_a_profiler_is_a_record_function():
    with profile(activities=[ProfilerActivity.CPU]):
        s = spans.span("repro_torch.epoch")
    assert isinstance(s, record_function)
    assert spans.span("repro_torch.epoch") is spans._NULL


@pytest.mark.parametrize("path", PATHS)
def test_the_port_enters_no_record_function_without_a_profiler(monkeypatch, path):
    _refuse_record_function(monkeypatch)
    RUN[path]()


# --- under a profiler: each span as often as its work, inside its parent --
@pytest.mark.parametrize("engine", ENGINES)
def test_epoch_spans_count_the_chunks_and_steps(engine, tmp_path):
    _, events = _profiled(lambda: _train(engine), tmp_path)
    got = _spans(events)
    steps = CHUNKS * S
    want = {"repro_torch.epoch": CHUNKS, "repro_torch.epoch.keys": CHUNKS,
            "repro_torch.epoch.stage": CHUNKS, "repro_torch.epoch.bounds": CHUNKS,
            "repro_torch.step.update": steps, "repro_torch.step.loss": steps}
    if engine.startswith("rowgrad"):
        want["repro_torch.step.draw"] = steps      # drawn outside the launch
    assert {k: len(v) for k, v in got.items()} == want
    chunks = got["repro_torch.epoch"]
    for name, intervals in got.items():
        if name != "repro_torch.epoch":
            assert all(_inside(iv, chunks) for iv in intervals), name
    for (s, e), later in zip(chunks, chunks[1:]):
        assert e <= later[0]


@pytest.mark.parametrize("engine", ENGINES)
def test_tables_and_losses_are_bitwise_with_and_without_the_profiler(engine, tmp_path):
    plain_params, plain_losses = _train(engine)
    (params, losses), _ = _profiled(lambda: _train(engine), tmp_path)
    assert torch.equal(losses, plain_losses)
    for k in ("W", "C"):
        assert torch.equal(params[k], plain_params[k]), k


@pytest.mark.parametrize("max_iters,tol", [(10, 1e-4), (10, 0.015), (10, 1e9), (1, 1e-4),
                                           (3, 0.0)])
def test_merge_round_spans_are_the_rounds_run(max_iters, tol, tmp_path):
    res, events = _profiled(lambda: _merge(max_iters, tol), tmp_path)
    got = _spans(events)
    rounds = _rounds_run(res.disps, max_iters, tol)
    assert len(got["repro_torch.merge.round"]) == rounds
    assert {k: len(v) for k, v in got.items() if k != "repro_torch.merge.round"} == {
        "repro_torch.merge": 1, "repro_torch.merge.init": 1, "repro_torch.merge.maps": 1}
    whole = got["repro_torch.merge"]
    for name, intervals in got.items():
        if name != "repro_torch.merge":
            assert all(_inside(iv, whole) for iv in intervals), name
    init_end = got["repro_torch.merge.init"][0][1]
    maps_start = got["repro_torch.merge.maps"][0][0]
    assert all(init_end <= s and e <= maps_start for s, e in got["repro_torch.merge.round"])
    plain = _merge(max_iters, tol)
    assert torch.equal(res.emb, plain.emb) and torch.equal(res.disps, plain.disps)


def test_driver_chunks_fall_inside_its_train_loop_span(tmp_path):
    res, events = _profiled(_drive, tmp_path)
    got = _spans(events)
    assert len(got["repro_torch.train_loop"]) == 1
    chunks = got["repro_torch.epoch"]
    assert len(chunks) == len(res.chunk_losses) > 0
    assert all(_inside(iv, got["repro_torch.train_loop"]) for iv in chunks)
    assert len(got["repro_torch.epoch.bounds"]) == len(chunks)
    assert "repro_torch.step.draw" in got          # the sparse engine draws outside


# --- the benchmark's record: the port's spans change none of it -----------
def _events(with_program: bool):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.window", "ts": 0, "dur": 1000},
          {"ph": "X", "cat": "user_annotation", "name": "portbench.epoch", "ts": 10, "dur": 480},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 100, "dur": 50},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 600, "dur": 50},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 95, "dur": 4},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 300,
           "dur": 30},
          {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 200, "dur": 40},
          {"ph": "X", "cat": "cpu_op", "name": "aten::slice", "ts": 700, "dur": 250}]
    if with_program:
        ev += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": ts, "dur": d}
               for n, ts, d in (("repro_torch.epoch", 12, 470), ("repro_torch.epoch.keys", 14, 20),
                                ("repro_torch.epoch.stage", 40, 30),
                                ("repro_torch.epoch.bounds", 80, 260),
                                ("repro_torch.step.update", 360, 60),
                                ("repro_torch.step.loss", 430, 40),
                                ("repro_torch.merge.round", 500, 300))]
    return ev


def test_program_spans_leave_the_benchmarks_record_and_breakdown_unchanged():
    counts = {"steps": 2}
    without, with_ = trace.parse(_events(False), counts), trace.parse(_events(True), counts)
    assert with_ == without
    assert trace.breakdown(with_) == trace.breakdown(without)
    assert set(with_["spans"]) == {"portbench.window", "portbench.epoch"}


def test_a_traced_chunk_gives_the_benchmark_the_same_record_keys_and_labels(tmp_path):
    """A real CPU trace of a chunk inside ``portbench.window``: the port's
    spans reach neither the record's lists nor the breakdown's labels."""
    tr = _trainer("fused")
    counts = [np.ones(V)] * N
    table = {k: torch.as_tensor(v) for k, v in stack_noise_tables(counts, "alias").items()}
    params = tr.init(prng.PRNGKey(0))
    cen, ctx = _chunks()

    def chunk():
        with record_function("portbench.window"):
            with record_function("portbench.epoch"):
                tr.epoch(params, cen[0], ctx[0], table, prng.PRNGKey(3))

    _, events = _profiled(chunk, tmp_path)
    assert _spans(events)["repro_torch.epoch"]
    rec = trace.parse(events, {"steps": S})
    bare = trace.parse([e for e in events if not e.get("name", "").startswith("repro_torch.")],
                       {"steps": S})
    assert rec == bare
    assert set(rec) == {"window", "device", "spans", "runtime", "host", "counts"}
    labels = {name for name, _ in trace.breakdown(rec)["idle_gaps"]}
    assert not any(name.startswith("repro_torch.") for name in labels)
