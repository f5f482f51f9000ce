"""The port's serving tier (``serve/``) on the CPU, against the JAX
package's.

* the LRU and batcher cases of ``tests/test_serve.py``, run on the port's
  copies;
* the port's server over one artifact against the reference's
  ``EmbeddingServer`` over the same directory: merged rows and a
  sub-model's present rows bitwise, reconstructed (absent) rows within
  atol 1e-6 (numpy's and torch's BLAS sum the d products in other orders),
  and against the port's ``reconstruct_missing``;
* the raw-id namespace and unknown ids, hot reload and a pinned store, the
  TCP round trip (and a malformed line), the errors of artifacts without
  sidecars;
* ``publish_incremental`` on the port: its final version bitwise the batch
  merge, and its artifacts read by the reference's server.
"""

import asyncio
import json
import time

import numpy as np
import pytest
import torch

from repro.core import merge as jm
from repro.serve import EmbeddingServer as JEmbeddingServer
from repro_torch.checkpoint import load_manifest, publish_table
from repro_torch.core import merge as tm
from repro_torch.serve import (ArtifactStore, CoalescingBatcher, EmbeddingServer,
                               LRUCache, ServeConfig, publish_incremental)
from repro_torch.serve.publish import submodel_arrivals
from repro_torch.serve.tcp import request_once, start_tcp_server

V, D, N = 60, 6, 3
REC_ATOL = 1e-6


def _stacked(V=V, d=D, n=N, seed=0):
    """Rotated copies of one table with per-model holes (ALiR's model)."""
    rng = np.random.default_rng(seed)
    Y = rng.normal(size=(V, d)).astype(np.float32)
    models, masks = [], []
    for i in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(d, d)))
        M = (Y @ q).astype(np.float32)
        mask = np.ones(V, bool) if i == 0 else rng.random(V) >= 0.3
        mask[: d + 2] = True
        M[~mask] = 0.0
        models.append(M)
        masks.append(mask)
    return tm.stack_models(models, masks)


def _publish(artifact_dir, stacked, word_ids=None, scale=1.0, **drop):
    """Batch-merge on the port and publish with every serving sidecar
    (``drop`` names sidecars to leave out)."""
    res = tm.get_merger("alir", device="cpu").merge(stacked)
    Y = res.Y * scale
    Ws = tm.alir_transforms(stacked, Y)
    side = dict(word_ids=word_ids, worker_ids=np.arange(stacked.n, dtype=np.int32),
                mask=stacked.mask, transforms=Ws, models=stacked.models)
    side.update(drop)
    publish_table(str(artifact_dir), Y, res.valid, **side)
    return Y.numpy(), res.valid.numpy(), Ws


def _server(path, **cfg):
    return EmbeddingServer(str(path), ServeConfig(coalesce_ms=0.5, **cfg), device="cpu")


# --------------------------------------------------------------------- cache
def test_lru_evicts_least_recently_used():
    c = LRUCache(2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1
    c.put("c", 3)
    assert c.get("b") is None and c.get("a") == 1 and c.get("c") == 3
    assert len(c) == 2 and "a" in c


def test_lru_hit_rate_and_zero_capacity():
    c = LRUCache(4)
    c.put("k", 7)
    assert c.get("k") == 7 and c.get("x") is None
    assert c.hit_rate == pytest.approx(0.5)
    c.clear()
    assert len(c) == 0 and c.get("k") is None
    off = LRUCache(0)
    off.put("k", 7)
    assert off.get("k") is None and len(off) == 0
    with pytest.raises(ValueError):
        LRUCache(-1)


# ------------------------------------------------------------------- batcher
def test_batcher_coalesces_and_dedups_one_window():
    calls = []

    def dispatch(keys):
        calls.append(sorted(keys))
        return {k: k * 10 for k in keys}

    async def go():
        b = CoalescingBatcher(dispatch, ServeConfig(coalesce_ms=5.0, max_batch=100))
        res = await asyncio.gather(*(b.submit(i % 3) for i in range(9)))
        assert res == [0, 10, 20] * 3
        assert b.requests == 9 and b.dispatches == 1
        s = b.stats()
        assert s["mean_batch"] == 3 and s["max_batch"] == 3

    asyncio.run(go())
    assert calls == [[0, 1, 2]]


def test_batcher_flushes_immediately_at_max_batch():
    async def go():
        b = CoalescingBatcher(lambda keys: {k: k for k in keys},
                              ServeConfig(coalesce_ms=1000.0, max_batch=4))
        await asyncio.wait_for(asyncio.gather(*(b.submit(i) for i in range(8))), timeout=5)
        assert b.dispatches == 2 and b.stats()["max_batch"] == 4

    asyncio.run(go())


def test_batcher_respects_concurrency_semaphore():
    def dispatch(keys):
        time.sleep(0.02)
        return {k: k for k in keys}

    async def go():
        b = CoalescingBatcher(dispatch, ServeConfig(coalesce_ms=0.1, max_batch=1,
                                                    max_concurrency=2,
                                                    dispatch_in_thread=True))
        await asyncio.gather(*(b.submit(i) for i in range(6)))
        s = b.stats()
        assert s["dispatches"] == 6 and 1 <= s["max_concurrent_dispatches"] <= 2

    asyncio.run(go())


def test_batcher_rejects_whole_batch_on_dispatch_error():
    def dispatch(keys):
        raise RuntimeError("backend down")

    async def go():
        b = CoalescingBatcher(dispatch, ServeConfig(coalesce_ms=1.0))
        res = await asyncio.gather(b.submit("a"), b.submit("b"), return_exceptions=True)
        assert all(isinstance(r, RuntimeError) for r in res)
        b._dispatch = lambda keys: {k: 1 for k in keys}
        assert await b.submit("a") == 1

    asyncio.run(go())


def test_drain_returns_once_dispatches_finished():
    """The reference's ``drain`` spins forever here (see the port's
    ``CoalescingBatcher.drain``): the dispatch task has finished but the
    loop has not yet run the callback that drops it from the in-flight set."""
    async def go():
        b = CoalescingBatcher(lambda keys: {k: k for k in keys},
                              ServeConfig(coalesce_ms=1000.0))
        assert await asyncio.wait_for(asyncio.gather(b.submit(1), b.submit(2)), 5) == [1, 2]
        await asyncio.wait_for(b.drain(), timeout=5)
        fut = asyncio.ensure_future(b.submit(3))     # pending in a 1 s window
        await asyncio.sleep(0)
        await asyncio.wait_for(b.drain(), timeout=5)  # flushes it at once
        assert fut.done() and fut.result() == 3 and b.dispatches == 2

    asyncio.run(go())


# -------------------------------------------------------------------- server
def test_store_loads_the_table_onto_its_device(tmp_path):
    stacked = _stacked()
    Y, valid, Ws = _publish(tmp_path, stacked, word_ids=np.arange(V, dtype=np.int32) * 3)
    store = ArtifactStore(str(tmp_path), device="cpu")
    t = store.table
    assert t.version == store.version == 1 and t.dim == D
    for name, want in (("emb", Y), ("valid", valid), ("mask", stacked.mask.numpy()),
                       ("transforms", Ws.numpy()), ("models", stacked.models.numpy())):
        got = getattr(t, name)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu", name
        np.testing.assert_array_equal(got.numpy(), want)
    assert t.mask.dtype == torch.bool and t.valid.dtype == torch.bool
    np.testing.assert_array_equal(t.valid_host, valid)
    np.testing.assert_array_equal(t.worker_ids, np.arange(N))
    np.testing.assert_array_equal(store.rows_of([0, 3, 4, -2, 10_000]), [0, 1, -1, -1, -1])


@pytest.mark.parametrize("seed", (0, 5))
def test_server_matches_the_reference_server(tmp_path, seed):
    stacked = _stacked(seed=seed)
    Y, valid, _ = _publish(tmp_path, stacked)
    mask = stacked.mask.numpy()
    models = stacked.models.numpy()
    rec = tm.reconstruct_missing(stacked, torch.from_numpy(Y)).numpy()
    rows = np.arange(V)

    async def go():
        ours, ref = _server(tmp_path), JEmbeddingServer(str(tmp_path), ServeConfig(coalesce_ms=0.5))
        o, r = await ours.embed_rows(rows), await ref.embed_rows(rows)
        np.testing.assert_array_equal(o["found"], r["found"])
        np.testing.assert_array_equal(o["found"], valid)
        assert o["vectors"].dtype == np.float32
        np.testing.assert_array_equal(o["vectors"], r["vectors"])       # merged: bitwise
        np.testing.assert_array_equal(o["vectors"][valid], Y[valid])
        assert o["version"] == r["version"] == 1
        for w in range(N):
            o = await ours.embed_rows(rows, submodel=w)
            r = await ref.embed_rows(rows, submodel=w)
            present = mask[w]
            np.testing.assert_array_equal(o["vectors"][present], r["vectors"][present])
            np.testing.assert_array_equal(o["vectors"][present], models[w][present])
            np.testing.assert_allclose(o["vectors"][~present], r["vectors"][~present],
                                       rtol=0, atol=REC_ATOL)
            np.testing.assert_allclose(o["vectors"], rec[w], rtol=0, atol=REC_ATOL)
        with pytest.raises(KeyError):
            await ours.embed_rows([0], submodel=99)

    asyncio.run(go())


def test_one_batch_mixes_spaces_in_one_gather(tmp_path):
    stacked = _stacked()
    Y, _, _ = _publish(tmp_path, stacked)
    srv = _server(tmp_path)
    keys = [(-1, 3), (1, 3), (-1, 0), (2, 7), (1, 9)]
    out = srv._gather(keys)
    assert sorted(out) == sorted(keys)
    np.testing.assert_array_equal(out[(-1, 3)], Y[3])
    np.testing.assert_array_equal(out[(1, 3)], stacked.models[1, 3].numpy())
    assert all(v.dtype == np.float32 and v.shape == (D,) for v in out.values())


def test_server_raw_id_namespace_and_unknown_ids(tmp_path):
    stacked = _stacked()
    word_ids = np.arange(V, dtype=np.int32) * 2        # raw ids: evens
    Y, valid, _ = _publish(tmp_path, stacked, word_ids=word_ids)

    async def go():
        srv = _server(tmp_path)
        ref = JEmbeddingServer(str(tmp_path), ServeConfig(coalesce_ms=0.5))
        ids = [0, 4, 3, 10_000, -1]
        out, r = await srv.embed_ids(ids), await ref.embed_ids(ids)
        np.testing.assert_array_equal(out["found"], [valid[0], valid[2], False, False, False])
        np.testing.assert_array_equal(out["found"], r["found"])
        np.testing.assert_array_equal(out["vectors"], r["vectors"])
        np.testing.assert_array_equal(out["vectors"][1], Y[2])
        assert (out["vectors"][2:] == 0).all()

    asyncio.run(go())


def test_rows_are_row_space_without_word_ids(tmp_path):
    stacked = _stacked()
    Y, _, _ = _publish(tmp_path, stacked)

    async def go():
        srv = _server(tmp_path)
        out = await srv.embed_ids([2, V, -3])
        np.testing.assert_array_equal(out["found"], [True, False, False])
        np.testing.assert_array_equal(out["vectors"][0], Y[2])

    asyncio.run(go())


def test_server_cache_hits_and_hot_reload(tmp_path):
    stacked = _stacked()
    _publish(tmp_path, stacked)

    async def go():
        srv = _server(tmp_path, cache_rows=V)
        pinned = EmbeddingServer(ArtifactStore(str(tmp_path), version=1, device="cpu"))
        await srv.embed_rows(np.arange(V))
        out = await srv.embed_rows(np.arange(V))
        assert srv.stats()["cache_hit_rate"] >= 0.5
        assert srv.refresh() is False

        Y2, _, _ = _publish(tmp_path, stacked, scale=2.0)            # version 2
        assert srv.store.latest_available() == 2
        assert srv.refresh() is True
        assert srv.store.version == 2 and len(srv.cache) == 0
        out2 = await srv.embed_rows(np.arange(V))
        np.testing.assert_array_equal(out2["vectors"][out2["found"]], Y2[out2["found"]])
        assert not np.array_equal(out2["vectors"], out["vectors"])
        assert out2["version"] == srv.stats()["version"] == 2
        assert pinned.refresh() is False and pinned.store.version == 1

    asyncio.run(go())


def test_artifacts_without_sidecars_refuse_submodel_queries(tmp_path):
    stacked = _stacked()
    publish_table(str(tmp_path / "bare"), stacked.models[0], stacked.mask[0])
    _publish(tmp_path / "nomodels", stacked, models=None)
    _publish(tmp_path / "notransforms", stacked, transforms=None)

    async def go():
        with pytest.raises(ValueError, match="no per-sub-model mask"):
            await _server(tmp_path / "bare").embed_rows([0], submodel=0)
        srv = _server(tmp_path / "nomodels")
        absent = int(np.flatnonzero(~stacked.mask[1].numpy())[0])
        out = await srv.embed_rows([absent], submodel=1)             # absent rows work
        assert out["found"].all()
        with pytest.raises(ValueError, match="models"):
            await srv.embed_rows([0], submodel=1)
        with pytest.raises(ValueError, match="transforms"):
            await _server(tmp_path / "notransforms").embed_rows([0], submodel=1)

    asyncio.run(go())


# ----------------------------------------------------------------------- tcp
def test_tcp_round_trip_stats_and_errors(tmp_path):
    stacked = _stacked()
    Y, valid, _ = _publish(tmp_path, stacked)

    async def go():
        server = _server(tmp_path)
        srv = await start_tcp_server(server)
        port = srv.sockets[0].getsockname()[1]
        try:
            r = await request_once("127.0.0.1", port, {"rows": [0, 1]})
            assert r["version"] == 1 and len(r["vectors"]) == 2
            np.testing.assert_array_equal(np.asarray(r["vectors"][0], np.float32), Y[0])
            r = await request_once("127.0.0.1", port, {"rows": [5], "submodel": 0})
            assert r["found"] == [bool(valid[5])]
            r = await request_once("127.0.0.1", port, {"ids": [2, 999]})
            assert r["found"] == [True, False]
            s = await request_once("127.0.0.1", port, {"op": "stats"})
            assert s["stats"]["requests"] >= 3
            bad = await request_once("127.0.0.1", port, {"op": "nope"})
            assert "error" in bad
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(b"not json\n\n[1]\n")
            await writer.drain()
            for _ in range(2):                           # the blank line is skipped
                assert "error" in json.loads(await reader.readline())
            writer.close()
            r = await request_once("127.0.0.1", port, {"op": "refresh"})
            assert r == {"refreshed": False, "version": 1}
        finally:
            srv.close()
            await srv.wait_closed()

    asyncio.run(go())


# ------------------------------------------------------------------- publish
def test_publish_incremental_final_version_is_the_batch_merge(tmp_path):
    stacked = _stacked(n=4, seed=2)
    word_ids = np.arange(V, dtype=np.int32) + 100
    versions, final = publish_incremental(
        submodel_arrivals(stacked, order=(2, 0, 3, 1)), str(tmp_path), word_ids=word_ids,
        publish_every=2, device="cpu", meta={"run": "t"})
    assert versions == [1, 2]
    batch = tm.get_merger("alir", device="cpu").merge(stacked)
    assert torch.equal(final.emb, batch.emb) and torch.equal(final.transforms, batch.transforms)
    m = load_manifest(str(tmp_path))
    assert [e["n_folded"] for e in m["versions"]] == [2, 4]
    assert [e["final"] for e in m["versions"]] == [False, True]
    assert m["versions"][0]["merge"] == "alir_incremental" and m["versions"][0]["run"] == "t"
    with pytest.raises(ValueError, match="no sub-model arrivals"):
        publish_incremental([], str(tmp_path), device="cpu")

    async def go():
        # the reference's server reads the port's artifact
        ref = JEmbeddingServer(str(tmp_path), ServeConfig(coalesce_ms=0.5))
        ours = _server(tmp_path)
        out, r = await ours.embed_ids(word_ids), await ref.embed_ids(word_ids)
        np.testing.assert_array_equal(out["vectors"], r["vectors"])
        np.testing.assert_array_equal(out["vectors"], batch.emb.numpy())
        v1 = EmbeddingServer(ArtifactStore(str(tmp_path), version=1, device="cpu"))
        got = await v1.embed_rows(np.arange(V), submodel=2)
        assert got["version"] == 1 and got["found"].any()

    asyncio.run(go())


def test_reference_artifact_served_by_the_port(tmp_path):
    """The JAX package's incremental publish, served by the port."""
    from repro.serve import publish_incremental as jpublish
    from repro.serve.publish import submodel_arrivals as jarrivals

    stacked = _stacked(seed=4)
    js = jm.stack_models(list(stacked.models.numpy()), list(stacked.mask.numpy()))
    _, final = jpublish(jarrivals(js), str(tmp_path), publish_every=3)
    Y = np.asarray(final.Y)
    rec = np.asarray(jm.reconstruct_missing(js, final.Y))

    async def go():
        srv = _server(tmp_path)
        out = await srv.embed_rows(np.arange(V))
        np.testing.assert_array_equal(out["vectors"], Y)
        for w in range(N):
            got = (await srv.embed_rows(np.arange(V), submodel=w))["vectors"]
            np.testing.assert_allclose(got, rec[w], rtol=0, atol=REC_ATOL)

    asyncio.run(go())
