"""The port's checkpoint layer (``checkpoint/io.py``) against the JAX
package's, on the CPU.

* the pytree round trip (empty dicts and lists, ``None``, tuples, torch
  tensors), and each package loading the other's checkpoints bitwise;
* published artifacts: each package loads what the other writes, arrays
  bitwise, manifest fields equal, versions monotonic across writers;
* the crash-safety cases of ``tests/test_artifact.py`` run on the port
  (a failed write, a stray temp file, an orphan version never reused,
  the manifest written after the table, ``gc_orphans``'s floor);
* the per-worker and tree-node helpers across packages;
* bfloat16: numpy has no such dtype, the JAX package writes a raw ``|V2``
  array; the port refuses both directions with a ``TypeError``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro_torch.checkpoint import io as tio


def _payload(V=20, d=4, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        emb=rng.normal(size=(V, d)).astype(np.float32),
        valid=np.ones(V, bool),
        word_ids=np.arange(V, dtype=np.int32) * 2,
        worker_ids=np.arange(n, dtype=np.int32),
        mask=rng.random((n, V)) > 0.3,
        transforms=rng.normal(size=(n, d, d)).astype(np.float32),
        models=rng.normal(size=(n, V, d)).astype(np.float32),
    )


def _tree(rng):
    return {
        "params": {"W": rng.normal(size=(5, 3)).astype(np.float32),
                   "b": rng.integers(0, 9, size=4).astype(np.int64)},
        "opt": [rng.normal(size=2), (np.float16(1.5) * np.ones(3, np.float16),)],
        "empty_d": {}, "empty_l": [], "none": None,
        "nested": {"deep": {"x": np.arange(6, dtype=np.int32).reshape(2, 3)}},
        "mask": rng.random(7) > 0.5,
    }


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    elif a is None:
        assert b is None
    else:
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert b.dtype == a.dtype and b.shape == a.shape
        np.testing.assert_array_equal(b, a)


# ------------------------------------------------------------------ pytrees
@pytest.mark.parametrize("writer,reader", [(tio, tio), (tio, jio), (jio, tio)],
                         ids=["port->port", "port->repro", "repro->port"])
def test_pytree_round_trip_across_packages(tmp_path, writer, reader):
    tree = _tree(np.random.default_rng(0))
    path = str(tmp_path / "ck" / "step_7.npz")
    writer.save_checkpoint(path, tree, step=7, extra={"note": "x"})
    back, meta = reader.load_checkpoint(path)
    _assert_tree_equal(tree, back)
    assert meta == {"step": 7, "note": "x"}
    assert reader.latest_step_path(str(tmp_path / "ck")) == path
    # the same flat keys and tags on disk
    with np.load(path) as data:
        assert sorted(data.files) == sorted(jio._flatten(tree))


def test_torch_leaves_save_as_numpy(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"W": torch.randn(4, 3, generator=g, requires_grad=True),
            "ids": torch.arange(5, dtype=torch.int32), "half": torch.ones(2).half(),
            "l": [torch.zeros(0), None]}
    path = str(tmp_path / "t.npz")
    tio.save_checkpoint(path, tree)
    back, meta = jio.load_checkpoint(path)                 # the reference reads it
    np.testing.assert_array_equal(back["W"], tree["W"].detach().numpy())
    assert back["ids"].dtype == np.int32 and back["half"].dtype == np.float16
    assert back["l"][1] is None and back["l"][0].shape == (0,)
    assert meta == {"step": None}
    assert tio.latest_step_path(str(tmp_path / "none")) is None


def test_bfloat16_is_refused_in_both_directions(tmp_path):
    """numpy has no bfloat16. The JAX package saves one as raw ``|V2``
    bytes and loads it back so, its dtype lost; the port refuses to save a
    bfloat16 tensor and to load a void leaf, with a clear TypeError."""
    with pytest.raises(TypeError, match="bfloat16.*cast"):
        tio.save_checkpoint(str(tmp_path / "a.npz"), {"w": torch.ones(3, dtype=torch.bfloat16)})
    with pytest.raises(TypeError, match="bfloat16"):
        tio.publish_table(str(tmp_path / "art"), torch.ones(2, 2, dtype=torch.bfloat16),
                          np.ones(2, bool))
    path = str(tmp_path / "j.npz")
    jio.save_checkpoint(path, {"w": jnp.arange(4, dtype=jnp.bfloat16), "ok": np.ones(2)})
    back, _ = jio.load_checkpoint(path)
    assert back["w"].dtype.kind == "V"                      # the reference's own loss
    with pytest.raises(TypeError, match="void"):
        tio.load_checkpoint(path)
    with pytest.raises(TypeError, match="void"):
        tio.save_checkpoint(str(tmp_path / "v.npz"), {"w": back["w"]})
    # a float32 copy round-trips both ways
    tio.save_checkpoint(str(tmp_path / "f.npz"),
                        {"w": torch.arange(4, dtype=torch.bfloat16).float()})
    np.testing.assert_array_equal(jio.load_checkpoint(str(tmp_path / "f.npz"))[0]["w"],
                                  np.arange(4, dtype=np.float32))


# ----------------------------------------------------------------- artifacts
@pytest.mark.parametrize("writer,reader", [(tio, jio), (jio, tio)],
                         ids=["port->repro", "repro->port"])
def test_artifacts_load_across_packages(tmp_path, writer, reader):
    art = str(tmp_path)
    payloads = [_payload(seed=k) for k in range(3)]
    assert writer.publish_table(art, meta={"merge": "test"}, **payloads[0]) == 1
    assert writer.publish_table(art, payloads[1]["emb"], payloads[1]["valid"]) == 2
    # the other package publishes into the same directory: versions stay monotonic
    assert reader.publish_table(art, **payloads[2]) == 3
    for v, p in ((1, payloads[0]), (3, payloads[2])):
        for pkg in (tio, jio):
            t = pkg.load_table(art, version=v)
            assert t.version == v and t.dim == 4
            for k in p:
                got = getattr(t, k)
                assert got.dtype == np.asarray(p[k]).dtype
                np.testing.assert_array_equal(got, p[k])
    t2 = reader.load_table(art, version=2)
    assert t2.word_ids is None and t2.mask is None and t2.models is None
    m_t, m_j = tio.load_manifest(art), jio.load_manifest(art)
    assert m_t == m_j and m_t["latest"] == 3
    assert [e["version"] for e in m_t["versions"]] == [1, 2, 3]
    first = m_t["versions"][0]
    assert first["merge"] == "test" and first["rows"] == 20 and first["n_models"] == 3
    assert first["file"] == "table_v000001.npz"
    assert tio.next_version(art) == jio.next_version(art) == 4


def test_tensor_payload_publishes_like_numpy(tmp_path):
    p = _payload()
    tio.publish_table(str(tmp_path / "t"), **{k: torch.from_numpy(v) for k, v in p.items()})
    jio.publish_table(str(tmp_path / "j"), **p)
    t, j = jio.load_table(str(tmp_path / "t")), jio.load_table(str(tmp_path / "j"))
    for k in p:
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
    with np.load(tmp_path / "t" / "table_v000001.npz") as a, \
            np.load(tmp_path / "j" / "table_v000001.npz") as b:
        assert a.files == b.files


def test_load_before_first_publish_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tio.load_table(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        tio.load_table(str(tmp_path / "never-created"))
    p = _payload()
    tio.publish_table(str(tmp_path), p["emb"], p["valid"])
    with pytest.raises(FileNotFoundError, match="not in manifest"):
        tio.load_table(str(tmp_path), version=5)


def test_failed_write_leaves_no_temp_and_no_manifest(tmp_path):
    target = str(tmp_path / "table_v000001.npz")

    def boom(tmp):
        with open(tmp, "wb") as f:
            f.write(b"partial")
        raise OSError("disk full")

    with pytest.raises(OSError):
        tio._atomic_write_bytes(target, boom)
    assert os.listdir(tmp_path) == []
    assert tio.load_manifest(str(tmp_path)) is None
    p = _payload()
    assert tio.publish_table(str(tmp_path), p["emb"], p["valid"]) == 1


def test_stray_tmp_file_is_invisible_to_readers(tmp_path):
    p = _payload()
    tio.publish_table(str(tmp_path), p["emb"], p["valid"])
    (tmp_path / ".tmp-table_v000002.npz.999").write_bytes(b"partial write")
    t = tio.load_table(str(tmp_path))
    assert t.version == 1
    np.testing.assert_array_equal(t.emb, p["emb"])
    assert tio.next_version(str(tmp_path)) == 2


def test_orphan_table_version_never_reused(tmp_path):
    p1 = _payload(seed=1)
    tio.publish_table(str(tmp_path), p1["emb"], p1["valid"])
    orphan = _payload(seed=2)
    tio._savez_to(tio._table_path(str(tmp_path), 2),
                  {"emb": orphan["emb"], "valid": orphan["valid"]})
    t = tio.load_table(str(tmp_path))
    assert t.version == 1
    np.testing.assert_array_equal(t.emb, p1["emb"])
    with pytest.raises(FileNotFoundError):
        tio.load_table(str(tmp_path), version=2)
    p3 = _payload(seed=3)
    assert tio.publish_table(str(tmp_path), p3["emb"], p3["valid"]) == 3
    np.testing.assert_array_equal(tio.load_table(str(tmp_path)).emb, p3["emb"])


def test_gc_orphans_keeps_the_floor(tmp_path):
    art = str(tmp_path)
    p = _payload()
    tio.publish_table(art, p["emb"], p["valid"])
    tio._savez_to(tio._table_path(art, 2), {"emb": p["emb"], "valid": p["valid"]})
    (tmp_path / ".tmp-x.1").write_bytes(b"junk")
    assert tio.gc_orphans(art) == [".tmp-x.1", "table_v000002.npz"]
    assert sorted(os.listdir(art)) == ["MANIFEST.json", "table_v000001.npz"]
    assert jio.load_manifest(art)["gc_floor"] == 2
    assert tio.next_version(art) == jio.next_version(art) == 3
    assert tio.gc_orphans(str(tmp_path / "missing")) == []


def test_manifest_written_after_table(tmp_path):
    p = _payload()
    tio.publish_table(str(tmp_path), p["emb"], p["valid"])
    m = tio.load_manifest(str(tmp_path))
    for e in m["versions"]:
        path = tmp_path / e["file"]
        assert path.exists()
        with np.load(path) as data:
            assert "emb" in data.files
    assert (tmp_path / tio.MANIFEST_NAME).exists()


# ----------------------------------------------------- worker and tree state
@pytest.mark.parametrize("writer,reader", [(tio, jio), (jio, tio)],
                         ids=["port->repro", "repro->port"])
def test_worker_and_tree_node_state_across_packages(tmp_path, writer, reader):
    d = str(tmp_path)
    rng = np.random.default_rng(3)
    params = {"W": rng.normal(size=(6, 2)).astype(np.float32),
              "C": rng.normal(size=(6, 2)).astype(np.float32)}
    assert reader.load_worker_state(d, 3) is None
    assert writer.publish_worker_state(d, 3, params, {"epoch": 1, "chunk": 4}) == 1
    writer.publish_worker_state(d, 3, params, {"epoch": 1, "chunk": 5})
    arrays, cursor, version = reader.load_worker_state(d, 3)
    assert version == 2 and cursor == {"epoch": 1, "chunk": 5}
    for k in params:
        np.testing.assert_array_equal(arrays[k], params[k])
    assert reader.load_worker_state(d, 3, version=1)[1]["chunk"] == 4
    assert tio.worker_state_dir(d, 3) == jio.worker_state_dir(d, 3)

    assert reader.load_tree_node(d, 1, 0) is None
    writer.publish_tree_node(d, 0, 5, {"model": params["W"]}, meta={"fan_in": 2})
    writer.publish_tree_node(d, 1, 2, {"Y": params["C"]}, meta={"arrived": [4, 5]})
    assert reader.list_tree_nodes(d) == [(0, 5), (1, 2)]
    arrays, meta, v = reader.load_tree_node(d, 1, 2)
    np.testing.assert_array_equal(arrays["Y"], params["C"])
    assert meta["arrived"] == [4, 5] and meta["level"] == 1 and meta["index"] == 2 and v == 1
    assert tio.tree_node_dir(d, 1, 2) == jio.tree_node_dir(d, 1, 2)
