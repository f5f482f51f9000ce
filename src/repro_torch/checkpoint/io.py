"""Checkpointing and the versioned merged-table artifact.

The counterpart of ``repro.checkpoint.io``; the on-disk format is the
reference's byte for byte, so each package loads what the other writes.
Two layers live here:

1. **Pytree checkpoints** (:func:`save_checkpoint` /
   :func:`load_checkpoint`): flat-key .npz save/restore for arbitrary
   dict/list/tuple trees. A torch tensor leaf is saved as
   ``.detach().cpu().numpy()``; leaves come back as numpy arrays and the
   caller moves them to its device.

2. **Published embedding artifacts** (:func:`publish_table` /
   :func:`load_table`): the handoff point between the merge phase and
   the serving tier. An artifact directory holds monotonically
   versioned, immutable table files plus a ``MANIFEST.json`` naming the
   latest complete one. Both the table file and the manifest are
   written to a temp name in the same directory and atomically
   ``os.replace``d, so a reader (or a crash at any instant) can only
   ever observe:

   * no manifest — nothing published yet;
   * a manifest pointing at a fully-written table file.

   A partial table write leaves only a ``.tmp-``-prefixed file that
   readers never look at; a crash *between* the table rename and the
   manifest rename leaves an orphan table file that readers ignore
   (manifest is the source of truth) and whose version number is never
   reused (:func:`next_version` scans files as well as the manifest).

**bfloat16.** numpy has no bfloat16: the JAX package writes such a leaf
through ``ml_dtypes`` as a raw two-byte void array (``|V2``) and reads it
back as one, its dtype lost. The port refuses both directions with a
``TypeError``: saving a tensor whose dtype numpy lacks, and loading a
void array. Cast to float32 (or view the bits as int16) before saving.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

_SEP = "/"


def _to_numpy(value, name: str) -> np.ndarray:
    """A leaf or artifact array as numpy (tensors copied to the host);
    ``TypeError`` for a dtype numpy cannot name (see the module doc)."""
    if isinstance(value, torch.Tensor):
        try:
            value = value.detach().cpu().numpy()
        except TypeError as e:          # bfloat16 and other dtypes numpy lacks
            raise TypeError(
                f"{name!r}: a {value.dtype} tensor has no numpy dtype; cast it "
                f"(e.g. .float()) before saving") from e
    arr = np.asarray(value)
    if arr.dtype.kind == "V":
        raise TypeError(
            f"{name!r}: raw void dtype {arr.dtype.str} (a bfloat16 array from "
            f"ml_dtypes?) cannot round-trip through .npz; cast it first")
    return arr


def _checked(key: str, arr: np.ndarray) -> np.ndarray:
    if arr.dtype.kind == "V":
        raise TypeError(
            f"{key!r} was saved as raw void dtype {arr.dtype.str}, its dtype lost "
            f"(the JAX package writes a bfloat16 leaf so); the port does not guess "
            f"it back: re-save the leaf as float32")
    return arr


def _flatten(tree) -> dict[str, np.ndarray]:
    out = {}

    def walk(path, node):
        if isinstance(node, dict):
            if not node:
                out[_SEP.join(path) + "@emptydict"] = np.zeros(0)
                return
            for k in sorted(node):
                walk(path + [str(k)], node[k])
        elif isinstance(node, (list, tuple)):
            if not node:
                out[_SEP.join(path) + "@emptylist"] = np.zeros(0)
                return
            for i, v in enumerate(node):
                walk(path + [f"#{i}"], v)
        elif node is None:
            out[_SEP.join(path) + "@none"] = np.zeros(0)
        else:
            key = _SEP.join(path)
            out[key] = _to_numpy(node, key)

    walk([], tree)
    return out


def _unflatten(flat: dict[str, np.ndarray]):
    _EMPTY_LIST = object()
    _EMPTY_DICT = object()
    root: dict = {}
    for key, val in flat.items():
        for tag, marker in (("@none", None), ("@emptylist", _EMPTY_LIST),
                            ("@emptydict", _EMPTY_DICT)):
            if key.endswith(tag):
                key = key[: -len(tag)]
                val = marker
                break
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if node is _EMPTY_LIST:
            return []
        if node is _EMPTY_DICT:
            return {}
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(k.startswith("#") for k in keys):
            return [fix(node[f"#{i}"]) for i in range(len(keys))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def save_checkpoint(path: str, tree, step: int | None = None,
                    extra: dict | None = None) -> None:
    """Save a dict/list/tuple pytree of arrays or tensors to ``path``
    (.npz) plus a ``<path>.meta.json`` sidecar carrying ``step`` and
    ``extra``. Not atomic — use :func:`publish_table` for tables a live
    reader may race with."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(tree)
    np.savez(path, **flat)
    meta = {"step": step, **(extra or {})}
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)


def load_checkpoint(path: str):
    """Restore a :func:`save_checkpoint` pytree (numpy leaves). Returns
    ``(tree, meta)`` where ``meta`` is the sidecar dict (empty if the
    sidecar is gone)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as data:
        tree = _unflatten({k: _checked(k, data[k]) for k in data.files})
    meta = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return tree, meta


def latest_step_path(ckpt_dir: str, prefix: str = "step_") -> str | None:
    """Path of the highest-step ``<prefix>N.npz`` checkpoint in
    ``ckpt_dir``, or ``None`` if there is none."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for f in os.listdir(ckpt_dir):
        if f.startswith(prefix) and f.endswith(".npz"):
            try:
                steps.append((int(f[len(prefix):-4]), f))
            except ValueError:
                pass
    if not steps:
        return None
    return os.path.join(ckpt_dir, max(steps)[1])


# ---------------------------------------------------------------------------
# Versioned merged-table artifacts (the merge → serve handoff).
# ---------------------------------------------------------------------------
MANIFEST_NAME = "MANIFEST.json"
_TABLE_FMT = "table_v{:06d}.npz"
_TMP_PREFIX = ".tmp-"
# Optional serving sidecars of publish_table, absent from the file when
# not published.
_OPTIONAL_KEYS = ("word_ids", "worker_ids", "mask", "transforms", "models")


@dataclass(frozen=True)
class ServableTable:
    """One complete, immutable published table version (numpy arrays).

    Required payload:
        ``emb (V, d)``   — the merged embedding table;
        ``valid (V,)``   — rows the table actually covers (union
                           presence of the folded sub-models).

    Optional serving sidecars (``None`` when not published):
        ``word_ids (V,)``      — raw word id per table row (the external
                                 query namespace);
        ``worker_ids (n,)``    — which workers each sub-model axis index
                                 corresponds to, canonical order;
        ``mask (n, V)``        — per-sub-model presence;
        ``transforms (n,d,d)`` — ALiR alignment maps ``W_i``, enough to
                                 reconstruct any sub-model's *missing*
                                 rows on the fly (``Y[w] @ W_i.T``);
        ``models (n, V, d)``   — the aligned-input sub-models themselves
                                 (needed to serve a sub-model's
                                 *present* rows in its own space).
    """

    emb: np.ndarray
    valid: np.ndarray
    version: int
    meta: dict = field(default_factory=dict)
    word_ids: np.ndarray | None = None
    worker_ids: np.ndarray | None = None
    mask: np.ndarray | None = None
    transforms: np.ndarray | None = None
    models: np.ndarray | None = None

    @property
    def dim(self) -> int:
        """Embedding dimensionality of the published table."""
        return int(self.emb.shape[1])


def _table_path(artifact_dir: str, version: int) -> str:
    return os.path.join(artifact_dir, _TABLE_FMT.format(version))


def _atomic_write_bytes(path: str, write_fn) -> None:
    """Write via a same-directory temp file + ``os.replace``. ``write_fn``
    receives the temp path; on any failure the temp file is removed (a
    crash can still leave one behind — readers never match the
    ``.tmp-`` prefix, and publishers overwrite/ignore it)."""
    d, name = os.path.split(path)
    tmp = os.path.join(d, f"{_TMP_PREFIX}{name}.{os.getpid()}")
    try:
        write_fn(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_manifest(artifact_dir: str) -> dict | None:
    """The artifact directory's manifest, or ``None`` before the first
    completed publish."""
    path = os.path.join(artifact_dir, MANIFEST_NAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _scan_table_versions(artifact_dir: str) -> list[int]:
    if not os.path.isdir(artifact_dir):
        return []
    out = []
    for f in os.listdir(artifact_dir):
        if f.startswith("table_v") and f.endswith(".npz"):
            try:
                out.append(int(f[len("table_v"):-4]))
            except ValueError:
                pass
    return sorted(out)


def next_version(artifact_dir: str) -> int:
    """The next free (monotonic) version number: past the manifest's
    latest AND past any orphan table file a crash-between-renames left
    behind — an orphan's number is never reused, so a version string
    uniquely names one byte-content. :func:`gc_orphans` removes orphan
    *files* but records their high-water mark in the manifest
    (``gc_floor``), so collection does not reopen their numbers."""
    manifest = load_manifest(artifact_dir)
    latest = manifest["latest"] if manifest else 0
    floor = (manifest or {}).get("gc_floor", 0)
    orphans = _scan_table_versions(artifact_dir)
    return max([latest, floor] + orphans) + 1


def gc_orphans(artifact_dir: str) -> list[str]:
    """Remove crash debris from an artifact directory; returns the
    removed file names.

    Two kinds of debris can exist, both invisible to readers:

    * ``.tmp-``-prefixed partial writes (a crash mid-:func:`_atomic_write_bytes`);
    * complete-but-unmanifested table files — a crash landed the table
      rename but died before the manifest rename ever pointed at it.

    Collection never touches a manifested version, and it records the
    highest collected orphan version as the manifest's ``gc_floor`` so
    :func:`next_version` still never reuses a collected number. Like
    publishing itself, gc assumes a single writer per directory.
    """
    if not os.path.isdir(artifact_dir):
        return []
    manifest = load_manifest(artifact_dir)
    manifested = {e["version"] for e in (manifest or {}).get("versions", [])}
    removed: list[str] = []
    orphan_hi = 0
    for f in sorted(os.listdir(artifact_dir)):
        path = os.path.join(artifact_dir, f)
        if f.startswith(_TMP_PREFIX):
            os.remove(path)
            removed.append(f)
        elif f.startswith("table_v") and f.endswith(".npz"):
            try:
                v = int(f[len("table_v"):-4])
            except ValueError:
                continue
            if v not in manifested:
                os.remove(path)
                removed.append(f)
                orphan_hi = max(orphan_hi, v)
    if orphan_hi:
        manifest = manifest or {"latest": 0, "versions": []}
        manifest["gc_floor"] = max(manifest.get("gc_floor", 0), orphan_hi)
        _atomic_write_bytes(
            os.path.join(artifact_dir, MANIFEST_NAME),
            lambda tmp: _write_json(tmp, manifest))
    return removed


def publish_arrays(artifact_dir: str, arrays: dict, *,
                   meta: dict | None = None) -> int:
    """Atomically publish one version of a dict of arrays or tensors —
    the core :func:`publish_table` (and the per-worker and tree-node
    state) build on. The .npz lands under a temp name and is renamed into
    place *before* the manifest rename points at it, so a reader (or a
    crash at any instant) only ever observes the previous complete
    version. Returns the new version number."""
    os.makedirs(artifact_dir, exist_ok=True)
    version = next_version(artifact_dir)
    arrays = {k: _to_numpy(v, k) for k, v in arrays.items()}
    table_path = _table_path(artifact_dir, version)
    _atomic_write_bytes(table_path, lambda tmp: _savez_to(tmp, arrays))

    manifest = load_manifest(artifact_dir) or {"latest": 0, "versions": []}
    entry = {"version": version, "file": os.path.basename(table_path),
             "created_unix": time.time(), **(meta or {})}
    manifest["versions"].append(entry)
    manifest["latest"] = version
    _atomic_write_bytes(
        os.path.join(artifact_dir, MANIFEST_NAME),
        lambda tmp: _write_json(tmp, manifest))
    return version


def load_arrays(artifact_dir: str, version: int | None = None
                ) -> tuple[dict, dict, int]:
    """Load a :func:`publish_arrays` version (``None`` = manifest's
    latest). Returns ``(arrays, entry_meta, version)``; raises
    ``FileNotFoundError`` when nothing is published — orphan files are
    not loadable state."""
    manifest = load_manifest(artifact_dir)
    if manifest is None or not manifest["versions"]:
        raise FileNotFoundError(
            f"no published version in {artifact_dir!r} (no {MANIFEST_NAME})")
    by_version = {e["version"]: e for e in manifest["versions"]}
    version = manifest["latest"] if version is None else version
    if version not in by_version:
        raise FileNotFoundError(
            f"version {version} not in manifest (has {sorted(by_version)})")
    entry = by_version[version]
    with np.load(os.path.join(artifact_dir, entry["file"]),
                 allow_pickle=False) as data:
        arrays = {k: _checked(k, data[k]) for k in data.files}
    meta = {k: v for k, v in entry.items() if k not in ("version", "file")}
    return arrays, meta, version


def publish_table(
    artifact_dir: str,
    emb,
    valid,
    *,
    word_ids=None,
    worker_ids=None,
    mask=None,
    transforms=None,
    models=None,
    meta: dict | None = None,
) -> int:
    """Atomically publish one table version (arrays or tensors, any
    device); returns its version number.

    Write order is the crash-safety argument: (1) the table .npz goes to
    a temp name and is renamed into place — a reader can never open a
    partial table; (2) only then is the manifest (also temp + rename)
    updated to point at it — a crash between (1) and (2) leaves the
    previous version live and the new file an ignored, never-reused
    orphan. Concurrent publishers to the same directory are not
    supported (one merge process per artifact dir).
    """
    arrays = {"emb": _to_numpy(emb, "emb"), "valid": _to_numpy(valid, "valid")}
    for k, v in (("word_ids", word_ids), ("worker_ids", worker_ids),
                 ("mask", mask), ("transforms", transforms),
                 ("models", models)):
        if v is not None:
            arrays[k] = _to_numpy(v, k)
    return publish_arrays(
        artifact_dir, arrays,
        meta={"rows": int(arrays["emb"].shape[0]),
              "dim": int(arrays["emb"].shape[1]),
              "n_models": int(arrays["mask"].shape[0]) if mask is not None
              else None,
              **(meta or {})})


def _savez_to(path: str, arrays: dict) -> None:
    # np.savez appends '.npz' to bare string names; temp names end in
    # '.<pid>', so hand it an open file object, which it never renames.
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def load_table(artifact_dir: str, version: int | None = None) -> ServableTable:
    """Load a published table — always a complete one.

    ``version=None`` loads the manifest's latest. Raises
    ``FileNotFoundError`` if nothing has been published (or the named
    version was never *manifested* — orphan files are not loadable
    state)."""
    arrays, meta, version = load_arrays(artifact_dir, version)
    return ServableTable(
        emb=arrays["emb"], valid=arrays["valid"].astype(bool),
        version=version, meta=meta,
        **{k: arrays.get(k) for k in _OPTIONAL_KEYS})


# ---------------------------------------------------------------------------
# Per-worker elastic training state (table shards + cursor).
# ---------------------------------------------------------------------------
_WORKER_DIR_FMT = "worker_{:04d}"


def worker_state_dir(state_dir: str, worker: int) -> str:
    """The per-worker artifact directory under an elastic state root —
    each worker gets its own versioned manifest, so workers checkpoint
    concurrently without sharing a writer."""
    return os.path.join(state_dir, _WORKER_DIR_FMT.format(worker))


def publish_worker_state(state_dir: str, worker: int, params: dict,
                         cursor: dict) -> int:
    """Atomically checkpoint one worker's training state: its table
    shards (``params`` — a flat dict of arrays or tensors, typically
    ``{"W", "C"}``) plus its stream cursor as manifest metadata. Same
    publish-then-manifest crash ordering as :func:`publish_table`.
    Returns the state version number."""
    return publish_arrays(
        worker_state_dir(state_dir, worker), dict(params),
        meta={"worker": int(worker),
              "cursor": {k: int(v) for k, v in cursor.items()}})


def load_worker_state(state_dir: str, worker: int,
                      version: int | None = None
                      ) -> tuple[dict, dict, int] | None:
    """Load a worker's last complete checkpoint: ``(params, cursor,
    version)``, or ``None`` when the worker has never checkpointed (a
    fresh start)."""
    wdir = worker_state_dir(state_dir, worker)
    try:
        arrays, meta, version = load_arrays(wdir, version)
    except FileNotFoundError:
        return None
    return arrays, dict(meta["cursor"]), version


# ---------------------------------------------------------------------------
# Reduction-tree merge state (restartable hierarchical merges).
# ---------------------------------------------------------------------------
_TREE_NODE_DIR_FMT = "tree_L{:02d}_N{:05d}"


def tree_node_dir(state_dir: str, level: int, index: int) -> str:
    """The per-node artifact directory for a reduction-tree merge
    (:class:`repro_torch.core.merge_tree.TreeAlirMerger`) under a merge
    state root. Level 0 holds arrived leaves (``index`` = worker id);
    higher levels hold solved interior nodes (``index`` = node index at
    that level). Each node versions independently."""
    return os.path.join(state_dir, _TREE_NODE_DIR_FMT.format(level, index))


def publish_tree_node(state_dir: str, level: int, index: int,
                      arrays: dict, *, meta: dict | None = None) -> int:
    """Atomically persist one tree node's arrays (leaf sub-model or
    solved interior consensus) with the publish-then-manifest crash
    ordering: a restart mid-merge only ever reloads complete nodes.
    Returns the node's version number."""
    return publish_arrays(
        tree_node_dir(state_dir, level, index), dict(arrays),
        meta={"level": int(level), "index": int(index), **(meta or {})})


def load_tree_node(state_dir: str, level: int, index: int,
                   version: int | None = None
                   ) -> tuple[dict, dict, int] | None:
    """Load a persisted tree node: ``(arrays, meta, version)``, or
    ``None`` when the node was never published."""
    try:
        return load_arrays(tree_node_dir(state_dir, level, index), version)
    except FileNotFoundError:
        return None


def list_tree_nodes(state_dir: str) -> list[tuple[int, int]]:
    """All persisted ``(level, index)`` tree nodes under ``state_dir``,
    leaves first (ascending level, then index)."""
    if not os.path.isdir(state_dir):
        return []
    out = []
    for name in os.listdir(state_dir):
        if not name.startswith("tree_L"):
            continue
        try:
            level, index = name[len("tree_L"):].split("_N")
            out.append((int(level), int(index)))
        except ValueError:
            continue
    return sorted(out)
