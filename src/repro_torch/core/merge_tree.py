"""Log-depth reduction-tree ALiR merge: O(log W) merge wallclock.

The counterpart of ``repro.core.merge_tree``. :class:`TreeAlirMerger`
replaces the flat solve over all W sub-models with a **reduction tree**
(``fan_in`` ≥ 2): leaves are the worker sub-models, each interior node
ALiR-merges its children's consensus tables as pseudo-sub-models (child
``valid`` = the pseudo-model's presence mask) and passes one ``(V, d)``
consensus upward. Nodes of one level are independent, so the critical
path is ``depth = ceil(log_fan_in W)`` node solves (:meth:`critical_path_s`
sums the slowest solve of each level).

Determinism and permutation invariance, by construction:

* **Topology** is a pure function of the sorted worker ids and
  ``fan_in`` (:func:`build_tree`); arrival order never enters.
* **Node solves are always cold**, keyed by ``fold_in(fold_in(base_key,
  level), index)``, so a node solved the moment its children completed is
  bitwise the same node solved at :meth:`~TreeAlirMerger.final` time.
* Nodes are solved one by one, never batched across a level: a batched
  solve and a loop of single solves are not bitwise equal.

What flows upward: the node's consensus ``Y``, ``valid`` (union presence
over its arrived workers), the per-worker ``mask`` rows, and the
**composed** worker→node maps ``W_w^node = W_w · W_c``, so ``Y_node @
(W_w^node)ᵀ`` reconstructs worker *w*'s rows from any level
(:func:`reconstruct_worker`).

Elastic semantics are tree-node policies: the ``deadline`` closes the
whole tree's window; a node with only some children arrived solves over
those (a single present child passes through untouched); ``quorum``
applies at the root. With a ``state_dir``, arrived leaves and solved
interior nodes are published as versioned artifacts
(:func:`repro_torch.checkpoint.io.publish_tree_node`, the reference's
format) and a restarted merger reloads and reuses them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch import prng
from repro_torch.checkpoint.io import list_tree_nodes, load_tree_node, publish_tree_node
from repro_torch.core.merge import (
    MergeConfig,
    MergeResult,
    Merger,
    StackedModels,
    _alir_solve,
    alir_transforms,
)


# ---------------------------------------------------------------------------
# Topology — a pure function of (sorted worker ids, fan_in).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TreeNode:
    """One reduction-tree node: ``level`` 0 = leaves, the root is the
    single node of the top level. ``worker_ids`` is the (ascending) span
    of workers the subtree covers."""

    level: int
    index: int
    worker_ids: tuple[int, ...]
    children: tuple["TreeNode", ...] = ()

    @property
    def is_leaf(self) -> bool:
        return not self.children


def build_tree(worker_ids, fan_in: int = 2) -> TreeNode:
    """The deterministic reduction tree over ``worker_ids``: leaves in
    ascending id order, consecutive ``fan_in``-groups per level, repeated
    to a single root."""
    ids = sorted({int(w) for w in worker_ids})
    if not ids:
        raise ValueError("cannot build a reduction tree over zero workers")
    if fan_in < 2:
        raise ValueError(f"fan_in must be >= 2, got {fan_in}")
    level = [TreeNode(level=0, index=i, worker_ids=(w,))
             for i, w in enumerate(ids)]
    depth = 0
    while len(level) > 1:
        depth += 1
        nxt = []
        for i in range(0, len(level), fan_in):
            group = tuple(level[i:i + fan_in])
            covered = tuple(w for g in group for w in g.worker_ids)
            nxt.append(TreeNode(level=depth, index=len(nxt),
                                worker_ids=covered, children=group))
        level = nxt
    return level[0]


def tree_levels(root: TreeNode) -> list[list[TreeNode]]:
    """All nodes grouped by level, ``[leaves, ..., [root]]``."""
    by_level: dict[int, list[TreeNode]] = {}

    def walk(node: TreeNode) -> None:
        by_level.setdefault(node.level, []).append(node)
        for c in node.children:
            walk(c)

    walk(root)
    return [sorted(by_level[lvl], key=lambda n: n.index)
            for lvl in sorted(by_level)]


def tree_depth(root: TreeNode) -> int:
    """Number of solve levels above the leaves."""
    return root.level


# ---------------------------------------------------------------------------
# Node results — what flows upward.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class NodeResult:
    """One solved tree node. ``worker_ids`` are the **arrived** workers
    the node covers (ascending); ``mask`` and ``transforms`` rows follow
    that order."""

    level: int
    index: int
    worker_ids: tuple[int, ...]
    Y: torch.Tensor                 # (V, d) node consensus; invalid rows zeroed
    valid: torch.Tensor             # (V,) union presence over covered workers
    mask: torch.Tensor              # (k, V) per-worker presence
    transforms: torch.Tensor        # (k, d, d) composed worker → node maps
    disps: torch.Tensor | None      # ALiR trace of this node's solve (leaves: None)


def reconstruct_worker(result, worker_id: int) -> torch.Tensor:
    """Worker ``worker_id``'s full table in its own space from any node's
    consensus: ``Y @ W_wᵀ`` with the composed transform. Accepts a
    :class:`NodeResult` or a root :class:`MergeResult`."""
    ids = tuple(result.worker_ids)
    if worker_id not in ids:
        raise KeyError(f"worker {worker_id} not covered by this node "
                       f"(has {ids})")
    W = result.transforms[ids.index(worker_id)]
    return result.Y @ W.T


class TreeAlirMerger(Merger):
    """ALiR through the reduction tree, behind the :class:`Merger`
    protocol. Batch use (``merge``) builds the tree over the stack's
    workers and solves bottom-up; incremental use (``add``/``fold``/
    ``final``) re-solves a node only when the set of arrived workers under
    it changed, so an arrival costs one root path of node solves.

    Args:
        config: the shared :class:`MergeConfig` (``fan_in`` and ``shard``
            are the tree dials).
        workers: the **expected** worker ids; fixes the topology up front
            (arrivals take their final leaf positions). ``None`` derives it
            from the workers arrived so far (``merge``: from the stack).
        key: explicit base key (default ``config.prng_key()``).
        state_dir: persist leaves and solved interior nodes here (atomic
            versioned artifacts) for restartable merges.
        resume: reload persisted state from ``state_dir`` on construction.
        device: where the tables live (the GPU unless ``"cpu"``).
    """

    name = "alir_tree"

    def __init__(self, config: MergeConfig | None = None, *, workers=None, key=None,
                 clock=None, state_dir: str | None = None, resume: bool = True,
                 device=None):
        super().__init__(config, clock=clock, device=device)
        self._key_override = key
        self._workers = (tuple(sorted({int(w) for w in workers}))
                         if workers is not None else None)
        # node cache: (level, index) -> (arrived-signature, NodeResult)
        self._cache: dict[tuple[int, int], tuple[tuple[int, ...], NodeResult]] = {}
        self.state_dir = state_dir
        self.stats = {"solved": 0, "passthrough": 0, "loaded": 0, "node_s": {}}
        if state_dir and resume:
            self._load_state()

    @property
    def key(self):
        return (self._key_override if self._key_override is not None
                else self.config.prng_key())

    def _node_key(self, node: TreeNode):
        """Per-node key — a pure function of the node's position."""
        return prng.fold_in(prng.fold_in(self.key, node.level), node.index)

    # -- the Merger protocol ----------------------------------------------
    def merge(self, stacked: StackedModels, *,
              worker_ids: tuple[int, ...] | None = None) -> MergeResult:
        """One-shot batch tree merge of a stack (no state shared with
        incremental folds)."""
        ids = (tuple(int(w) for w in worker_ids)
               if worker_ids is not None else tuple(range(stacked.n)))
        if len(ids) != stacked.n:
            raise ValueError(f"{len(ids)} worker ids for {stacked.n} sub-models")
        scratch = TreeAlirMerger(self.config, workers=ids, key=self._key_override,
                                 device=self.device)
        stacked = stacked.to(self.device)
        for i in sorted(range(len(ids)), key=lambda i: ids[i]):
            scratch.add(ids[i], stacked.models[i], stacked.mask[i], fold=False)
        res = scratch.fold()
        self.stats["solved"] += scratch.stats["solved"]
        self.stats["passthrough"] += scratch.stats["passthrough"]
        self.stats["node_s"].update(scratch.stats["node_s"])
        return res

    def fold(self, warm: bool | None = None) -> MergeResult:
        """Solve (or reuse) the tree over everything arrived; nodes always
        solve cold, so ``warm`` is ignored."""
        del warm
        if not self._models:
            raise ValueError("no sub-models have arrived yet")
        res = self._node_result(self._topology())
        return MergeResult(worker_ids=res.worker_ids, emb=res.Y, valid=res.valid,
                           disps=res.disps, mask=res.mask, transforms=res.transforms)

    def node(self, level: int, index: int) -> NodeResult | None:
        """A solved node (``None`` if not solved yet)."""
        hit = self._cache.get((level, index))
        return hit[1] if hit else None

    def critical_path_s(self) -> float:
        """Sum over levels of the slowest node solve at that level — the
        wallclock when each level's nodes run concurrently."""
        per_level: dict[int, float] = {}
        for (lvl, _), s in self.stats["node_s"].items():
            per_level[lvl] = max(per_level.get(lvl, 0.0), s)
        return sum(per_level.values())

    # -- solving -----------------------------------------------------------
    def _topology(self) -> TreeNode:
        return build_tree(self._workers or self.worker_ids, self.config.fan_in)

    def _on_arrival(self, worker_id: int) -> None:
        if self.state_dir:
            model, mask = self._models[worker_id]
            publish_tree_node(self.state_dir, 0, worker_id, {"model": model, "mask": mask},
                              meta={"worker": worker_id, "fan_in": self.config.fan_in})

    def _node_result(self, node: TreeNode) -> NodeResult | None:
        """Solve the subtree over its arrived workers, reusing cached
        results whose arrived-signature is unchanged; ``None`` when no
        worker under the node has arrived."""
        if node.is_leaf:
            w = node.worker_ids[0]
            if w not in self._models:
                return None
            hit = self._cache.get((0, node.index))
            if hit and hit[0] == (w,):
                return hit[1]
            res = self._leaf_result(node)
            self._cache[(0, node.index)] = ((w,), res)
            return res
        kids = [r for r in (self._node_result(c) for c in node.children)
                if r is not None]
        if not kids:
            return None
        sig = tuple(w for r in kids for w in r.worker_ids)
        hit = self._cache.get((node.level, node.index))
        if hit and hit[0] == sig:
            return hit[1]
        res = self._solve_node(node, kids)
        self._cache[(node.level, node.index)] = (sig, res)
        if self.state_dir and res.level > 0:
            self._persist_node(res, sig)
        return res

    def _leaf_result(self, node: TreeNode) -> NodeResult:
        w = node.worker_ids[0]
        model, mask = self._models[w]
        Yl = model * mask[:, None]
        d = model.shape[1]
        return NodeResult(
            level=0, index=node.index, worker_ids=(w,), Y=Yl, valid=mask,
            mask=mask[None],
            transforms=torch.eye(d, dtype=Yl.dtype, device=Yl.device)[None],
            disps=None)

    def _solve_node(self, node: TreeNode, kids: list[NodeResult]) -> NodeResult:
        ids = tuple(w for r in kids for w in r.worker_ids)
        if len(kids) == 1:
            # a single present child passes through (an ALiR "solve" of one
            # model would only rotate it toward the init)
            c = kids[0]
            self.stats["passthrough"] += 1
            return NodeResult(level=node.level, index=node.index, worker_ids=ids,
                              Y=c.Y, valid=c.valid, mask=c.mask,
                              transforms=c.transforms, disps=c.disps)
        cfg = self.config
        child_stack = StackedModels(models=torch.stack([c.Y for c in kids]),
                                    mask=torch.stack([c.valid for c in kids]))
        t0 = time.perf_counter()
        Y, valid, disps = _alir_solve(
            child_stack, init=cfg.init, max_iters=cfg.max_iters, tol=cfg.tol,
            key=self._node_key(node), shard=cfg.shard)
        Wc = alir_transforms(child_stack, Y, shard=cfg.shard)
        # compose: worker → child (c.transforms), then child → node (Wc)
        transforms = torch.cat([c.transforms @ Wc[i] for i, c in enumerate(kids)])
        if transforms.device.type == "cuda":
            torch.cuda.synchronize(transforms.device)
        self.stats["solved"] += 1
        self.stats["node_s"][(node.level, node.index)] = time.perf_counter() - t0
        return NodeResult(level=node.level, index=node.index, worker_ids=ids, Y=Y,
                          valid=valid, mask=torch.cat([c.mask for c in kids]),
                          transforms=transforms, disps=disps)

    # -- persistence -------------------------------------------------------
    def _persist_node(self, res: NodeResult, sig: tuple[int, ...]) -> None:
        arrays = {"Y": res.Y, "valid": res.valid, "mask": res.mask,
                  "transforms": res.transforms}
        if res.disps is not None:
            arrays["disps"] = res.disps
        publish_tree_node(self.state_dir, res.level, res.index, arrays,
                          meta={"arrived": list(sig), "fan_in": self.config.fan_in,
                                "level": res.level, "index": res.index})

    def _load_state(self) -> None:
        """Reload persisted leaves (arrivals) and interior solves onto the
        merger's device; a reloaded node is only *used* when its
        arrived-signature still matches, so stale persisted nodes are
        harmless. Nodes persisted with another ``fan_in`` are skipped."""
        def dev(a, dtype=None):
            return torch.from_numpy(a).to(self.device, dtype)

        for level, index in list_tree_nodes(self.state_dir):
            loaded = load_tree_node(self.state_dir, level, index)
            if loaded is None:
                continue
            arrays, meta, _ = loaded
            if meta.get("fan_in") != self.config.fan_in:
                continue
            if level == 0:
                self._models[int(index)] = (dev(arrays["model"]),
                                            dev(arrays["mask"], torch.bool))
            else:
                sig = tuple(int(w) for w in meta.get("arrived", ()))
                res = NodeResult(
                    level=level, index=index, worker_ids=sig, Y=dev(arrays["Y"]),
                    valid=dev(arrays["valid"], torch.bool),
                    mask=dev(arrays["mask"], torch.bool),
                    transforms=dev(arrays["transforms"]),
                    disps=dev(arrays["disps"]) if "disps" in arrays else None)
                self._cache[(level, index)] = (sig, res)
            self.stats["loaded"] += 1


# Register with the merge registry (get_merger imports lazily; a direct
# import of this module keeps the mapping consistent too).
from repro_torch.core import merge as _merge_mod  # noqa: E402

_merge_mod.MERGERS.setdefault("alir_tree", TreeAlirMerger)
