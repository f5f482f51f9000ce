"""The Merge phase — a :class:`Merger` API over Concat, PCA, averaging
and ALiR (the paper's contribution), in torch.

The counterpart of ``repro.core.merge``. All merges operate on *stacked*
sub-models: ``models (n, V, d)`` over the **union** vocabulary, plus a
presence ``mask (n, V)``. Concat/PCA use the intersection rows; ALiR uses
the union and reconstructs missing rows.

ALiR (Alternating Linear Regression, paper §3.3.2), per iteration:

1. *Estimate translation* — per sub-model, Orthogonal Procrustes on its
   present rows: W_i = UVᵀ from the SVD of M_i'ᵀ Y'.
2. *Estimate missing values* — M_i* = Y* W_iᵀ.
3. *Update joint embedding* — Y ← mean over i of (M_i W_i), with the
   reconstructed rows for the missing parts.

It stops (freezing Y and the reported displacement) once the change in
the mean normalized displacement drops below ``tol``.

**The Merger API**, as the reference's::

    merger = get_merger("alir", quorum=3, deadline=60.0)   # MergeConfig dials
    out = merger.merge(stacked)                  # batch: all at once
    for worker_id, (model, mask) in arrivals:    # incremental: any order
        res = merger.add(worker_id, model, mask) # servable consensus now
    final = merger.final()                       # canonical cold solve

Registered mergers (:data:`MERGER_NAMES`): ``"alir"``, ``"alir_tree"``
(the reduction tree of :mod:`repro_torch.core.merge_tree`), ``"average"``,
``"concat"``, ``"pca"``. One frozen :class:`MergeConfig` carries every
dial. A merger's tensors live on its device (the GPU unless
``device="cpu"``). The free functions ``merge_alir`` / ``merge_concat`` /
``merge_pca`` / ``merge_average`` are deprecated shims over the internals.

SVD and eigh go to ``torch.linalg``. Float32 matrix products here run in
full float32 on the GPU: this module sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False`` when it is imported.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch import prng
from repro_torch.device import resolve_device
from repro_torch.spans import span

# TF32 keeps ~3 decimal digits; the merge is held to float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclass(frozen=True)
class StackedModels:
    """``n`` sub-models on the union vocabulary: ``(n, V, d)`` rows plus
    a ``(n, V)`` bool presence mask (rows are garbage where absent)."""

    models: torch.Tensor
    mask: torch.Tensor

    @property
    def n(self) -> int:
        return self.models.shape[0]

    def intersection(self) -> torch.Tensor:
        """(V,) bool — words present in *every* sub-model."""
        return torch.all(self.mask, dim=0)

    def union_present(self) -> torch.Tensor:
        """(V,) bool — words present in *at least one* sub-model."""
        return torch.any(self.mask, dim=0)

    def to(self, device) -> "StackedModels":
        return StackedModels(models=self.models.to(device),
                             mask=self.mask.to(device).bool())


def stack_models(models, masks) -> StackedModels:
    """Stack per-worker ``(V, d)`` arrays + ``(V,)`` masks."""
    m = torch.as_tensor(np.stack([np.asarray(x) for x in models]))
    k = torch.as_tensor(np.stack([np.asarray(x) for x in masks])).bool()
    return StackedModels(models=m, mask=k)


# ---------------------------------------------------------------------------
# Concat / PCA / averaging
# ---------------------------------------------------------------------------
def _merge_concat(stacked: StackedModels):
    n, V, d = stacked.models.shape
    emb = stacked.models.permute(1, 0, 2).reshape(V, n * d)
    valid = stacked.intersection()
    return emb * valid[:, None], valid


def _merge_pca(stacked: StackedModels, out_dim: int):
    # Economy form: eigendecomposition of the (nd × nd) covariance over
    # intersection rows.
    emb, valid = _merge_concat(stacked)
    vf = valid.to(emb.dtype)
    cnt = torch.clamp_min(vf.sum(), 1)
    mean = (emb * vf[:, None]).sum(0) / cnt
    X = (emb - mean) * vf[:, None]
    cov = X.T @ X / cnt
    _, eigvec = torch.linalg.eigh(cov)                 # ascending
    comps = eigvec[:, -out_dim:].flip(1)               # (nd, out_dim)
    return (X @ comps) * vf[:, None], valid


def _merge_average(stacked: StackedModels):
    maskf = stacked.mask.to(stacked.models.dtype)
    num = (stacked.models * maskf[..., None]).sum(0)
    den = torch.clamp_min(maskf.sum(0), 1.0)
    return num / den[:, None], stacked.union_present()


# ---------------------------------------------------------------------------
# Orthogonal Procrustes and the Gram products
# ---------------------------------------------------------------------------
def orthogonal_procrustes(A: torch.Tensor, B: torch.Tensor,
                          weights: torch.Tensor | None = None) -> torch.Tensor:
    """W minimizing ‖A W − B‖_F (rows optionally weighted), W orthogonal."""
    if weights is not None:
        A = A * weights[:, None]
    U, _, Vt = torch.linalg.svd(A.T @ B, full_matrices=False)
    return U @ Vt


def gram_block_partials(A: torch.Tensor, B: torch.Tensor,
                        num_shards: int) -> torch.Tensor:
    """Per-row-block partial Grams ``(..., S, d_A, d_B)``: block ``s`` is
    ``A[s·blk:(s+1)·blk]ᵀ B[s·blk:(s+1)·blk]`` (rows zero-padded at the
    end to a multiple of ``S``). Leading batch dims broadcast."""
    V = A.shape[-2]
    S = int(num_shards)
    pad = (-V) % S
    if pad:
        A = torch.cat([A, A.new_zeros((*A.shape[:-2], pad, A.shape[-1]))], -2)
        B = torch.cat([B, B.new_zeros((*B.shape[:-2], pad, B.shape[-1]))], -2)
    blk = (V + pad) // S
    Ab = A.reshape(*A.shape[:-2], S, blk, A.shape[-1])
    Bb = B.reshape(*B.shape[:-2], S, blk, B.shape[-1])
    return Ab.transpose(-1, -2) @ Bb


def reduce_gram_partials(parts: torch.Tensor) -> torch.Tensor:
    """Sum ``(..., S, d, e)`` partials in **ascending block order**."""
    out = torch.zeros_like(parts[..., 0, :, :])
    for s in range(parts.shape[-3]):
        out = out + parts[..., s, :, :]
    return out


def sharded_gram(A: torch.Tensor, B: torch.Tensor, num_shards: int = 1) -> torch.Tensor:
    """``AᵀB`` as the fixed-order ``num_shards``-block reduction
    (``num_shards <= 1``: the plain dense product)."""
    if num_shards <= 1:
        return A.transpose(-1, -2) @ B
    return reduce_gram_partials(gram_block_partials(A, B, num_shards))


# ---------------------------------------------------------------------------
# ALiR
# ---------------------------------------------------------------------------
def _alir_iteration(Y: torch.Tensor, models: torch.Tensor, mask: torch.Tensor,
                    gram_shards: int = 1, group=None):
    """One ALiR round over all n models at once. Returns (Y_new,
    displacement, W (n,d,d)). With a process ``group``, the Grams go
    through :func:`repro_torch.sharding.merge.mesh_sharded_gram` (one
    ``all_gather``; bitwise the local ``sharded_gram`` at the same
    ``gram_shards``)."""
    maskf = mask.to(Y.dtype)[..., None]                 # (n, V, 1)
    A = models * maskf
    Byy = Y[None] * maskf
    if group is None:
        gram = sharded_gram(A, Byy, gram_shards)
    else:
        from repro_torch.sharding.merge import mesh_sharded_gram

        gram = mesh_sharded_gram(A, Byy, group, num_shards=gram_shards)
    U, _, Vt = torch.linalg.svd(gram, full_matrices=False)
    W = U @ Vt                                          # (n, d, d)
    aligned_present = models @ W                        # valid on present rows
    aligned_full = torch.where(maskf > 0, aligned_present, Y[None])
    num_rows = torch.clamp_min(maskf.sum(dim=(1, 2)), 1.0)
    disp = torch.linalg.vector_norm((Y[None] - aligned_present) * maskf,
                                    dim=(1, 2)) / torch.sqrt(num_rows * Y.shape[1])
    return aligned_full.mean(0), disp.mean(), W


def _alir_loop(Y0, models, mask, max_iters: int, tol: float,
               gram_shards: int = 1):
    """``max_iters`` rounds; once the displacement change drops below
    ``tol``, Y and the reported displacement freeze and the remaining
    rounds skip the SVDs. Returns (Y, disps (max_iters,))."""
    Y = Y0
    prev = torch.tensor(float("inf"), dtype=Y0.dtype, device=Y0.device)
    done = False
    disps = []
    for _ in range(max_iters):
        if done:
            disp = prev
        else:
            # the convergence test's host sync closes the round's span
            with span("repro_torch.merge.round"):
                Y, disp, _ = _alir_iteration(Y, models, mask, gram_shards)
                done = bool(torch.abs(prev - disp) < tol)
        prev = disp
        disps.append(disp)
    return Y, torch.stack(disps)


def alir_init(stacked: StackedModels, out_dim: int, init: str, key):
    """Initial ``(V, out_dim)`` consensus: "random" (paper init i) or
    "pca" — PCA on intersection rows, random elsewhere (init ii)."""
    n, V, d = stacked.models.shape
    device = stacked.models.device
    with span("repro_torch.merge.init"):
        if init == "random":
            return 0.1 * prng.normal(key, (V, out_dim), device=device)
        if init == "pca":
            pca_emb, valid = _merge_pca(stacked, out_dim)
            rnd = 0.1 * prng.normal(key, (V, out_dim), device=device)
            return torch.where(valid[:, None], pca_emb, rnd)
    raise ValueError(f"unknown init {init!r}")


def _alir_solve(stacked: StackedModels, out_dim: int | None = None,
                init: str = "pca", max_iters: int = 10, tol: float = 1e-4,
                key=None, Y0: torch.Tensor | None = None, shard: int = 1):
    """ALiR-merge a stack into one consensus table. Returns ``(Y (V,d),
    valid (V,), disps (max_iters,))``; invalid rows are zeroed."""
    n, V, d = stacked.models.shape
    out_dim = out_dim or d
    if out_dim != d:
        raise ValueError("ALiR aligns in the sub-model dimension; out_dim must equal d")
    if Y0 is None:
        key = key if key is not None else prng.PRNGKey(0)
        Y0 = alir_init(stacked, out_dim, init, key)
    elif tuple(Y0.shape) != (V, d):
        raise ValueError(f"warm-start Y0 has shape {tuple(Y0.shape)}, expected {(V, d)}")
    models = stacked.models * stacked.mask[..., None]
    Y, disps = _alir_loop(Y0, models, stacked.mask, max_iters, tol, shard)
    valid = stacked.union_present()
    return Y * valid[:, None], valid, disps


def alir_transforms(stacked: StackedModels, Y: torch.Tensor,
                    shard: int = 1) -> torch.Tensor:
    """Per-sub-model orthogonal maps ``W_i`` onto consensus ``Y``
    ``(n, d, d)``: one ALiR round's Procrustes step, Y unchanged."""
    with span("repro_torch.merge.maps"):
        _, _, Ws = _alir_iteration(Y, stacked.models * stacked.mask[..., None],
                                   stacked.mask, shard)
    return Ws


def reconstruct_missing(stacked: StackedModels, Y: torch.Tensor) -> torch.Tensor:
    """Completed models ``(n, V, d)``: present rows pass through,
    missing rows are M_i* = Y* W_iᵀ (paper §3.3.2 step 2)."""
    Ws = alir_transforms(stacked, Y)
    rec = Y[None] @ Ws.transpose(-1, -2)
    return torch.where(stacked.mask[..., None], stacked.models, rec)


# ---------------------------------------------------------------------------
# The Merger API: one config, one result type, one protocol.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class MergeConfig:
    """Every merge dial in one frozen config.

    Solver knobs (ALiR mergers): ``init`` / ``max_iters`` / ``tol`` /
    ``seed`` / ``warm_start``; ``out_dim`` is only consumed by the
    ``"pca"`` merger (ALiR aligns in the sub-model dimension).
    Arrival-policy knobs: ``quorum`` is the minimum number of arrived
    sub-models a :meth:`Merger.final` requires; ``deadline`` (seconds on
    the merger's clock, from construction) closes the arrival window —
    late arrivals are recorded, not folded. Scale knobs: ``fan_in`` is the
    reduction-tree arity; ``shard`` the Gram-accumulation block count
    (:func:`sharded_gram`) — both static dials that define the bits.
    """

    out_dim: int | None = None
    init: str = "pca"
    max_iters: int = 10
    tol: float = 1e-4
    seed: int = 0
    warm_start: bool = True
    quorum: int | None = None
    deadline: float | None = None
    fan_in: int = 2
    shard: int = 1

    def validated(self) -> "MergeConfig":
        """Raise on out-of-range dials; returns self for chaining."""
        if self.quorum is not None and self.quorum < 1:
            raise ValueError(f"quorum must be >= 1, got {self.quorum}")
        if self.deadline is not None and self.deadline < 0:
            raise ValueError(f"deadline must be >= 0, got {self.deadline}")
        if self.fan_in < 2:
            raise ValueError(f"fan_in must be >= 2, got {self.fan_in}")
        if self.shard < 1:
            raise ValueError(f"shard must be >= 1, got {self.shard}")
        return self

    def prng_key(self) -> np.ndarray:
        """The config's base key (mergers fold in per-node data)."""
        return prng.PRNGKey(self.seed)


@dataclass(frozen=True)
class MergeResult:
    """One merge outcome: the consensus over the folded sub-models.
    ``worker_ids`` is the canonical (ascending) order of the merged
    workers, also the sub-model axis order of ``mask``/``transforms``;
    ``transforms`` (ALiR mergers) are the per-worker maps ``W_i``: a row
    absent from sub-model *i* is reconstructed as ``Y[w] @ W_i.T``."""

    worker_ids: tuple[int, ...]
    emb: torch.Tensor                       # (V, d) consensus; invalid rows zeroed
    valid: torch.Tensor                     # (V,) union presence over merged models
    disps: torch.Tensor | None = None       # ALiR per-iteration displacement trace
    mask: torch.Tensor | None = None        # (n, V) per-worker presence
    transforms: torch.Tensor | None = None  # (n, d, d) worker → consensus maps

    @property
    def Y(self) -> torch.Tensor:
        """Alias for ``emb``."""
        return self.emb


class Merger:
    """The merge protocol: :meth:`merge` (one-shot batch) and
    :meth:`add` / :meth:`fold` / :meth:`final` (incremental, sub-models
    registered as workers finish, in any order).

    The base class owns the arrival policy shared by every merger:
    canonical (ascending worker-id) ordering, duplicate and shape
    rejection, the ``deadline`` window (late arrivals land in
    :attr:`late_workers`) on an injectable ``clock``, and the ``quorum``
    check on :meth:`final`. Subclasses implement :meth:`merge`; folding
    defaults to re-merging everything arrived.
    """

    name: str = "base"

    def __init__(self, config: MergeConfig | None = None, *, clock=None,
                 device=None):
        self.config = (config or MergeConfig()).validated()
        self.device = resolve_device(device)
        # injectable clock, so deadline behaviour is deterministic in tests
        self._clock = clock if clock is not None else time.monotonic
        self._t0 = self._clock()
        self.late_workers: list[int] = []
        self._models: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}

    @property
    def quorum(self) -> int | None:
        return self.config.quorum

    @property
    def deadline(self) -> float | None:
        return self.config.deadline

    @property
    def worker_ids(self) -> tuple[int, ...]:
        """Arrived workers in canonical (ascending) order."""
        return tuple(sorted(self._models))

    @property
    def n_folded(self) -> int:
        """Number of sub-models that have arrived so far."""
        return len(self._models)

    @property
    def quorum_met(self) -> bool:
        """Whether enough sub-models arrived for :meth:`final` (always
        without a quorum)."""
        return self.config.quorum is None or self.n_folded >= self.config.quorum

    @property
    def deadline_passed(self) -> bool:
        """Whether the arrival window has closed (never without a deadline)."""
        return (self.config.deadline is not None
                and self._clock() - self._t0 > self.config.deadline)

    def stacked(self) -> StackedModels:
        """The arrived sub-models restacked in canonical worker order."""
        if not self._models:
            raise ValueError("no sub-models have arrived yet")
        ids = self.worker_ids
        return StackedModels(models=torch.stack([self._models[i][0] for i in ids]),
                             mask=torch.stack([self._models[i][1] for i in ids]))

    def add(self, worker_id: int, model, mask, *,
            fold: bool = True) -> MergeResult | None:
        """Register a finished worker's ``(V, d)`` sub-model and ``(V,)``
        presence mask (and, by default, re-fold the consensus and return
        it). Duplicate worker ids are rejected. Returns ``None`` without
        registering when the ``deadline`` has passed: the straggler is
        recorded in :attr:`late_workers`."""
        if self.deadline_passed:
            self.late_workers.append(int(worker_id))
            return None
        if worker_id in self._models:
            raise ValueError(f"worker {worker_id} already folded in")
        model = torch.as_tensor(model, device=self.device)
        mask = torch.as_tensor(mask, device=self.device).bool()
        if model.ndim != 2 or tuple(mask.shape) != (model.shape[0],):
            raise ValueError(
                f"expected model (V, d) and mask (V,); got {tuple(model.shape)} "
                f"and {tuple(mask.shape)}")
        if self._models:
            V, d = next(iter(self._models.values()))[0].shape
            if tuple(model.shape) != (V, d):
                raise ValueError(
                    f"sub-model shape {tuple(model.shape)} != established {(V, d)}")
        self._models[int(worker_id)] = (model, mask)
        self._on_arrival(int(worker_id))
        return self.fold() if fold else None

    def _on_arrival(self, worker_id: int) -> None:
        """Subclass hook after a sub-model registers."""

    def merge(self, stacked: StackedModels, *,
              worker_ids: tuple[int, ...] | None = None) -> MergeResult:
        """One-shot batch merge of a stack (``worker_ids`` labels its
        model axis)."""
        raise NotImplementedError

    def fold(self, warm: bool | None = None) -> MergeResult:
        """Re-merge everything that has arrived; ``fold(warm=False)`` after
        all arrivals is the batch :meth:`merge` bit for bit."""
        del warm
        return self.merge(self.stacked(), worker_ids=self.worker_ids)

    def final(self, *, require_quorum: bool = True) -> MergeResult:
        """The canonical cold fold over every sub-model that arrived on
        time: bitwise the batch :meth:`merge` of that subset's stack in
        canonical worker order, whatever the arrival order. Raises
        ``RuntimeError`` when a configured quorum is unmet, unless
        ``require_quorum=False``."""
        if require_quorum and not self.quorum_met:
            raise RuntimeError(
                f"quorum not met: {self.n_folded} sub-model(s) arrived, "
                f"quorum is {self.config.quorum}")
        return self.fold(warm=False)

    def describe(self) -> str:
        return f"{self.name}({self.config})"


def _result_ids(stacked: StackedModels,
                worker_ids: tuple[int, ...] | None) -> tuple[int, ...]:
    if worker_ids is None:
        return tuple(range(stacked.n))
    ids = tuple(int(w) for w in worker_ids)
    if len(ids) != stacked.n:
        raise ValueError(f"{len(ids)} worker ids for {stacked.n} sub-models")
    return ids


class AlirMerger(Merger):
    """The paper's merger, batch and incremental.

    Sub-models are restacked in canonical worker-id order before every
    fold, so the final cold fold is bitwise the batch :meth:`merge`
    whatever the arrival order. Intermediate folds warm-start from the
    previous consensus (``warm_start``): they match the batch merge only
    up to a global orthogonal map (ALiR's gauge), so :meth:`final` always
    solves cold. ``valid`` covers the words of the arrived sub-models.
    """

    name = "alir"

    def __init__(self, config: MergeConfig | None = None, *, key=None, clock=None,
                 device=None):
        super().__init__(config, clock=clock, device=device)
        self._key_override = key
        self._Y: torch.Tensor | None = None

    @property
    def init(self) -> str:
        return self.config.init

    @property
    def max_iters(self) -> int:
        return self.config.max_iters

    @property
    def tol(self) -> float:
        return self.config.tol

    @property
    def warm_start(self) -> bool:
        return self.config.warm_start

    @property
    def key(self) -> np.ndarray:
        """Base key for the cold-solve init."""
        return (self._key_override if self._key_override is not None
                else self.config.prng_key())

    def merge(self, stacked: StackedModels, *,
              worker_ids: tuple[int, ...] | None = None,
              Y0: torch.Tensor | None = None) -> MergeResult:
        cfg = self.config
        with span("repro_torch.merge"):
            stacked = stacked.to(self.device)
            Y, valid, disps = _alir_solve(
                stacked, out_dim=cfg.out_dim, init=cfg.init, max_iters=cfg.max_iters,
                tol=cfg.tol, key=self.key, Y0=Y0, shard=cfg.shard)
            Ws = alir_transforms(stacked, Y, shard=cfg.shard)
        return MergeResult(worker_ids=_result_ids(stacked, worker_ids), emb=Y,
                           valid=valid, disps=disps, mask=stacked.mask, transforms=Ws)

    def fold(self, warm: bool | None = None) -> MergeResult:
        """Re-solve ALiR over everything arrived; ``warm`` overrides the
        config's ``warm_start`` for this fold."""
        warm = self.config.warm_start if warm is None else warm
        Y0 = self._Y if (warm and self._Y is not None) else None
        res = self.merge(self.stacked(), worker_ids=self.worker_ids, Y0=Y0)
        self._Y = res.emb
        return res


class _FunctionMerger(Merger):
    """The stateless merges (average/concat/pca): batch and incremental
    are the same computation over the arrived stack."""

    def merge(self, stacked: StackedModels, *,
              worker_ids: tuple[int, ...] | None = None) -> MergeResult:
        stacked = stacked.to(self.device)
        emb, valid = self._apply(stacked)
        return MergeResult(worker_ids=_result_ids(stacked, worker_ids),
                           emb=emb, valid=valid, mask=stacked.mask)

    def _apply(self, stacked: StackedModels):
        raise NotImplementedError


class AverageMerger(_FunctionMerger):
    """Presence-weighted element-wise mean over union rows — the paper's
    counter-example (sub-models live in incompatible gauges)."""

    name = "average"

    def _apply(self, stacked: StackedModels):
        return _merge_average(stacked)


class ConcatMerger(_FunctionMerger):
    """``(V, n·d)`` concatenation over intersection rows; other rows zero."""

    name = "concat"

    def _apply(self, stacked: StackedModels):
        return _merge_concat(stacked)


class PcaMerger(_FunctionMerger):
    """PCA of the concatenation down to ``config.out_dim`` (default d)."""

    name = "pca"

    def _apply(self, stacked: StackedModels):
        out_dim = self.config.out_dim or int(stacked.models.shape[2])
        return _merge_pca(stacked, out_dim)


class IncrementalAlirMerger(AlirMerger):
    """The keyword-dial spelling of :class:`AlirMerger` (the reference's
    pre-registry name). New code: ``get_merger("alir", ...)``."""

    def __init__(self, *, init: str = "pca", max_iters: int = 10,
                 tol: float = 1e-4, key=None, warm_start: bool = True,
                 quorum: int | None = None, deadline: float | None = None,
                 clock=None, device=None):
        cfg = MergeConfig(init=init, max_iters=max_iters, tol=tol,
                          warm_start=warm_start, quorum=quorum, deadline=deadline)
        super().__init__(cfg, key=key, clock=clock, device=device)


# ---------------------------------------------------------------------------
# The registry (mirrors core.engine's ENGINES / get_engine).
# ---------------------------------------------------------------------------
MERGERS: dict[str, type[Merger]] = {
    "alir": AlirMerger,
    "average": AverageMerger,
    "concat": ConcatMerger,
    "pca": PcaMerger,
}

MERGER_NAMES: tuple[str, ...] = ("alir", "alir_tree", "average", "concat", "pca")


def _tree_merger_cls() -> type[Merger]:
    # Imported lazily: merge_tree builds on this module.
    from repro_torch.core.merge_tree import TreeAlirMerger
    return TreeAlirMerger


def get_merger(spec: str | Merger = "alir", config: MergeConfig | None = None, *,
               clock=None, device=None, **overrides) -> Merger:
    """Resolve a merger: pass an instance through, or build one from a
    registry name and config (``overrides`` are :class:`MergeConfig`
    fields) on ``device`` (the GPU unless ``device="cpu"``)::

        get_merger("alir_tree", fan_in=4, quorum=3)
        get_merger("alir", MergeConfig(max_iters=20), deadline=60.0)
    """
    if isinstance(spec, Merger):
        if config is not None or overrides or device is not None:
            raise ValueError(
                "pass either a Merger instance or a name+config, not both")
        return spec
    name = str(spec)
    cfg = config or MergeConfig()
    if overrides:
        cfg = replace(cfg, **overrides)
    if name == "alir_tree":
        cls = _tree_merger_cls()
    elif name in MERGERS:
        cls = MERGERS[name]
    else:
        raise ValueError(
            f"unknown merger {name!r}; expected one of {sorted(MERGER_NAMES)}")
    return cls(cfg, clock=clock, device=device)


# ---------------------------------------------------------------------------
# Deprecated free-function shims (the reference's pre-registry surface).
# ---------------------------------------------------------------------------
def _deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"{old} is deprecated; use {new} (the Merger registry: "
        "repro_torch.core.merge.get_merger)", DeprecationWarning, stacklevel=3)


def merge_alir(stacked: StackedModels, out_dim: int | None = None,
               init: str = "pca", max_iters: int = 10, tol: float = 1e-4,
               key=None, Y0: torch.Tensor | None = None, shard: int = 1, *,
               device=None):
    """Deprecated shim — use ``get_merger("alir").merge(stacked)``.
    Returns the legacy ``(Y, valid, disps)`` triple."""
    _deprecated("merge_alir", 'get_merger("alir").merge(...)')
    return _alir_solve(stacked.to(resolve_device(device)), out_dim=out_dim,
                       init=init, max_iters=max_iters, tol=tol, key=key, Y0=Y0,
                       shard=shard)


def merge_concat(stacked: StackedModels, *, device=None):
    """Deprecated shim — use ``get_merger("concat").merge(stacked)``."""
    _deprecated("merge_concat", 'get_merger("concat").merge(...)')
    return _merge_concat(stacked.to(resolve_device(device)))


def merge_pca(stacked: StackedModels, out_dim: int, *, device=None):
    """Deprecated shim — use ``get_merger("pca", out_dim=...).merge(stacked)``."""
    _deprecated("merge_pca", 'get_merger("pca", out_dim=...).merge(...)')
    return _merge_pca(stacked.to(resolve_device(device)), out_dim)


def merge_average(stacked: StackedModels, *, device=None):
    """Deprecated shim — use ``get_merger("average").merge(stacked)``."""
    _deprecated("merge_average", 'get_merger("average").merge(...)')
    return _merge_average(stacked.to(resolve_device(device)))


#: The pre-registry name of an incremental fold's result, kept as the
#: reference keeps it: every merger now returns :class:`MergeResult`.
FoldResult = MergeResult


# ---------------------------------------------------------------------------
# Name-dispatched merge for the pipeline driver.
# ---------------------------------------------------------------------------
MERGE_METHODS = ("concat", "pca", "alir_rand", "alir_pca", "alir_tree",
                 "average", "single")


def merge(stacked: StackedModels, method: str, out_dim: int, key=None, *,
          fan_in: int = 2, shard: int = 1, device=None, **kw):
    """Merge by name (one of :data:`MERGE_METHODS`) on ``device`` (the
    GPU unless ``device="cpu"``). Returns ``(emb, valid)``; ``key`` seeds
    the alir_rand/alir_pca inits, ``fan_in`` sizes the ``alir_tree``
    reduction tree, ``shard`` the Gram accumulation; extra kwargs go to
    the ALiR solver (``alir_tree``: to its :class:`MergeConfig`)."""
    device = resolve_device(device)
    stacked = stacked.to(device)
    if method == "concat":
        return _merge_concat(stacked)
    if method == "pca":
        return _merge_pca(stacked, out_dim)
    if method in ("alir_rand", "alir_pca"):
        init = "random" if method == "alir_rand" else "pca"
        Y, v, _ = _alir_solve(stacked, out_dim, init=init, key=key,
                              shard=shard, **kw)
        return Y, v
    if method == "alir_tree":
        cfg = MergeConfig(out_dim=None, fan_in=fan_in, shard=shard, **kw)
        res = get_merger("alir_tree", cfg, device=device).merge(stacked)
        return res.emb, res.valid
    if method == "average":
        return _merge_average(stacked)
    if method == "single":
        return stacked.models[0], stacked.mask[0]
    raise ValueError(f"unknown merge method {method!r}; expected one of "
                     f"{MERGE_METHODS}")
