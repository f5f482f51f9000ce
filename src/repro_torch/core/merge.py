"""The Merge phase — Concat, PCA, averaging and ALiR (the paper's
contribution), in torch.

The counterpart of the batch-merge half of ``repro.core.merge``. All
merges operate on *stacked* sub-models: ``models (n, V, d)`` over the
**union** vocabulary, plus a presence ``mask (n, V)``. Concat/PCA use the
intersection rows; ALiR uses the union and reconstructs missing rows.

ALiR (Alternating Linear Regression, paper §3.3.2), per iteration:

1. *Estimate translation* — per sub-model, Orthogonal Procrustes on its
   present rows: W_i = UVᵀ from the SVD of M_i'ᵀ Y'.
2. *Estimate missing values* — M_i* = Y* W_iᵀ.
3. *Update joint embedding* — Y ← mean over i of (M_i W_i), with the
   reconstructed rows for the missing parts.

It stops (freezing Y and the reported displacement) once the change in
the mean normalized displacement drops below ``tol``.

SVD and eigh go to ``torch.linalg``. Float32 matrix products here run in
full float32 on the GPU: this module sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False`` when it is imported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import prng
from repro_torch.device import resolve_device

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
                    gram_shards: int = 1):
    """One ALiR round over all n models at once. Returns (Y_new,
    displacement, W (n,d,d))."""
    maskf = mask.to(Y.dtype)[..., None]                 # (n, V, 1)
    A = models * maskf
    Byy = Y[None] * maskf
    U, _, Vt = torch.linalg.svd(sharded_gram(A, Byy, gram_shards),
                                full_matrices=False)
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
            Y, disp, _ = _alir_iteration(Y, models, mask, gram_shards)
        done = done or bool(torch.abs(prev - disp) < tol)
        prev = disp
        disps.append(disp)
    return Y, torch.stack(disps)


def alir_init(stacked: StackedModels, out_dim: int, init: str, key):
    """Initial ``(V, out_dim)`` consensus: "random" (paper init i) or
    "pca" — PCA on intersection rows, random elsewhere (init ii)."""
    n, V, d = stacked.models.shape
    device = stacked.models.device
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
# Name-dispatched merge for the pipeline driver.
# ---------------------------------------------------------------------------
MERGE_METHODS = ("concat", "pca", "alir_rand", "alir_pca", "average", "single")


def merge(stacked: StackedModels, method: str, out_dim: int, key=None, *,
          shard: int = 1, device=None, **kw):
    """Merge by name (one of :data:`MERGE_METHODS`) on ``device`` (the
    GPU unless ``device="cpu"``). Returns ``(emb, valid)``; ``key`` seeds
    the alir_* inits, ``shard`` the Gram accumulation; extra kwargs go
    to the ALiR solver."""
    stacked = stacked.to(resolve_device(device))
    if method == "concat":
        return _merge_concat(stacked)
    if method == "pca":
        return _merge_pca(stacked, out_dim)
    if method in ("alir_rand", "alir_pca"):
        init = "random" if method == "alir_rand" else "pca"
        Y, v, _ = _alir_solve(stacked, out_dim, init=init, key=key,
                              shard=shard, **kw)
        return Y, v
    if method == "average":
        return _merge_average(stacked)
    if method == "single":
        return stacked.models[0], stacked.mask[0]
    raise ValueError(f"unknown merge method {method!r}; expected one of "
                     f"{MERGE_METHODS}")
