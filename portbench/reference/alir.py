"""The plain ALiR merge (paper §3.3.2): PCA init on the rows every
sub-model holds, random elsewhere; rounds of Orthogonal Procrustes per
sub-model, reconstruction of the rows a sub-model lacks and the mean; a
stop once the displacement settles; then each sub-model's map onto the
consensus.

Frozen copy of ``src/repro_torch/core/merge.py`` at commit 69e108eca3b3
(``_merge_concat``, ``_merge_pca``, ``_alir_iteration`` without a process
group and with one Gram shard, ``_alir_loop``, ``alir_init``,
``_alir_solve``, ``alir_transforms``, ``AlirMerger.merge``), and of the
ALiR init's ``normal`` draw (``src/repro_torch/prng.py``). Float32; the
caller decides whether matrix products may use TF32 (the merge states
they may not).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import threefry

NORMAL_CHUNK = 1 << 25


def _normal(key, V: int, d: int, device) -> torch.Tensor:
    k0, k1 = threefry.key_words(key, device)
    out = torch.empty(V * d, dtype=torch.float32, device=device)
    for a in range(0, V * d, NORMAL_CHUNK):
        b = min(a + NORMAL_CHUNK, V * d)
        out[a:b] = threefry.normal(k0, k1, torch.arange(a, b, dtype=torch.int64, device=device))
    return out.view(V, d)


def _pca(models: torch.Tensor, mask: torch.Tensor, out_dim: int):
    n, V, d = models.shape
    valid = torch.all(mask, dim=0)
    emb = models.permute(1, 0, 2).reshape(V, n * d) * valid[:, None]
    vf = valid.to(emb.dtype)
    cnt = torch.clamp_min(vf.sum(), 1)
    mean = (emb * vf[:, None]).sum(0) / cnt
    X = (emb - mean) * vf[:, None]
    cov = X.T @ X / cnt
    _, eigvec = torch.linalg.eigh(cov)
    comps = eigvec[:, -out_dim:].flip(1)
    return (X @ comps) * vf[:, None], valid


def _iteration(Y: torch.Tensor, models: torch.Tensor, mask: torch.Tensor):
    maskf = mask.to(Y.dtype)[..., None]
    A = models * maskf
    Byy = Y[None] * maskf
    gram = A.transpose(-1, -2) @ Byy
    U, _, Vt = torch.linalg.svd(gram, full_matrices=False)
    W = U @ Vt
    aligned_present = models @ W
    aligned_full = torch.where(maskf > 0, aligned_present, Y[None])
    num_rows = torch.clamp_min(maskf.sum(dim=(1, 2)), 1.0)
    disp = torch.linalg.vector_norm((Y[None] - aligned_present) * maskf,
                                    dim=(1, 2)) / torch.sqrt(num_rows * Y.shape[1])
    return aligned_full.mean(0), disp.mean(), W


def alir(models: torch.Tensor, mask: torch.Tensor, key, max_iters: int = 10,
         tol: float = 1e-4):
    """``(Y (V, d), valid (V,), transforms (n, d, d))`` of sub-models
    ``(n, V, d)`` with presence ``mask`` ``(n, V)``; ``key`` seeds the
    random init of rows outside the intersection."""
    n, V, d = models.shape
    pca_emb, inter = _pca(models, mask, d)
    Y = torch.where(inter[:, None], pca_emb, 0.1 * _normal(key, V, d, models.device))
    del pca_emb
    models = models * mask[..., None]
    prev = torch.tensor(float("inf"), dtype=Y.dtype, device=Y.device)
    done = False
    for _ in range(max_iters):
        if done:
            disp = prev
        else:
            Y, disp, _ = _iteration(Y, models, mask)
        done = done or bool(torch.abs(prev - disp) < tol)
        prev = disp
    valid = torch.any(mask, dim=0)
    Y = Y * valid[:, None]
    _, _, Ws = _iteration(Y, models, mask)
    return Y, valid, Ws


def procrustes(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """The orthogonal ``R`` that minimises ‖A R − B‖."""
    U, _, Vt = torch.linalg.svd(A.T.double() @ B.double(), full_matrices=False)
    return (U @ Vt).float()


def row_gap(Yp: torch.Tensor, Yr: torch.Tensor, valid: torch.Tensor) -> tuple[float, np.ndarray]:
    """After the orthogonal map that best aligns the program's table onto
    the reference's: the worst valid row's distance, over that row's norm
    in the reference or the median row's, whichever is larger. Returns it
    and the map."""
    R = procrustes(Yp[valid], Yr[valid])
    rows = torch.linalg.vector_norm((Yp[valid] @ R - Yr[valid]).double(), dim=1)
    ref_norm = torch.linalg.vector_norm(Yr[valid].double(), dim=1)
    scale = torch.clamp_min(ref_norm, float(ref_norm.median()))
    return float((rows / scale).max()), R
