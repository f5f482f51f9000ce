"""core/merge.py of the port against the JAX package's batch merges.

``eigh`` fixes its eigenvectors' signs per LAPACK build, so the PCA merge
and the PCA-initialized ALiR are compared up to that gauge: PCA column by
column up to sign, the full ``alir_pca`` after Procrustes alignment (and
through the gauge-free Gram ``Y Yᵀ``). ALiR fed the reference's own
initial consensus ``Y0`` is compared directly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import merge as jm
from repro_torch import prng
from repro_torch.core import merge as tm

# Products of (V, d) tables are summed in another order than XLA's, and
# ALiR's SVDs amplify that over its iterations; on O(1) entries the port
# stays within these bounds.
ATOL = 2e-5
ALIR_ATOL = 1e-4


def _stack(n=3, V=160, d=8, seed=0, full=False):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(V, d))
    models, masks = [], []
    for i in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(d, d)))   # each in its own gauge
        models.append((base @ q + 0.05 * rng.normal(size=(V, d))).astype(np.float32))
        m = np.ones(V, bool) if full else rng.random(V) < 0.8
        m[:20] = True                                  # a shared intersection
        masks.append(m)
    return (jm.StackedModels(models=jnp.asarray(np.stack(models)),
                             mask=jnp.asarray(np.stack(masks))),
            tm.stack_models(models, masks))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _align(A, B):
    """A rotated onto B by orthogonal Procrustes (the gauge fix)."""
    u, _, vt = np.linalg.svd(A.T @ B)
    return A @ (u @ vt)


@pytest.mark.parametrize("method", ("concat", "average", "single"))
def test_gauge_free_merges_match(method):
    js, ts = _stack()
    je, jv = jm.merge(js, method, out_dim=8)
    te, tv = tm.merge(ts, method, out_dim=8, device="cpu")
    np.testing.assert_array_equal(_np(tv), _np(jv))
    np.testing.assert_allclose(_np(te), _np(je), rtol=0, atol=ATOL)


@pytest.mark.parametrize("out_dim", (4, 8))
def test_pca_matches_up_to_column_signs(out_dim):
    js, ts = _stack(seed=1)
    je, jv = jm.merge(js, "pca", out_dim=out_dim)
    te, tv = tm.merge(ts, "pca", out_dim=out_dim, device="cpu")
    je, te = _np(je), _np(te)
    np.testing.assert_array_equal(_np(tv), _np(jv))
    signs = np.sign((je * te).sum(0))
    np.testing.assert_allclose(te * signs, je, rtol=0, atol=ATOL)


@pytest.mark.parametrize("init", ("pca", "random"))
def test_alir_fed_the_reference_y0_matches(init):
    """Partial masks (reconstructed rows) and the post-convergence freeze:
    the same Y0 gives the same consensus and displacement trace."""
    js, ts = _stack(seed=2)
    Y0 = jm.alir_init(js, 8, init, jax.random.PRNGKey(4))
    jY, jv, jd = jm._alir_solve(js, 8, Y0=Y0, max_iters=12, tol=1e-4)
    tY, tv, td = tm._alir_solve(ts, 8, Y0=torch.from_numpy(np.array(Y0)), max_iters=12,
                                tol=1e-4)
    np.testing.assert_array_equal(_np(tv), _np(jv))
    np.testing.assert_allclose(_np(tY), _np(jY), rtol=0, atol=ALIR_ATOL)
    np.testing.assert_allclose(_np(td), _np(jd), rtol=1e-3, atol=1e-6)


def test_alir_trace_freezes_after_convergence():
    _, ts = _stack(seed=3, full=True)
    _, _, disps = tm._alir_solve(ts, 8, max_iters=15, tol=1e-3)
    d = _np(disps)
    assert d.shape == (15,)
    stop = next(i for i in range(1, 15) if abs(d[i - 1] - d[i]) < 1e-3)
    assert np.all(d[stop:] == d[stop])


def test_alir_random_init_is_the_reference_normal():
    js, ts = _stack(seed=4)
    j = np.asarray(jm.alir_init(js, 8, "random", jax.random.PRNGKey(9)))
    t = tm.alir_init(ts, 8, "random", prng.PRNGKey(9)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-7)     # erfinv ulps


def test_full_alir_pca_matches_gauge_invariantly():
    """Every word present in every model: the PCA init is the whole Y0,
    ALiR is equivariant under a global orthogonal map, so the consensus
    matches after Procrustes alignment, and its Gram matrix directly."""
    js, ts = _stack(seed=5, full=True)
    jY, _ = jm.merge(js, "alir_pca", out_dim=8, key=jax.random.PRNGKey(42))
    tY, _ = tm.merge(ts, "alir_pca", out_dim=8, key=prng.PRNGKey(42), device="cpu")
    jY, tY = _np(jY), _np(tY)
    np.testing.assert_allclose(_align(tY, jY), jY, rtol=0, atol=ALIR_ATOL)
    np.testing.assert_allclose(tY @ tY.T, jY @ jY.T, rtol=0, atol=10 * ALIR_ATOL)


def test_procrustes_gram_and_reconstruction_match():
    js, ts = _stack(seed=6)
    A, B = _np(ts.models[0]), _np(ts.models[1])
    w = np.linspace(0.5, 1.5, A.shape[0]).astype(np.float32)
    np.testing.assert_allclose(
        tm.orthogonal_procrustes(torch.from_numpy(A), torch.from_numpy(B),
                                 torch.from_numpy(w)).numpy(),
        np.asarray(jm.orthogonal_procrustes(jnp.asarray(A), jnp.asarray(B),
                                            jnp.asarray(w))), atol=ATOL)
    for shards in (1, 3, 7):
        np.testing.assert_allclose(
            tm.sharded_gram(torch.from_numpy(A), torch.from_numpy(B), shards).numpy(),
            np.asarray(jm.sharded_gram(jnp.asarray(A), jnp.asarray(B), shards)),
            rtol=1e-5, atol=ATOL)                      # entries are O(100)
        parts = tm.gram_block_partials(torch.from_numpy(A), torch.from_numpy(B), shards)
        assert tuple(parts.shape) == (shards, 8, 8)
    Y = _np(jm.merge(js, "alir_rand", out_dim=8, key=jax.random.PRNGKey(1))[0])
    np.testing.assert_allclose(
        tm.reconstruct_missing(ts, torch.from_numpy(Y.copy())).numpy(),
        np.asarray(jm.reconstruct_missing(js, jnp.asarray(Y))), rtol=0, atol=ALIR_ATOL)
    np.testing.assert_allclose(
        tm.alir_transforms(ts, torch.from_numpy(Y.copy()), shard=2).numpy(),
        np.asarray(jm.alir_transforms(js, jnp.asarray(Y), shard=2)), rtol=0,
        atol=ALIR_ATOL)


def test_merge_dispatch_and_errors():
    _, ts = _stack(seed=7)
    assert set(tm.MERGE_METHODS) == set(jm.MERGE_METHODS) - {"alir_tree"}
    with pytest.raises(ValueError, match="unknown merge method"):
        tm.merge(ts, "alir_tree", out_dim=8, device="cpu")
    with pytest.raises(ValueError, match="out_dim must equal d"):
        tm.merge(ts, "alir_pca", out_dim=4, device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
