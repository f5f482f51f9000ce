"""K7 (``repro_torch.kernels.swa_decode``) on the CPU, where its wrapper runs
the plain version, against the JAX package: the Pallas kernel in interpret
mode and the jnp oracle at the cases of ``tests/test_kernels.py``, float32
and bfloat16, large scores, the ``W % chunk`` error, and GQA (more query
heads than KV heads) against the reference's ``_sdpa`` with every slot
valid. Inputs are made with numpy from a seed and handed to both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.swa_decode import swa_decode_kernel
from repro.models.attention import _sdpa
from repro_torch.kernels import sgns_fused
from repro_torch.kernels.swa_decode import swa_decode, swa_decode_plain


def _inputs(seed, B, W, H, D, Hkv=None, scale=0.5, v_scale=None):
    rng = np.random.default_rng(seed)
    Hkv = H if Hkv is None else Hkv
    q = (rng.standard_normal((B, H, D)) * scale).astype(np.float32)
    k = (rng.standard_normal((B, W, Hkv, D)) * scale).astype(np.float32)
    v = (rng.standard_normal((B, W, Hkv, D)) * (v_scale or scale)).astype(np.float32)
    return q, k, v


def _port(q, k, v, dtype=torch.float32, **kw):
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dtype) for a in (q, k, v)]
    return swa_decode(*t, **kw)


# The four (B, W, H, D, chunk) cases of tests/test_kernels.py.
CASES = [(2, 256, 4, 64, 64), (1, 512, 8, 128, 128), (3, 128, 2, 32, 32),
         (2, 256, 4, 64, 256)]


@pytest.mark.parametrize("B,W,H,D,chunk", CASES)
def test_plain_matches_the_interpret_mode_kernel_and_the_oracle(B, W, H, D, chunk):
    """atol 2e-5, the JAX test's: float32 sums over W in another order."""
    q, k, v = _inputs(B * W + chunk, B, W, H, D)
    got = _port(q, k, v, chunk=chunk).numpy()
    assert got.shape == (B, H, D) and got.dtype == np.float32
    pallas = np.asarray(swa_decode_kernel(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          chunk=chunk, interpret=True))
    oracle = np.asarray(ref.swa_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(got, pallas, atol=2e-5)
    np.testing.assert_allclose(got, oracle, atol=2e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_dtypes(dtype, tol):
    """The JAX test's shapes and bounds. bfloat16 inputs are rounded the
    same way on both sides (round to nearest even), the result is cast
    back to bfloat16: 3e-2 covers its half-ulp at |out| < 4."""
    q, k, v = _inputs(7, 2, 128, 4, 64)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = _port(q, k, v, dtype=tdt, chunk=64)
    assert got.dtype == tdt
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    # the same rounded inputs on both sides
    np.testing.assert_array_equal(np.asarray(jq, np.float32),
                                  torch.from_numpy(q).to(tdt).float().numpy())
    pallas = swa_decode_kernel(jq, jk, jv, chunk=64, interpret=True)
    oracle = ref.swa_decode_ref(jq, jk, jv)
    assert pallas.dtype == jdt
    for other in (pallas, oracle):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(other, np.float32),
                                   atol=tol)


def test_online_softmax_stability():
    """Scores of |s| ~ 20·20·sqrt(32): finite, and within the JAX test's
    1e-4 of both JAX functions."""
    q, k, v = _inputs(3, 1, 128, 2, 32, scale=20.0, v_scale=1.0)
    got = _port(q, k, v, chunk=32).numpy()
    assert np.isfinite(got).all()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    np.testing.assert_allclose(got, np.asarray(swa_decode_kernel(jq, jk, jv, chunk=32,
                                                                 interpret=True)), atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(ref.swa_decode_ref(jq, jk, jv)), atol=1e-4)


def test_window_not_divisible_by_chunk_raises_as_the_reference():
    q, k, v = _inputs(0, 1, 96, 2, 16)
    with pytest.raises(ValueError, match="window 96 not divisible by chunk 64") as ours:
        _port(q, k, v, chunk=64)
    with pytest.raises(ValueError) as theirs:
        swa_decode_kernel(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=64,
                          interpret=True)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("Hkv", [2, 4])
def test_gqa_matches_the_reference_sdpa_with_every_slot_valid(Hkv):
    """H = 8 query heads over Hkv KV heads: the reference's decode attention
    on a full ring is ``_sdpa`` with an all-zero mask. It divides the scores
    by sqrt(D) where K7 multiplies by 1/sqrt(D) (a last-ulp difference):
    atol 2e-5 as above."""
    B, W, H, D = 2, 128, 8, 64
    q, k, v = _inputs(11 + Hkv, B, W, H, D, Hkv=Hkv)
    got = _port(q, k, v, chunk=32).numpy()
    want = np.asarray(_sdpa(jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v),
                            jnp.zeros((1, W), jnp.float32)))[:, 0]
    np.testing.assert_allclose(got, want, atol=2e-5)
    # query head h reads KV head h // (H // Hkv): each group alone is the
    # ungrouped function on its KV head
    rep = H // Hkv
    for g in range(Hkv):
        alone = _port(q[:, g * rep:(g + 1) * rep], np.repeat(k[:, :, g:g + 1], rep, 2),
                      np.repeat(v[:, :, g:g + 1], rep, 2), chunk=32).numpy()
        np.testing.assert_allclose(got[:, g * rep:(g + 1) * rep], alone, atol=1e-6)


def test_wrapper_checks_its_inputs_and_counts_no_launch_on_the_cpu():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 1, 64, 4, 16, Hkv=2))
    before = sgns_fused.LAUNCHES["swa_decode"]
    out = swa_decode(q, k, v, chunk=64)
    assert torch.equal(out, swa_decode_plain(q, k, v, chunk=64))
    assert sgns_fused.LAUNCHES["swa_decode"] == before
    with pytest.raises(TypeError, match="k must be"):
        swa_decode(q, k.double(), v, chunk=64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        swa_decode(q.double(), k.double(), v.double(), chunk=64)
    with pytest.raises(ValueError, match="contiguous"):
        swa_decode(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, chunk=64)
    with pytest.raises(ValueError, match="do not group"):
        swa_decode(q[:, :3].contiguous(), k, v, chunk=64)
    with pytest.raises(ValueError, match="v must have shape"):
        swa_decode(q, k, v[:, :32].contiguous(), chunk=64)
