"""The port's ``jax.random`` samplers against the JAX package: ``randint``
bitwise against ``jax.random.randint``, the key-tensor threefry against
the per-key form, and the worker-batched CDF and alias samplers bitwise
against ``jax.vmap`` of the reference's on the same keys. Integer
outputs, so every comparison here is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pairs as jpairs
from repro_torch import prng
from repro_torch.data import pairs as tpairs
from repro_torch.kernels.sgns_fused import seed_tensor

SEEDS = (0, 1, 42, 2**31 - 1)
SPANS = ((0, 1), (0, 2), (0, 7), (0, 2**16), (0, 89_611), (0, 300_000),
         (5, 5), (9, 3), (-100, 50), (-(2**31), 2**31 - 1))


@pytest.mark.parametrize("bounds", SPANS, ids=lambda b: f"{b[0]}_{b[1]}")
@pytest.mark.parametrize("shape", ((7,), (3, 5), (1000,)))
@pytest.mark.parametrize("seed", SEEDS)
def test_randint_bitwise(seed, shape, bounds):
    lo, hi = bounds
    ref = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, lo, hi,
                                        jnp.int32))
    got = prng.randint(prng.PRNGKey(seed), shape, lo, hi)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), ref)


def test_randint_empty_span_returns_minval():
    got = prng.randint(prng.PRNGKey(3), (50,), 11, 4)
    assert torch.equal(got, torch.full((50,), 11, dtype=torch.int32))


def test_key_tensor_threefry_equals_the_per_key_form():
    """One chain of ops over an (n, 2) key tensor — int64 words or the
    trainer's int32 seed bits — gives each key's single-key bits,
    splits, uniforms and randints."""
    keys = prng.split(prng.PRNGKey(8), 5)
    for kt in (torch.from_numpy(keys.astype(np.int64)), seed_tensor(keys)):
        bits = prng.random_bits(kt, (4, 6))
        assert tuple(bits.shape) == (5, 4, 6) and bits.dtype == torch.int64
        split = prng.split(kt, 3)
        np.testing.assert_array_equal(split.numpy().astype(np.uint32),
                                      prng.split(keys, 3))
        u = prng.uniform(kt, (33,))
        r = prng.randint(kt, (33,), 0, 1000)
        for i, k in enumerate(keys):
            np.testing.assert_array_equal(bits[i].numpy(),
                                          prng.random_bits(k, (4, 6)).numpy())
            np.testing.assert_array_equal(u[i].numpy(), prng.uniform(k, (33,)).numpy())
            np.testing.assert_array_equal(
                r[i].numpy(), np.asarray(jax.random.randint(jnp.asarray(k), (33,), 0, 1000)))


def test_key_tensor_rejects_bad_shapes():
    with pytest.raises(ValueError, match="uint32 words"):
        prng.key_tensor(torch.zeros((4, 3), dtype=torch.int64))


@pytest.fixture(scope="module")
def counts():
    rng = np.random.default_rng(0)
    cs = [rng.zipf(1.3, 400).astype(np.float64) for _ in range(3)]
    cs[1][:25] = 0            # rows absent from a worker's vocabulary
    cs[2][-40:] = 0
    cs[2][100:120] = 0
    return cs


@pytest.mark.parametrize("shape", ((64, 5), (1000,), (7, 3, 2)))
@pytest.mark.parametrize("kind", ("cdf", "alias"))
def test_samplers_bitwise_with_vmapped_reference(counts, kind, shape):
    """Worker w's ids equal the reference sampler's on worker w's own
    table and key, under ``jax.vmap`` — whether the keys come as numpy
    words or as the trainer's int32 seed tensor."""
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(4), len(counts)))
    jt = jpairs.stack_noise_tables(counts, kind=kind)
    fn = jpairs.negative_sampler_fn(kind)
    ref = np.asarray(jax.vmap(lambda t, k: fn(t, k, shape))(jt, jnp.asarray(keys)))
    tt = tpairs.stack_noise_tables(counts, kind=kind)
    for k in (keys, seed_tensor(keys)):
        got = tpairs.negative_sampler_fn(kind)(tt, k, shape)
        assert got.dtype == torch.int32 and tuple(got.shape) == (len(counts), *shape)
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("kind", ("cdf", "alias"))
def test_zero_count_rows_are_unreachable(counts, kind):
    tt = tpairs.stack_noise_tables(counts, kind=kind)
    keys = prng.split(prng.PRNGKey(9), len(counts))
    ids = tpairs.negative_sampler_fn(kind)(tt, keys, (20_000,)).numpy()
    for w, c in enumerate(counts):
        assert (c[ids[w]] > 0).all(), f"worker {w} drew a zero-count row"


def test_cdf_to_ids_right_side_on_boundaries():
    """``u`` exactly 0.0 or exactly on a repeated boundary maps to the
    interval above it, as the reference's ``side="right"`` does."""
    cdf = torch.tensor([[0.0, 0.0, 0.5, 0.5, 1.0]], dtype=torch.float32)
    u = torch.tensor([[0.0, 0.25, 0.5, 0.75, 0.9999999]], dtype=torch.float32)
    got = tpairs.cdf_to_ids(cdf, u)
    ref = jpairs.cdf_to_ids(jnp.asarray(cdf[0].numpy()), jnp.asarray(u[0].numpy()))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got[0].numpy(), [2, 2, 4, 4, 4])


def test_negative_sampler_fn_rejects_unknown():
    assert tpairs.negative_sampler_fn("cdf") is tpairs.sample_negatives_cdf
    assert set(tpairs.NEGATIVE_SAMPLERS) == set(jpairs.NEGATIVE_SAMPLERS)
    with pytest.raises(ValueError, match="unknown negative sampler"):
        tpairs.negative_sampler_fn("gumbel")
