"""repro_torch.prng against jax.random: keys, splits, fold-ins, bits and
uniforms bitwise; normals within the erfinv tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import prng

SEEDS = (0, 1, 42, 12345, 2**31 - 1)
SHAPES = ((1,), (7,), (3, 5), (257, 33))


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def test_jax_runs_partitionable_threefry():
    """The port reproduces threefry2x32 in partitionable mode; a jax
    upgrade that changes either setting must fail here, loudly."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_bitwise(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed), np.asarray(_jkey(seed)))
    assert prng.PRNGKey(seed).dtype == np.uint32


@pytest.mark.parametrize("num", (1, 2, 5, 64))
@pytest.mark.parametrize("seed", SEEDS)
def test_split_bitwise(seed, num):
    np.testing.assert_array_equal(prng.split(prng.PRNGKey(seed), num),
                                  np.asarray(jax.random.split(_jkey(seed), num)))


def test_split_of_a_key_stack_is_the_stack_of_splits():
    keys = prng.split(prng.PRNGKey(3), 4)
    out = prng.split(keys, 3)
    assert out.shape == (4, 3, 2)
    for i in range(4):
        np.testing.assert_array_equal(out[i], prng.split(keys[i], 3))


@pytest.mark.parametrize("data", (0, 1, 7, 1000, 2**32 - 1))
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_bitwise(seed, data):
    np.testing.assert_array_equal(
        prng.fold_in(prng.PRNGKey(seed), data),
        np.asarray(jax.random.fold_in(_jkey(seed), np.uint32(data))))


def test_step_keys_match_a_scan_of_splits():
    """The per-step subkeys of the async trainer's scan body
    (``key, sub = split(key)``), for a stack of worker keys."""
    keys = np.asarray(jax.random.split(_jkey(9), 3))

    def body(k, _):
        k, sub = jax.random.split(k)
        return k, sub

    ref = np.stack([np.asarray(jax.lax.scan(body, jnp.asarray(k), None,
                                            length=6)[1]) for k in keys])
    np.testing.assert_array_equal(prng.step_keys(keys, 6), ref)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_bitwise(seed, shape):
    ref = np.asarray(jax.random.bits(_jkey(seed), shape, jnp.uint32))
    got = prng.random_bits(prng.PRNGKey(seed), shape).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), ref)


@pytest.mark.parametrize("bounds", ((0.0, 1.0), (-0.5 / 48, 0.5 / 48),
                                    (-0.5 / 500, 0.5 / 500), (-1.0, 1.0)))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_uniform_bitwise(seed, shape, bounds):
    lo, hi = bounds
    ref = np.asarray(jax.random.uniform(_jkey(seed), shape, jnp.float32, lo, hi))
    got = prng.uniform(prng.PRNGKey(seed), shape, lo, hi).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_erfinv_tolerance(seed):
    """The uniforms under the normals are bitwise equal; torch's erfinv
    and XLA's polynomial differ by a few ulps, up to ~6e-6 relative in
    the tails where erfinv is steep (measured over 1e5 draws), hence
    rtol 1e-5 / atol 1e-6."""
    shape = (2000, 50)
    ref = np.asarray(jax.random.normal(_jkey(seed), shape, jnp.float32))
    got = prng.normal(prng.PRNGKey(seed), shape).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_bits_on_requested_device():
    t = prng.random_bits(prng.PRNGKey(0), (4,), device=torch.device("cpu"))
    assert t.dtype == torch.int64 and int(t.max()) < 2**32 and int(t.min()) >= 0
