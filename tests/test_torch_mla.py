"""The port's MLA (``repro_torch.models.attention.MLA``) against
``repro.models.attention``'s ``mla_forward`` and ``mla_decode`` on the CPU,
and deepseek-v2-lite-16b (reduced: an ``L-D`` prefix layer, then ``L-E``
with 4 experts, top 2, one shared) end to end against the JAX package.

Tolerances: MLA's forward (naive) and decode (absorbed, over the
compressed cache) atol 1e-5 on O(1) outputs, the caches atol 1e-5; absorbed
against naive inside the port atol 1e-4
(``tests/test_decode_consistency.py::test_mla_absorb_equals_naive``'s: the
two contract W_UK and W_UV in another order). The arch-level checks are
``test_torch_arch_zoo.py``'s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.models import attention
from test_torch_arch_zoo import (  # noqa: F401  (the fixture)
    _one_torch_thread, check_decode, check_forward, check_loss_and_grads, check_serve,
    check_train_steps, setup_arch,
)

ARCH = "deepseek-v2-lite-16b"
D, H, HD, HR, R = 64, 4, 16, 8, 32


def _pair(seed=0, theta=1e4):
    p = jattn.init_mla(jax.random.PRNGKey(seed), D, H, kv_lora_rank=R, head_dim=HD,
                       rope_head_dim=HR, dtype=jnp.float32)
    m = attention.MLA(None, D, H, kv_lora_rank=R, head_dim=HD, rope_head_dim=HR,
                      dtype=torch.float32, rope_theta=theta, device="cpu")
    with torch.no_grad():
        for k, v in p.items():
            getattr(m, k).copy_(torch.tensor(np.asarray(v)))
    return p, m


@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("absorb", [False, True])
def test_mla_forward_matches_the_reference(window, absorb):
    p, m = _pair()
    rng = np.random.default_rng(0)
    x = (0.5 * rng.standard_normal((2, 10, D))).astype(np.float32)
    pos = rng.integers(0, 300, (2, 10)).astype(np.int32)
    want = jattn.mla_forward(p, jnp.asarray(x), jnp.asarray(pos), n_heads=H, head_dim=HD,
                             rope_head_dim=HR, window=window, absorb=absorb)
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(pos), window, absorb=absorb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("window", [None, 5])
def test_mla_decode_matches_the_reference(window):
    """14 steps into a cache of 8 slots with a window of 5 (a ring that
    wraps), or 14 slots without: outputs and the compressed cache after
    every step."""
    p, m = _pair(1)
    cache_len = 14 if window is None else 8
    rng = np.random.default_rng(1)
    xs = (0.5 * rng.standard_normal((14, 2, 1, D))).astype(np.float32)
    jcache = jattn.init_mla_cache(2, cache_len, R, HR, jnp.float32)
    cache = attention.init_mla_cache(2, cache_len, R, HR, torch.float32)
    for i in range(14):
        jcache, want = jattn.mla_decode(p, jcache, jnp.asarray(xs[i]), jnp.int32(i),
                                        n_heads=H, head_dim=HD, rope_head_dim=HR,
                                        window=window)
        mask = attention.decode_mask(cache_len, i, window, "cpu")
        with torch.no_grad():
            got = m.decode(cache, torch.from_numpy(xs[i]), i, mask=mask, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5,
                                   err_msg=f"step {i}")
        for k in ("c_kv", "k_rope"):
            np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]), rtol=0,
                                       atol=1e-5, err_msg=f"{k} at step {i}")


def test_mla_absorb_equals_naive():
    """``tests/test_decode_consistency.py``'s check, on the port."""
    _, m = _pair()
    x = torch.from_numpy((0.3 * np.random.default_rng(1).standard_normal((2, 6, D)))
                         .astype(np.float32))
    pos = torch.arange(6, dtype=torch.int32)[None].expand(2, 6)
    with torch.no_grad():
        naive, absorbed = m(x, pos, absorb=False), m(x, pos, absorb=True)
    np.testing.assert_allclose(naive.numpy(), absorbed.numpy(), atol=1e-4)


# ---------------------------------------------------------------------------
# deepseek-v2-lite-16b (reduced) end to end
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref():
    return setup_arch(ARCH)


def test_forward_logits_aux_and_mask(ref):
    assert check_forward(ARCH, *ref) > 0.0


def test_loss_and_every_gradient(ref):
    check_loss_and_grads(ARCH, *ref)


def test_twelve_decode_steps_and_caches(ref):
    check_decode(ARCH, *ref)


def test_serve_generates_the_reference_tokens():
    check_serve(ARCH)


def test_launcher_steps_match_the_reference(tmp_path):
    check_train_steps(ARCH, tmp_path)
