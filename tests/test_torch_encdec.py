"""Cross-attention (``GQA.cross``, ``GQA.encode_kv``) against
``repro.models.attention``'s ``cross_forward`` and ``encode_kv`` on the
CPU, and seamless-m4t-large-v2 (reduced: 2 encoder ``A-D`` layers, 2
decoder ``C-D`` layers) end to end against the JAX package: the forward
over frames and tokens, ``prefill_encoder``'s cross K/V, decode, ``serve``
(zero frames, one a prompt token) and the launcher's batch dicts.

Tolerances: cross-attention atol 1e-5; the arch-level checks are
``test_torch_arch_zoo.py``'s (``prefill_encoder``'s cross K/V among the
caches). The reference's encoder is causal (``gqa_forward``'s default);
so is the port's, and a test pins that parity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro_torch.models import attention, transformer
from test_torch_arch_zoo import (  # noqa: F401  (the fixture)
    _one_torch_thread, check_decode, check_forward, check_loss_and_grads, check_serve,
    check_train_steps, setup_arch,
)

ARCH = "seamless-m4t-large-v2"
D, H, HKV, HD = 48, 4, 2, 12


@pytest.mark.parametrize("bias", [False, True])
def test_cross_forward_and_encode_kv_match_the_reference(bias):
    p = jattn.init_gqa(jax.random.PRNGKey(0), D, H, HKV, HD, jnp.float32, qkv_bias=bias)
    m = attention.GQA(None, D, H, HKV, HD, torch.float32, qkv_bias=bias, device="cpu")
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for k, v in p.items():
            v = np.asarray(v) + (0.1 * rng.standard_normal(v.shape).astype(np.float32)
                                 if k.startswith("b") else 0)
            p[k] = jnp.asarray(v)
            getattr(m, k).copy_(torch.tensor(np.asarray(v)))
    x = rng.standard_normal((2, 5, D)).astype(np.float32)
    enc = rng.standard_normal((2, 9, D)).astype(np.float32)
    kv = jattn.encode_kv(p, jnp.asarray(enc), n_kv=HKV, head_dim=HD)
    want = jattn.cross_forward(p, jnp.asarray(x), kv, n_heads=H, n_kv=HKV, head_dim=HD)
    with torch.no_grad():
        ours_kv = m.encode_kv(torch.from_numpy(enc))
        got = m.cross(torch.from_numpy(x), ours_kv["k"], ours_kv["v"])
    for k in ("k", "v"):
        np.testing.assert_allclose(ours_kv[k].numpy(), np.asarray(kv[k]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# seamless-m4t-large-v2 (reduced) end to end
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref():
    return setup_arch(ARCH)


def test_forward_logits_aux_and_mask(ref):
    assert check_forward(ARCH, *ref) == 0.0


def test_the_encoder_is_causal_as_the_reference_one(ref):
    """Changing the last frame moves only the last encoder position's
    output, in both packages (``ROADMAP.md`` queue 3's parity note)."""
    jm, params, model = ref
    cfg = model.cfg
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((1, 6, cfg.d_model)).astype(np.float32)
    moved = frames.copy()
    moved[:, -1] += 1.0
    with torch.no_grad():
        a, b = (transformer.encode(model, torch.from_numpy(f)) for f in (frames, moved))
    assert torch.equal(a[:, :-1], b[:, :-1]) and not torch.equal(a[:, -1], b[:, -1])
    ctx = jtf._make_ctx_forward(jm.cfg, 1, 6)
    ctx.window = None
    ja, jb = (jtf.run_stack_forward(params["enc"]["stack"], jm.cfg, jnp.asarray(f), ctx, (),
                                    ("A-D",))[0] for f in (frames, moved))
    np.testing.assert_array_equal(np.asarray(ja)[:, :-1], np.asarray(jb)[:, :-1])
    np.testing.assert_allclose(a.numpy(), jtf.rms_norm(ja, params["enc"]["final_norm"],
                                                       cfg.norm_eps), rtol=0, atol=1e-5)


def test_loss_and_every_gradient(ref):
    check_loss_and_grads(ARCH, *ref)


def test_prefill_encoder_and_twelve_decode_steps(ref):
    check_decode(ARCH, *ref)


def test_serve_generates_the_reference_tokens():
    check_serve(ARCH)


def test_launcher_steps_match_the_reference(tmp_path):
    check_train_steps(ARCH, tmp_path)
