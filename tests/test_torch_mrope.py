"""M-RoPE (``repro_torch.models.layers.mrope_angles``,
``text_mrope_positions``) against ``repro.models.layers`` on the CPU, and
qwen2-vl-7b (reduced: M-RoPE sections rescaled by ``reduced()``, qkv
biases, 16 zero-or-random patch embeddings before the text) end to end
against the JAX package.

Tolerances: the angles by PR 14's rule (atol 2e-6 at positions below 64;
5e-4 up to 4,096, where an ulp of a frequency moves the angle by ~2e-4
rad); the text positions bitwise; the arch-level checks are
``test_torch_arch_zoo.py``'s, the vision batch's mask bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch import configs
from repro_torch.models import layers
from test_torch_arch_zoo import (  # noqa: F401  (the fixture)
    _one_torch_thread, check_decode, check_forward, check_loss_and_grads, check_serve,
    check_train_steps, setup_arch,
)

ARCH = "qwen2-vl-7b"


@pytest.mark.parametrize("head_dim,sections,hi,atol", [
    (128, (16, 24, 24), 64, 2e-6), (128, (16, 24, 24), 4096, 5e-4), (32, (6, 5, 5), 64, 2e-6)])
def test_mrope_angles_match_the_reference(head_dim, sections, hi, atol):
    rng = np.random.default_rng(0)
    pos = rng.integers(0, hi, (3, 2, 7)).astype(np.int32)
    got = layers.mrope_angles(torch.from_numpy(pos), head_dim, 1e6, sections)
    want = jlayers.mrope_angles(jnp.asarray(pos), head_dim, 1e6, sections)
    for a, b in zip(got, want):
        assert a.shape == b.shape == (2, 7, head_dim // 2)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol)


def test_mrope_bands_follow_their_axis():
    """Band j's angle comes from the axis owning it: with only the height
    axis moving, only the height bands' angles move."""
    pos = torch.zeros((3, 1, 4), dtype=torch.int32)
    pos[1] = torch.arange(4)
    cos, _ = layers.mrope_angles(pos, 32, 1e4, (6, 5, 5))
    moved = (cos[0, 1:] != cos[0, :1]).any(0)
    assert moved.tolist() == [False] * 6 + [True] * 5 + [False] * 5
    with pytest.raises(ValueError, match="sum"):
        layers.mrope_angles(pos, 32, 1e4, (6, 5, 4))


@pytest.mark.parametrize("start", [0, 5])
def test_text_mrope_positions_are_the_reference(start):
    got = layers.text_mrope_positions(2, 6, start)
    want = jlayers.text_mrope_positions(2, 6, start)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_reduced_sections_are_the_reference_rule():
    ours, theirs = configs.get_config(ARCH).reduced(), jconfigs.get_config(ARCH).reduced()
    assert ours.mrope_sections == theirs.mrope_sections
    assert sum(ours.mrope_sections) == ours.resolved_head_dim // 2


# ---------------------------------------------------------------------------
# qwen2-vl-7b (reduced) end to end
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref():
    return setup_arch(ARCH)


def test_forward_logits_aux_and_mask_with_patches(ref):
    """Random patch embeddings before the text; the mask's zeros over them."""
    assert check_forward(ARCH, *ref) == 0.0


def test_forward_with_3d_positions(ref):
    """An explicit (3, B, S) position grid (a 4 × 4 image's t/h/w ids, then
    text) through the forward of both packages."""
    jm, params, model = ref
    cfg = model.cfg
    P = cfg.frontend_tokens
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (2, 5), dtype=np.int32)
    pe = rng.standard_normal((2, P, cfg.d_model)).astype(np.float32)
    hh, ww = np.divmod(np.arange(P), 4)
    img = np.stack([np.zeros(P), hh, ww]).astype(np.int32)
    text = np.broadcast_to(np.arange(4, 4 + 5, dtype=np.int32), (3, 5))
    pos = np.broadcast_to(np.concatenate([img, text], 1)[:, None], (3, 2, P + 5)).copy()
    jl, _, _ = jtf.forward_logits(params, jm.cfg, {"tokens": jnp.asarray(toks),
                                                   "patch_embeds": jnp.asarray(pe),
                                                   "positions": jnp.asarray(pos)})
    with torch.no_grad():
        logits, _, mask = model.forward_logits({"tokens": torch.from_numpy(toks),
                                                "patch_embeds": torch.from_numpy(pe),
                                                "positions": torch.from_numpy(pos)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    assert mask[:, :P].sum() == 0 and mask[:, P:].all()


def test_loss_and_every_gradient(ref):
    check_loss_and_grads(ARCH, *ref)


def test_twelve_decode_steps_and_caches(ref):
    check_decode(ARCH, *ref)


def test_serve_generates_the_reference_tokens():
    check_serve(ARCH)


def test_launcher_steps_match_the_reference(tmp_path):
    check_train_steps(ARCH, tmp_path)
