"""jamba-1.5-large-398b (reduced: one cycle of ``M-D M-E M-D A-E M-D M-E
M-D M-E``, 4 experts, top 2; Adafactor) end to end against the JAX
package on the CPU — Mamba's conv and SSM state, a GQA cache and MoE in
one stack — and one of its Mamba layers at S = 1,024, where the
reference's chunked scan runs as two chunks of 512. Tolerances: the
arch-level checks are ``test_torch_arch_zoo.py``'s; the layer atol 1e-5
(recursive doubling here, ``lax.associative_scan``'s tree there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtf
from repro_torch.models import transformer
from test_torch_arch_zoo import (  # noqa: F401  (the fixture)
    _one_torch_thread, check_decode, check_forward, check_loss_and_grads, check_serve,
    check_train_steps, setup_arch,
)

ARCH = "jamba-1.5-large-398b"


@pytest.fixture(scope="module")
def ref():
    return setup_arch(ARCH)


def test_mamba_through_a_jamba_layer_at_1024_tokens():
    """A reduced jamba ``M-D`` layer at S = 1,024: the reference's chunked
    branch (two chunks of 512, the state carried across)."""
    jm, params, model = setup_arch(ARCH)
    cfg = model.cfg
    lp = jax.tree.map(lambda a: a[0], params["stack"]["cycle"]["0"])
    x = np.random.default_rng(3).standard_normal((1, 1024, cfg.d_model)).astype(np.float32)
    want, _ = jtf.apply_layer_forward(lp, cfg.cycle_codes[0], jnp.asarray(x),
                                      jtf._make_ctx_forward(jm.cfg, 1, 1024))
    with torch.no_grad():
        got, _ = model.layers[0](torch.from_numpy(x),
                                 transformer.make_ctx_forward(cfg, 1, 1024))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)



def test_forward_logits_aux_and_mask(ref):
    assert check_forward(ARCH, *ref) > 0.0


def test_loss_and_every_gradient(ref):
    check_loss_and_grads(ARCH, *ref)


def test_twelve_decode_steps_and_caches(ref):
    check_decode(ARCH, *ref)


def test_serve_generates_the_reference_tokens():
    check_serve(ARCH)


def test_launcher_steps_match_the_reference_with_adafactor(tmp_path):
    check_train_steps(ARCH, tmp_path)
