"""xlstm-1.3b (reduced: one cycle of ``m m s m m m m m``: mLSTM's matrix
memory and sLSTM's scalar state) end to end against the JAX package on
the CPU. Tolerances: ``test_torch_arch_zoo.py``'s, 2e-4 for this arch
(eight recurrent layers grow a 5e-6 difference: ``PERF.md`` §2); the
mixers one by one are in ``test_torch_ssm.py``."""

import pytest

from test_torch_arch_zoo import (  # noqa: F401  (the fixture)
    _one_torch_thread, check_decode, check_forward, check_loss_and_grads, check_serve,
    check_train_steps, setup_arch,
)

ARCH = "xlstm-1.3b"


@pytest.fixture(scope="module")
def ref():
    return setup_arch(ARCH)


def test_forward_logits_aux_and_mask(ref):
    assert check_forward(ARCH, *ref) == 0.0


def test_loss_and_every_gradient(ref):
    check_loss_and_grads(ARCH, *ref)


def test_twelve_decode_steps_and_caches(ref):
    check_decode(ARCH, *ref)


def test_serve_generates_the_reference_tokens():
    check_serve(ARCH)


def test_launcher_steps_match_the_reference(tmp_path):
    check_train_steps(ARCH, tmp_path)
