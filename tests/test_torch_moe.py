"""The port's MoE FFN (``repro_torch.models.moe``) against
``repro.models.moe`` on the CPU, and qwen3-moe-30b-a3b (reduced: 4
experts, top 2, every FFN an MoE) end to end against the JAX package.

Tolerances: ``moe_forward``'s output atol 1e-5 and its aux loss rtol 1e-5
(float32 sums in another order); the routes — ``top_idx`` and the keep
mask — bitwise (integer: a stable sort for ``top_k``, an integer cumsum
for the positions). A route flips only where the k-th and (k+1)-th
probabilities are a few ulps apart; the check names the token, the group
and that gap, and no seed is chosen to hide one. The arch-level checks are
``test_torch_arch_zoo.py``'s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe
from test_torch_arch_zoo import (  # noqa: F401  (the fixture)
    _one_torch_thread, check_decode, check_forward, check_loss_and_grads, check_serve,
    check_train_steps, setup_arch,
)

ARCH = "qwen3-moe-30b-a3b"


def _pair(d, f, E, k, shared, seed=0):
    p = jmoe.init_moe(jax.random.PRNGKey(seed), d, f, E, k, jnp.float32, num_shared=shared,
                      d_ff_shared=f if shared else None)
    m = moe.MoE(None, d, f, E, k, torch.float32, num_shared=shared,
                d_ff_shared=f if shared else None, device="cpu")
    with torch.no_grad():
        for name, v in jax.tree_util.tree_flatten_with_path(p)[0]:
            path = ".".join(str(getattr(q, "key", q)) for q in name)
            m.get_parameter(path).copy_(torch.tensor(np.asarray(v)))
    return p, m


def _reference_routes(p, x, E, k, capacity_factor, groups):
    """The reference's routing lines (``moe_forward``, ``repro/models/moe.py``)
    up to the keep mask, in JAX."""
    B, S, d = x.shape
    N = B * S
    groups = 1 if groups is None else groups
    G = groups if N % groups == 0 and N >= groups else 1
    Ng = N // G
    xt = jnp.asarray(x).reshape(G, Ng, d)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ p["router"], axis=-1)
    _, top_idx = jax.lax.top_k(probs, k)
    capacity = int(max(1, round(capacity_factor * Ng * k / E)))
    flat_e = top_idx.reshape(G, Ng * k)
    one_hot_e = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(one_hot_e, axis=1) - 1) * one_hot_e, axis=-1)
    return np.asarray(probs), np.asarray(top_idx), np.asarray(pos < capacity), capacity


def _assert_routes_equal(probs, want_idx, got_idx, k, what):
    if np.array_equal(got_idx, want_idx):
        return
    g, t = np.argwhere((got_idx != want_idx).any(-1))[0]
    srt = np.sort(probs[g, t])[::-1]
    raise AssertionError(f"{what}: route of token {t} (group {g}) flipped: reference "
                         f"{want_idx[g, t].tolist()}, port {got_idx[g, t].tolist()}; the k-th "
                         f"and (k+1)-th probabilities differ by {srt[k - 1] - srt[k]:.3e}")


CASES = {
    # (B, S, d, f, E, k, capacity_factor, groups, shared)
    "no-drop": (2, 8, 32, 48, 4, 2, 4.0, None, 0),
    "drops": (2, 8, 32, 48, 4, 2, 0.5, None, 0),
    "groups2-shared": (2, 8, 32, 48, 4, 2, 1.25, 2, 1),
    "groups-indivisible": (3, 5, 32, 48, 8, 3, 1.0, 2, 0),
    "decode-B4-64e-top6": (4, 1, 32, 16, 64, 6, 1.25, None, 2),
    "N1": (1, 1, 32, 16, 8, 2, 1.25, 4, 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_forward_matches_the_reference(case):
    B, S, d, f, E, k, cf, groups, shared = CASES[case]
    p, m = _pair(d, f, E, k, shared)
    x = np.random.default_rng(1).standard_normal((B, S, d)).astype(np.float32)
    want, want_aux = jmoe.moe_forward(p, jnp.asarray(x), num_experts=E, top_k=k,
                                      capacity_factor=cf, groups=groups)
    routes = []
    with torch.no_grad():
        got, aux = m(torch.from_numpy(x), capacity_factor=cf, groups=groups, routes=routes)
    probs, top_idx, keep, capacity = _reference_routes(p, x, E, k, cf, groups)
    _assert_routes_equal(probs, top_idx, routes[0]["top_idx"].numpy(), k, case)
    np.testing.assert_array_equal(routes[0]["keep"].numpy(), keep)
    if case == "drops":
        assert not keep.all()
    if case == "no-drop":
        assert keep.all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


@pytest.mark.parametrize("case", ["drops", "groups2-shared"])
def test_moe_gradients_match_jax_grad(case):
    B, S, d, f, E, k, cf, groups, shared = CASES[case]
    p, m = _pair(d, f, E, k, shared)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    w = rng.standard_normal((B, S, d)).astype(np.float32)

    def f_ref(p, x):
        y, aux = jmoe.moe_forward(p, x, num_experts=E, top_k=k, capacity_factor=cf,
                                  groups=groups)
        return jnp.sum(y * w) + aux

    gp, gx = jax.grad(f_ref, argnums=(0, 1))(p, jnp.asarray(x))
    m.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = m(xt, capacity_factor=cf, groups=groups)
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=0, atol=1e-5)
    for name, v in jax.tree_util.tree_flatten_with_path(gp)[0]:
        path = ".".join(str(getattr(q, "key", q)) for q in name)
        np.testing.assert_allclose(m.get_parameter(path).grad.numpy(), np.asarray(v), rtol=0,
                                   atol=1e-5, err_msg=path)


def test_top_k_breaks_ties_to_the_lower_index_as_lax_top_k():
    probs = np.array([[0.25, 0.25, 0.1, 0.25, 0.15], [0.2, 0.2, 0.2, 0.2, 0.2]], np.float32)
    for k in (1, 2, 3):
        vals, idx = moe.top_k(torch.from_numpy(probs), k)
        jvals, jidx = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("cf,Ng,k,E", [(1.25, 4, 2, 4), (1.25, 2, 2, 4), (1.25, 4, 6, 64),
                                       (16.0, 2, 6, 64), (4.0, 2, 6, 64), (0.1, 1, 1, 64)])
def test_capacity_is_the_reference_python_round(cf, Ng, k, E):
    x = torch.zeros((1, Ng, 8))
    r = moe.route(torch.zeros((8, E)), x, E, k, cf)
    assert r["capacity"] == int(max(1, round(cf * Ng * k / E)))


def test_dropped_assignments_change_nothing_kept():
    """A token whose every assignment is dropped gets only the shared
    expert's output; the dispatch writes no slot twice (repeat bitwise)."""
    B, S, d, f, E, k = 1, 12, 16, 16, 2, 2
    p, m = _pair(d, f, E, k, 1)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((B, S, d)).astype(np.float32))
    routes = []
    with torch.no_grad():
        a, _ = m(x, capacity_factor=0.25, routes=routes)
        b, _ = m(x, capacity_factor=0.25)
        shared = m.shared(x.reshape(1, S, d))
    assert torch.equal(a, b)
    keep = routes[0]["keep"].reshape(S, k)
    dropped = ~keep.any(-1)
    assert dropped.any()
    assert torch.equal(a[0, dropped], shared[0, dropped])


# ---------------------------------------------------------------------------
# qwen3-moe-30b-a3b (reduced) end to end
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
