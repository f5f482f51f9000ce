"""The port's optimizers (``repro_torch.optim``) against the JAX package's
on the CPU: ``init`` and ``update`` on the same parameters, gradients and
state at steps 0, 1 and 9 (a 1-D, a 2-D and a 3-D parameter, a list and
an empty subtree), Adafactor's state shapes, and ``tests/test_infra.py``'s
optimizer tests mirrored. Inputs are made with numpy from a seed.

Tolerance: atol 1e-6 on parameters and state of O(1). The two packages
reduce Adafactor's means in different orders, and XLA's float32 ``pow``
and ``sqrt`` may differ from numpy's and torch's in the last ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import get_optimizer as jget_optimizer
from repro_torch.optim import get_optimizer
from repro_torch.tree import tree_map, tree_paths

ATOL = 1e-6
CASES = {
    "sgd": dict(lr=0.1),
    "sgd_momentum": dict(lr=0.1, momentum=0.9),
    "adamw": dict(lr=0.05),
    "adafactor": dict(lr=0.1),
}
SHAPES = {"b": (16,), "w": (8, 12), "stack": {"cycle": {"0": {"wq": (3, 5, 7)}},
                                              "prefix": [{"n": (6,)}], "none": None}}


def _draw(rng, scale=1.0):
    def one(shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    return _map_shapes(one, SHAPES)


def _map_shapes(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_shapes(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_shapes(fn, v) for v in tree]
    return None if tree is None else fn(tree)


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_trees_close(ours, ref, atol, what):
    ours_np = tree_paths(tree_map(lambda t: t.numpy(), ours))
    ref_np = tree_paths(jax.tree.map(np.asarray, ref))
    assert set(ours_np) == set(ref_np), what
    for path, a in ours_np.items():
        assert a.dtype == ref_np[path].dtype and a.shape == ref_np[path].shape, (what, path)
        np.testing.assert_allclose(a, ref_np[path], rtol=0, atol=atol, err_msg=f"{what} {path}")


@pytest.mark.parametrize("case", list(CASES))
def test_init_and_update_match_the_reference(case):
    name = case.split("_")[0]
    ours, ref = get_optimizer(name, **CASES[case]), jget_optimizer(name, **CASES[case])
    rng = np.random.default_rng(0)
    params = _draw(rng)
    p_t, p_j = _to_torch(params), _to_jax(params)
    s_t, s_j = ours.init(p_t), ref.init(p_j)
    _assert_trees_close(s_t, s_j, 0.0, "init")
    for step in (0, 1, 9):
        grads = _draw(rng, scale=0.5)
        before = tree_map(torch.clone, p_t)
        p_t, s_t = ours.update(_to_torch(grads), s_t, p_t, step)
        p_j, s_j = ref.update(_to_jax(grads), s_j, p_j, jnp.int32(step))
        _assert_trees_close(p_t, p_j, ATOL, f"params at step {step}")
        _assert_trees_close(s_t, s_j, ATOL, f"state at step {step}")
        moved = [not torch.equal(a, b) for a, b in zip(tree_paths(before).values(),
                                                       tree_paths(p_t).values())]
        assert all(moved), step


def test_adafactor_state_shapes_equal_the_reference():
    params = _draw(np.random.default_rng(1))
    ours = tree_paths(get_optimizer("adafactor").init(_to_torch(params)))
    ref = tree_paths(jget_optimizer("adafactor").init(_to_jax(params)))
    assert {k: tuple(v.shape) for k, v in ours.items()} == {k: v.shape for k, v in ref.items()}
    assert ours["stack/cycle/0/wq/vr"].shape == (3, 5)
    assert ours["stack/cycle/0/wq/vc"].shape == (3, 7)
    assert ours["b/v"].shape == (16,)


def test_unknown_optimizer_raises():
    with pytest.raises(KeyError):
        get_optimizer("lion")


# ---------------------------------------------------------------------------
# tests/test_infra.py's optimizer tests, on the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["sgd", "adamw", "adafactor"])
def test_optimizer_minimizes_quadratic(name):
    opt = get_optimizer(name, lr=0.1 if name != "adamw" else 0.05)
    target = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 16)).astype(np.float32))
    params = {"w": torch.zeros((8, 16)), "b": torch.zeros((16,))}
    state = opt.init(params)

    def loss_fn(p):
        return torch.sum((p["w"] + p["b"][None] - target) ** 2) / 8.0

    loss0 = float(loss_fn(params))
    for i in range(150):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        g = dict(zip(leaves, torch.autograd.grad(loss_fn(leaves), list(leaves.values()))))
        params, state = opt.update(g, state, params, i)
    assert float(loss_fn(params)) < loss0 * 0.1, name


def test_adafactor_state_is_factored():
    opt = get_optimizer("adafactor")
    st = opt.init({"w": torch.zeros((64, 32)), "b": torch.zeros((32,))})
    assert st["w"]["vr"].shape == (64,)
    assert st["w"]["vc"].shape == (32,)
    assert st["b"]["v"].shape == (32,)
