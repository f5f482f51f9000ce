"""The port's state-space and recurrent mixers (``repro_torch.models.ssm``:
Mamba, sLSTM, mLSTM) against ``repro.models.ssm`` on the CPU, each branch
of each (chunked and not, segmented and not) and their decode states, and
xlstm-1.3b (reduced: the ``m m s m m m m m`` cycle) end to end against the
JAX package.

Tolerances: the mixers' outputs and decode states atol 1e-5 on O(1)
values (measured ≤ 1e-6: transcendental functions and matmul sums in the
last ulps). Mamba's scan is recursive doubling here and
``lax.associative_scan``'s tree there (at S = 1,024 through a jamba layer:
``test_torch_hybrid.py``). The constant inits (``A_log``, ``D``, ``dt_bias``, ``conv_b``, ``b``, the raw
``norm``s) are bitwise. xlstm-1.3b's arch-level checks use 2e-4
(``test_torch_arch_zoo.py``: eight recurrent layers grow a 5e-6
difference)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch import configs, convert
from repro_torch.models import ssm, transformer
from test_torch_arch_zoo import _one_torch_thread  # noqa: F401  (the fixture)
D, H = 64, 4


def _load(module, params):
    with torch.no_grad():
        for k, v in params.items():
            getattr(module, k).copy_(torch.tensor(np.asarray(v)))
    return module


def _x(S, seed=0, b=2):
    return np.random.default_rng(seed).standard_normal((b, S, D)).astype(np.float32)


def _mamba(seed=5, di=128):
    p = jssm.init_mamba(jax.random.PRNGKey(seed), D, d_inner=di, d_state=16, d_conv=4,
                        dtype=jnp.float32)
    m = ssm.Mamba(None, D, d_inner=di, d_state=16, d_conv=4, dtype=torch.float32, device="cpu")
    consts = {k: getattr(m, k).detach().clone() for k in ("A_log", "D", "dt_bias", "conv_b")}
    return p, _load(m, p), consts


def test_constant_inits_are_the_reference_bitwise():
    p, _, consts = _mamba()
    for k, v in consts.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(p[k]), err_msg=k)
    sp = jssm.init_slstm(jax.random.PRNGKey(0), D, H, jnp.float32)
    s = ssm.SLSTM(None, D, H, torch.float32, "cpu")
    mp = jssm.init_mlstm(jax.random.PRNGKey(0), D, H, expand=2, dtype=jnp.float32)
    m = ssm.MLSTM(None, D, H, expand=2, dtype=torch.float32, device="cpu")
    for mod, ref, names in ((s, sp, ("b", "norm")), (m, mp, ("norm",))):
        for k in names:
            np.testing.assert_array_equal(getattr(mod, k).detach().numpy(), np.asarray(ref[k]))


def test_linear_scan_is_the_recurrence():
    rng = np.random.default_rng(0)
    for c in (1, 2, 3, 7, 8, 33):
        a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, c, 3, 4)).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal((2, c, 3, 4)).astype(np.float32))
        h, want = torch.zeros((2, 3, 4)), []
        for t in range(c):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        np.testing.assert_allclose(ssm.linear_scan(a, b).numpy(),
                                   torch.stack(want, 1).numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("S,chunk", [(12, 512), (16, 4), (16, 0), (13, 4)],
                         ids=["one-segment", "chunked", "no-chunk", "indivisible"])
def test_mamba_forward_matches_the_reference(S, chunk):
    p, m, _ = _mamba()
    x = _x(S)
    want = jssm.mamba_forward(p, jnp.asarray(x), d_inner=128, d_state=16, chunk=chunk)
    with torch.no_grad():
        got = m(torch.from_numpy(x), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_mamba_decode_states_match_the_reference():
    p, m, _ = _mamba()
    x = _x(9, 1)
    jc = jssm.init_mamba_cache(2, 128, 16, 4, jnp.float32)
    c = ssm.init_mamba_cache(2, 128, 16, 4, torch.float32)
    for t in range(9):
        jc, want = jssm.mamba_decode(p, jc, jnp.asarray(x[:, t:t + 1]), d_inner=128,
                                     d_state=16)
        with torch.no_grad():
            got = m.decode(c, torch.from_numpy(x[:, t:t + 1]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
        for k in ("conv", "h"):
            np.testing.assert_allclose(c[k].numpy(), np.asarray(jc[k]), rtol=0, atol=1e-5,
                                       err_msg=f"{k} at step {t}")


def _slstm(seed=4):
    p = jssm.init_slstm(jax.random.PRNGKey(seed), D, H, jnp.float32)
    return p, _load(ssm.SLSTM(None, D, H, torch.float32, "cpu"), p)


@pytest.mark.parametrize("S,segment", [(12, 64), (128, 64), (128, 0)],
                         ids=["short", "segmented", "monolithic"])
def test_slstm_forward_matches_the_reference(S, segment):
    p, m = _slstm()
    x = _x(S, 2)
    want = jssm.slstm_forward(p, jnp.asarray(x), n_heads=H, segment=segment)
    with torch.no_grad():
        got = m(torch.from_numpy(x), segment=segment)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_slstm_decode_states_match_the_reference():
    p, m = _slstm()
    x = _x(10, 3)
    st = jssm.init_slstm_state(2, H, D // H)
    c = ssm.init_slstm_state(2, H, D // H)
    for t in range(10):
        st, want = jssm.slstm_decode(p, st, jnp.asarray(x[:, t:t + 1]), n_heads=H)
        with torch.no_grad():
            got = m.decode(c, torch.from_numpy(x[:, t:t + 1]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
        for k, v in zip(("h", "c", "n", "m"), st):
            np.testing.assert_allclose(c[k].numpy(), np.asarray(v), rtol=0, atol=1e-5,
                                       err_msg=f"{k} at step {t}")


def _mlstm(seed=3):
    p = jssm.init_mlstm(jax.random.PRNGKey(seed), D, H, expand=2, dtype=jnp.float32)
    return p, _load(ssm.MLSTM(None, D, H, expand=2, dtype=torch.float32, device="cpu"), p)


@pytest.mark.parametrize("S,chunk", [(12, 256), (32, 8), (32, 0), (30, 8)],
                         ids=["short", "chunkwise", "step-scan", "indivisible"])
def test_mlstm_forward_matches_the_reference(S, chunk):
    p, m = _mlstm()
    x = _x(S, 4)
    want = jssm.mlstm_forward(p, jnp.asarray(x), n_heads=H, expand=2, chunk=chunk)
    with torch.no_grad():
        got = m(torch.from_numpy(x), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_mlstm_chunkwise_equals_the_step_scan():
    """``_mlstm_chunk_scan``'s claim, on the port: the chunkwise form is
    the step scan."""
    _, m = _mlstm()
    x = torch.from_numpy(_x(32, 5))
    with torch.no_grad():
        np.testing.assert_allclose(m(x, chunk=8).numpy(), m(x, chunk=0).numpy(), rtol=0,
                                   atol=1e-5)


def test_mlstm_decode_states_match_the_reference():
    p, m = _mlstm()
    x = _x(10, 6)
    dh = 2 * D // H
    st = jssm.init_mlstm_state(2, H, dh)
    c = ssm.init_mlstm_state(2, H, dh)
    for t in range(10):
        st, want = jssm.mlstm_decode(p, st, jnp.asarray(x[:, t:t + 1]), n_heads=H, expand=2)
        with torch.no_grad():
            got = m.decode(c, torch.from_numpy(x[:, t:t + 1]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
        for k, v in zip(("C", "n", "m"), st):
            np.testing.assert_allclose(c[k].numpy(), np.asarray(v), rtol=0, atol=1e-5,
                                       err_msg=f"{k} at step {t}")


@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm"])
def test_mixer_gradients_match_jax_grad(mixer):
    """Through each branch that remats (chunked Mamba, chunkwise mLSTM,
    segmented sLSTM): the inputs' and parameters' gradients."""
    S = {"mamba": 16, "mlstm": 32, "slstm": 128}[mixer]
    p, m = {"mamba": lambda: _mamba()[:2], "mlstm": _mlstm, "slstm": _slstm}[mixer]()
    fwd = {"mamba": (lambda p, x: jssm.mamba_forward(p, x, d_inner=128, d_state=16, chunk=4),
                     dict(chunk=4)),
           "mlstm": (lambda p, x: jssm.mlstm_forward(p, x, n_heads=H, expand=2, chunk=8),
                     dict(chunk=8)),
           "slstm": (lambda p, x: jssm.slstm_forward(p, x, n_heads=H, segment=64),
                     dict(segment=64))}[mixer]
    x = _x(S, 7)
    w = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)
    gp, gx = jax.grad(lambda p, x: jnp.sum(fwd[0](p, x) * w), argnums=(0, 1))(p, jnp.asarray(x))
    m.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    (m(xt, **fwd[1]) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=0, atol=1e-5)
    for k, v in gp.items():
        scale = max(1.0, float(np.abs(v).max()))
        np.testing.assert_allclose(getattr(m, k).grad.numpy(), np.asarray(v), rtol=0,
                                   atol=1e-5 * scale, err_msg=k)


def test_init_cache_kinds_match_the_reference():
    """Every cache kind's keys, shapes and dtypes, through ``to_jax_cache``
    (xlstm: ``C``/``n``/``m`` and ``h``/``c``/``n``/``m``; jamba: ``conv``/
    ``h`` and ``k``/``v``)."""
    for arch in ("xlstm-1.3b", "jamba-1.5-large-398b"):
        jcache = jax.tree.map(np.asarray, jtf.init_cache(jconfigs.get_config(arch).reduced(),
                                                         2, 7))
        ours = convert.to_jax_cache(configs.get_config(arch).reduced(),
                                    transformer.init_cache(configs.get_config(arch).reduced(),
                                                           2, 7, device="cpu"))
        want = jax.tree_util.tree_flatten_with_path(jcache)[0]
        got = dict(jax.tree_util.tree_flatten_with_path(ours)[0])
        assert set(got) == {k for k, _ in want}
        for k, v in want:
            assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
            assert not got[k].any()
