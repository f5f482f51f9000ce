"""The LLM decode path of the port (``repro_torch.configs``, ``.models``,
``.launch.decode_llm``) on the CPU against the JAX package: the configs
field by field, the init's keys and weights, the building blocks, the
decode step across the switch to K7 on a full ring (logits and ring
contents), and ``serve``'s tokens. Inputs are made with numpy from a seed;
weights go across with ``convert.from_jax_model_params``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import erfinv

from repro import configs as jconfigs
from repro.configs import sgns_wiki as jwiki
from repro.launch.decode_llm import serve as jax_serve
from repro.models import Model as JaxModel
from repro.models import layers as jlayers
from repro_torch import configs, convert, prng
from repro_torch.configs import sgns_wiki
from repro_torch.launch.decode_llm import serve
from repro_torch.models import Model, attention, layers, transformer

PORTED = tuple(jconfigs.ARCH_IDS)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_and_reduced_equal_the_reference_field_by_field(arch):
    ours, theirs = configs.get_config(arch), jconfigs.get_config(arch)
    for a, b in ((ours, theirs), (ours.reduced(), theirs.reduced()),
                 (ours.reduced().with_overrides(num_kv_heads=2),
                  theirs.reduced().with_overrides(num_kv_heads=2))):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (a.resolved_head_dim, a.padded_vocab, a.resolved_num_cycles,
                a.layer_codes()) == (b.resolved_head_dim, b.padded_vocab,
                                     b.resolved_num_cycles, b.layer_codes())
        for shape in jconfigs.SHAPES:
            assert configs.supports_shape(a, shape) == jconfigs.supports_shape(b, shape)
            assert (dataclasses.asdict(configs.config_for_shape(a, shape))
                    == dataclasses.asdict(jconfigs.config_for_shape(b, shape)))


def test_registry_shapes_and_sgns_wiki_equal_the_reference():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert configs.LONG_500K_SKIPS == jconfigs.LONG_500K_SKIPS
    assert ({k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()})
    for kind in ("train", "prefill", "decode"):
        assert (dataclasses.asdict(configs.smoke_shape(kind))
                == dataclasses.asdict(jconfigs.smoke_shape(kind)))
    assert dataclasses.asdict(sgns_wiki.CONFIG) == dataclasses.asdict(jwiki.CONFIG)
    assert sgns_wiki.SAMPLING_RATES == jwiki.SAMPLING_RATES
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-2")


# ---------------------------------------------------------------------------
# Init: keys bitwise, weights within the normal rule
# ---------------------------------------------------------------------------
def _jax_param_keys(cfg, seed):
    """``{parameter name: (key, scale)}`` for every drawn parameter, derived
    with ``jax.random`` along the reference's init (``init_model``,
    ``init_stack``, ``init_layer``, ``init_gqa``, ``init_mlp``)."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 6)
    d, Vp = cfg.d_model, cfg.padded_vocab
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    out = {"embed": (ks[0], 0.02)}
    if not cfg.tie_embeddings:
        out["lm_head"] = (ks[2], (2.0 / (d + Vp)) ** 0.5)
    kp, kc = jax.random.split(ks[1])
    layer_keys = [k for kcyc in jax.random.split(kc, cfg.resolved_num_cycles)
                  for k in jax.random.split(kcyc, len(cfg.cycle_codes))]
    assert not cfg.prefix_codes
    for i, lk in enumerate(layer_keys):
        k4 = jax.random.split(lk, 4)
        fans = {"wq": (d, H * hd), "wk": (d, Hkv * hd), "wv": (d, Hkv * hd),
                "wo": (H * hd, d)}
        for name, k in zip(("wq", "wk", "wv", "wo"), jax.random.split(k4[0], 4)):
            out[f"layers.{i}.attn.{name}"] = (k, (2.0 / sum(fans[name])) ** 0.5)
        fans = {"gate": (d, cfg.d_ff), "up": (d, cfg.d_ff), "down": (cfg.d_ff, d)}
        for name, k in zip(("gate", "up", "down"), jax.random.split(k4[1], 3)):
            out[f"layers.{i}.ffn.{name}"] = (k, (2.0 / sum(fans[name])) ** 0.5)
    return out


def test_layer_keys_are_the_reference_init_stack_keys():
    cfg = configs.get_config("h2o-danube-1.8b").reduced()
    ks = jax.random.split(jax.random.PRNGKey(5), 6)
    kp, kc = jax.random.split(ks[1])
    want = [np.asarray(k) for kcyc in jax.random.split(kc, cfg.resolved_num_cycles)
            for k in jax.random.split(kcyc, len(cfg.cycle_codes))]
    got = transformer.layer_keys(prng.split(prng.PRNGKey(5), 6)[1], cfg.prefix_codes,
                                 cfg.cycle_codes, cfg.resolved_num_cycles)
    assert len(got) == cfg.num_layers == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "qwen1.5-0.5b"])
def test_init_matches_the_reference_init(arch):
    """Every drawn parameter is ``scale·normal(key)`` with the reference's
    key (bitwise, above); ``normal``'s uniforms are bitwise, its erfinv is
    not. The normal rule of ``PERF.md`` §2 bounds each package against the
    exact ``sqrt(2)·erfinv(u)``: the port by 4 ulps, XLA by 16 ulps plus
    half an ulp of u's effect; so the two differ by at most their sum,
    scaled, plus an ulp of each scaled value. Norm scales (ones), the
    qkv biases (zeros) and the tied head are equal."""
    cfg = configs.get_config(arch).reduced()
    jparams = JaxModel(jconfigs.get_config(arch).reduced()).init(jax.random.PRNGKey(0))
    flat = dict(convert.from_jax_model_params(cfg, jax.tree.map(np.asarray, jparams))
                .named_parameters())
    ours = dict(Model(cfg, prng.PRNGKey(0), device="cpu").named_parameters())
    assert set(ours) == set(flat)
    drawn = _jax_param_keys(cfg, 0)
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32))
    for name, p in ours.items():
        got, ref = p.numpy(), flat[name].numpy()
        assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape, name
        if name not in drawn:
            np.testing.assert_array_equal(got, ref, err_msg=name)
            continue
        key, scale = drawn[name]
        u = prng.uniform(np.asarray(key), got.shape, lo, 1.0).numpy().astype(np.float64)
        exact = np.sqrt(2.0) * erfinv(u)
        ulp_x = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
        half_ulp_u = 0.5 * np.spacing(np.abs(u).astype(np.float32)).astype(np.float64) \
            * np.sqrt(np.pi / 2) * np.exp(exact ** 2 / 2)
        bound = (np.float32(scale) * (20 * ulp_x + half_ulp_u)
                 + np.spacing(np.abs(got)) + np.spacing(np.abs(ref)))
        err = np.abs(got.astype(np.float64) - ref)
        assert (err <= bound).all(), (name, float((err / bound).max()))


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------
def test_rms_norm_apply_rope_and_mlp_match_the_reference():
    """float32 on the same inputs: rsqrt, pow, sin/cos and the matmuls may
    differ in the last ulp between XLA and torch (atol 2e-6 on O(1))."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 48)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)), atol=2e-6)

    pos = rng.integers(0, 4096, (2, 3)).astype(np.int32)
    cos, sin = layers.rope_angles(torch.from_numpy(pos), 32, 1e4)
    jcos, jsin = jlayers.rope_angles(jnp.asarray(pos), 32, 1e4)
    # at positions up to 4096 an ulp of a frequency moves the angle by ~2e-4 rad
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=5e-4)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=5e-4)
    xh = rng.standard_normal((2, 3, 4, 32)).astype(np.float32)
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(xh), torch.tensor(np.asarray(jcos)),
                          torch.tensor(np.asarray(jsin))).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(xh), jcos, jsin)), atol=2e-6)
    small = rng.integers(0, 64, (2, 3)).astype(np.int32)
    for a, b in zip(layers.rope_angles(torch.from_numpy(small), 32, 1e4),
                    jlayers.rope_angles(jnp.asarray(small), 32, 1e4)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6)

    w = {k: (0.2 * rng.standard_normal(s)).astype(np.float32)
         for k, s in (("gate", (48, 64)), ("up", (48, 64)), ("down", (64, 48)))}
    np.testing.assert_allclose(
        layers.mlp(torch.from_numpy(x), *(torch.from_numpy(w[k]) for k in
                                         ("gate", "up", "down"))).numpy(),
        np.asarray(jlayers.mlp({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x))),
        atol=2e-6)


# ---------------------------------------------------------------------------
# The decode step across the full-ring switch
# ---------------------------------------------------------------------------
def _danube(num_kv_heads):
    jcfg = jconfigs.get_config("h2o-danube-1.8b").reduced()
    cfg = configs.get_config("h2o-danube-1.8b").reduced()
    if num_kv_heads is not None:
        jcfg = jcfg.with_overrides(num_kv_heads=num_kv_heads)
        cfg = cfg.with_overrides(num_kv_heads=num_kv_heads)
    return cfg, jcfg


@pytest.mark.parametrize("num_kv_heads", [None, 2], ids=["rep1", "rep2"])
def test_decode_step_matches_the_reference_across_the_full_ring(num_kv_heads, monkeypatch):
    """Reduced h2o-danube (window 32, 2 layers; 4 query heads over 4 or 2
    KV heads), B = 2, S = W + 13 = 45 teacher-forced steps from the
    reference's weights: the ring fills at pos 31, from where both layers
    run K7 (28 calls). Logits and the rings after every step within atol
    1e-5 (measured: at most 2.9e-6 on logits of |x| < 3, 3.3e-6 on the
    rings; reduction order, rsqrt and pow in the last ulp)."""
    cfg, jcfg = _danube(num_kv_heads)
    W = cfg.attention_window
    B, S = 2, W + 13
    jm = JaxModel(jcfg)
    params = jm.init(jax.random.PRNGKey(1))
    model = convert.from_jax_model_params(cfg, jax.tree.map(np.asarray, params))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S), dtype=np.int32)

    calls = []
    real = attention.swa_decode

    def spy(q, k, v, **kw):
        calls.append(kw["chunk"])
        return real(q, k, v, **kw)

    monkeypatch.setattr(attention, "swa_decode", spy)
    step = jax.jit(jm.make_decode_step())
    jcache = jm.init_cache(B, W)
    cache = model.init_cache(B, W)
    for i in range(S):
        jl, jcache = step(params, jcache, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        with torch.inference_mode():
            logits, cache = model.decode_step(cache, torch.from_numpy(toks[:, i:i + 1]), i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-5,
                                   err_msg=f"logits at pos {i}")
        ours = convert.to_jax_cache(cfg, cache)
        for name in ("k", "v"):
            np.testing.assert_allclose(ours["cycle"]["0"][name],
                                       np.asarray(jcache["cycle"]["0"][name]), atol=1e-5,
                                       err_msg=f"ring {name} at pos {i}")
    assert calls == [W] * (cfg.num_layers * (S - (W - 1)))


@pytest.mark.parametrize("num_kv_heads", [None, 2], ids=["rep1", "rep2"])
def test_full_ring_through_k7_equals_the_plain_masked_attention(num_kv_heads):
    """The same steps with ``swa_kernel=False`` (the reference's masked
    ``_sdpa`` on every step): the two routes differ only in scaling by
    1/sqrt(D) or dividing by sqrt(D) and in reduction order."""
    cfg, _ = _danube(num_kv_heads)
    W = cfg.attention_window
    model = Model(cfg, prng.PRNGKey(2), device="cpu")
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (2, W + 6), dtype=np.int32))
    caches = [model.init_cache(2, W), model.init_cache(2, W)]
    with torch.inference_mode():
        for i in range(W + 6):
            a, _ = model.decode_step(caches[0], toks[:, i:i + 1], i)
            b, _ = model.decode_step(caches[1], toks[:, i:i + 1], i, swa_kernel=False)
            if i < W - 1:
                assert torch.equal(a, b)
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-6)


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,kw", [
    ("h2o-danube-1.8b", dict(batch=2, prompt_len=40, new_tokens=8)),
    ("qwen1.5-0.5b", dict(batch=2, prompt_len=6, new_tokens=8)),
], ids=["h2o-danube-1.8b", "qwen1.5-0.5b"])
def test_serve_generates_the_reference_tokens(arch, kw):
    """Greedy tokens are integers: equal. h2o-danube's ring (32) fills at
    pos 31 and wraps; qwen1.5-0.5b has tied embeddings, qkv biases and a
    full-attention cache."""
    want, _ = jax_serve(arch, reduced=True, **kw)
    got, stats = serve(arch, reduced=True, device="cpu", **kw)
    assert got.dtype == torch.int32 and got.shape == (kw["batch"], kw["new_tokens"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(stats) == {"prefill_s", "decode_s", "tok_per_s"}


@pytest.mark.parametrize("arch", PORTED)
def test_decode_cache_len_matches_the_reference(arch):
    ours = Model(configs.get_config(arch), device="meta")
    theirs = JaxModel(jconfigs.get_config(arch))
    for name, shape in jconfigs.SHAPES.items():
        assert ours.decode_cache_len(configs.SHAPES[name]) == theirs.decode_cache_len(shape)


def test_serve_refuses_to_run_on_the_cpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve("h2o-danube-1.8b", reduced=True, batch=1, prompt_len=2, new_tokens=1)


def test_converter_refuses_a_tree_of_another_model():
    cfg = configs.get_config("qwen1.5-0.5b").reduced()
    params = jax.tree.map(np.asarray, JaxModel(jconfigs.get_config("llama3-8b").reduced())
                          .init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="lm_head"):
        convert.from_jax_model_params(cfg, params)
