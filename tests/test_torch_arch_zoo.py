"""Every arch of the registry on the port (``repro_torch.models``), on the
CPU: the reference's own smoke and consistency checks
(``tests/test_models_smoke.py``, ``tests/test_decode_consistency.py``; its
training tests in ``test_torch_arch_training.py``) run on the port, the six archs of slice 14 (MoE, MLA, Mamba, mLSTM/sLSTM,
M-RoPE with the vision stub, encoder-decoder) initialised from the
reference's keys, and the parameter tree's round trip for all ten.

It also holds the helpers the per-arch parity files share
(``test_torch_moe.py``, ``test_torch_mla.py``, ``test_torch_ssm.py``,
``test_torch_hybrid.py``, ``test_torch_mrope.py``, ``test_torch_encdec.py``):
the reference's weights go across with ``convert.from_jax_model_params``
(never an init from a key on each side: the two ``normal``s differ in the
last ulps), inputs are made with numpy from a seed. Their tolerances, on
O(1) values (PR 23's):

* ``forward_logits``' logits atol 1e-5, its aux loss rtol 1e-5, the mask
  bitwise; ``loss_fn`` rtol 1e-5; each gradient atol 1e-5 scaled by its
  tensor's largest |g| where that exceeds 1 (a gradient of magnitude 32
  carries ulps of 4e-6);
* 12 decode steps: logits and every cache (``to_jax_cache``) atol 1e-5
  (scaled likewise);
* xlstm-1.3b: 2e-4 for all of these. Its layers on identical inputs agree
  within 5e-6 (``test_torch_ssm.py``), but eight recurrent layers carry a
  difference forward and grow it (measured: 3.4e-6 after the first layer,
  6.1e-5 in the residual stream after the eighth; logits 2.3e-5, gradients
  9.7e-5 on the embedding's largest 7.6; over 12 decode steps of 4 token
  seeds the logits ≤ 3.5e-5 but for one step at 1.1e-4, where an mLSTM
  read-out's denominator is small, the caches ≤ 2.0e-5): ``PERF.md`` §2;
* ``serve`` tokens bitwise; two launcher steps from the reference's init
  checkpoint: losses rtol 1e-5; xlstm-1.3b's second loss rtol 1e-4
  (measured 5.0e-5): AdamW's first update moves each entry by about
  lr·sign(g), and where its gradient is near zero the two packages' last
  ulps pick the sign.
"""

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import erfinv

from repro import configs as jconfigs
from repro.checkpoint import save_checkpoint as jsave
from repro.launch import train as jlm
from repro.launch.decode_llm import serve as jax_serve
from repro.models import Model as JaxModel
from repro.models import transformer as jtf
from repro.optim import get_optimizer as jget_optimizer
from repro_torch import configs, convert, prng
from repro_torch.launch import train as tlm
from repro_torch.launch.decode_llm import serve
from repro_torch.models import Model, transformer
from repro_torch.optim import get_optimizer
from repro_torch.tree import tree_paths

NEW_ARCHS = ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b", "jamba-1.5-large-398b",
             "xlstm-1.3b", "qwen2-vl-7b", "seamless-m4t-large-v2")
ATOL = {"xlstm-1.3b": 2e-4}
STEP_RTOL = {"xlstm-1.3b": 1e-4}
B, S = 2, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Helpers the per-arch files share
# ---------------------------------------------------------------------------
def atol(arch) -> float:
    return ATOL.get(arch, 1e-5)


def setup_arch(arch, seed=0, **overrides):
    """(the reference's Model, its params from PRNGKey(seed), the port's
    model holding those params), both reduced."""
    jcfg = jconfigs.get_config(arch).reduced().with_overrides(**overrides)
    cfg = configs.get_config(arch).reduced().with_overrides(**overrides)
    jm = JaxModel(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    return jm, params, convert.from_jax_model_params(cfg, jax.tree.map(np.asarray, params))


def batches(cfg, seed, b=B, s=S):
    """The same batch for both packages: random tokens (labels = tokens);
    vision: ``frontend_tokens`` random patch embeddings before them;
    encoder-decoder: ``s`` random frames."""
    rng = np.random.default_rng(seed)
    np_b = {"tokens": rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)}
    np_b["labels"] = np_b["tokens"]
    if cfg.frontend == "vision":
        np_b["patch_embeds"] = rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        np_b["frames"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return ({k: torch.from_numpy(v) for k, v in np_b.items()},
            {k: jnp.asarray(v) for k, v in np_b.items()})


def assert_trees_close(ours: dict, ref: dict, tol: float, what: str):
    """Leaf by leaf: |a − b| <= tol · max(1, max |b|)."""
    assert set(ours) == set(ref), (what, set(ours) ^ set(ref))
    for path, a in ours.items():
        a, b = np.asarray(a), np.asarray(ref[path])
        assert a.shape == b.shape and a.dtype == b.dtype, (what, path, a.shape, b.shape)
        scale = max(1.0, float(np.abs(b).max()) if b.size else 1.0)
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale, err_msg=f"{what}: {path}")


def check_forward(arch, jm, params, model, seed=2):
    ours_b, ref_b = batches(model.cfg, seed)
    jl, jaux, jmask = jtf.forward_logits(params, jm.cfg, ref_b)
    with torch.no_grad():
        logits, aux, mask = model.forward_logits(ours_b)
    assert logits.shape == jl.shape
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0, atol=atol(arch))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    return float(aux)


def check_loss_and_grads(arch, jm, params, model, seed=4):
    ours_b, ref_b = batches(model.cfg, seed)
    ref_loss, ref_grads = jax.value_and_grad(jm.loss_fn)(params, ref_b)
    model.requires_grad_(True)
    names, ps = zip(*model.named_parameters())
    loss = model.loss_fn(ours_b)
    grads = torch.autograd.grad(loss, ps)
    loss = loss.detach()
    model.requires_grad_(False)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    assert_trees_close(tree_paths(convert.to_jax_opt_state(model.param_tree(dict(zip(names,
                                                                                     grads))))),
                       tree_paths(jax.tree.map(np.asarray, ref_grads)), atol(arch), "gradient")


def check_decode(arch, jm, params, model, steps=12, seed=1):
    """``steps`` teacher-forced decode steps from empty caches (an
    encoder-decoder's filled by ``prefill_encoder`` from random frames):
    logits and every cache after every step."""
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, steps), dtype=np.int32)
    enc_len = 6 if cfg.encoder_layers else None
    jcache = jm.init_cache(B, steps, enc_len=enc_len)
    cache = model.init_cache(B, steps, enc_len=enc_len)
    if enc_len:
        frames = rng.standard_normal((B, enc_len, cfg.d_model)).astype(np.float32)
        jcache = jax.jit(lambda p, f, c: jtf.prefill_encoder(p, jm.cfg, f, c, B))(
            params, jnp.asarray(frames), jcache)
        cache = model.prefill_encoder(torch.from_numpy(frames), cache)
        assert_trees_close(tree_paths(convert.to_jax_cache(cfg, cache)),
                           tree_paths(jax.tree.map(np.asarray, jcache)), atol(arch),
                           "the prefilled cache")
    step = jax.jit(jm.make_decode_step())
    for i in range(steps):
        jl, jcache = step(params, jcache, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        logits, cache = model.decode_step(cache, torch.from_numpy(toks[:, i:i + 1]), i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0, atol=atol(arch),
                                   err_msg=f"logits at pos {i}")
        assert_trees_close(tree_paths(convert.to_jax_cache(cfg, cache)),
                           tree_paths(jax.tree.map(np.asarray, jcache)), atol(arch),
                           f"cache after pos {i}")


def check_serve(arch, **kw):
    kw = dict(dict(batch=2, prompt_len=6, new_tokens=6), **kw)
    want, _ = jax_serve(arch, reduced=True, **kw)
    got, stats = serve(arch, reduced=True, device="cpu", **kw)
    assert got.dtype == torch.int32 and got.shape == (kw["batch"], kw["new_tokens"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(stats) == {"prefill_s", "decode_s", "tok_per_s"}


def reference_init_checkpoint(arch, ckpt_dir):
    """Step 0 of ``arch`` (reduced) as the reference's launcher would save it
    (its init and ``cfg.train_optimizer``'s state), so both launchers
    resume from the same weights."""
    cfg = jconfigs.get_config(arch).reduced()
    params = JaxModel(cfg).init(jax.random.PRNGKey(0))
    opt = jget_optimizer(cfg.train_optimizer)
    jsave(f"{ckpt_dir}/step_0.npz", {"params": params, "opt": opt.init(params)}, step=0)


def check_train_steps(arch, tmp_path, steps=2):
    """``launch/train.train`` of both packages from the reference's init, with
    ``cfg.train_optimizer`` and the launcher's batch dicts: the first loss
    (before any update) rtol 1e-5, the later ones rtol 1e-5, or
    ``STEP_RTOL[arch]``."""
    kw = dict(reduced=True, steps=steps, batch=2, seq=16, lr=3e-3, ckpt_every=100,
              resume=True)
    for pkg in ("repro", "port"):
        reference_init_checkpoint(arch, tmp_path / pkg)
    with contextlib.redirect_stdout(io.StringIO()):
        _, ref = jlm.train(arch, ckpt_dir=str(tmp_path / "repro"), **kw)
        _, ours, _ = tlm.train(arch, ckpt_dir=str(tmp_path / "port"), device="cpu", **kw)
    np.testing.assert_allclose(ours[0], ref[0], rtol=1e-5)
    np.testing.assert_allclose(ours[1:], ref[1:], rtol=STEP_RTOL.get(arch, 1e-5))


# ---------------------------------------------------------------------------
# tests/test_models_smoke.py on the port, every arch
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def built():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = Model(configs.get_config(arch).reduced(), prng.PRNGKey(0),
                                device="cpu")
        return cache[arch]

    return get


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_forward_shapes_and_finite(arch, built):
    m = built(arch)
    batch = m.example_batch(configs.smoke_shape("train"))
    with torch.no_grad():
        logits, aux, mask = m.forward_logits(batch)
    assert logits.shape[0] == batch["labels"].shape[0]
    assert logits.shape[-1] == m.cfg.padded_vocab
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))
    assert mask.shape == logits.shape[:2]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_one_train_step(arch, built):
    m = Model(built(arch).cfg, device="cpu").load_param_tree(built(arch).param_tree())
    opt = get_optimizer(m.cfg.train_optimizer)
    with torch.no_grad():
        state = opt.init(m.param_tree())
    embed0 = m.embed.detach().clone()
    _, loss = m.make_train_step(opt)(state, m.example_batch(configs.smoke_shape("train")), 0)
    assert bool(torch.isfinite(loss))
    assert not torch.allclose(m.embed, embed0)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_one_decode_step(arch, built):
    m = built(arch)
    cache = m.init_cache(2, 64, enc_len=16 if m.cfg.encoder_layers else None)
    logits, _ = m.decode_step(cache, torch.ones((2, 1), dtype=torch.int32), 5)
    assert logits.shape == (2, 1, m.cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# tests/test_decode_consistency.py on the port
# ---------------------------------------------------------------------------
CONSISTENCY_ARCHS = ("llama3-8b", "h2o-danube-1.8b", "deepseek-v2-lite-16b",
                     "jamba-1.5-large-398b", "xlstm-1.3b", "qwen2-vl-7b")


@pytest.mark.parametrize("arch", CONSISTENCY_ARCHS)
def test_decode_matches_forward(arch):
    cfg = configs.get_config(arch).reduced()
    if cfg.moe is not None:
        # decode capacity: headroom so that no token drops in this test
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))
    m = Model(cfg, prng.PRNGKey(0), device="cpu")
    b, s = 2, 12
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s),
                                                              dtype=np.int32))
    with torch.no_grad():
        full, _, _ = m.forward_logits({"tokens": toks})
    cache = m.init_cache(b, s)
    for i in range(s):
        out, cache = m.decode_step(cache, toks[:, i:i + 1], i)
    np.testing.assert_allclose(out[:, 0].numpy(), full[:, -1].numpy(), atol=2e-3, rtol=2e-3)


def test_encdec_decode_matches_forward():
    cfg = configs.get_config("seamless-m4t-large-v2").reduced()
    m = Model(cfg, prng.PRNGKey(2), device="cpu")
    b, se, sd = 2, 10, 8
    rng = np.random.default_rng(2)
    frames = torch.from_numpy(rng.normal(size=(b, se, cfg.d_model)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, sd), dtype=np.int32))
    with torch.no_grad():
        full, _, _ = m.forward_logits({"frames": frames, "tokens": toks})
    cache = m.prefill_encoder(frames, m.init_cache(b, sd, enc_len=se))
    for i in range(sd):
        out, cache = m.decode_step(cache, toks[:, i:i + 1], i)
    np.testing.assert_allclose(out[:, 0].numpy(), full[:, -1].numpy(), atol=2e-3, rtol=2e-3)


# ---------------------------------------------------------------------------
# Init: the reference's keys, weights within the normal rule
# ---------------------------------------------------------------------------
def _dense(k, fan_in, fan_out):
    return k, (fan_in, fan_out), (2.0 / (fan_in + fan_out)) ** 0.5


def _layer_draws(prefix, lk, code, cfg):
    """``{name: (key, shape, scale)}`` of every drawn parameter of one layer,
    derived with ``jax.random`` along ``init_layer`` and the mixers' and
    FFNs' inits."""
    mixer, ffn = cfg.parse_code(code)
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    k4 = jax.random.split(lk, 4)
    out = {}

    def gqa(name, k):
        fans = ((d, H * hd), (d, Hkv * hd), (d, Hkv * hd), (H * hd, d))
        for w, kk, f in zip(("wq", "wk", "wv", "wo"), jax.random.split(k, 4), fans):
            out[f"{prefix}{name}.{w}"] = _dense(kk, *f)

    if mixer in ("A", "S", "C"):
        gqa("attn", k4[0])
        if mixer == "C":
            gqa("cross", k4[2])
    elif mixer == "L":
        r, hr = cfg.mla.kv_lora_rank, cfg.mla.rope_head_dim
        fans = (("wq_nope", d, H * hd), ("wq_rope", d, H * hr), ("w_dkv", d, r),
                ("w_uk", r, H * hd), ("w_uv", r, H * hd), ("w_krope", d, hr),
                ("wo", H * hd, d))
        for (w, a, b), kk in zip(fans, jax.random.split(k4[0], 7)):
            out[f"{prefix}attn.{w}"] = _dense(kk, a, b)
    elif mixer == "M":
        di, ds = cfg.ssm.expand * d, cfg.ssm.d_state
        dtr = cfg.ssm.dt_rank or max(1, d // 16)
        ks = jax.random.split(k4[0], 6)
        out[f"{prefix}mixer.in_proj"] = _dense(ks[0], d, 2 * di)
        out[f"{prefix}mixer.conv_w"] = (ks[1], (cfg.ssm.d_conv, di), 0.1)
        out[f"{prefix}mixer.x_proj"] = _dense(ks[2], di, dtr + 2 * ds)
        out[f"{prefix}mixer.dt_proj"] = _dense(ks[3], dtr, di)
        out[f"{prefix}mixer.out_proj"] = _dense(ks[5], di, d)
    elif mixer == "m":
        di = cfg.ssm.mlstm_expand * d
        ks = jax.random.split(k4[0], 7)
        for w, i, f in (("up", 0, (d, 2 * di)), ("wq", 1, (di, di)), ("wk", 2, (di, di)),
                        ("wv", 3, (di, di)), ("w_if", 4, (di, 2 * H)), ("down", 6, (di, d))):
            out[f"{prefix}mixer.{w}"] = _dense(ks[i], *f)
    else:
        dh = d // H
        ks = jax.random.split(k4[0], 3)
        out[f"{prefix}mixer.w_in"] = _dense(ks[0], d, 4 * d)
        out[f"{prefix}mixer.r"] = (ks[1], (4, H, dh, dh), 0.02)
        out[f"{prefix}mixer.out_proj"] = _dense(ks[2], d, d)

    def mlp(name, k, f):
        for w, kk, fan in zip(("gate", "up", "down"), jax.random.split(k, 3),
                              ((d, f), (d, f), (f, d))):
            out[f"{prefix}{name}.{w}"] = _dense(kk, *fan)

    if ffn == "D":
        mlp("ffn", k4[1], cfg.d_ff)
    elif ffn == "E":
        m = cfg.moe
        E, f = m.num_experts, m.d_ff_expert
        ks = jax.random.split(k4[1], 5)
        out[f"{prefix}ffn.router"] = _dense(ks[0], d, E)
        for w, i, shape in (("gate", 1, (E, d, f)), ("up", 2, (E, d, f)), ("down", 3, (E, f, d))):
            out[f"{prefix}ffn.{w}"] = (ks[i], shape, 0.02)
        if m.num_shared:
            mlp("ffn.shared", ks[4], (m.d_ff_shared or f) * m.num_shared)
    return out


def _stack_keys(key, prefix_codes, cycle_codes, n_cycles):
    kp, kc = jax.random.split(key)
    keys = list(jax.random.split(kp, max(len(prefix_codes), 1))[:len(prefix_codes)])
    for kcyc in jax.random.split(kc, n_cycles):
        keys += list(jax.random.split(kcyc, len(cycle_codes)))
    return keys


def _jax_draws(cfg, seed):
    ks = jax.random.split(jax.random.PRNGKey(seed), 6)
    d, Vp = cfg.d_model, cfg.padded_vocab
    out = {"embed": (ks[0], (Vp, d), 0.02)}
    if not cfg.tie_embeddings:
        out["lm_head"] = _dense(ks[2], d, Vp)
    codes = cfg.layer_codes()
    for i, (lk, code) in enumerate(zip(_stack_keys(ks[1], cfg.prefix_codes, cfg.cycle_codes,
                                                   cfg.resolved_num_cycles), codes)):
        out.update(_layer_draws(f"layers.{i}.", lk, code, cfg))
    if cfg.encoder_layers:
        for i, lk in enumerate(_stack_keys(ks[3], (), ("A-D",), cfg.encoder_layers)):
            out.update(_layer_draws(f"enc.layers.{i}.", lk, "A-D", cfg))
    return out


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_init_uses_the_reference_keys_and_the_normal_rule(arch):
    """Every drawn parameter is ``scale·normal(key)`` with the reference's
    key, derived here with ``jax.random`` along the reference's init; the
    port's value must be within the ``normal`` rule's bound (PR 14's:
    ``tests/test_torch_models.py``) of the reference's value, which only
    the right key gives. Every other parameter (norm scales, zero biases,
    ``conv_b``, ``dt_bias``, ``A_log``, ``D``) is bitwise the reference's."""
    cfg = configs.get_config(arch).reduced()
    jparams = JaxModel(jconfigs.get_config(arch).reduced()).init(jax.random.PRNGKey(0))
    ref = dict(convert.from_jax_model_params(cfg, jax.tree.map(np.asarray, jparams))
               .named_parameters())
    ours = dict(Model(cfg, prng.PRNGKey(0), device="cpu").named_parameters())
    assert set(ours) == set(ref)
    drawn = _jax_draws(cfg, 0)
    assert set(drawn) < set(ours)
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32))
    for name, p in ours.items():
        got, want = p.numpy(), ref[name].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if name not in drawn:
            np.testing.assert_array_equal(got, want, err_msg=name)
            continue
        key, shape, scale = drawn[name]
        assert tuple(shape) == got.shape, name
        u = prng.uniform(np.asarray(key), got.shape, lo, 1.0).numpy().astype(np.float64)
        exact = np.sqrt(2.0) * erfinv(u)
        ulp_x = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
        half_ulp_u = 0.5 * np.spacing(np.abs(u).astype(np.float32)).astype(np.float64) \
            * np.sqrt(np.pi / 2) * np.exp(exact ** 2 / 2)
        bound = (np.float32(scale) * (20 * ulp_x + half_ulp_u)
                 + np.spacing(np.abs(got)) + np.spacing(np.abs(want)))
        err = np.abs(got.astype(np.float64) - want)
        assert (err <= bound).all(), (name, float((err / bound).max()))


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "seamless-m4t-large-v2"])
def test_layer_keys_cover_a_prefix_and_the_encoder(arch):
    cfg = configs.get_config(arch).reduced()
    ks = jax.random.split(jax.random.PRNGKey(5), 6)
    pk = prng.split(prng.PRNGKey(5), 6)
    for got, want in (
            (transformer.layer_keys(pk[1], cfg.prefix_codes, cfg.cycle_codes,
                                    cfg.resolved_num_cycles),
             _stack_keys(ks[1], cfg.prefix_codes, cfg.cycle_codes, cfg.resolved_num_cycles)),
            (transformer.layer_keys(pk[3], (), ("A-D",), cfg.encoder_layers),
             _stack_keys(ks[3], (), ("A-D",), cfg.encoder_layers))):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))


# ---------------------------------------------------------------------------
# The parameter tree: reference → port → reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_tree_round_trips_bitwise(arch):
    """Reduced: the reference's init → the port → the reference's tree, every
    leaf bitwise (the sLSTM/mLSTM mixers' raw ``norm``, ``norm_x``,
    ``enc.final_norm`` by their exact names)."""
    params = jax.tree.map(np.asarray, JaxModel(jconfigs.get_config(arch).reduced())
                          .init(jax.random.PRNGKey(0)))
    model = convert.from_jax_model_params(configs.get_config(arch).reduced(), params)
    back, ref = tree_paths(convert.to_jax_model_params(model)), tree_paths(params)
    assert set(back) == set(ref)
    for path, a in ref.items():
        assert back[path].dtype == a.dtype, path
        np.testing.assert_array_equal(back[path], a, err_msg=path)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_tree_round_trips_at_full_width_on_meta(arch):
    """Full width, shapes only: ``jax.eval_shape`` of the reference's init →
    meta tensors → a model on ``device="meta"`` → its tree: the same paths,
    shapes and dtypes."""
    jcfg = jconfigs.get_config(arch)
    shapes = jax.eval_shape(JaxModel(jcfg).init, jax.random.PRNGKey(0))
    meta = jax.tree.map(lambda s: torch.empty(s.shape, dtype=getattr(torch, str(s.dtype)),
                                              device="meta"), shapes)
    model = convert.from_jax_model_params(configs.get_config(arch), meta, device="meta")
    back = tree_paths(model.param_tree())
    ref = tree_paths(shapes)
    assert set(back) == set(ref)
    for path, s in ref.items():
        assert tuple(back[path].shape) == tuple(s.shape), path
        assert str(back[path].dtype) == f"torch.{s.dtype}", path
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(s.shape)) for s in ref.values())
    if arch == "deepseek-v2-lite-16b":
        assert n == 15_706_470_400


def test_converter_refuses_a_tree_of_another_arch():
    params = jax.tree.map(np.asarray, JaxModel(jconfigs.get_config("qwen3-moe-30b-a3b")
                                               .reduced()).init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="parameters differ"):
        convert.from_jax_model_params(configs.get_config("deepseek-v2-lite-16b").reduced(),
                                      params)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "seamless-m4t-large-v2"])
def test_example_batch_vision_and_encdec_are_the_reference_batches(arch, kind):
    model = Model(configs.get_config(arch).reduced(), device="cpu")
    ours = model.example_batch(configs.smoke_shape(kind), prng.PRNGKey(3))
    ref = JaxModel(jconfigs.get_config(arch).reduced()).example_batch(
        jconfigs.smoke_shape(kind), jax.random.PRNGKey(3))
    assert set(ours) == set(ref)
    for name, v in ours.items():
        if name == "pos":
            assert v == int(ref["pos"])
            continue
        assert v.dtype == getattr(torch, str(ref[name].dtype))
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[name]), err_msg=name)


def test_to_jax_cache_copies_even_on_the_cpu():
    """The decode step writes caches in place, so a ``to_jax_cache`` taken
    before a step must not change with it — on the CPU too, and for a
    prefix layer (deepseek's ``L-D``), whose arrays are not stacked."""
    model = Model(configs.get_config("deepseek-v2-lite-16b").reduced(), prng.PRNGKey(0),
                  device="cpu")
    cache = model.init_cache(1, 3)
    tok = torch.ones((1, 1), dtype=torch.int32)
    model.decode_step(cache, tok, 0)
    before = tree_paths(convert.to_jax_cache(model.cfg, cache))
    frozen_copy = {k: v.copy() for k, v in before.items()}
    model.decode_step(cache, tok, 1)
    assert not np.array_equal(before["prefix/#0/c_kv"][:, 1], cache[0]["c_kv"][:, 1].numpy())
    for k, v in before.items():
        np.testing.assert_array_equal(v, frozen_copy[k], err_msg=k)
