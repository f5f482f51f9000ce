"""The port's LM training path on the CPU against the JAX package, on the
four dense architectures (reduced): llama3-8b, qwen1.5-0.5b (qkv biases),
smollm-360m (tied embeddings) and h2o-danube-1.8b (window 32, run at S =
48 > window). The reference's parameters go across with
``convert.from_jax_model_params`` (never an init from a key on each side:
the two ``normal``s differ in the last ulps); inputs are made with numpy
from a seed. Tolerances, each on O(1) values:

* ``causal_mask`` and ``example_batch``: bitwise (integer logic);
* ``gqa_forward`` and ``forward_logits``: atol 1e-5 (measured ≤ 2.7e-6:
  matmul reduction order, rsqrt and pow in the last ulp);
* ``lm_loss``: rtol 1e-6 (the log-sum-exp and the mean's sums in another
  order); ``loss_fn``: rtol 1e-5;
* each gradient, in the reference's layout: atol 1e-5 (measured ≤ 4.3e-7);
* 5 ``sgd`` steps: parameters atol 1e-5, losses rtol 1e-5; 5 ``adamw``
  steps: losses rtol 1e-5; the parameters after each of 5 steps taken from
  the reference's parameters and state, atol 1e-5, only where the
  reference's gradient exceeds 1e-6 in magnitude at every step so far
  (AdamW's first steps move a parameter by about lr·sign(g), so where |g|
  is near 0 the last ulps of g decide its move);
* ``microbatches=2`` against 1 (``tests/test_models_smoke.py``'s test):
  loss rtol 1e-5, parameters atol 2e-5; against the reference's
  microbatched step: loss rtol 1e-5, parameters atol 1e-5;
* remat on against off (per cycle, per layer, both): bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import Model as JaxModel
from repro.models import attention as jattention
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.optim import get_optimizer as jget_optimizer
from repro_torch import configs, convert, prng
from repro_torch.models import Model, attention, layers
from repro_torch.optim import get_optimizer
from repro_torch.tree import tree_paths

ARCHS = ("llama3-8b", "qwen1.5-0.5b", "smollm-360m", "h2o-danube-1.8b")
B, S = 2, 48


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """A reduced model's ops are too small to split across threads; beside
    other test processes on the machine, torch's thread pool only contends
    (a training loop of 1 s alone took over 100 s so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch, seed=0, **overrides):
    jcfg = jconfigs.get_config(arch).reduced().with_overrides(**overrides)
    cfg = configs.get_config(arch).reduced().with_overrides(**overrides)
    jm = JaxModel(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    model = convert.from_jax_model_params(cfg, jax.tree.map(np.asarray, params))
    return jm, params, model


def _tokens(cfg, seed, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape, dtype=np.int32)


def _batches(toks):
    return ({"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)},
            {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})


def _np(tree):
    return tree_paths(jax.tree.map(np.asarray, tree))


def _grads(model, batch):
    model.requires_grad_(True)
    names, params = zip(*model.named_parameters())
    loss = model.loss_fn(batch)
    grads = torch.autograd.grad(loss, params)
    return loss.detach(), model.param_tree(dict(zip(names, grads)))


def _assert_close(ours: dict, ref: dict, atol, what, where=None):
    assert set(ours) == set(ref), what
    for path, a in ours.items():
        a, b = np.asarray(a), np.asarray(ref[path])
        assert a.shape == b.shape, (what, path)
        if where is not None:
            a, b = a[where[path]], b[where[path]]
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=f"{what}: {path}")


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Sq,Sk,window,offset", [
    (48, 48, None, 0), (48, 48, 32, 0), (5, 12, None, 7), (5, 12, 4, 7), (1, 64, 16, 63)])
def test_causal_mask_is_the_reference_mask_bitwise(Sq, Sk, window, offset):
    ours = attention.causal_mask(Sq, Sk, window, offset)
    ref = np.asarray(jattention.causal_mask(Sq, Sk, window, offset))
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_forward_matches_the_reference(arch):
    jm, params, model = _setup(arch)
    cfg = model.cfg
    lp = jax.tree.map(lambda a: a[0], params["stack"]["cycle"]["0"]["attn"])
    x = np.random.default_rng(1).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    positions = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    ref = jattention.gqa_forward(lp, jnp.asarray(x), jnp.asarray(positions),
                                 n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
                                 head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                                 window=cfg.attention_window)
    rope = layers.rope_angles(torch.from_numpy(positions.copy()), cfg.resolved_head_dim,
                              cfg.rope_theta)
    with torch.no_grad():
        ours = model.layers[0].attn(torch.from_numpy(x), rope, cfg.attention_window)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_matches_the_reference(arch):
    jm, params, model = _setup(arch)
    cfg = model.cfg
    toks = _tokens(cfg, 2)
    jl, jaux, jmask = jtf.forward_logits(params, jm.cfg, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        logits, aux, mask = model.forward_logits({"tokens": torch.from_numpy(toks)})
    assert logits.shape == (B, S, cfg.padded_vocab) == jl.shape
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    assert float(aux) == float(jaux) == 0.0
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


@pytest.mark.parametrize("masked", [None, "random", "zeros"])
def test_lm_loss_matches_the_reference(masked):
    rng = np.random.default_rng(3)
    logits = (3 * rng.standard_normal((2, 16, 512))).astype(np.float32)
    labels = rng.integers(0, 512, (2, 16), dtype=np.int32)
    mask = {None: None, "random": (rng.random((2, 16)) < 0.6).astype(np.float32),
            "zeros": np.zeros((2, 16), np.float32)}[masked]
    ref = jlayers.lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                          None if mask is None else jnp.asarray(mask))
    ours = layers.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                          None if mask is None else torch.from_numpy(mask))
    assert ours.dtype == torch.float32 and ours.shape == ()
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)
    if masked == "zeros":
        assert float(ours) == 0.0


# ---------------------------------------------------------------------------
# Loss and gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_every_gradient_match_jax_grad(arch):
    jm, params, model = _setup(arch)
    ours_b, ref_b = _batches(_tokens(model.cfg, 4))
    ref_loss, ref_grads = jax.value_and_grad(jm.loss_fn)(params, ref_b)
    loss, grads = _grads(model, ours_b)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    _assert_close(tree_paths(convert.to_jax_opt_state(grads)), _np(ref_grads), 1e-5,
                  "gradient")


def test_param_tree_is_the_reference_tree_and_round_trips():
    _, params, model = _setup("smollm-360m")
    ours = convert.to_jax_model_params(model)
    ref = _np(params)
    assert set(tree_paths(ours)) == set(ref)
    for path, a in tree_paths(ours).items():
        np.testing.assert_array_equal(a, ref[path])
    back = convert.to_jax_model_params(
        convert.from_jax_model_params(model.cfg, ours))
    for path, a in tree_paths(back).items():
        np.testing.assert_array_equal(a, ref[path])


# ---------------------------------------------------------------------------
# Training steps
# ---------------------------------------------------------------------------
def _run_steps(jm, params, model, name, steps, lr, forced=False, seed=5):
    """``steps`` steps of both packages' train steps on the same batches.
    ``forced``: each step starts the port from the reference's parameters
    and optimizer state, and the port's parameters after it are kept
    (where the reference's gradient at every step so far exceeds 1e-6 in
    magnitude) beside the reference's."""
    opt, jopt = get_optimizer(name, lr=lr), jget_optimizer(name, lr=lr)
    step_fn = model.make_train_step(opt)
    jstep = jax.jit(jm.make_train_step(jopt))
    jgrad = jax.jit(jax.grad(jm.loss_fn))
    with torch.no_grad():
        state = opt.init(model.param_tree())
    jstate = jopt.init(params)
    rng = np.random.default_rng(seed)
    losses, jlosses, big, after = [], [], None, []
    for i in range(steps):
        toks = rng.integers(0, model.cfg.vocab_size, (B, S), dtype=np.int32)
        ours_b, ref_b = _batches(toks)
        if forced:
            model.load_param_tree(jax.tree.map(np.asarray, params))
            state = convert.from_jax_opt_state(jax.tree.map(np.asarray, jstate))
            g = _np(jgrad(params, ref_b))
            step_big = {k: np.abs(v) > 1e-6 for k, v in g.items()}
            big = step_big if big is None else {k: big[k] & step_big[k] for k in big}
        state, loss = step_fn(state, ours_b, i)
        params, jstate, jloss = jstep(params, jstate, ref_b, jnp.int32(i))
        losses.append(float(loss))
        jlosses.append(float(jloss))
        if forced:
            after.append((tree_paths(convert.to_jax_model_params(model)), _np(params), big))
    return losses, jlosses, params, after


@pytest.mark.parametrize("arch", ARCHS)
def test_five_sgd_steps_match_the_reference(arch):
    jm, params, model = _setup(arch)
    losses, jlosses, params, _ = _run_steps(jm, params, model, "sgd", 5, lr=0.1)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    _assert_close(tree_paths(convert.to_jax_model_params(model)), _np(params), 1e-5, "params")


@pytest.mark.parametrize("arch", ARCHS)
def test_five_adamw_steps_match_the_reference(arch):
    """The losses of 5 free-running steps; then the parameters after each
    of 5 steps taken from the reference's parameters and state, where |g|
    is not near 0. Free-running parameters drift apart from the near-zero
    entries on (each moves about lr·sign(g)), and the drift reaches every
    later gradient, so they are compared only through the losses."""
    jm, params, model = _setup(arch)
    losses, jlosses, _, _ = _run_steps(jm, params, model, "adamw", 5, lr=3e-3)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    jm, params, model = _setup(arch)
    losses, jlosses, _, after = _run_steps(jm, params, model, "adamw", 5, lr=3e-3,
                                           forced=True)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    for i, (ours, ref, big) in enumerate(after):
        # most entries qualify: the test must not compare nothing
        assert sum(int(m.sum()) for m in big.values()) > 0.5 * sum(m.size for m in big.values())
        _assert_close(ours, ref, 1e-5, f"params after step {i} where |g| > 1e-6", where=big)


def test_microbatch_accumulation_matches_full_batch():
    """``tests/test_models_smoke.py``'s test on the port, and the port's
    microbatched step against the reference's."""
    jm, params, model = _setup("qwen1.5-0.5b")
    toks = np.random.default_rng(3).integers(0, model.cfg.vocab_size, (4, 16), dtype=np.int32)
    ours_b, ref_b = _batches(toks)
    opt, jopt = get_optimizer("sgd", lr=0.1), jget_optimizer("sgd", lr=0.1)
    out = {}
    for mb in (1, 2):
        m = convert.from_jax_model_params(model.cfg, jax.tree.map(np.asarray, params))
        _, loss = m.make_train_step(opt, microbatches=mb)({}, ours_b, 0)
        out[mb] = (float(loss), tree_paths(convert.to_jax_model_params(m)))
    np.testing.assert_allclose(out[1][0], out[2][0], rtol=1e-5)
    _assert_close(out[2][1], out[1][1], 2e-5, "mb 2 vs 1")
    p2, _, l2 = jax.jit(jm.make_train_step(jopt, microbatches=2))(
        params, jopt.init(params), ref_b, jnp.int32(0))
    np.testing.assert_allclose(out[2][0], float(l2), rtol=1e-5)
    _assert_close(out[2][1], _np(p2), 1e-5, "mb 2 vs the reference's")
    with pytest.raises(ValueError, match="microbatches"):
        m.make_train_step(opt, microbatches=3)({}, ours_b, 0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat,per_layer", [(True, False), (True, True), (False, True)])
def test_remat_changes_no_value(arch, remat, per_layer):
    _, params, _ = _setup(arch, remat=False, remat_per_layer=False)
    cfg = configs.get_config(arch).reduced()
    toks = _tokens(cfg, 6)
    out = []
    for overrides in (dict(remat=False, remat_per_layer=False),
                      dict(remat=remat, remat_per_layer=per_layer)):
        model = convert.from_jax_model_params(cfg.with_overrides(**overrides),
                                              jax.tree.map(np.asarray, params))
        loss, grads = _grads(model, _batches(toks)[0])
        out.append((loss, convert.to_jax_opt_state(grads)))
    assert torch.equal(out[0][0], out[1][0])
    for path, g in tree_paths(out[0][1]).items():
        np.testing.assert_array_equal(g, tree_paths(out[1][1])[path], err_msg=path)


def test_training_reduces_loss_dense():
    """``tests/test_models_smoke.py``'s dense test on a converted model:
    from_jax_model_params gives a model that trains."""
    _, _, model = _setup("llama3-8b")
    opt = get_optimizer("adamw", lr=3e-3)
    step_fn = model.make_train_step(opt)
    with torch.no_grad():
        state = opt.init(model.param_tree())
    toks = torch.from_numpy(_tokens(model.cfg, 0, (4, 32)))
    losses = []
    for i in range(30):
        state, loss = step_fn(state, {"tokens": toks, "labels": toks}, i)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7, losses[::10]
    # decode takes no gradient from a trainable model
    cache = model.init_cache(1, 4)
    logits, _ = model.decode_step(cache, toks[:1, :1], 0)
    assert not logits.requires_grad and not cache[0]["k"].requires_grad


# ---------------------------------------------------------------------------
# example_batch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("seed", [None, 3])
def test_example_batch_is_the_reference_batch_bitwise(kind, seed):
    jcfg = jconfigs.get_config("qwen1.5-0.5b").reduced()
    model = Model(configs.get_config("qwen1.5-0.5b").reduced(), device="cpu")
    shape = configs.smoke_shape(kind)
    key = None if seed is None else prng.PRNGKey(seed)
    ours = model.example_batch(shape, key)
    ref = JaxModel(jcfg).example_batch(jconfigs.smoke_shape(kind),
                                       None if seed is None else jax.random.PRNGKey(seed))
    assert set(ours) == set(ref)
    for name, v in ours.items():
        if name == "pos":
            assert v == int(ref["pos"]) == shape.seq_len - 1
            continue
        assert v.dtype == torch.int32 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[name]), err_msg=name)
    assert dataclasses.asdict(shape) == dataclasses.asdict(jconfigs.smoke_shape(kind))
