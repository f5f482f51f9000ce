"""The fused SGNS step and its alias negative draw: CUDA kernels for Hopper,
their plain torch versions, and the wrappers that choose between them.

Two kernels (sources in ``repro_torch/csrc/``):

* **K1** ``sample_negatives`` (``sample_negatives.cu``) — replaces the JAX
  package's ``_sampler_kernel``: the counter-hash alias draw, one thread
  per draw. Bit-identical to :func:`sample_negatives_plain` and to the
  reference's ``fused_negative_ids``.
* **K2** ``sgns_fused_step`` (``sgns_fused_step.cu``) — replaces
  ``_sgns_fused_kernel``: the whole SGNS step for n workers at once. Its
  wrapper draws the step's negatives with K1 and plans the apply (stable
  sorts of the touched rows); the kernels then gather, run the forward
  and the row gradients from the pre-step tables, and apply them
  deterministically, without float atomics.

Every wrapper takes stacked per-worker operands (a leading worker axis
``n``) and runs the plain version when its tensors lie on the CPU; on a
CUDA tensor it launches the kernel or raises. :data:`LAUNCHES` counts the
kernel launches of each wrapper.

Seeds are ``(n, 2)`` int32 tensors holding the bits of each worker's
uint32 key words (:func:`seed_tensor`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels.build import load

_MASK = 0xFFFFFFFF
_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: (library, symbol) -> argument types; all return an int
# (cudaGetLastError() after the launch).
_SIGNATURES = {
    ("sample_negatives", "sample_negatives_launch"):
        [_P] * 4 + [_I, _I, ctypes.c_longlong, _P],
    ("sgns_fused_step", "sgns_pairs_launch"):
        [_P] * 5 + [_I] * 5 + [_P] * 3 + [_I, _P],
    ("sgns_fused_step", "sgns_apply_launch"):
        [_P] * 9 + [_I] * 5 + [ctypes.c_float, _I, _P],
}
_entry_points: dict = {}
MAX_NEGATIVES = 16

#: Kernel launches per wrapper (plain integers; reset with
#: :func:`reset_launch_counts`).
LAUNCHES: dict[str, int] = {"sample_negatives": 0, "sgns_fused_step": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def seed_tensor(keys, device="cpu") -> torch.Tensor:
    """``(..., 2)`` uint32 key words → an int32 tensor with the same bits."""
    words = np.array(keys, dtype=np.uint32, order="C", copy=True)
    return torch.from_numpy(words.view(np.int32)).to(device)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------
def _mulmod32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32) without int64
    overflow: split ``c`` into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 avalanche round on int64 tensors of uint32 values."""
    x = x ^ (x >> 16)
    x = _mulmod32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mulmod32(x, 0x846CA68B)
    return x ^ (x >> 16)


def counter_uniforms(seed: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """U[0,1) float32 per counter; ``seed`` (..., 2) broadcasts against
    ``counters`` with its last axis dropped."""
    s = seed.to(torch.int64) & _MASK
    s0, s1 = s[..., 0], s[..., 1]
    for _ in range(counters.dim() - s0.dim()):
        s0, s1 = s0[..., None], s1[..., None]
    bits = mix32((mix32(counters ^ s0) + s1) & _MASK)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def alias_draw_from_counters(seed: torch.Tensor, prob: torch.Tensor,
                             alias: torch.Tensor,
                             base: torch.Tensor) -> torch.Tensor:
    """One alias draw per counter in ``base`` (int64 draw positions,
    leading worker axis matching ``prob``/``alias`` ``(n, V)``)."""
    u_idx = counter_uniforms(seed, (base * 2) & _MASK)
    u_acc = counter_uniforms(seed, (base * 2 + 1) & _MASK)
    V = prob.shape[-1]
    scaled = u_idx * torch.tensor(float(V), dtype=torch.float32,
                                  device=u_idx.device)
    idx = torch.clamp_max(scaled.to(torch.int64), V - 1)
    n = prob.shape[0]
    flat = idx.reshape(n, -1)
    p = torch.gather(prob, 1, flat).reshape(idx.shape)
    a = torch.gather(alias, 1, flat).reshape(idx.shape)
    return torch.where(u_acc < p, idx.to(torch.int32), a.to(torch.int32))


def sample_negatives_plain(seeds: torch.Tensor, prob: torch.Tensor,
                           alias: torch.Tensor,
                           shape: tuple[int, ...]) -> torch.Tensor:
    """``(n, *shape)`` int32 ids: worker w draws from its own ``prob[w]``,
    ``alias[w]`` with its own seed, counters row-major from 0."""
    n = prob.shape[0]
    count = int(np.prod(shape, dtype=np.int64))
    base = torch.arange(count, dtype=torch.int64, device=prob.device)
    base = base.expand(n, count)
    return alias_draw_from_counters(seeds, prob, alias, base).reshape(n, *shape)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # the TPU kernel's form (sgns_fused.py), not log-sigmoid
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def sgns_fused_step_plain(params: dict, centers: torch.Tensor,
                          contexts: torch.Tensor, table: dict,
                          seeds: torch.Tensor, lr: float, *,
                          negatives: int = 5):
    """The step K2 computes, in torch: ``train_step_sparse`` on the
    replayed ids with the fused kernel's softplus loss. Updates
    ``params`` in place (accumulating ``index_add_`` at W[centers], then
    C[contexts], then C[negatives]) and returns ``(params, loss (n, B),
    ids (n, B, K))``."""
    W, C = params["W"], params["C"]
    n, V, d = W.shape
    B = centers.shape[1]
    K = negatives
    ids = sample_negatives_plain(seeds, table["prob"], table["alias"], (B, K))
    off = torch.arange(n, dtype=torch.int64, device=W.device) * V
    cen = (centers.to(torch.int64) + off[:, None]).reshape(-1)
    ctx = (contexts.to(torch.int64) + off[:, None]).reshape(-1)
    neg = (ids.to(torch.int64) + off[:, None, None]).reshape(-1)
    Wf, Cf = W.view(n * V, d), C.view(n * V, d)
    w = Wf[cen].view(n, B, d)
    cp = Cf[ctx].view(n, B, d)
    cn = Cf[neg].view(n, B, K, d)

    s_pos = (w * cp).sum(-1)
    s_neg = (w[:, :, None, :] * cn).sum(-1)
    loss = _softplus(-s_pos) + _softplus(s_neg).sum(-1)
    g_pos = torch.sigmoid(s_pos) - 1.0
    g_neg = torch.sigmoid(s_neg)
    dw = g_pos[..., None] * cp + (g_neg[..., None] * cn).sum(2)
    dcp = g_pos[..., None] * w
    dcn = g_neg[..., None] * w[:, :, None, :]

    neg_lr = -float(np.float32(lr))
    Wf.index_add_(0, cen, neg_lr * dw.reshape(-1, d))
    Cf.index_add_(0, ctx, neg_lr * dcp.reshape(-1, d))
    Cf.index_add_(0, neg, neg_lr * dcn.reshape(-1, d))
    return params, loss, ids


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------
def _check(t: torch.Tensor, what: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _kernel_device(device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}; tensors must lie "
                         f"on the CPU (plain version) or on a CUDA device")


def _entry(lib: str, symbol: str):
    """The typed ctypes function for a C entry point (built on first use)."""
    fn = _entry_points.get((lib, symbol))
    if fn is None:
        fn = getattr(load(lib), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = _SIGNATURES[(lib, symbol)]
        _entry_points[(lib, symbol)] = fn
    return fn


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def sample_negatives(seeds: torch.Tensor, prob: torch.Tensor,
                     alias: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """K1: ``(n, *shape)`` int32 negative ids, worker w drawing from
    ``(prob[w], alias[w])`` under ``seeds[w]``."""
    device = prob.device
    n, V = prob.shape
    _check(prob, "prob", torch.float32, (n, V), device)
    _check(alias, "alias", torch.int32, (n, V), device)
    _check(seeds, "seeds", torch.int32, (n, 2), device)
    if device.type == "cpu":
        return sample_negatives_plain(seeds, prob, alias, shape)
    _kernel_device(device)
    per_worker = int(np.prod(shape, dtype=np.int64))
    out = torch.empty((n, *shape), dtype=torch.int32, device=device)
    fn = _entry("sample_negatives", "sample_negatives_launch")
    with torch.cuda.device(device):
        err = fn(_ptr(seeds), _ptr(prob), _ptr(alias), _ptr(out), n, V,
                 per_worker, _stream(device))
    _raise_on(err, "sample_negatives")
    LAUNCHES["sample_negatives"] += 1
    return out


def sgns_fused_step(params: dict, centers: torch.Tensor, contexts: torch.Tensor,
                    table: dict, seeds: torch.Tensor, lr: float, *,
                    negatives: int = 5):
    """K2: one SGNS step for every worker. ``params`` ``{"W", "C"}`` of
    ``(n, V, d)`` float32 are updated **in place** (the tables are the
    largest tensors of the system; the TPU kernel aliases them too);
    ``centers``/``contexts`` ``(n, B)`` int32 ids in ``[0, V)`` (the
    kernels do not bounds-check them; the trainer checks each chunk);
    ``table`` the stacked
    ``{"prob", "alias"}`` ``(n, V)`` alias tables; ``seeds`` ``(n, 2)``;
    ``lr`` the step's learning rate.

    Returns ``(params, loss (n, B), ids (n, B, K))``: the per-pair loss
    and the negatives the step drew.
    """
    W, C = params["W"], params["C"]
    device = W.device
    n, V, d = W.shape
    B = centers.shape[-1]
    K = int(negatives)
    if not 1 <= K <= MAX_NEGATIVES:
        raise ValueError(f"negatives must be in [1, {MAX_NEGATIVES}], got {K}")
    _check(W, "W", torch.float32, (n, V, d), device)
    _check(C, "C", torch.float32, (n, V, d), device)
    _check(centers, "centers", torch.int32, (n, B), device)
    _check(contexts, "contexts", torch.int32, (n, B), device)
    _check(table["prob"], "prob", torch.float32, (n, V), device)
    _check(table["alias"], "alias", torch.int32, (n, V), device)
    _check(seeds, "seeds", torch.int32, (n, 2), device)
    if device.type == "cpu":
        return sgns_fused_step_plain(params, centers, contexts, table, seeds,
                                     lr, negatives=K)
    _kernel_device(device)
    loss = torch.empty((n, B), dtype=torch.float32, device=device)
    coef = torch.empty((n, B, K + 1), dtype=torch.float32, device=device)
    dW = torch.empty((n, B, d), dtype=torch.float32, device=device)
    vec4 = int(d % 4 == 0 and W.data_ptr() % 16 == 0 and C.data_ptr() % 16 == 0)
    pairs = _entry("sgns_fused_step", "sgns_pairs_launch")
    apply = _entry("sgns_fused_step", "sgns_apply_launch")
    # Draw and plan: K1 draws the step's negatives; each worker's touched
    # rows, stably sorted, form runs in addend order for the apply (W at
    # centers; C at contexts, then at negatives).
    ids = sample_negatives(seeds, table["prob"], table["alias"], (B, K))
    w_keys, w_perm = torch.sort(centers, dim=1, stable=True)
    c_keys, c_perm = torch.sort(torch.cat([contexts, ids.view(n, B * K)], 1),
                                dim=1, stable=True)
    with torch.cuda.device(device):
        stream = _stream(device)
        err = pairs(_ptr(W), _ptr(C), _ptr(centers), _ptr(contexts), _ptr(ids),
                    n, V, d, B, K, _ptr(loss), _ptr(coef), _ptr(dW), vec4, stream)
        _raise_on(err, "sgns_fused_step (pairs)")
        err = apply(_ptr(W), _ptr(C), _ptr(centers), _ptr(coef), _ptr(dW),
                    _ptr(c_keys), _ptr(c_perm), _ptr(w_keys), _ptr(w_perm),
                    n, V, d, B, K, -float(np.float32(lr)), vec4, stream)
        _raise_on(err, "sgns_fused_step (apply)")
    LAUNCHES["sgns_fused_step"] += 1
    return params, loss, ids
