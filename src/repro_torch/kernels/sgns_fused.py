"""The fused SGNS step and its alias negative draw: CUDA kernels for Hopper,
their plain torch versions, and the wrappers that choose between them.

Two kernels (sources in ``repro_torch/csrc/``):

* **K1** ``sample_negatives`` (``sample_negatives.cu``) — replaces the JAX
  package's ``_sampler_kernel``: the counter-hash alias draw, one thread
  per draw. Bit-identical to :func:`sample_negatives_plain` and to the
  reference's ``fused_negative_ids``.
* **K2** ``sgns_fused_step`` (``sgns_fused_step.cu``) — replaces
  ``_sgns_fused_kernel``: the whole SGNS step for n workers at once, in
  one persistent launch (``sgns_block_step.cuh``, shared with K4a:
  :mod:`~repro_torch.kernels.sgns_block_step`) that draws the step's
  negatives itself, as the TPU kernel does (K1's ``alias_draw`` at the same
  counters, so the returned ids are K1's bit for bit), sorts each worker's
  touched rows, runs the forward and the row gradients from the pre-step
  tables, and applies them deterministically, without float atomics.

K1 keeps its own launch where a step takes a draw from outside: K4b's
sequential step, K5 and K6.

Every wrapper takes stacked per-worker operands (a leading worker axis
``n``) and runs the plain version when its tensors lie on the CPU; on a
CUDA tensor it launches the kernel or raises. :data:`LAUNCHES` counts the
kernel launches of each wrapper, this module's and those of
``sgns_update`` (K3), ``sgns_fused_hbm`` (K4), ``sgns_fused_pipe`` (K5),
``sgns_fused_tiered`` (K6) and ``swa_decode`` (K7), which share its C
binding helpers.

Seeds are ``(n, 2)`` int32 tensors holding the bits of each worker's
uint32 key words (:func:`seed_tensor`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.sgns import train_step_sparse_
from repro_torch.kernels.build import load
from repro_torch.kernels.sgns_block_step import run_block_step

_MASK = 0xFFFFFFFF
_P, _I = ctypes.c_void_p, ctypes.c_int
# K2's and K4a's launch (`sgns_block_step.cuh`: block_step_entry)
_BLOCK_STEP = [_P] * 20 + [ctypes.c_longlong] + [_I] * 10 + [ctypes.c_float, _I, _P]
# C entry points: (library, symbol) -> argument types; all return an int
# (cudaGetLastError() after the launch).
_SIGNATURES = {
    ("sample_negatives", "sample_negatives_launch"):
        [_P] * 4 + [_I, _I, ctypes.c_longlong, _P],
    ("sgns_fused_step", "sgns_fused_step_launch"): _BLOCK_STEP,
    ("sgns_row_grads", "sgns_row_grads_launch"):
        [_P] * 3 + [ctypes.c_longlong, _I, _I] + [_P] * 4 + [_I, _P],
    ("sgns_fused_hbm", "sgns_hbm_chain_launch"): _BLOCK_STEP,
    ("sgns_fused_hbm", "sgns_hbm_sequential_launch"):
        [_P] * 5 + [_I] * 5 + [ctypes.c_float, _P, _P],
    ("sgns_fused_pipe", "sgns_pipe_launch"):
        [_P] * 14 + [_I] * 7 + [ctypes.c_float, _I, _P],
    ("sgns_fused_tiered", "sgns_tiered_launch"):
        [_P] * 14 + [_I] * 7 + [ctypes.c_float, _I, _P],
    ("swa_decode", "swa_decode_launch"):
        [_P] * 7 + [_I] * 5 + [ctypes.c_float, _I, _P],
    ("swa_decode", "swa_decode_parts"): [_I] * 6,
}
_entry_points: dict = {}
MAX_NEGATIVES = 16

#: Kernel launches per wrapper (plain integers; reset with
#: :func:`reset_launch_counts`).
LAUNCHES: dict[str, int] = {"sample_negatives": 0, "sgns_fused_step": 0,
                             "sgns_row_grads": 0, "sgns_fused_hbm_step": 0,
                             "sgns_fused_pipe_step": 0, "sgns_fused_tiered_step": 0,
                             "swa_decode": 0}


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
    # the TPU kernels' form (sgns_fused.py, sgns_update.py), not log-sigmoid
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def sgns_fused_step_plain(params: dict, centers: torch.Tensor,
                          contexts: torch.Tensor, table: dict,
                          seeds: torch.Tensor, lr: float, *,
                          negatives: int = 5):
    """The step K2 computes, in torch: the worker-batched
    ``train_step_sparse_`` on the replayed ids, with the fused kernel's
    softplus loss (K3's plain row gradients). Updates ``params`` in place
    (accumulating ``index_add_`` at W[centers], then C[contexts], then
    C[negatives]) and returns ``(params, loss (n, B), ids (n, B, K))``."""
    from repro_torch.kernels.sgns_update import sgns_row_grads_plain

    ids = sample_negatives_plain(seeds, table["prob"], table["alias"],
                                 (centers.shape[1], negatives))
    loss = train_step_sparse_(params, centers, contexts, ids, lr,
                              row_grads=sgns_row_grads_plain)
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


def _seed_of(key, device) -> torch.Tensor:
    """One ``(2,)`` key — uint32 words, or a tensor of their bits or
    values — as the ``(1, 2)`` int32 seed tensor the kernels take."""
    if isinstance(key, torch.Tensor):
        k = key.to(device=device, dtype=torch.int64).reshape(1, 2) & _MASK
        return torch.where(k >= 1 << 31, k - (1 << 32), k).to(torch.int32)
    return seed_tensor(np.asarray(key).reshape(1, 2), device)


def fused_negative_ids(seed, prob: torch.Tensor, alias: torch.Tensor,
                       shape: tuple[int, ...]) -> torch.Tensor:
    """The reference's ``fused_negative_ids``: the kernels' negative draw as
    a function of values, ``shape`` int32 ids from one alias table ``prob``,
    ``alias`` ``(V,)`` under one ``(2,)`` ``seed``, two counters a draw,
    row-major from 0 (:func:`alias_draw_from_counters`)."""
    count = int(np.prod(shape, dtype=np.int64))
    base = torch.arange(count, dtype=torch.int64, device=prob.device).reshape(1, count)
    ids = alias_draw_from_counters(_seed_of(seed, prob.device), prob.reshape(1, -1),
                                   alias.reshape(1, -1), base)
    return ids.reshape(tuple(shape))


def sample_negatives_fused(table: dict, key, shape: tuple[int, ...]) -> torch.Tensor:
    """The reference's ``sample_negatives_fused(table, key, shape)``, the
    samplers' ``fn(table, key, shape)`` contract, on K1: ``shape`` int32 ids
    from one alias table ``{"prob", "alias"}`` ``(V,)`` under one ``(2,)``
    key (its plain version on CPU tensors, the kernel on CUDA ones)."""
    prob, alias = table["prob"], table["alias"]
    seeds = _seed_of(key, prob.device)
    return sample_negatives(seeds, prob.reshape(1, -1).contiguous(),
                            alias.reshape(1, -1).contiguous(), tuple(shape))[0]


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
    and the negatives the step drew (on the card, inside its one launch).
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
    # One launch draws the step's negatives, sorts each worker's touched rows
    # into runs in addend order (W at centers; C at contexts, then at
    # negatives) and runs the step as one block of all B pairs.
    loss, ids = run_block_step("sgns_fused_step", "sgns_fused_step_launch", "sgns_fused_step",
                               params, centers, contexts, table, seeds, lr, B, K)
    return params, loss, ids
