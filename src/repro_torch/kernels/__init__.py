"""Hand-written CUDA kernels for Hopper (sources in ``repro_torch/csrc``),
with their plain torch versions and wrappers.

* ``sgns_fused`` — K1 ``sample_negatives`` (the counter-hash alias draw)
  and K2 ``sgns_fused_step`` (the whole SGNS step for n workers, the draw
  inside its one launch). Powers the ``fused`` update engine. Holds the launch counters and the C
  binding helpers the other kernel modules share.
* ``sgns_update`` — K3 ``sgns_row_grads`` (forward and row gradients on
  gathered rows). Powers the ``rowgrad`` engine; ``ops`` wraps it in the
  reference's ``kernels/ops.py`` contract, ``ref`` holds its oracle.
* ``sgns_fused_hbm`` — K4 ``sgns_fused_hbm_step`` (the step as a chain of
  pair blocks, or pair by pair). Powers the ``fused_hbm`` engine.
* ``sgns_fused_pipe`` — K5 ``sgns_fused_pipe_step`` (the block chain in
  one launch, rows in place), with the reference's block planner
  (``plan_blocks``) for its plain version. Powers ``fused_pipe``.
* ``sgns_fused_tiered`` — K6 ``sgns_fused_tiered_step`` (K5 with the most
  frequent rows kept in L2). Powers ``fused_tiered``.
* ``swa_decode`` — K7 ``swa_decode`` (single-token sliding-window
  attention over a full ring-buffer KV cache, with GQA). Powers the SWA
  layers' decode in ``repro_torch.models.attention``; ``ref`` holds its
  plain version.
* ``build`` — ``nvcc`` build and ``ctypes`` loading of the sources.

The package exports the names ``repro.kernels`` exports, each on its port
counterpart (the Pallas dials ``interpret`` and ``block_b`` have none):
``sgns_row_grads``, ``sgns_apply_step``, ``make_row_grad_fn`` (``ops``, over
K3); ``sgns_fused_step``, ``counter_uniforms``, ``sample_negatives_fused``
and ``fused_negative_ids`` (``sgns_fused``: K2, the draw's hash, K1 under
the reference's ``(table, key, shape)`` sampler contract, the draw as a
function of values); ``sgns_row_grads_ref`` and ``swa_decode_ref``
(``ref``); ``swa_decode_kernel`` (``swa_decode``, K7).
"""

import importlib

# name -> submodule, imported on first use (the kernel modules import core)
_EXPORTS = {"sgns_row_grads": "ops", "sgns_apply_step": "ops", "make_row_grad_fn": "ops",
            "sgns_fused_step": "sgns_fused", "sample_negatives_fused": "sgns_fused",
            "fused_negative_ids": "sgns_fused", "counter_uniforms": "sgns_fused",
            "sgns_row_grads_ref": "ref", "swa_decode_ref": "ref",
            "swa_decode_kernel": "swa_decode"}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        value = getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
