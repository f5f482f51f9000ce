"""Hand-written CUDA kernels for Hopper (sources in ``repro_torch/csrc``),
with their plain torch versions and wrappers.

* ``sgns_fused`` — K1 ``sample_negatives`` (the counter-hash alias draw)
  and K2 ``sgns_fused_step`` (the whole SGNS step for n workers). Powers
  the ``fused`` update engine.
* ``build`` — ``nvcc`` build and ``ctypes`` loading of the sources.
"""
