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
"""
