#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py                      # every phase, one GPU
    python3 chip_smoke.py --phases build,k1,k2
    python3 chip_smoke.py --phases build,random,hbm
    python3 chip_smoke.py --phases build,hbm,pipe
    python3 chip_smoke.py --phases build,decode
    python3 chip_smoke.py --phases build,main,sync,merge
    python3 chip_smoke.py --phases build,main,serve,cli
    python3 chip_smoke.py --phases build,elastic,contracts
    python3 chip_smoke.py --phases build,main,multiproc
    python3 chip_smoke.py --phases build,dryrun,budget
    python3 chip_smoke.py --phases build,lm_train
    python3 chip_smoke.py --phases build,archs
    python3 chip_smoke.py --phases build,sharding

Phases:

1. ``build`` — compile the CUDA sources under ``src/repro_torch/csrc`` with
   ``nvcc`` (one process per source, all at once) and print the build time
   and ptxas's register/spill report, kernel by kernel.
2. ``k1`` — K1 (``sample_negatives``) against its plain torch version on the
   GPU at V = 300,000 (alias table of a Zipf(1.0) distribution), ids of
   shape (4, 1024, 5): the ids must be bitwise equal.
3. ``k2`` — one K2 step (``sgns_fused_step``) against its plain version at
   V = 300,000, d = 500, K = 5, B = 1024, n = 4: ids bitwise equal, W′, C′
   and the per-pair loss within tolerance, and two K2 runs from the same
   inputs bitwise identical.
4. ``main`` — the port's main path through its entry points at the
   configuration of ``examples/train_w2v_100m.py``: ``train_submodels``
   (10 workers, d = 500, 1 epoch of 64 steps), ``merge(..., "alir_pca")``
   and ``evaluate_all``. The kernel launch counts are reset just before and
   read just after training; K2 must have launched once per step and K1
   never (K2 draws the negatives inside its launch), and every sub-model's
   W must have left its init.
4b. ``multiproc`` — two processes on the card train ``main``'s configuration
   (``train_submodels(process_index=r, process_count=2)``, 5 workers each,
   a gloo group through a file under ``build/``: NCCL refuses two ranks on
   one device): each rank's block of W and chunk losses, the gathered
   sub-models and the epoch losses bitwise the ``main`` run's (SHA-256 of the
   bytes); zero collectives in training, the merge phase's two
   ``all_gather``s counted; K2 once a step in each rank.
5. ``sync`` — the synchronous baselines at the main configuration. The
   paper's comparison: ``train_sync_baseline`` (one shared 89,611 × 500
   table, batches of n·B = 10,240 pairs, 64 steps, ``engine="fused"``:
   K1 draws each step's negatives, the gradient is dense) twice, bitwise
   equal, with K1 launched once a step and K2 never; its pairs/s printed
   beside the ``main`` phase's; its first 4 steps held against the same
   steps on the CPU (ids bitwise, K2's tolerances) and run in an NCCL
   process group of world size 1 (bitwise the run without a group). Then
   local SGD: ``make_periodic_sync_epoch`` over the main path's 10 workers
   (10 stacked copies, one K2 launch a local step, a mean over the worker
   axis every 8 steps), bitwise a hand loop of K2 steps and means, and
   within K2's tolerances of the same loop with K2's plain version.
6. ``merge`` — the ``Merger`` registry on the ``main`` phase's 10 × 89,611
   × 500 sub-models: each of ``alir``, ``alir_tree`` (fan_in 2),
   ``average``, ``concat`` and ``pca`` timed (and the tree's critical
   path); ``get_merger("alir")`` bitwise ``merge(..., "alir_pca")``;
   ``IncrementalAlirMerger`` fed in two arrival orders (warm folds on each
   arrival in the first) bitwise the batch merge; the tree's root bitwise
   the same under a permuted arrival order, and its quality beside flat
   ALiR's; ``mesh_sharded_gram`` in an NCCL group of one at S = 4 bitwise
   ``sharded_gram``, with exactly one ``all_gather_into_tensor``.
7. ``serve`` — train → publish → serve on the ``main`` phase's 10 × 89,611
   × 500 sub-models, after a seeded knock-out (20 % of the rows masked out
   of 1 to 9 random sub-models each, as ``benchmarks/bench_oov.py`` does, so
   every sub-model has absent rows): ``publish_incremental`` (``alir``,
   ``publish_every=5``, the sub-models included) writes v1 after 5 folds
   and v2 (the final cold fold) while a tracking ``EmbeddingServer`` (its
   table on the card) serves v1. Checked on the card: merged rows bitwise
   the final fold's Y and unknown raw ids not found; in every sub-model's
   space present rows bitwise the sub-model and absent rows within 1e-5 of
   ``reconstruct_missing``; a store pinned at v1 stays there while
   ``refresh()`` moves the tracking one to v2 and clears its cache; the
   JSON-lines TCP round trip (``ids``, ``stats``, a malformed line,
   ``refresh``). Printed: the publish and load walls, p50/p99 latency and
   lookups/s at ``ServeConfig()``'s defaults (32 concurrent clients, each
   32 ``embed_ids`` calls of 64 raw ids over Zipf(1) rows), and the
   device's share of a dispatched batch (its gathers and the copy to the
   host, from the profiler).
8. ``cli`` — ``repro_torch.launch.train_sgns.main`` in-process on the card
   (``--engine fused``, 10 workers, d = 500, B = 1024, a 100,000-word model,
   60,000 sentences: one epoch of 306 steps a worker; ``--merge alir_pca
   --publish DIR --publish-every 5 --save PATH``) with K2 launched once a
   step and K1 never; ``repro_torch.launch.serve.main`` on what it
   published (merged space with an unknown id; ``--submodel 0 --version
   1``); then ``python -m repro_torch.examples.quickstart``, ``serve_decode``
   and ``train_w2v_100m --steps 64 --epochs 1 --engine fused`` as
   processes, each to exit 0 with its expected lines.
9. ``random`` — the same configuration divided by the ``random`` strategy
   (rate 1/10: every worker its own vocabulary and noise table, trained in
   the union index space) on the ``rowgrad`` engine (the ``jax.random``
   CDF draw, torch gathers, K3 ``sgns_row_grads``, the ordered scatter
   ``sgns.ordered_add_``): 64 steps, then ``merge(..., "alir_pca")``, the
   missing rows reconstructed, and ``evaluate_all``. K3 must have launched
   once per step, every W left its init, the merged table must be finite
   and cover exactly the union presence mask. Then one step of ``dense``,
   ``sparse`` and ``rowgrad`` run twice from the same state must repeat
   bit for bit, and the scatter is timed as the ordered apply and as
   ``index_add_``'s atomics on the same addends.
10. ``hbm`` — the main configuration on the ``fused_hbm`` engine (K4a,
   ``block_pairs=256``: four blocks a step, the draw inside the launch) for
   64 steps, K4a once per step and K1 never; then ``sequential=True`` (K4b)
   for 8 steps, K4b and K1 once per step each; and W moved.
11. ``pipe`` — the main configuration on ``fused_pipe`` (K5, ``block_pairs
   =256``, ``ring_depth=2``) and then on ``fused_tiered`` (K6, ``hot_rows
   =256``) for 64 steps each: K5 or K6 and K1 once per step, W moved, and
   the trained W and every step's losses bitwise equal to the ``hbm``
   phase's ``fused_hbm`` run (same seeds, same chunks): the whole training
   run is held against K4a.
12. ``elastic`` — elastic training (``repro_torch.elastic``) at the main
   width (V = 89,611, d = 500, B = 1024, K = 5; 1 epoch of 64 steps in chunks
   of 16), cut to 4 workers trained one at a time, a checkpoint (358.4 MB a
   worker) every 2 chunks into a temporary state directory: on ``fused``
   (K2) the uninterrupted run twice bitwise; a kill and restart, and a kill
   with work stealing, over 2 simulated hosts, each bitwise the
   uninterrupted run with K2 launched once per step trained (replays
   included) and K1 never; ``train_submodels_elastic`` resumed on the
   finished directory (no launch, W bitwise); ``merge_finished`` with a
   quorum of 3 bitwise the survivors' final fold. On ``rowgrad`` (K3,
   ``random``) the uninterrupted run and a seeded kill-and-restart
   schedule that replays a lost chunk, bitwise. For each engine worker 0's
   first chunk is also trained on the CPU (the kernel's plain version) from
   the same init: W′, C′ and the losses within K2's or K3's tolerances. Every case under the collective recorder (none);
   save and load walls printed; whether an n = 1 worker is bitwise the
   stacked run's slice printed (a finding, not a check).
13. ``contracts`` — ``repro_torch.analysis.contracts`` on the card: every
   engine × sampler over one chunk of 8 steps at the main width with n = 2
   (no ``c10d::`` op, no NCCL kernel, the tables in place), the ``@zipf50k``
   traffic against ``BENCH_wallclock.json``; in an NCCL group of world size
   1 the mesh Gram's one all-gather (rejected by the certifier) and the
   sync baselines' all-reduces (3 a step; 2 a sync + 1 an epoch). Each
   engine with a kernel also trains one chunk of 8 steps (K4b: 1) at n = 2
   on the card and on the CPU (its kernels' plain versions) from the same
   init, ids and key: W′, C′ and the losses within K2's tolerances.
13b. ``dryrun`` — ``repro_torch.launch.dryrun_sgns`` through its entry point
   at the paper's width (``configs/sgns_wiki.py``: V = 300,000, d = 500, K =
   5, B = 1024, one worker, 16 steps of Zipf(1) ids; ``--vmem-budget-mb`` the
   opt-in 227 KiB): the ten cases, zero collectives on every async case,
   each case's launches and ``c10d::`` ops as expected (``sync`` 3 a step,
   ``local_sgd_k`` 2 a sync and 1 an epoch, ``merge_alir_iter`` 1
   all-gather), device µs a step and roofline rows; then K2, K3, K4a, K5, K6
   over 4 steps on the card and on the CPU from one init at this width
   (K2's tolerances and ``CHUNK_REL``), and K1 bitwise its plain version.
13c. ``budget`` — one step of each engine with a kernel (and K7 at the
   decode shape), then ``cudaFuncGetAttributes`` of every instantiation they
   launched equal to ``analysis/vmem.py``'s static and dynamic shared memory;
   registers and local memory (spills) of all 80 instantiations printed; the
   ``stamps`` variant of K2's and K4a's launch at the main path's shapes,
   its ``%globaltimer`` marks held to ``analysis/dma_model.check_timeline``.
14. ``time`` — each kernel held against its plain version at its path's
   shapes, then it and its plain version timed with CUDA events beside the
   least time the card could take: K1 (ids bitwise) and K2 (ids bitwise,
   W′, C′ and loss within tolerance, repeat bitwise) at the main path's
   shapes (n = 10, V = 89,611, its noise table), K1 beside an empty launch
   of the same grid (``kernel_variants``' ``empty``: its launch floor); K3
   on n·B = 10,240 pairs gathered from random tables, repeat bitwise and
   bitwise the first design (``kernel_variants``' ``first``), both timed as
   the whole call and on the device; K4a (ids bitwise, W′, C′ and loss within
   K2's tolerance, repeat bitwise; and with ``block_pairs >= B`` against
   K2) and K4b (against its plain per-pair loop, repeat bitwise) at the
   main path's shapes; K2, K4a and K5 with one block bitwise equal; K2 (one
   block) and K4a (``block_pairs=256``) each also timed as the launch alone
   on a fixed draw, beside K5's whole call at the same block size (in
   turns: kernel, K5, K5, kernel) and the torch block sorts the launch
   replaced, with each path's longest run of one row;
   K5 at ``ring_depth`` 2 and 3 and K6 at ``hot_rows`` 256, 2,048 and V
   there too (ids bitwise; W′, C′ and loss bitwise K4a's; within K2's
   tolerances of the plain version; repeat bitwise), each timed as the
   whole call, as the launch alone on fixed block sorts, beside K4a's whole
   call; and at the reference's ``@zipf50k`` shape (n = 1, V = 50,000,
   d = 512, B = 8,192, 64 blocks of 128) the planner's row traffic on the
   card (91,386 and 59,692 rows at ``hot_rows`` 0 and 2,048) and K5 and K6
   bitwise against, and timed beside, K4a.
15. ``profile`` — the main path's, the ``random``/``rowgrad`` path's, the
   ``fused_hbm`` path's (K4a) and (after ``pipe``) the ``fused_pipe``
   path's training again under
   ``torch.profiler``, those of them that ran: device time per step by
   kernel (gathers and scatter apart) and the device's idle share of the
   training loop (summary printed;
   ``profile_{main,random,hbm,pipe}*.json`` in the output directory); with
   ``decode``, 16
   full-ring decode steps too (``chiprun_out/profile_decode.json``).
16. ``decode`` — the LLM decode path (``repro_torch.launch.decode_llm
   .serve``) on h2o-danube-1.8b at full width (24 layers, d = 2560, 32
   query heads over 8 KV heads, window 4096, float32; weights from seed
   0): batch 4, a prompt of 4,096 tokens, 64 new ones. Every SWA layer's
   ring is full from the prompt's last token on, so K7 (``swa_decode``)
   must launch 24 × 65 = 1,560 times. Then, from a copy of serve's caches
   taken as its last prompt step returns (the prompt is not decoded
   twice), a snapshot of them, and 16 teacher-forced steps with K7 and 16
   with the plain masked attention from the snapshot: K7 held
   against its plain version on every layer's real cache on the first 4
   steps (float32 and bfloat16), the two routes' logits within the
   reference's decode tolerance; and K7, its plain version and
   ``scaled_dot_product_attention`` (the library yardstick) timed on
   layer 0's cache. Independent of the SGNS phases.
17. ``lm_train`` — the LM training path (``repro_torch.launch.train.train``)
   on smollm-360m at full width (32 layers, d = 960, 15 query heads over 5
   KV heads, head_dim 64, d_ff 2,560, vocabulary 49,152, tied embeddings,
   float32, TF32 off, AdamW, per-layer remat), 16 steps of 8 × 1,024
   tokens (``train_4k``'s 256 × 4,096 cut) with a checkpoint every 8: every
   loss finite and the mean of the last 4 below the mean of the first 4,
   none of the eight kernels launched, the step-16 checkpoint reloaded
   bitwise the live parameters and optimizer state; a second run from the
   same seed with the same losses bitwise (else the first op whose output
   differs between two runs of one step is named and the losses held at
   rtol 1e-6); then 4 steps timed and 3 under torch.profiler: s a step,
   tokens/s, peak device memory, the model FLOPs a step (6·N·tokens plus
   attention; and with remat's second forward) and their share of the
   float32 peak, the loop's idle share. Then one step's loss and gradients
   on the card against the CPU from one converted init at 1 × 128 tokens
   (loss rtol 1e-5, each gradient within ``CHUNK_REL`` of its largest
   |g|); and ``repro_torch.examples.async_embeddings_for_llm`` in-process
   with its expected lines, K2 once a step of its SGNS pretraining and no
   other kernel. Independent of the other phases.
18. ``archs`` — the rest of the model zoo, through
   ``repro_torch.launch.decode_llm.serve`` at the reference CLI's defaults
   (batch 4, a prompt of 16, 32 new tokens, seed 0) at full width, float32,
   TF32 off: deepseek-v2-lite-16b (MLA's absorbed decode over the
   compressed cache, MoE with 2 shared and 64 routed experts, top 6; its
   15,706,470,400 parameters counted), qwen2-vl-7b (M-RoPE, qkv biases),
   xlstm-1.3b (mLSTM, sLSTM) and seamless-m4t-large-v2 (24 + 24 layers,
   cross-attention; zero frames encoded first), each freed before the
   next: tokens int32 of shape (4, 32) in range; prefill and decode ms a
   step, tok/s, peak memory beside the bytes bound (every weight read once
   a step: the reference's MoE runs every expert on its capacity buffer).
   Then from the same seed again (init timed): decode against the forward
   at B = 2 (deepseek S = 12 at capacity factor 16, no assignment dropped
   in either pass; qwen2-vl S = 12; xlstm S = 512, so that the chunkwise
   mLSTM and the segmented sLSTM run; seamless 10 frames and 8 tokens)
   within atol = rtol = 2e-3; 16 deepseek steps replayed from a cache
   snapshot, bitwise; qwen2-vl's forward over 1,024 zero patch embeddings
   and 12 tokens. The six archs of the slice reduced, card vs CPU from one
   converted init: logits and 4 decode steps (caches included) within the
   CPU tests' tolerances, the MoE routes equal, one step's loss (rtol
   1e-5) and gradients (``CHUNK_REL`` of each tensor's largest |g|). One
   Mamba mixer at jamba-1.5-large's widths (d 8,192, d_inner 16,384,
   d_state 16, dt_rank 512), card vs CPU: a forward at S = 1,024 (two
   chunks of 512) and 8 decode steps. Each full-width arch's decode is
   also profiled (8 steps at B = 4: ms a step, device busy, idle share,
   device ops a step, device time by group; ``profile_archs_<arch>.json``
   in the output directory). None of the eight kernels launches (no arch
   here has a window). Independent of the other phases.

19. ``sharding`` — the LLM sharding layer. ``launch.train.train`` on
   smollm-360m at full width with ``lm_train``'s settings for 4 steps of 8
   × 1,024 tokens, without a mesh and on ``make_smoke_mesh()`` (a 1 × 1
   mesh, an NCCL group of one; parameters and AdamW state as DTensors):
   the losses bitwise (else within rtol 1e-5). Then one step on the mesh
   timed, one under ``torch.profiler`` (``with_flops``) and one counted by
   ``launch.op_cost``: the matmul flops within 1 % of the profiler's, the
   step no faster than the float32 roofline's largest term, the counted
   peak bytes within ±20 % of ``torch.cuda.max_memory_allocated`` (less
   what the process held before the step beyond its inputs), and
   op_cost's bytes beside the profiler's device time by op group. Meanwhile
   ``python -m repro_torch.launch.dryrun`` traces the cases of
   ``SHARD_DRYRUNS`` (llama3-8b, deepseek-v2-lite-16b, smollm-360m and
   h2o-danube-1.8b × ``train_4k`` on 16 × 16, h2o also on 2 × 16 × 16,
   jamba-1.5-large-398b × ``long_500k`` on 16 × 16 and deepseek ×
   ``decode_32k`` on 2 × 16 × 16), and ``--rank-rule`` holds reduced
   smollm-360m, deepseek-v2-lite-16b and llama3-8b to the rank rule on a
   fake 4 × 4 group (the CPU test's check, on this host's torch), each in a
   process of its own (a fake group): every dry run must trace and
   replicate nothing where no rule placed it, h2o's peak on 2 × 16 × 16
   must not exceed its peak on 16 × 16 (the LM loss keeps the vocabulary
   sharded), llama3's and deepseek's ``train_4k`` flops, matmul flops and
   GB must equal ``SHARD_TORCH213`` (this tree's figures on torch 2.13)
   within 1e-6, the two list their outputs of ``SHARD_ALLOC_GB`` or more
   (``--allocations``): none of llama3's may be the whole ``(Vp, d)``
   embedding table (its gradient stays on each rank's vocabulary block),
   none of deepseek's an activation of the whole ``(G, E, C, d)`` MoE
   buffer's size or of its ``E·C + Nk`` rows (each rank builds its block),
   every rank rule must hold; their rows (GB a rank against
   80, flops, bytes, collectives by kind, the dominant term) and the torch
   version are printed. None of the eight kernels launches.

Each phase's wall is printed as it ends. It prints a ``{"kernels": [...]}``
JSON line, then the card's name and power
limit as ``nvidia-smi`` reports them, then ``{"ok": true, ...}`` last. Any
failing phase raises and the script exits non-zero. Without a CUDA device,
or outside a checkout of the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import subprocess
import sys
import time
from contextlib import contextmanager
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32 outside
# the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12

# Tolerances of K2 against its plain version on the card. The two reduce
# the dot products in different orders (both add a row's duplicates
# serially in pair order), so the coefficients differ by an ulp or so;
# values are O(1), so a few float32 ulps per addend over a hot row's
# hundreds of addends stays under these bounds.
K2_TABLE_ATOL = 1e-5
K2_LOSS_ATOL = 1e-4
# K3 against its plain version: per-pair outputs, no accumulation; the two
# sum the K + 1 dot products in different orders, so outputs of O(0.1) and
# losses of O(1) differ by a few ulps. K2's bounds, with room to spare.
K3_GRAD_ATOL = 1e-5
K3_LOSS_ATOL = 1e-4
# A chunk trained on the card against the same chunk on the CPU (the
# kernels' plain versions) from the word2vec init: the tables stay near
# 1e-3, where K2's absolute bound alone would pass a lost update of a cold
# row, so the difference must also stay under this share of the largest
# update (reordered float32 sums differ by a few ulps of the values).
CHUNK_REL = 1e-3
# K4 against its plain version: K2's tolerances (K4b's plain loop is a
# chain of batch-1 steps, its dot products reduced in another order than
# the kernel's, each difference carried into the later pairs).
# K5 and K6 likewise against theirs; against K4a they are bitwise.

# K7 against its plain version (float32: the window's sums in another
# order; bfloat16: an output rounded to 8 bits, the JAX test's bound), and
# the K7 route's logits against the plain masked attention's
# (tests/test_decode_consistency.py's atol and rtol).
K7_ATOL = {"float32": 1e-5, "bfloat16": 3e-2}
DECODE_LOGITS_TOL = 2e-3

PHASES = ("build", "k1", "k2", "main", "multiproc", "sync", "merge", "serve", "cli", "random",
          "hbm", "pipe", "elastic", "contracts", "dryrun", "budget", "time", "profile",
          "decode", "lm_train", "archs", "sharding")
REPLACES = {
    "sample_negatives": "src/repro/kernels/sgns_fused.py:197",
    "sgns_fused_step": "src/repro/kernels/sgns_fused.py:105",
    "sgns_row_grads": "src/repro/kernels/sgns_update.py:52",
    "sgns_fused_hbm_step": "src/repro/kernels/sgns_fused_hbm.py:128",
    "sgns_fused_hbm_step_sequential": "src/repro/kernels/sgns_fused_hbm.py:185",
    "sgns_fused_pipe_step": "src/repro/kernels/sgns_fused_pipe.py:419",
    "sgns_fused_tiered_step": "src/repro/kernels/sgns_fused_tiered.py:94",
    "swa_decode": "src/repro/kernels/swa_decode.py:28",
}
SOURCES = {
    "sample_negatives": "src/repro_torch/csrc/sample_negatives.cu",
    "sgns_fused_step": "src/repro_torch/csrc/sgns_fused_step.cu",
    "sgns_row_grads": "src/repro_torch/csrc/sgns_row_grads.cu",
    "sgns_fused_hbm_step": "src/repro_torch/csrc/sgns_fused_hbm.cu",
    "sgns_fused_hbm_step_sequential": "src/repro_torch/csrc/sgns_fused_hbm.cu",
    "sgns_fused_pipe_step": "src/repro_torch/csrc/sgns_fused_pipe.cu",
    "sgns_fused_tiered_step": "src/repro_torch/csrc/sgns_fused_tiered.cu",
    "swa_decode": "src/repro_torch/csrc/swa_decode.cu",
}
# The main path's configuration (examples/train_w2v_100m.py, cut to 64 steps).
VOCAB = 100_000
NUM_WORKERS, DIM, BATCH, STEPS, STEPS_PER_CHUNK = 10, 500, 1024, 64, 32
# The decode path's: h2o-danube-1.8b at full width, a prompt of one window.
DECODE = dict(arch="h2o-danube-1.8b", batch=4, prompt_len=4096, new_tokens=64, seed=0)
DECODE_CHECK_STEPS, DECODE_KERNEL_CHECKS = 16, 4
# The sync phase: the baseline's first steps held against the CPU, and
# local SGD's syncs (8 of 8 local steps in the 64-step epoch).
SYNC_CHECK_STEPS, SYNC_EVERY = 4, 8
# The serve phase: the main path's sub-models with 20 % of the rows knocked
# out of 1 to n - 1 of them; served reconstructions against
# reconstruct_missing on the card (other cuBLAS kernels for other M: the
# sums run in other orders); the load at ServeConfig()'s defaults.
SERVE_KNOCKOUT, SERVE_REC_ATOL = 0.2, 1e-5
SERVE_CLIENTS, SERVE_CALLS, SERVE_IDS = 32, 32, 64
# The elastic phase: the main width cut to 4 workers (a checkpoint moves
# 358.4 MB a worker) in chunks of 16 steps, a checkpoint every 2 chunks.
ELASTIC_WORKERS, ELASTIC_CHUNK, ELASTIC_CKPT_EVERY = 4, 16, 2
# The cli phase: train_sgns at the main width on 60,000 sentences (306
# steps a worker in its one epoch; 40,000 give 204), and the examples with
# what each prints.
# The dryrun phase: the paper's width (configs/sgns_wiki.py), steps a case,
# and the shared-memory budget (the H100's opt-in 227 KiB a CTA, in MiB).
DRYRUN_V, DRYRUN_STEPS, DEFAULT_BUDGET_MB = 300_000, 16, 232_448 / 2 ** 20
# The multiproc phase: ranks on the one card, and each rank's time limit.
MULTIPROC_WORLD, MULTIPROC_TIMEOUT_S = 2, 300
# The lm_train phase: smollm-360m at full width, train_4k's 256 × 4,096 cut to
# 8 × 1,024 tokens a step; the card against the CPU at 1 × 128; the loop's
# steps timed and profiled after the runs; the example's expected lines.
LM_TRAIN = dict(arch="smollm-360m", steps=16, batch=8, seq=1024, lr=3e-4, ckpt_every=8)
LM_CHECK_BATCH, LM_CHECK_SEQ, LM_LOSS_RTOL, LM_REPEAT_RTOL = 1, 128, 1e-5, 1e-6
LM_TIMED_STEPS, LM_PROFILED_STEPS = 4, 3
LM_EXAMPLE_LINES = ("async embedding pretrain:", "vocab covered by the merged model",
                    "LM loss, last")
# The archs phase: the four archs that fit one card whole decode at full
# width (serve at the reference CLI's defaults), each decode held against
# its forward (deepseek at a capacity factor where no assignment drops:
# 16·2·6/64 → 3 slots at decode), 16 replayed steps of deepseek; the six
# new archs reduced, card vs CPU; jamba's Mamba mixer at its widths.
ZOO_FULL = ("deepseek-v2-lite-16b", "qwen2-vl-7b", "xlstm-1.3b", "seamless-m4t-large-v2")
ZOO_REDUCED = ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b", "jamba-1.5-large-398b",
               "xlstm-1.3b", "qwen2-vl-7b", "seamless-m4t-large-v2")
ZOO_SERVE = dict(batch=4, prompt_len=16, new_tokens=32, seed=0)
ZOO_CONSISTENCY = {
    "deepseek-v2-lite-16b": dict(b=2, s=12, moe=dict(capacity_factor=16.0)),
    "qwen2-vl-7b": dict(b=2, s=12),
    "xlstm-1.3b": dict(b=2, s=512),      # mLSTM chunkwise, sLSTM segmented
    "seamless-m4t-large-v2": dict(b=2, s=8, enc_len=10),
}
DEEPSEEK_PARAMS = 15_706_470_400
ZOO_REPLAY_STEPS, ZOO_VL_PATCHES, ZOO_REDUCED_DECODE = 16, 1024, 4
ZOO_MAMBA_SEQ, ZOO_MAMBA_DECODE, ZOO_PROFILE_STEPS = 1024, 8, 8
# the CPU tests' tolerances of the reduced archs (xlstm's recurrences grow
# a last-ulp difference: tests/test_torch_arch_zoo.py)
ZOO_ATOL = {"xlstm-1.3b": 2e-4}
# The sharding phase: the smoke mesh (1 x 1, a group of one on the card) with
# lm_train's settings for 4 steps, the mesh-less run's losses held to it; one
# step's op_cost against the profiler (matmul flops) and the allocator (peak
# bytes); the dry run's two cases, each a process of its own (a fake group).
SHARD_TRAIN = dict(arch="smollm-360m", steps=4, batch=8, seq=1024, lr=3e-4)
SHARD_FLOPS_RTOL, SHARD_PEAK_TOL = 0.01, 0.20
SHARD_DRYRUNS = (("llama3-8b", "train_4k", False), ("deepseek-v2-lite-16b", "train_4k", False),
                 ("deepseek-v2-lite-16b", "decode_32k", True), ("smollm-360m", "train_4k", False),
                 ("h2o-danube-1.8b", "train_4k", False), ("h2o-danube-1.8b", "train_4k", True),
                 ("jamba-1.5-large-398b", "long_500k", False))
# llama3-8b and deepseek-v2-lite-16b x train_4k on 16 x 16 with torch 2.13.0
# (a CPU host), this tree: flops, matmul flops a rank and GB a rank (1e9
# bytes) from `python -m repro_torch.launch.dryrun --arch A --shape train_4k
# --json out.json` (its flops_per_chip, matmul_flops_per_chip,
# hbm_gb_per_chip x 2**30 / 1e9). Every torch version must read them within
# SHARD_TORCH_RTOL.
SHARD_TORCH213 = {"llama3-8b_train_4k": (261969178286145.0, 261400299569152.0, 4.433474422),
                  "deepseek-v2-lite-16b_train_4k": (123846356538321.0, 123337502097408.0,
                                                    6.971944268)}
SHARD_TORCH_RTOL = 1e-6
# the two train_4k dry runs list their outputs of this many GB (1e9 bytes) or
# more a rank, held to no whole embedding table or MoE buffer
SHARD_ALLOC_GB = 0.5
SHARD_DRYRUN_TIMEOUT_S = 600
SHARD_MATMULS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
SHARD_OP_GROUPS = (("matmuls", ("mm", "addmm", "bmm", "baddbmm")),
                   ("copies", ("copy_", "_to_copy", "clone", "cat", "stack", "zeros_like",
                               "fill_", "zero_")),
                   ("indexing", ("embedding", "embedding_dense_backward", "index", "gather",
                                 "scatter", "index_put", "index_put_", "slice_backward",
                                 "select_backward")),
                   ("reductions", ("sum", "mean", "logsumexp", "_log_softmax", "_softmax",
                                   "amax", "_softmax_backward_data",
                                   "_log_softmax_backward_data")))
CLI_SENTENCES = 60_000
EXAMPLES = (
    ("quickstart", [], ("trained 4 async sub-models", "alir_pca   similarity")),
    ("serve_decode", [], ("serving starts at artifact v1", "hot-swapped to artifact v4",
                          "reconstructed", "serving stats:")),
    ("train_w2v_100m", ["--steps", "64", "--epochs", "1", "--engine", "fused"],
     ("async training:", "ALiR merge of 10", "merged model: sim", "checkpoint →")),
)
_WORLD: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def zipf_alias_table(V: int, n: int, device, a: float = 1.0) -> dict:
    """Stacked ``(n, V)`` alias table of a Zipf(a) distribution by rank."""
    import numpy as np
    import torch
    from repro_torch.core.distributions import build_alias_table

    p = np.arange(1, V + 1, dtype=np.float64) ** (-a)
    prob, alias = build_alias_table(p / p.sum())
    return {"prob": torch.tensor(prob, dtype=torch.float32, device=device)
            .expand(n, V).contiguous(),
            "alias": torch.tensor(alias, dtype=torch.int32, device=device)
            .expand(n, V).contiguous()}


def seeds_for(n: int, seed: int, device):
    from repro_torch import prng
    from repro_torch.kernels.sgns_fused import seed_tensor

    return seed_tensor(prng.split(prng.PRNGKey(seed), n), device)


# ---------------------------------------------------------------------------
def phase_build() -> dict:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    report = build.build_all()
    log(f"[build] nvcc {' '.join(build.NVCC_FLAGS)}: "
        f"{time.perf_counter() - t0:.1f} s wall for {len(report)} sources")
    for name, r in report.items():
        log(f"[build]   {name}: {r['seconds']:.1f} s -> {r['path']}")
        for line in r["log"].splitlines():
            if "Compiling entry function" in line:
                log(f"[build]     {line.split(chr(39))[1][:96]}")
            elif "registers" in line or "spill" in line:
                log(f"[build]       {line.strip()}")
    return report


def _check_k1(tag, seeds, table, shape) -> float:
    """K1 against its plain version on the same inputs: bitwise."""
    import torch
    from repro_torch.kernels.sgns_fused import sample_negatives, sample_negatives_plain

    ids = sample_negatives(seeds, table["prob"], table["alias"], shape)
    ref = sample_negatives_plain(seeds, table["prob"], table["alias"], shape)
    torch.cuda.synchronize(ids.device)
    mismatches = int((ids != ref).sum())
    log(f"[{tag}] K1 V={table['prob'].shape[-1]} ids {tuple(ids.shape)}: {mismatches} "
        f"mismatches against the plain version; ids span "
        f"[{int(ids.min())}, {int(ids.max())}]")
    if mismatches:
        raise RuntimeError(f"K1 is not bitwise equal to its plain version "
                           f"({mismatches} ids differ)")
    return 0.0


def phase_k1(device, V=300_000, shape=(1024, 5), n=4) -> dict:
    table = zipf_alias_table(V, n, device)
    return {"max_abs_err": _check_k1("k1", seeds_for(n, 0, device), table, shape)}


def _k2_inputs(device, V, d, B, n, seed=0):
    import torch
    from repro_torch.kernels.sgns_fused import sample_negatives_plain

    table = zipf_alias_table(V, n, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    W = 0.1 * torch.randn((n, V, d), generator=gen, device=device)
    C = 0.1 * torch.randn((n, V, d), generator=gen, device=device)
    # Zipf-distributed centers/contexts: hot rows repeat, as in real batches
    centers = sample_negatives_plain(seeds_for(n, 1, device), table["prob"],
                                     table["alias"], (B,))
    contexts = sample_negatives_plain(seeds_for(n, 2, device), table["prob"],
                                      table["alias"], (B,))
    return W, C, centers, contexts, table, seeds_for(n, 3, device)


def _check_step(tag, label, step, plain_step, W, C, centers, contexts, table,
                seeds, lr, K, repeat=False, **kw) -> float:
    """One kernel step (``step``: K2's or K4's wrapper) against one plain
    step from clones of the same inputs: ids bitwise equal, W′/C′/loss
    within K2's tolerances, C updated; with ``repeat``, a second kernel run
    must be bitwise identical to the first."""
    import torch

    runs = []
    for _ in range(2 if repeat else 1):
        p = {"W": W.clone(), "C": C.clone()}
        runs.append(step(p, centers, contexts, table, seeds, lr, negatives=K, **kw))
    plain = {"W": W.clone(), "C": C.clone()}
    plain, loss_p, ids_p = plain_step(plain, centers, contexts, table, seeds, lr,
                                      negatives=K, **kw)
    torch.cuda.synchronize(W.device)
    p1, l1, i1 = runs[0]
    id_mismatch = int((i1 != ids_p).sum())
    err_w = float((p1["W"] - plain["W"]).abs().max())
    err_c = float((p1["C"] - plain["C"]).abs().max())
    err_l = float((l1 - loss_p).abs().max())
    moved = float((p1["C"] - C).abs().max())
    n, V, d = W.shape
    msg = (f"[{tag}] {label} n={n} V={V} d={d} B={centers.shape[1]} K={K}: ids "
           f"{id_mismatch} mismatches; max |ΔW′| {err_w:.3e}, max |ΔC′| {err_c:.3e} "
           f"(tol {K2_TABLE_ATOL:g}; largest C update {moved:.3e}); max |Δloss| "
           f"{err_l:.3e} (tol {K2_LOSS_ATOL:g})")
    same = True
    if repeat:
        p2, l2, i2 = runs[1]
        same = (torch.equal(p1["W"], p2["W"]) and torch.equal(p1["C"], p2["C"])
                and torch.equal(l1, l2) and torch.equal(i1, i2))
        msg += f"; repeat run bitwise identical: {same}"
    log(msg)
    del runs, plain
    if id_mismatch:
        raise RuntimeError(f"{label}'s negatives differ from the plain version's")
    if err_w > K2_TABLE_ATOL or err_c > K2_TABLE_ATOL or err_l > K2_LOSS_ATOL:
        raise RuntimeError(f"{label} disagrees with its plain version beyond tolerance")
    if not same:
        raise RuntimeError(f"two {label} runs from the same inputs differ")
    if not math.isfinite(moved) or moved == 0.0:
        raise RuntimeError(f"{label} left the C table unchanged")
    return max(err_w, err_c, err_l)


def phase_k2(device, V=300_000, d=500, B=1024, n=4, K=5, lr=0.025) -> dict:
    from repro_torch.kernels.sgns_fused import sgns_fused_step, sgns_fused_step_plain

    W, C, centers, contexts, table, seeds = _k2_inputs(device, V, d, B, n)
    log(f"[k2] tables {2 * W.numel() * 4 / 1e9:.1f} GB (+ copies for the plain "
        f"and repeat runs)")
    return {"max_abs_err": _check_step("k2", "K2", sgns_fused_step, sgns_fused_step_plain,
                                       W, C, centers, contexts, table, seeds, lr, K,
                                       repeat=True)}


def world():
    """The main path's synthetic corpus and benchmark suite, made once."""
    if not _WORLD:
        from repro_torch.data.corpus import SemanticCorpusModel
        from repro_torch.eval.benchmarks import BenchmarkSuite

        t0 = time.perf_counter()
        gen = SemanticCorpusModel.create(vocab_size=VOCAB, num_topics=64, seed=0)
        corpus = gen.generate(num_sentences=120_000, seed=1)
        _WORLD.update(corpus=corpus,
                      suite=BenchmarkSuite.from_model(gen, top_words=min(20_000, VOCAB)))
        log(f"[world] corpus: {corpus.num_sentences} sentences, {corpus.num_tokens} "
            f"tokens ({time.perf_counter() - t0:.1f} s)")
    return _WORLD["corpus"], _WORLD["suite"]


def train_kw(strategy: str, engine) -> dict:
    """``train_submodels`` arguments of the main configuration."""
    from repro_torch.core.sgns import SGNSConfig

    cfg = SGNSConfig(vocab_size=0, dim=DIM, window=5, negatives=5)
    return dict(strategy=strategy, num_workers=NUM_WORKERS, cfg=cfg, epochs=1,
                batch_size=BATCH, window=5, max_vocab=VOCAB, base_min_count=10,
                max_steps_per_epoch=STEPS, steps_per_chunk=STEPS_PER_CHUNK,
                engine=engine)


def _train(tag: str, device, kw: dict, kernels: tuple, steps: int | None = None,
           absent: tuple = ()):
    """``train_submodels`` with every launch count set to 0 just before and
    read just after. Each kernel in ``kernels`` must have launched once per
    step, each in ``absent`` never; losses finite, the first step's exactly (K + 1)·log 2 (C starts
    at zero), the tables finite, and every worker's W moved from its init
    (dW is a sum of C rows, so W moves only if the C updates landed)."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.core.driver import train_submodels
    from repro_torch.core.sgns import init_params
    from repro_torch.kernels import sgns_fused

    corpus, _ = world()
    if steps is not None:
        kw = {**kw, "max_steps_per_epoch": steps, "steps_per_chunk": steps}
    cfg = kw["cfg"]
    sgns_fused.reset_launch_counts()
    t0 = time.perf_counter()
    res = train_submodels(corpus, VOCAB, device=device, **kw)
    launches = dict(sgns_fused.LAUNCHES)
    wall = time.perf_counter() - t0
    V = res.union_vocab.size
    taken = res.timings["steps_per_epoch"]
    log(f"[{tag}] trained {NUM_WORKERS} x {V} x {DIM} sub-models ({kw['strategy']}, "
        f"{kw['engine']}): {taken} steps, vocab {res.timings['vocab_s']:.2f} s, init "
        f"{res.timings['init_s']:.2f} s, train {res.timings['train_s']:.3f} s "
        f"({res.timings['chunk_wait_s']:.3f} s blocked on chunks), setup+init+train "
        f"{wall:.1f} s")
    for k, cl in enumerate(res.chunk_losses):
        log(f"[{tag}]   chunk {k} mean loss per worker: "
            + " ".join(f"{x:.7f}" for x in cl.mean(axis=1)))
    log(f"[{tag}] launches during training: {launches}")
    for name in kernels:
        if launches[name] != taken:
            raise RuntimeError(f"expected {taken} launches of {name}, got {launches}")
    for name in absent:
        if launches[name]:
            raise RuntimeError(f"expected no launch of {name}, got {launches}")
    if not all(np.isfinite(c).all() for c in res.chunk_losses):
        raise RuntimeError("non-finite training loss")
    first = res.chunk_losses[0][:, 0]
    plateau = (cfg.negatives + 1) * math.log(2.0)
    if np.abs(first - plateau).max() > 1e-5:
        raise RuntimeError(f"first-step loss {first} != (K+1)·log 2 = {plateau}")
    if not torch.isfinite(res.stacked.models).all():
        raise RuntimeError("non-finite sub-model tables")
    keys = prng.split(prng.PRNGKey(cfg.seed), NUM_WORKERS)
    cfg_v = replace(cfg, vocab_size=V)
    moved = [float((res.stacked.models[i] - init_params(k, cfg_v, device=device)["W"])
                   .abs().max()) for i, k in enumerate(keys)]
    log(f"[{tag}] max |W - W_init| per worker: " + " ".join(f"{m:.3e}" for m in moved))
    if not all(math.isfinite(m) and m > 0.0 for m in moved):
        raise RuntimeError("a sub-model's W never left its init: C was not updated")
    return res, launches, taken


def _merge_and_score(tag, res, device, full_cover: bool):
    """ALiR-merge the sub-models, check the table, and score it."""
    import numpy as np
    import torch
    from repro_torch.core.merge import merge
    from repro_torch.eval.benchmarks import evaluate_all

    _, suite = world()
    V = res.union_vocab.size
    t0 = time.perf_counter()
    emb, valid = merge(res.stacked, "alir_pca", out_dim=DIM, device=device)
    torch.cuda.synchronize(device)
    merge_s = time.perf_counter() - t0
    emb_np, valid_np = emb.cpu().numpy(), valid.cpu().numpy()
    log(f"[{tag}] ALiR merge of {NUM_WORKERS} x ({V}, {DIM}): {merge_s:.2f} s")
    if emb_np.shape != (V, DIM) or not np.isfinite(emb_np).all():
        raise RuntimeError(f"bad merged table: shape {emb_np.shape}")
    union = res.stacked.mask.any(0).cpu().numpy()
    if not np.array_equal(valid_np, union):
        raise RuntimeError("the merged table's valid rows are not the union presence mask")
    if full_cover and int(valid_np.sum()) != V:
        raise RuntimeError("shuffle's merged table must cover the whole vocabulary")
    scores = evaluate_all(emb_np, valid_np, res.union_vocab, suite)
    log(f"[{tag}] merged model: sim rho={scores['similarity']:.3f} "
        f"analogy={scores['analogy']:.3f} purity={scores['categorization']:.3f}")
    return emb, scores


def phase_main(device):
    kw = train_kw("shuffle", "fused")
    res, launches, taken = _train("main", device, kw, ("sgns_fused_step",),
                                  absent=("sample_negatives",))
    emb, scores = _merge_and_score("main", res, device, full_cover=True)
    # the sync phase compares its pairs/s with this run's; the merge phase
    # merges these sub-models again (and drops them)
    return {"launches": launches, "steps": taken, "counts": res.union_vocab.counts,
            "V": res.union_vocab.size, "n": NUM_WORKERS, "dim": DIM, "B": BATCH,
            "K": kw["cfg"].negatives, "lr": kw["cfg"].lr, "train_kw": kw,
            "train_s": res.timings["train_s"], "stacked": res.stacked,
            "alir_pca": emb, "scores": scores, "vocab": res.union_vocab,
            "chunk_losses": res.chunk_losses, "losses": res.losses}


@contextmanager
def _nccl_world_of_one(tag: str, device):
    """An NCCL process group of world size 1 on ``device``, rendezvous
    through a file under the build directory (no network), destroyed on
    exit so that later phases run with no group."""
    import os
    import torch
    import torch.distributed as dist

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    store = ROOT / "build" / f"nccl_store_{tag}"
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1), rank=0,
                            world_size=1)
    try:
        if dist.get_backend() != "nccl":
            raise RuntimeError(f"expected an NCCL group, got {dist.get_backend()}")
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)


@contextmanager
def _collective_calls():
    """Count every ``torch.distributed`` collective the block makes (by
    name), without changing what the calls do."""
    import torch.distributed as dist

    calls: list = []
    names = ("all_gather_into_tensor", "all_gather", "all_reduce", "broadcast",
             "reduce_scatter_tensor", "all_to_all_single", "barrier")
    real = {n: getattr(dist, n) for n in names}

    def counted(name):
        def call(*a, **k):
            calls.append(name)
            return real[name](*a, **k)
        return call

    for n in names:
        setattr(dist, n, counted(n))
    try:
        yield calls
    finally:
        for n, fn in real.items():
            setattr(dist, n, fn)


def _sync_inputs(device):
    """The sync baseline's inputs, rebuilt with the driver's own helpers
    (``train_sync_baseline`` with seed 0 and one epoch): the vocabulary's
    alias table, the epoch's first STEPS batches of n·B pairs, its key."""
    from repro_torch.core import driver
    from repro_torch.core.sgns import SGNSConfig
    from repro_torch.data.pairs import build_noise_table, extract_pairs
    from repro_torch.data.vocab import build_vocab

    corpus, _ = world()
    batch = NUM_WORKERS * BATCH
    vocab = build_vocab(corpus, VOCAB, min_count=1, max_size=VOCAB)
    cfg = SGNSConfig(vocab_size=vocab.size, dim=DIM, window=5, negatives=5)
    centers, contexts = extract_pairs(corpus, vocab, window=5, subsample_t=1e-4, seed=0)
    steps = min(max(1, len(centers) // batch), STEPS)
    rng = driver._epoch_rng(0, driver._STREAM_SYNC_PERM, 0)
    perm = driver._tiled_permutation(rng, len(centers), steps * batch)
    return dict(cfg=cfg, table=build_noise_table(vocab.counts, kind="alias"),
                centers=centers[perm].reshape(steps, batch),
                contexts=contexts[perm].reshape(steps, batch),
                key=driver._epoch_key(0, driver._STREAM_SYNC_EPOCH, 0), steps=steps)


def phase_sync(device, main: dict) -> dict:
    """The synchronous baselines at the main configuration: the paper's
    comparison (one shared table, the gradient synchronized every step)
    and local SGD over the main path's 10 workers."""
    import torch
    from repro_torch import prng
    from repro_torch.core.async_trainer import make_periodic_sync_epoch, make_sync_epoch
    from repro_torch.core.driver import train_sync_baseline
    from repro_torch.core.engine import get_engine
    from repro_torch.core.sgns import SGNSConfig, init_params, linear_lr, worker_mean
    from repro_torch.kernels import sgns_fused as K

    corpus, _ = world()
    batch = NUM_WORKERS * BATCH
    cfg = SGNSConfig(vocab_size=0, dim=DIM, window=5, negatives=5)
    plateau = (cfg.negatives + 1) * math.log(2.0)
    # 1. the baseline through its entry point, twice
    runs = []
    for _ in range(2):
        K.reset_launch_counts()
        params, vocab, info = train_sync_baseline(
            corpus, VOCAB, cfg, epochs=1, batch_size=batch, window=5, max_vocab=VOCAB,
            max_steps_per_epoch=STEPS, engine="fused", device=device)
        runs.append((params, info, dict(K.LAUNCHES)))
        log(f"[sync] baseline {vocab.size} x {DIM}, batch {batch}: "
            f"{info['steps_per_epoch']} steps in {info['train_s']:.3f} s, epoch loss "
            f"{info['losses'][0]:.7f}; launches {runs[-1][2]}")
    (p1, i1, l1), (p2, i2, _) = runs
    steps = i1["steps_per_epoch"]
    if l1["sample_negatives"] != steps or l1["sgns_fused_step"]:
        raise RuntimeError(f"expected {steps} K1 launches and no K2, got {l1}")
    if steps != STEPS or not all(math.isfinite(x) for x in i1["losses"]):
        raise RuntimeError(f"bad baseline run: {steps} steps, losses {i1['losses']}")
    if not i1["losses"][0] < plateau:
        raise RuntimeError(f"the baseline's loss did not fall below (K+1)·log 2: "
                           f"{i1['losses']}")
    same = (torch.equal(p1["W"], p2["W"]) and torch.equal(p1["C"], p2["C"])
            and i1["losses"] == i2["losses"])
    log(f"[sync] repeat run bitwise identical (W, C, losses): {same}")
    if not same:
        raise RuntimeError("two baseline runs from the same seed differ")
    del runs, p1, p2
    sync_pps = [batch * i["steps_per_epoch"] / i["train_s"] for i in (i1, i2)]
    async_pps = main["n"] * main["B"] / (main["train_s"] / main["steps"])
    log(f"[sync] pairs/s: synchronous baseline {sync_pps[1]:.4e} warm (its repeat; the "
        f"first, cold run {sync_pps[0]:.4e}) (10,240 x {steps} / train_s); asynchronous "
        f"main path {async_pps:.4e} (n·B / step wall, {main['train_s']:.3f} s for "
        f"{main['steps']} steps): {async_pps / sync_pps[1]:.3f}x the warm baseline "
        f"({async_pps / sync_pps[0]:.3f}x the cold run)")

    # its first steps against the same steps on the CPU
    inp = _sync_inputs(device)
    cfg_v, n_check = inp["cfg"], SYNC_CHECK_STEPS
    c, x = inp["centers"][:n_check], inp["contexts"][:n_check]
    out = []
    init = init_params(prng.PRNGKey(cfg_v.seed), cfg_v, device=device)
    for dev in (device, torch.device("cpu")):
        K.reset_launch_counts()
        params = {k: v.to(dev, copy=True) for k, v in init.items()}
        epoch = make_sync_epoch(cfg_v, inp["table"], inp["steps"], engine="fused",
                                device=dev)
        out.append((*epoch(params, c, x, inp["key"], 0), K.LAUNCHES["sample_negatives"]))
    (pg, lg, kg), (pc, lc, _) = out
    if kg != n_check:
        raise RuntimeError(f"expected {n_check} K1 launches, got {kg}")
    seeds = K.seed_tensor(prng.step_keys(inp["key"], n_check))
    engine = get_engine("fused")
    table = {k: v[None] for k, v in inp["table"].items()}
    mism = sum(int((engine.sample({k: v.to(device) for k, v in table.items()},
                                  seeds[i:i + 1].to(device), (batch, 5)).cpu()
                    != engine.sample(table, seeds[i:i + 1], (batch, 5))).sum())
               for i in range(n_check))
    err_t = max(float((pg[k].cpu() - pc[k]).abs().max()) for k in ("W", "C"))
    err_l = float((lg.cpu() - lc).abs().max())
    log(f"[sync] first {n_check} steps on the card vs the CPU: ids {mism} mismatches, "
        f"max |Δtable| {err_t:.3e} (tol {K2_TABLE_ATOL:g}), max |Δloss| {err_l:.3e} "
        f"(tol {K2_LOSS_ATOL:g}); step losses "
        + " ".join(f"{v:.7f}" for v in lg.tolist()))
    if mism or err_t > K2_TABLE_ATOL or err_l > K2_LOSS_ATOL:
        raise RuntimeError("the sync epoch on the card disagrees with the CPU's")
    if abs(float(lg[0]) - plateau) > 1e-5:
        raise RuntimeError(f"the first step's loss {float(lg[0])} is not (K+1)·log 2")

    # the process-group path: an NCCL group of one is no group, bitwise
    with _nccl_world_of_one("sync", device) as group, _collective_calls() as calls:
        params = {k: v.clone() for k, v in init.items()}
        pn, ln = make_sync_epoch(cfg_v, inp["table"], inp["steps"], group=group,
                                 engine="fused", device=device)(params, c, x, inp["key"], 0)
        torch.cuda.synchronize(device)
    same = torch.equal(pn["W"], pg["W"]) and torch.equal(pn["C"], pg["C"]) and \
        torch.equal(ln, lg)
    log(f"[sync] NCCL group of one, {n_check} steps: bitwise the run without a group: "
        f"{same}; collectives {len(calls)} ({sorted(set(calls))})")
    if not same or len(calls) != 3 * n_check:
        raise RuntimeError("the sync epoch in a group of one is not the run without one")
    del out, pg, pc, pn

    # 2. local SGD: 10 stacked workers, a mean every SYNC_EVERY steps
    n, every = NUM_WORKERS, SYNC_EVERY
    c3 = inp["centers"].reshape(-1, every, batch)
    x3 = inp["contexts"].reshape(-1, every, batch)
    total = inp["steps"]
    K.reset_launch_counts()
    t0 = time.perf_counter()
    got, losses = make_periodic_sync_epoch(cfg_v, inp["table"], total, sync_every=every,
                                           num_workers=n, engine="fused", device=device)(
        init, c3, x3, inp["key"], 0)
    torch.cuda.synchronize(device)
    periodic_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    log(f"[sync] periodic sync, {n} workers x {BATCH} pairs, a mean every {every} "
        f"steps: {total} steps in {periodic_s:.3f} s ({n * BATCH * total / periodic_s:.4e} "
        f"pairs/s); launches {launches}; mean loss per sync "
        + " ".join(f"{v:.7f}" for v in losses.mean(dim=1).tolist()))
    if launches["sgns_fused_step"] != total or launches["sample_negatives"]:
        raise RuntimeError(f"expected {total} K2 launches and no K1, got {launches}")
    moved = max(float((got[k] - init[k]).abs().max()) for k in ("W", "C"))
    if not torch.isfinite(losses).all() or not (math.isfinite(moved) and moved > 0.0):
        raise RuntimeError(f"periodic sync: losses {losses.mean(dim=1)}, the tables "
                           f"moved {moved} from their init")
    tab = {k: v.to(device).expand(n, -1).contiguous() for k, v in inp["table"].items()}
    seeds = K.seed_tensor(prng.step_keys(inp["key"], total), device)
    cen = torch.from_numpy(c3).to(device)
    ctx = torch.from_numpy(x3).to(device)
    errs = {}
    for label, step in (("K2", K.sgns_fused_step), ("plain", K.sgns_fused_step_plain)):
        stacked = {k: v.repeat(n, 1, 1) for k, v in init.items()}
        hand = torch.empty_like(losses)
        for o in range(total // every):
            for j in range(every):
                i = o * every + j
                _, loss, _ = step(stacked, cen[o, j].reshape(n, BATCH).contiguous(),
                                  ctx[o, j].reshape(n, BATCH).contiguous(), tab,
                                  seeds[i].expand(n, 2).contiguous(),
                                  float(linear_lr(i, total, cfg_v)), negatives=5)
                hand[o, j] = worker_mean(loss).mean()
            means = {k: t.mean(dim=0) for k, t in stacked.items()}
            for k, t in stacked.items():
                t.copy_(means[k].expand_as(t))
        torch.cuda.synchronize(device)
        errs[label] = (max(float((got[k] - means[k]).abs().max()) for k in ("W", "C")),
                       float((losses - hand).abs().max()))
        del stacked, means
    log(f"[sync] periodic sync vs a hand loop of {total // every} x ({every} K2 steps, "
        f"then the mean): max |Δtable| {errs['K2'][0]:.3e}, max |Δloss| "
        f"{errs['K2'][1]:.3e} (bitwise required); vs the same loop with K2's plain "
        f"version: {errs['plain'][0]:.3e} (tol {K2_TABLE_ATOL:g}), {errs['plain'][1]:.3e} "
        f"(tol {K2_LOSS_ATOL:g})")
    if errs["K2"] != (0.0, 0.0):
        raise RuntimeError("the periodic sync is not bitwise its hand loop")
    if errs["plain"][0] > K2_TABLE_ATOL or errs["plain"][1] > K2_LOSS_ATOL:
        raise RuntimeError("the periodic sync disagrees with K2's plain version")
    return {"launches": l1, "periodic_launches": launches, "steps": steps,
            "pairs_per_s": sync_pps, "async_pairs_per_s": async_pps,
            "train_s": [i1["train_s"], i2["train_s"]], "periodic_s": periodic_s}


def phase_merge(device, main: dict) -> dict:
    """The Merger registry and the reduction tree on the main path's
    sub-models: batch ≡ incremental and the tree's arrival independence,
    bitwise; the mesh Gram in an NCCL group of one; each merger's wall."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.core.merge import IncrementalAlirMerger, get_merger, sharded_gram
    from repro_torch.eval.benchmarks import evaluate_all
    from repro_torch.sharding.merge import mesh_sharded_gram

    _, suite = world()
    stacked = main["stacked"]
    n, V, d = stacked.models.shape
    walls, out = {}, {}

    def timed(label, fn):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(device)
        walls[label] = time.perf_counter() - t0
        return res

    for name in ("alir", "alir_tree", "average", "concat", "pca"):
        merger = get_merger(name, device=device)
        out[name] = timed(name, lambda: merger.merge(stacked))
        if name == "alir_tree":
            tree = merger
        if not torch.isfinite(out[name].emb).all():
            raise RuntimeError(f"{name}: non-finite merged table")
    log(f"[merge] {n} x ({V}, {d}) on the card, wall s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in walls.items())
        + f"; the tree's critical path {tree.critical_path_s():.3f} s over "
        f"{tree.stats['solved']} node solves ({tree.stats['passthrough']} passed through)")
    batch = out["alir"]
    if not torch.equal(batch.emb, main["alir_pca"]):
        raise RuntimeError('get_merger("alir") is not merge(..., "alir_pca") bitwise')

    def arrive(merger, order, fold: bool):
        for w in order:
            merger.add(int(w), stacked.models[w], stacked.mask[w], fold=fold)
        return merger.final()

    # batch ≡ incremental, two arrival orders (warm folds on each arrival in
    # the first), the final cold fold in canonical order
    for k, order in enumerate((np.random.default_rng(1).permutation(n),
                               np.random.default_rng(2).permutation(n))):
        final = timed(f"incremental_{k}",
                      lambda: arrive(IncrementalAlirMerger(device=device), order, k == 0))
        same = all(torch.equal(getattr(final, f), getattr(batch, f))
                   for f in ("emb", "valid", "transforms"))
        log(f"[merge] IncrementalAlirMerger, arrivals {order.tolist()} "
            f"({'a warm fold each' if k == 0 else 'no fold'}), then final(): bitwise "
            f"the batch merge: {same} ({walls[f'incremental_{k}']:.3f} s)")
        if not same or final.worker_ids != tuple(range(n)):
            raise RuntimeError("the incremental ALiR merge is not the batch merge")

    # the tree's root under a permuted arrival order
    order = np.random.default_rng(3).permutation(n)
    root = timed("alir_tree_arrivals",
                 lambda: arrive(get_merger("alir_tree", fan_in=2, device=device), order,
                                False))
    same = all(torch.equal(getattr(root, f), getattr(out["alir_tree"], f))
               for f in ("emb", "valid", "transforms"))
    log(f"[merge] alir_tree (fan_in 2), arrivals {order.tolist()}: root bitwise the "
        f"batch tree's: {same}")
    if not same:
        raise RuntimeError("the tree's root depends on the arrival order")
    union = stacked.mask.any(0)
    scores = {}
    for name in ("alir", "alir_tree"):
        if not torch.equal(out[name].valid, union):
            raise RuntimeError(f"{name}: valid rows are not the union presence mask")
        scores[name] = evaluate_all(out[name].emb.cpu().numpy(), out[name].valid.cpu().numpy(),
                                    main["vocab"], suite)
    log(f"[merge] quality: flat alir_pca sim rho={scores['alir']['similarity']:.3f} "
        f"analogy={scores['alir']['analogy']:.3f} purity="
        f"{scores['alir']['categorization']:.3f}; alir_tree sim rho="
        f"{scores['alir_tree']['similarity']:.3f} analogy={scores['alir_tree']['analogy']:.3f}"
        f" purity={scores['alir_tree']['categorization']:.3f}")

    # the mesh Gram: one all_gather in an NCCL group of one
    S = 4
    pad = (-V) % S
    A = F.pad(stacked.models[0], (0, 0, 0, pad))
    B = F.pad(batch.emb, (0, 0, 0, pad))
    with _nccl_world_of_one("merge", device) as group, _collective_calls() as calls:
        g = mesh_sharded_gram(A, B, group, num_shards=S)
        torch.cuda.synchronize(device)
    same = torch.equal(g, sharded_gram(A, B, S))
    log(f"[merge] mesh_sharded_gram, S = {S}, V padded {V} -> {V + pad}: bitwise "
        f"sharded_gram: {same}; collectives {calls}")
    if not same or calls != ["all_gather_into_tensor"]:
        raise RuntimeError("the mesh Gram is not sharded_gram with one all_gather")
    return {"walls": walls, "critical_path_s": tree.critical_path_s(), "scores": scores}


def _knocked_out(stacked, seed: int):
    """``stacked`` with ``SERVE_KNOCKOUT`` of the rows masked out of 1 to
    n − 1 random sub-models each (``benchmarks/bench_oov.py``'s knock-out:
    every row keeps a holder) and zeroed there, on the card."""
    import numpy as np
    import torch
    from repro_torch.core.merge import StackedModels

    n, V, _ = stacked.models.shape
    rng = np.random.default_rng(seed)
    mask = stacked.mask.cpu().numpy().copy()
    rows = rng.choice(V, size=int(SERVE_KNOCKOUT * V), replace=False)
    k = rng.integers(1, n, size=len(rows))                 # models that lose the row
    order = rng.permuted(np.tile(np.arange(n), (len(rows), 1)), axis=1)
    lose = np.arange(n)[None, :] < k[:, None]
    mask[order[lose], np.repeat(rows, k)] = False
    mask_t = torch.from_numpy(mask).to(stacked.models.device)
    return StackedModels(models=stacked.models * mask_t[..., None], mask=mask_t)


async def _serve_clients(server, batches) -> tuple[list, float]:
    """Each client sends its ``embed_ids`` calls one after the other; the
    clients run concurrently. Per-call latencies (s) and the wall."""
    lat: list = []

    async def client(calls):
        for ids in calls:
            t0 = time.perf_counter()
            out = await server.embed_ids(ids)
            lat.append(time.perf_counter() - t0)
            if not out["found"].all():
                raise RuntimeError("a served id was not found")

    t0 = time.perf_counter()
    await asyncio.gather(*(client(c) for c in batches))
    return lat, time.perf_counter() - t0


def _batch_device_share(prof, span: str, DeviceType) -> dict:
    """Over every host span named ``span`` (one dispatched batch each):
    the mean host window, the device's busy time inside it (the union of
    kernel and copy intervals) and its share, and device µs by kind."""
    events = list(prof.events())
    windows = [(e.time_range.start, e.time_range.end) for e in events if e.name == span]
    dev = [(e.time_range.start, e.time_range.end, e.name) for e in events
           if e.device_type == DeviceType.CUDA and "Command Buffer" not in e.name
           and not e.name.startswith("repro_torch.")]
    kinds = {"copy to the host": 0.0, "copy to the device": 0.0, "kernels": 0.0}
    total = busy = 0.0
    for t0, t1 in windows:
        total += t1 - t0
        inside = [(max(s, t0), min(f, t1), n) for s, f, n in dev if min(f, t1) > max(s, t0)]
        busy += _union_us([(s, f) for s, f, _ in inside], t0)
        for s, f, name in inside:
            kind = ("copy to the host" if "DtoH" in name else
                    "copy to the device" if "HtoD" in name else "kernels")
            kinds[kind] += f - s
    n = len(windows)
    return {"batches": n, "batch_us": total / n, "device_busy_us": busy / n,
            "device_share": busy / total, "device_us_by_kind": {k: v / n for k, v in kinds.items()}}


def phase_serve(device, main: dict) -> dict:
    """Publish → serve on the card from the main path's sub-models (a
    seeded knock-out gives each sub-model absent rows): v1 after 5 folds,
    v2 final; the served rows against the published tables and
    ``reconstruct_missing``; a pinned store and a hot reload; the TCP
    round trip; latency and lookups/s at ``ServeConfig()``'s defaults; the
    device's share of a batch; the publish and load walls."""
    import shutil

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.checkpoint import load_manifest
    from repro_torch.core.merge import get_merger, reconstruct_missing
    from repro_torch.serve import (ArtifactStore, EmbeddingServer, ServeConfig,
                                   publish_incremental, request_once, start_tcp_server)
    from repro_torch.serve.publish import submodel_arrivals

    gpu = nvidia_smi_line()
    vocab = main["vocab"]
    stacked = _knocked_out(main["stacked"], seed=0)
    n, V, d = stacked.models.shape
    absent = int((~stacked.mask).sum())
    art = ROOT / "build" / "chip_smoke_serve"
    shutil.rmtree(art, ignore_errors=True)
    walls = {}

    def timed(label, fn):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(device)
        walls[label] = time.perf_counter() - t0
        return out

    arrivals = list(submodel_arrivals(stacked))
    merger = get_merger("alir", device=device)
    v1, _ = timed("publish_v1", lambda: publish_incremental(
        arrivals[:5], str(art), word_ids=vocab.word_ids, publish_every=5,
        include_models=True, merger=merger, final_cold_fold=False))
    server = timed("load_v1", lambda: EmbeddingServer(str(art), ServeConfig(), device=device))
    pinned = ArtifactStore(str(art), version=1, device=device)
    asyncio.run(server.embed_rows(np.arange(1000)))
    cached = len(server.cache)
    v2, final = timed("publish_v2", lambda: publish_incremental(
        arrivals[5:], str(art), word_ids=vocab.word_ids, publish_every=5,
        include_models=True, merger=merger))
    swapped = timed("refresh_v2", server.refresh)
    sizes = {e["file"]: (art / e["file"]).stat().st_size
             for e in load_manifest(str(art))["versions"]}
    log(f"[serve] {n} x ({V}, {d}) sub-models, {SERVE_KNOCKOUT:.0%} of the rows knocked "
        f"out of 1..{n - 1} of them ({absent} absent (worker, row) pairs); published "
        f"v{v1} after 5 folds in {walls['publish_v1']:.3f} s, v{v2} (final, cold) in "
        f"{walls['publish_v2']:.3f} s; files {sizes} ({sum(sizes.values()) / 1e9:.3f} GB); "
        f"store load v1 {walls['load_v1']:.3f} s, refresh to v2 {walls['refresh_v2']:.3f} s "
        f"({gpu})")
    if (v1, v2) != ([1], [2]):
        raise RuntimeError(f"expected versions [1] and [2], got {v1} and {v2}")
    if not (swapped and server.store.version == 2 and cached and not len(server.cache)):
        raise RuntimeError("the tracking store did not swap to v2 and clear its cache")
    if pinned.refresh() or pinned.version != 1:
        raise RuntimeError("the store pinned at v1 moved")
    t = server.store.table
    if not all(x.device == device for x in (t.emb, t.valid, t.mask, t.transforms, t.models)):
        raise RuntimeError("the served table is not on the card")

    # merged space: bitwise the final fold's Y at every valid row asked,
    # unknown raw ids (never in the vocabulary) not found
    rng = np.random.default_rng(1)
    rows = rng.choice(V, size=min(8192, V), replace=False)
    unknown = np.setdiff1d(np.arange(VOCAB), vocab.word_ids)[:64]
    ids = np.concatenate([vocab.word_ids[rows], unknown, [-5]])
    out = asyncio.run(server.embed_ids(ids))
    Y = final.Y.cpu().numpy()
    found = out["found"]
    if not found[:len(rows)].all() or found[len(rows):].any():
        raise RuntimeError("found flags disagree with the vocabulary and valid rows")
    if not np.array_equal(out["vectors"][:len(rows)], Y[rows]):
        raise RuntimeError("served merged rows are not the published table's bits")
    # sub-model spaces: present rows bitwise the sub-model, absent rows
    # within SERVE_REC_ATOL of reconstruct_missing on the card
    rec = reconstruct_missing(stacked, final.Y)
    mask = stacked.mask.cpu().numpy()
    rec_err, n_absent = 0.0, 0
    for w in range(n):
        got = asyncio.run(server.embed_rows(rows, submodel=w))["vectors"]
        present = mask[w, rows]
        if not np.array_equal(got[present], stacked.models[w, rows].cpu().numpy()[present]):
            raise RuntimeError(f"worker {w}'s present rows are not its sub-model's bits")
        rec_err = max(rec_err, float(np.abs(got - rec[w, rows].cpu().numpy()).max()))
        n_absent += int((~present).sum())
    del rec
    log(f"[serve] {len(rows)} rows asked: merged bitwise final Y; {len(unknown) + 1} unknown "
        f"ids not found; in the {n} sub-model spaces the present rows bitwise, {n_absent} "
        f"absent rows reconstructed: max |served - reconstruct_missing| {rec_err:.3e} "
        f"(tol {SERVE_REC_ATOL:g}); pinned store at v1, tracking store v1 -> v2, cache "
        f"{cached} -> 0 rows")
    if rec_err > SERVE_REC_ATOL:
        raise RuntimeError("served reconstructions disagree with reconstruct_missing")

    # the JSON-lines front end on an ephemeral port
    async def tcp():
        srv = await start_tcp_server(server)
        port = srv.sockets[0].getsockname()[1]
        try:
            r = await request_once("127.0.0.1", port, {"ids": [int(ids[0]), int(unknown[0])]})
            s = await request_once("127.0.0.1", port, {"op": "stats"})
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(b"{not json\n")
            await writer.drain()
            bad = json.loads(await reader.readline())
            writer.close()
            again = await request_once("127.0.0.1", port, {"op": "refresh"})
            return r, s, bad, again
        finally:
            srv.close()
            await srv.wait_closed()

    r, s, bad, again = asyncio.run(tcp())
    ok = (r["version"] == 2 and r["found"] == [True, False]
          and np.array_equal(np.asarray(r["vectors"][0], np.float32), Y[rows[0]])
          and s["stats"]["requests"] > 0 and "error" in bad
          and again == {"refreshed": False, "version": 2})
    log(f"[serve] TCP: ids -> version {r['version']} found {r['found']}; stats requests "
        f"{s['stats']['requests']}; malformed line -> {bad}; refresh -> {again}")
    if not ok:
        raise RuntimeError("the TCP round trip answered wrongly")

    # latency and lookups/s at ServeConfig()'s defaults: concurrent clients,
    # each a series of embed_ids calls of SERVE_IDS raw ids over Zipf(1) rows
    bench = EmbeddingServer(server.store, ServeConfig())
    p = 1.0 / np.arange(1, V + 1)
    zrows = np.random.default_rng(2).choice(V, p=p / p.sum(),
                                            size=(2, SERVE_CLIENTS, SERVE_CALLS, SERVE_IDS))
    keys_seen: list = []
    real_dispatch = bench.batcher._dispatch

    def recording(keys):
        keys_seen.append(list(keys))
        return real_dispatch(keys)

    bench.batcher._dispatch = recording
    asyncio.run(_serve_clients(bench, vocab.word_ids[zrows[0]]))          # warm-up
    warm = bench.stats()
    bench.batcher._latencies_s.clear()
    bench.batcher._batch_sizes.clear()
    keys_seen.clear()
    d0, h0, m0 = bench.batcher.dispatches, bench.cache.hits, bench.cache.misses
    lat, wall = asyncio.run(_serve_clients(bench, vocab.word_ids[zrows[1]]))
    st = bench.stats()
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    lookups = SERVE_CLIENTS * SERVE_CALLS * SERVE_IDS
    hits = bench.cache.hits - h0
    serving = {
        "calls": len(lat), "ids_per_call": SERVE_IDS, "clients": SERVE_CLIENTS,
        "wall_s": wall, "lookups_per_s": lookups / wall,
        "call_p50_ms": float(np.percentile(lat_ms, 50)),
        "call_p99_ms": float(np.percentile(lat_ms, 99)),
        "key_p50_ms": st["p50_ms"], "key_p99_ms": st["p99_ms"],
        "dispatches": bench.batcher.dispatches - d0, "mean_batch": st["mean_batch"],
        "cache_hit_rate": hits / (hits + bench.cache.misses - m0),
        "warmup_cache_hit_rate": warm["cache_hit_rate"]}
    log(f"[serve] ServeConfig() defaults, {SERVE_CLIENTS} concurrent clients x "
        f"{SERVE_CALLS} embed_ids calls of {SERVE_IDS} raw ids (Zipf(1) over rows), after "
        f"a warm-up round: {lookups} lookups in {wall:.4f} s = {serving['lookups_per_s']:.1f} "
        f"lookups/s; per call p50 {serving['call_p50_ms']:.4f} ms, p99 "
        f"{serving['call_p99_ms']:.4f} ms; per key p50 {st['p50_ms']:.4f} ms, p99 "
        f"{st['p99_ms']:.4f} ms; {serving['dispatches']} dispatches, mean batch "
        f"{st['mean_batch']:.2f}, cache hit rate {serving['cache_hit_rate']:.4f} ({gpu})")

    # the device's share of a batch: the measured round's batches replayed
    # through the gather under the profiler
    replay = keys_seen[:200]
    for keys in replay[:5]:
        bench._gather(keys)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for keys in replay:
            with record_function("repro_torch.serve_batch"):
                bench._gather(keys)
        torch.cuda.synchronize(device)
    share = _batch_device_share(prof, "repro_torch.serve_batch", DeviceType)
    log(f"[serve] a dispatched batch (mean {np.mean([len(k) for k in replay]):.1f} keys, "
        f"{share['batches']} replayed under the profiler): host window "
        f"{share['batch_us']:.1f} us, device busy {share['device_busy_us']:.1f} us "
        f"(share {share['device_share']:.4f}); device us by kind "
        + ", ".join(f"{k} {v:.2f}" for k, v in share["device_us_by_kind"].items())
        + f" ({gpu})")
    del server, pinned, bench, stacked, arrivals, merger, final
    shutil.rmtree(art, ignore_errors=True)
    return {"walls": walls, "bytes": sizes, "rec_err": rec_err, "serving": serving,
            "batch": share}


def _run_cli(main_fn, argv: list):
    """A CLI's ``main`` in this process: its standard output (captured and
    logged) and what it returned."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main_fn(argv)
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"[cli]   | {line}")
    return text, result


def _expect(text: str, wanted, label: str) -> None:
    missing = [w for w in wanted if w not in text]
    if missing:
        raise RuntimeError(f"{label}: output lacks {missing}")


def phase_cli(device) -> dict:
    """The port's CLIs and examples on the card: ``train_sgns`` (``fused``,
    10 × 500, ``--publish`` and ``--save``) with its K2 launches counted,
    ``serve`` on what it published (merged space, a sub-model space pinned
    at v1, an unknown id), and the three examples as ``python -m``
    processes."""
    import os
    import shutil

    import numpy as np
    import torch
    from repro_torch.checkpoint import load_checkpoint, load_table
    from repro_torch.kernels import sgns_fused
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train_sgns

    out = ROOT / "build" / "chip_smoke_cli"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    art, ckpt = out / "artifact", out / "merged.npz"
    argv = ["--engine", "fused", "--workers", str(NUM_WORKERS), "--dim", str(DIM),
            "--batch", str(BATCH), "--vocab", str(VOCAB), "--epochs", "1",
            "--merge", "alir_pca", "--sentences", str(CLI_SENTENCES),
            "--publish", str(art), "--publish-every", "5", "--save", str(ckpt),
            "--device", str(device)]
    log(f"[cli] python -m repro_torch.launch.train_sgns {' '.join(argv)}")
    sgns_fused.reset_launch_counts()
    t0 = time.perf_counter()
    text, res = _run_cli(train_sgns.main, argv)
    wall = time.perf_counter() - t0
    launches = dict(sgns_fused.LAUNCHES)
    steps = res.timings["steps_per_epoch"]
    _expect(text, ("engine=fused:alias", "alir_pca   sim=",
                   "published 2 incremental table version(s)",
                   f"saved merged embedding → {ckpt}"), "train_sgns")
    log(f"[cli] train_sgns: {wall:.3f} s wall; {steps} steps a worker, train "
        f"{res.timings['train_s']:.4f} s ({NUM_WORKERS * BATCH * steps / res.timings['train_s']:.1f}"
        f" pairs/s), chunk wait {res.timings['chunk_wait_s']:.4f} s, merge alir_pca "
        f"{res.timings['merge_alir_pca_s']:.4f} s; launches {launches} ({nvidia_smi_line()})")
    if launches["sgns_fused_step"] != steps or launches["sample_negatives"]:
        raise RuntimeError(f"expected {steps} K2 launches and no K1, got {launches}")
    saved, meta = load_checkpoint(str(ckpt))
    V = res.union_vocab.size
    if (saved["embedding"].shape != (V, DIM) or not np.isfinite(saved["embedding"]).all()
            or meta.get("method") != "alir_pca"):
        raise RuntimeError(f"bad saved embedding {saved['embedding'].shape} {meta}")
    final = load_table(str(art))
    if final.version != 2 or final.models.shape != (NUM_WORKERS, V, DIM):
        raise RuntimeError("the published artifact is not v2 with every sub-model")
    del res
    torch.cuda.empty_cache()

    known = [int(x) for x in final.word_ids[:3]]
    oov = int(np.setdiff1d(np.arange(VOCAB), final.word_ids)[0])
    q = ",".join(str(x) for x in known + [oov])
    t0 = time.perf_counter()
    merged, _ = _run_cli(serve_cli.main, ["--artifact", str(art), "--query", q,
                                       "--device", str(device)])
    serve_s = time.perf_counter() - t0
    _expect(merged, ("artifact v2  space=merged", f"id {oov:>8d} [OOV]", "stats:"), "serve")
    if merged.count("[ok ]") != len(known):
        raise RuntimeError("serve: a known id was not found")
    sub, _ = _run_cli(serve_cli.main, ["--artifact", str(art), "--query", q, "--submodel", "0",
                                    "--version", "1", "--device", str(device)])
    _expect(sub, ("artifact v1  space=submodel 0", "[OOV]", "stats:"), "serve --submodel")
    log(f"[cli] serve: merged query {serve_s:.3f} s wall (load included)")

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    walls = {}
    for name, extra, wanted in EXAMPLES:
        cmd = [sys.executable, "-m", f"repro_torch.examples.{name}", *extra]
        if name == "train_w2v_100m":
            cmd += ["--save", str(out / "w2v_100m.npz")]
        log(f"[cli] {' '.join(cmd[1:])}")
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=str(ROOT),
                              timeout=600)
        walls[name] = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            log(f"[cli]   | {line}")
        if proc.returncode:
            log(proc.stderr[-4000:])
            raise RuntimeError(f"{name} exited {proc.returncode}")
        _expect(proc.stdout, wanted, name)
        log(f"[cli] {name}: exit 0 in {walls[name]:.3f} s")
    shutil.rmtree(out, ignore_errors=True)
    return {"train_wall_s": wall, "steps": steps, "launches": launches,
            "serve_s": serve_s, "example_walls": walls}


# ---------------------------------------------------------------------------
# The LM training path (smollm-360m at full width) and the example that
# feeds it the paper's embeddings.
# ---------------------------------------------------------------------------
def _lm_grads(cfg, init, toks, device):
    """One forward and backward of ``cfg`` from ``init`` (the reference's
    tree) on ``toks``: (loss, {path: gradient} in the reference's layout)."""
    import torch
    from repro_torch import convert
    from repro_torch.tree import tree_paths

    model = convert.from_jax_model_params(cfg, init, device=device)
    model.requires_grad_(True)
    t = torch.from_numpy(toks).to(device)
    names, params = zip(*model.named_parameters())
    loss = model.loss_fn({"tokens": t, "labels": t})
    grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), tree_paths(convert.to_jax_opt_state(
        model.param_tree(dict(zip(names, grads)))))


def _lm_divergence(cfg, init, toks, device) -> str:
    """Run one forward and backward twice from ``init`` and name the first
    module whose output, or else the first gradient, differs between the
    two: the op on the path that is not deterministic on the card."""
    import torch
    from repro_torch import convert

    runs = []
    for _ in range(2):
        model = convert.from_jax_model_params(cfg, init, device=device)
        outs = []
        for name, mod in model.named_modules():
            mod.register_forward_hook(
                lambda m, a, o, name=name: outs.append((name, o.detach().clone()))
                if isinstance(o, torch.Tensor) else None)
        model.requires_grad_(True)
        t = torch.from_numpy(toks).to(device)
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(model.loss_fn({"tokens": t, "labels": t}), params)
        runs.append((outs, list(zip(names, grads))))
    for (name, a), (_, b) in zip(runs[0][0], runs[1][0]):
        if not torch.equal(a, b):
            return f"the output of {name}"
    for (name, a), (_, b) in zip(runs[0][1], runs[1][1]):
        if not torch.equal(a, b):
            return f"the gradient of {name}"
    return "none found in one step (the difference builds over steps)"


def phase_lm_train(device) -> dict:
    """The LM training path at full width through ``launch.train.train``
    (see the module doc, phase 17)."""
    import shutil

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch import convert, prng
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.examples import async_embeddings_for_llm as example
    from repro_torch.kernels import sgns_fused
    from repro_torch.launch.train import synthetic_lm_batches, train
    from repro_torch.models import Model
    from repro_torch.optim import get_optimizer
    from repro_torch.tree import tree_paths

    arch, steps, B, S = LM_TRAIN["arch"], LM_TRAIN["steps"], LM_TRAIN["batch"], LM_TRAIN["seq"]
    cfg = get_config(arch)
    out = ROOT / "build" / "chip_smoke_lm"
    shutil.rmtree(out, ignore_errors=True)
    kw = dict(reduced=False, steps=steps, batch=B, seq=S, lr=LM_TRAIN["lr"],
              ckpt_every=LM_TRAIN["ckpt_every"], device=device)

    # 1. the launcher, its checkpoints, no kernel, the loss falls
    log(f"[lm_train] train({arch!r}, reduced=False, steps={steps}, batch={B}, seq={S}, "
        f"lr={LM_TRAIN['lr']}, ckpt_every={LM_TRAIN['ckpt_every']}) on {device}")
    sgns_fused.reset_launch_counts()
    t0 = time.perf_counter()
    model, losses, opt_state = train(arch, ckpt_dir=str(out), **kw)
    wall = time.perf_counter() - t0
    launches = dict(sgns_fused.LAUNCHES)
    log(f"[lm_train] losses {losses}; wall {wall:.1f} s (init, {steps} steps, "
        f"{steps // LM_TRAIN['ckpt_every'] + 1} checkpoint writes); launches {launches}")
    if any(launches.values()):
        raise RuntimeError(f"the LM training path launched a kernel: {launches}")
    first, last = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
    if len(losses) != steps or not np.isfinite(losses).all() or not last < first:
        raise RuntimeError(f"the loss did not fall: first 4 {first}, last 4 {last}")
    path = out / f"step_{steps}.npz"
    t0 = time.perf_counter()
    tree, meta = load_checkpoint(str(path))
    load_s = time.perf_counter() - t0
    saved = tree_paths(tree)
    live = tree_paths({"params": convert.to_jax_model_params(model),
                       "opt": convert.to_jax_opt_state(opt_state)})
    same = set(saved) == set(live) and all(
        saved[k].dtype == live[k].dtype and np.array_equal(saved[k], live[k]) for k in live)
    ckpt_bytes = path.stat().st_size
    log(f"[lm_train] step-{steps} checkpoint: {len(live)} arrays, {ckpt_bytes / 1e9:.3f} GB, "
        f"loaded in {load_s:.2f} s, bitwise the live parameters and AdamW state: {same}")
    if not same or meta.get("step") != steps:
        raise RuntimeError(f"the step-{steps} checkpoint is not the live state ({meta})")
    del model, opt_state, tree, saved, live
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()

    # 2. the same run again from the same seed: the same losses
    torch.cuda.reset_peak_memory_stats(device)
    held = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    model, again, opt_state = train(arch, ckpt_dir=None, **kw)
    wall2 = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) - held
    culprit = None
    if again != losses:
        toks = next(synthetic_lm_batches(cfg.vocab_size, B, S, 1))
        init = convert.to_jax_model_params(Model(cfg, prng.PRNGKey(0), device=device))
        culprit = _lm_divergence(cfg, init, toks, device)
        log(f"[lm_train] the repeat differs: {again}; not deterministic on the card: "
            f"{culprit}; held at rtol {LM_REPEAT_RTOL}")
        np.testing.assert_allclose(again, losses, rtol=LM_REPEAT_RTOL)
    log(f"[lm_train] repeat from the same seed: losses bitwise {again == losses}; wall "
        f"{wall2:.1f} s; peak device memory {peak / 2**30:.2f} GiB above the "
        f"{held / 2**30:.2f} GiB held before")

    # 3. the loop timed, then profiled
    step_fn = model.make_train_step(get_optimizer(cfg.train_optimizer, lr=LM_TRAIN["lr"]))
    batches = [torch.from_numpy(t).to(device) for t in
               synthetic_lm_batches(cfg.vocab_size, B, S, LM_TIMED_STEPS + LM_PROFILED_STEPS)]

    def run_steps(toks, step0):
        nonlocal opt_state
        for i, t in enumerate(toks):
            opt_state, loss = step_fn(opt_state, {"tokens": t, "labels": t}, step0 + i)
            float(loss)                  # the launcher reads every loss
        torch.cuda.synchronize(device)

    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    run_steps(batches[:LM_TIMED_STEPS], steps)
    s_step = (time.perf_counter() - t0) / LM_TIMED_STEPS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("repro_torch.lm_train_loop"):
            run_steps(batches[LM_TIMED_STEPS:], steps + LM_TIMED_STEPS)
    summary = _device_summary(prof, "repro_torch.lm_train_loop", LM_PROFILED_STEPS,
                              PROFILE_GROUPS["lm_train"], DeviceType)
    _write_profile("lm_train", prof, summary, trace=False)
    n_params = sum(p.numel() for p in model.parameters())
    layer_params = n_params - model.embed.numel() - model.final_norm.scale.numel()
    T, L = B * S, cfg.num_layers
    attn_fwd = 4 * B * S * S * cfg.num_heads * cfg.resolved_head_dim * L
    model_flops = 6 * n_params * T + 3 * attn_fwd
    executed = model_flops + 2 * layer_params * T + attn_fwd      # remat's second forward
    mfu = model_flops / s_step / PEAK_FP32_FLOP_PER_S
    log(f"[lm_train] {n_params} parameters; {s_step:.4f} s a step, {T / s_step:.1f} tokens/s; "
        f"model FLOPs a step {model_flops / 1e12:.3f} T (6·N·tokens + attention), "
        f"{executed / 1e12:.3f} T with remat's second forward; "
        f"{mfu:.4f} of the float32 peak ({executed / s_step / PEAK_FP32_FLOP_PER_S:.4f} "
        f"counting remat) ({nvidia_smi_line()})")
    log(f"[lm_train] profile of {LM_PROFILED_STEPS} steps: loop "
        f"{summary['window_us'] / 1e3:.1f} ms, device busy "
        f"{summary['device_busy_us'] / 1e3:.1f} ms, idle share {summary['idle_share']:.4f}")
    for g, v in summary["device_us_per_step"].items():
        log(f"[lm_train]   {g}: {v / 1e3:.2f} ms/step")
    for k in summary["kernels"][:8]:
        log(f"[lm_train]     {k['device_us'] / LM_PROFILED_STEPS / 1e3:8.2f} ms/step  "
            f"x{k['count']:<6d} {k['name'][:90]}")
    del model, opt_state, step_fn, batches, prof
    torch.cuda.empty_cache()

    # 4. the card against the CPU at full width, one step's loss and gradients
    init = convert.to_jax_model_params(Model(cfg, prng.PRNGKey(0), device=device))
    toks = next(synthetic_lm_batches(cfg.vocab_size, LM_CHECK_BATCH, LM_CHECK_SEQ, 1))
    t0 = time.perf_counter()
    card, cpu = _lm_grads(cfg, init, toks, device), _lm_grads(cfg, init, toks, "cpu")
    loss_rel = abs(card[0] - cpu[0]) / abs(cpu[0])
    grad_rel = max(float(np.abs(card[1][k] - g).max() / np.abs(g).max())
                   for k, g in cpu[1].items())
    log(f"[lm_train] card vs CPU at {LM_CHECK_BATCH} x {LM_CHECK_SEQ}: loss {card[0]!r} vs "
        f"{cpu[0]!r} (rel {loss_rel:.3e}); the largest gradient difference "
        f"{grad_rel:.3e} of its tensor's largest |g| ({time.perf_counter() - t0:.1f} s)")
    if loss_rel > LM_LOSS_RTOL or grad_rel > CHUNK_REL:
        raise RuntimeError("the card's full-width step is not the CPU's")
    del init, card, cpu
    torch.cuda.empty_cache()

    # 5. the example: SGNS sub-models → ALiR → published → served → the LM
    sgns_fused.reset_launch_counts()
    t0 = time.perf_counter()
    text, res = _run_cli(example.main, ["--device", str(device)])
    example_s = time.perf_counter() - t0
    ex_launches = dict(sgns_fused.LAUNCHES)
    _expect(text, LM_EXAMPLE_LINES, "async_embeddings_for_llm")
    pretrain_steps = res["timings"]["steps_per_epoch"] * example.PRETRAIN_EPOCHS
    log(f"[lm_train] async_embeddings_for_llm: {example_s:.1f} s; {pretrain_steps} "
        f"pretraining steps; launches {ex_launches}")
    others = {k: n for k, n in ex_launches.items() if k != "sgns_fused_step" and n}
    if ex_launches["sgns_fused_step"] != pretrain_steps or others:
        raise RuntimeError(f"expected {pretrain_steps} K2 launches and no other kernel, "
                           f"got {ex_launches}")
    for name in ("loss_random", "loss_pretrained"):
        ls = res[name]
        if not (np.isfinite(ls).all() and np.mean(ls[-10:]) < np.mean(ls[:10])):
            raise RuntimeError(f"the example's {name} did not fall")
    return {"losses": losses, "s_step": s_step, "tokens_per_s": T / s_step,
            "peak_bytes": peak, "model_flops": model_flops, "mfu": mfu,
            "idle_share": summary["idle_share"], "repeat_bitwise": culprit is None,
            "culprit": culprit, "ckpt_bytes": ckpt_bytes, "loss_rel": loss_rel,
            "grad_rel": grad_rel, "example_launches": ex_launches}


# ---------------------------------------------------------------------------
# The LLM sharding layer: the smoke mesh on the card, the cost model against
# the profiler and the allocator, the dry run on simulated meshes.
# ---------------------------------------------------------------------------
def _op_group(name: str) -> str:
    name = name.split("::")[-1]
    return next((g for g, names in SHARD_OP_GROUPS if name in names), "elementwise and other")


def _leaf_matmul_flops(prof) -> float:
    """The profiler's flops of the matmul-class events that ran a kernel on
    the device and have no matmul-class event below them. DTensor's own
    call of an op and the local op it dispatches are two events (the local
    one is the work); and an op that remat's recompute stops before it
    runs (torch's checkpoint ends its recompute at the last saved tensor)
    is an event with flops but no kernel."""
    def has_mm_child(e):
        return any(c.name in SHARD_MATMULS or has_mm_child(c) for c in e.cpu_children)

    def device_us(e):
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)

    return float(sum(e.flops or 0 for e in prof.events()
                     if e.name in SHARD_MATMULS and device_us(e) > 0 and not has_mm_child(e)))


def _start_dryruns(out: Path) -> list:
    """``python -m repro_torch.launch.dryrun`` on each of SHARD_DRYRUNS, each
    a process of its own (its fake group), all started at once: they trace
    on the host while the card trains."""
    import os

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2"}
    procs = []
    for arch, shape, multi_pod in SHARD_DRYRUNS:
        tag = f"{arch}_{shape}{'_multipod' if multi_pod else ''}"
        js, log_path = out / f"{tag}.json", out / f"{tag}.log"
        js.unlink(missing_ok=True)
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                "--shape", shape, "--json", str(js)] + (["--multi-pod"] if multi_pod else [])
        if f"{arch}_{shape}" in SHARD_TORCH213 and not multi_pod:
            argv += ["--allocations", str(SHARD_ALLOC_GB)]
        f = open(log_path, "w")
        procs.append((tag, js, log_path, f, time.perf_counter(),
                      subprocess.Popen(argv, stdout=f, stderr=subprocess.STDOUT, env=env,
                                       cwd=str(ROOT))))
    return procs


def _start_rank_rules(out: Path) -> list:
    """``python -m repro_torch.launch.dryrun --rank-rule`` on each arch of
    ``RANK_RULE_ARCHS`` (reduced, a fake group of 16), each a process of its
    own beside the dry runs: the CPU test of the rule, on this host's
    torch."""
    import os
    from repro_torch.launch.dryrun import RANK_RULE_ARCHS

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    procs = []
    for arch in RANK_RULE_ARCHS:
        log_path = out / f"rank_rule_{arch}.log"
        f = open(log_path, "w")
        procs.append((arch, log_path, f, time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--rank-rule", arch],
            stdout=f, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT))))
    return procs


def _end_procs(procs, kill: bool) -> dict:
    """Waits on each process of ``procs`` (each tuple ends with its log
    file, its start and its ``Popen``) until ``SHARD_DRYRUN_TIMEOUT_S``
    after its start, or at once kills it where ``kill``; one past its time
    is killed. Closes the logs. Returns ``{Popen: (exit code or "timeout",
    seconds from its start to its end as waited)}``."""
    rcs = {}
    for *_, f, t0, p in procs:
        try:
            if kill:
                p.kill()
            left = SHARD_DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)
            rc = p.wait(timeout=max(1.0, left))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rc = "timeout"
        rcs[p] = (rc, time.perf_counter() - t0)
        f.close()
    return rcs


def _finish_rank_rules(procs, rcs: dict) -> dict:
    """Each arch's cases, from the ended processes (:func:`_end_procs`);
    raises where one misses the rule (the command's exit code) or made no
    line."""
    got = {}
    for arch, log_path, f, t0, p in procs:
        rc = rcs[p][0]
        lines = [ln for ln in log_path.read_text().splitlines() if ln.startswith("{")]
        if not lines:
            raise RuntimeError(f"the rank rule of {arch} printed nothing (exit {rc})")
        got[arch] = json.loads(lines[-1])
        for kind, c in got[arch].items():
            over = 16 * c["per_rank"] / c["unsharded"] - 1
            log(f"[sharding] rank rule, reduced {arch} {kind} on 4 x 4: a rank "
                f"{c['per_rank']:.6e} matmul flops x 16 = {16 * c['per_rank']:.6e} vs "
                f"{c['unsharded']:.6e} without a mesh (rel {over:+.6e}; allowed above it: 3 x "
                f"{c['excused']:.6e} excused = {3 * c['excused'] / c['unsharded']:.6e} of it); "
                f"replicated where no rule: {c['fallbacks'] or 'none'}")
        if rc != 0:
            raise RuntimeError(f"reduced {arch} misses the rank rule (exit {rc})")
    return got


def _finish_dryruns(procs, rcs: dict) -> dict:
    """Each dry run's row, from the ended processes (:func:`_end_procs`);
    raises where one failed or made no roofline row."""
    rows = {}
    for tag, js, log_path, f, t0, p in procs:
        rc, wall = rcs[p]
        text = log_path.read_text()
        log(f"[sharding] dry run {tag}: exit {rc}, {wall:.1f} s; its output:")
        for line in text.splitlines():
            if not line.startswith("[rank0]:W"):
                log(f"[sharding]   | {line}")
        if rc != 0:
            raise RuntimeError(f"the dry run {tag} failed (exit {rc})")
        row = json.loads(js.read_text())[0]
        if "compute_s" not in row:
            raise RuntimeError(f"the dry run {tag} made no roofline row: {row}")
        rows[tag] = {**row, "wall_s": wall}
    return rows


def _whole_blocks(dryruns: dict) -> dict:
    """For llama3-8b's and deepseek-v2-lite-16b's ``train_4k`` rows: the
    listed outputs (``--allocations``) that are the whole ``(Vp, d)``
    embedding table, or an activation ``(..., d)`` of at least the whole
    ``(G, E, C, d)`` MoE buffer's elements or with its ``E·C + Nk`` rows."""
    from repro_torch.configs import SHAPES, get_config

    out = {}
    for tag in ("llama3-8b_train_4k", "deepseek-v2-lite-16b_train_4k"):
        row = dryruns[tag]
        cfg = get_config(tag.rsplit("_train_4k", 1)[0])
        d, shape = cfg.d_model, SHAPES["train_4k"]
        bad = [a for a in row["allocations"] if a[1] == [cfg.padded_vocab, d]]
        if cfg.moe is not None:
            m = cfg.moe
            G = row["chips"] // 16                     # a group a batch shard
            ng = shape.global_batch // row["microbatches"] * shape.seq_len // G
            C = max(1, round(m.capacity_factor * ng * m.top_k / m.num_experts))
            whole, rows = G * m.num_experts * C * d, m.num_experts * C + ng * m.top_k
            bad += [a for a in row["allocations"] if len(a[1]) >= 3 and a[1][-1] == d
                    and (math.prod(a[1]) >= whole or rows in a[1])]
        out[tag] = bad
    return out


def phase_sharding(device) -> dict:
    """The LLM sharding layer (see the module doc, phase 19)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import sgns_fused
    from repro_torch.launch import op_cost
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.train import synthetic_lm_batches, train
    from repro_torch.optim import get_optimizer
    from repro_torch.sharding import ctx as shctx
    from repro_torch.sharding.rules import tree_data_specs, with_sharding

    out = ROOT / "build" / "chip_smoke_sharding"
    out.mkdir(parents=True, exist_ok=True)
    log(f"[sharding] torch {torch.__version__} (the dry runs and the rank rule trace on it)")
    procs = _start_dryruns(out)
    rule_procs = _start_rank_rules(out)
    try:
        arch, steps, B, S = (SHARD_TRAIN[k] for k in ("arch", "steps", "batch", "seq"))
        kw = dict(reduced=False, steps=steps, batch=B, seq=S, lr=SHARD_TRAIN["lr"],
                  ckpt_dir=None, ckpt_every=10 ** 9, device=device)
        gpu = nvidia_smi_line()

        # 1. the smoke mesh: the same run with and without it
        sgns_fused.reset_launch_counts()
        t0 = time.perf_counter()
        model, plain, opt_state = train(arch, **kw)
        plain_s = time.perf_counter() - t0
        del model, opt_state
        torch.cuda.empty_cache()
        mesh = make_smoke_mesh(device)
        t0 = time.perf_counter()
        model, sharded, opt_state = train(arch, mesh=mesh, **kw)
        mesh_s = time.perf_counter() - t0
        bitwise = sharded == plain
        log(f"[sharding] {arch} at full width, {steps} steps of {B} x {S} tokens: without a "
            f"mesh {plain} ({plain_s:.1f} s); on the 1 x 1 smoke mesh (DTensor parameters "
            f"and AdamW state, NCCL group of one) {sharded} ({mesh_s:.1f} s); bitwise {bitwise}")
        if not bitwise:
            np.testing.assert_allclose(sharded, plain, rtol=LM_LOSS_RTOL)
        placements = {str(p.placements) for p in model.parameters()}
        log(f"[sharding] parameter placements on the smoke mesh: {sorted(placements)}")

        # 2. one step against the profiler, the allocator and the roofline
        cfg = model.cfg
        step_fn = model.make_train_step(get_optimizer(cfg.train_optimizer,
                                                      lr=SHARD_TRAIN["lr"]))
        batches = []
        for t in synthetic_lm_batches(cfg.vocab_size, B, S, 4):
            b = {"tokens": torch.from_numpy(t).to(device)}
            b["labels"] = b["tokens"]
            batches.append(with_sharding(b, tree_data_specs(b, mesh), mesh))

        def one_step(i, mode=None):
            nonlocal opt_state
            with shctx.use_mesh_constraints(mesh, mode=mode):
                opt_state, loss = step_fn(opt_state, batches[i], steps + i)
            float(loss.full_tensor())
            torch.cuda.synchronize(device)

        one_step(0)                                          # warm
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated(device)           # the inputs, and what else lives
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        one_step(1)
        s_step = time.perf_counter() - t0
        peak_alloc = torch.cuda.max_memory_allocated(device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     with_flops=True) as prof:
            one_step(2)
        prof_mm = _leaf_matmul_flops(prof)
        dev_by_group: dict = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if us:
                g = _op_group(e.key)
                dev_by_group[g] = dev_by_group.get(g, 0.0) + us
        mode = op_cost.CostMode()
        mode.track([p for p in model.parameters()])
        mode.track([opt_state, batches[3]])
        inputs = mode.cost.peak_bytes
        t0 = time.perf_counter()
        one_step(3, mode)
        counted_s = time.perf_counter() - t0
        cost = mode.cost
        r = rl.analyze(arch, f"train {B}x{S}", cost, 1, dtype="float32")
        flops_rel = abs(cost.matmul_flops - prof_mm) / prof_mm
        # the allocator's peak with only the step's inputs held (the process
        # also holds what earlier phases left), against op_cost's
        peak_step = peak_alloc - held + inputs
        peak_rel = (cost.peak_bytes - peak_step) / peak_step
        log(f"[sharding] one step on the smoke mesh: {s_step:.4f} s ({gpu}); op_cost "
            f"{cost.ops} ops, matmul flops {cost.matmul_flops:.6e} vs the profiler's "
            f"{prof_mm:.6e} (rel {flops_rel:.3e}); all flops {cost.flops:.6e}, bytes "
            f"{cost.bytes:.6e}; counted in {counted_s:.1f} s")
        log(f"[sharding] roofline (float32 peak): compute {r.compute_s:.4f} s, memory "
            f"{r.memory_s:.4f} s, collective {r.collective_s:.4f} s -> {r.dominant}; the "
            f"measured step is {s_step / r.bound_s:.3f} x the bound")
        log(f"[sharding] peak bytes: op_cost {cost.peak_bytes / 2**30:.3f} GiB ({inputs / 2**30:.3f} "
            f"of inputs) vs torch.cuda.max_memory_allocated {peak_alloc / 2**30:.3f} GiB with "
            f"{held / 2**30:.3f} held before the step: {peak_step / 2**30:.3f} GiB with the "
            f"inputs alone (rel {peak_rel:+.4f})")
        by_group: dict = {}
        for name, b in cost.bytes_by_op.items():
            g = _op_group(name)
            by_group[g] = by_group.get(g, 0.0) + b
        for g in sorted(set(by_group) | set(dev_by_group), key=lambda g: -by_group.get(g, 0)):
            gb, us = by_group.get(g, 0.0), dev_by_group.get(g, 0.0)
            log(f"[sharding]   {g:24s} op_cost {gb / 1e9:9.3f} GB "
                f"({gb / rl.HBM_BW * 1e3:8.3f} ms at the HBM peak); profiler device "
                f"{us / 1e3:9.3f} ms")
        launches = {k: v for k, v in sgns_fused.LAUNCHES.items() if v}
        if launches:
            raise RuntimeError(f"the sharding phase launched a kernel: {launches}")
        if flops_rel > SHARD_FLOPS_RTOL:
            raise RuntimeError(f"op_cost's matmul flops are {flops_rel:.3e} off the profiler's")
        if s_step < r.bound_s:
            raise RuntimeError(f"the step ({s_step} s) beat its bound ({r.bound_s} s)")
        if abs(peak_rel) > SHARD_PEAK_TOL:
            raise RuntimeError(f"op_cost's peak bytes are {peak_rel:+.3f} off the allocator's")
        del model, opt_state, step_fn, batches, prof
        torch.cuda.empty_cache()
    except BaseException:
        _end_procs(procs + rule_procs, kill=True)
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    rcs = _end_procs(procs + rule_procs, kill=False)
    dryruns = _finish_dryruns(procs, rcs)
    rank_rule = _finish_rank_rules(rule_procs, rcs)
    for tag, row in dryruns.items():
        log(f"[sharding] {tag}: {row['chips']} ranks, {row['hbm_gb_per_chip'] * 2**30 / 1e9:.6f} "
            f"GB a rank (of 80: fits {row['fits']}), flops {row['flops_per_chip']:.9e} (matmul "
            f"{row['matmul_flops_per_chip']:.9e}), bytes "
            f"{row['bytes_per_chip']:.4e}, collectives {row['collective_ops']} "
            f"({row['collective_bytes_per_chip']:.4e} B, dcn {row['dcn_bytes_per_chip']:.4e}), "
            f"{row['dominant']}-bound, replicated where no rule: {row['fallbacks']}; counted "
            f"on the host, {row['trace_s']:.1f} s to trace")
        if row["fallbacks"]:
            raise RuntimeError(f"the dry run {tag} replicated where no rule placed it: "
                               f"{row['fallbacks']} ({row['fallback_reasons']})")
        if tag in SHARD_TORCH213:
            got = (row["flops_per_chip"], row["matmul_flops_per_chip"],
                   row["hbm_gb_per_chip"] * 2**30 / 1e9)
            rel = [g / w - 1 for g, w in zip(got, SHARD_TORCH213[tag])]
            log(f"[sharding] {tag} against torch 2.13 (flops, matmul flops, GB): "
                f"{[f'{r:+.3e}' for r in rel]}")
            if max(abs(r) for r in rel) > SHARD_TORCH_RTOL:
                raise RuntimeError(f"the dry run {tag} on torch {torch.__version__} reads "
                                   f"{got}, not torch 2.13's {SHARD_TORCH213[tag]}")
    for tag, why in _whole_blocks(dryruns).items():
        log(f"[sharding] {tag}: outputs of >= {SHARD_ALLOC_GB} GB a rank "
            f"{len(dryruns[tag]['allocations'])}, of a whole table or buffer: {why or 'none'}")
        if why:
            raise RuntimeError(f"the dry run {tag} holds whole blocks: {why}")
    h2o = [dryruns[f"h2o-danube-1.8b_train_4k{s}"]["hbm_gb_per_chip"] for s in ("", "_multipod")]
    log(f"[sharding] h2o-danube-1.8b x train_4k GB a rank: 16 x 16 {h2o[0] * 2**30 / 1e9:.6f}, "
        f"2 x 16 x 16 {h2o[1] * 2**30 / 1e9:.6f}")
    if h2o[1] > h2o[0]:
        raise RuntimeError("h2o-danube-1.8b x train_4k holds more a rank on 2 x 16 x 16 than on "
                           "16 x 16")
    return {"rank_rule": rank_rule, "losses": sharded, "bitwise": bitwise, "s_step": s_step,
            "matmul_flops": cost.matmul_flops, "profiler_matmul_flops": prof_mm,
            "flops_rel": flops_rel, "bound_s": r.bound_s, "peak_bytes": cost.peak_bytes,
            "peak_alloc": peak_alloc, "peak_step": peak_step, "peak_rel": peak_rel,
            "dryruns": dryruns}


# ---------------------------------------------------------------------------
# The rest of the model zoo (MoE, MLA, Mamba, mLSTM/sLSTM, M-RoPE with the
# vision stub, encoder-decoder) at full width and, reduced, card vs CPU.
# ---------------------------------------------------------------------------
def _zoo_tol(arch) -> float:
    return ZOO_ATOL.get(arch, 1e-5)


def _zoo_batch(cfg, seed, b, s, device):
    """Random tokens (labels = tokens), with the arch's patch embeddings or
    frames (random normal), as numpy and on ``device``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    np_b = {"tokens": rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)}
    np_b["labels"] = np_b["tokens"]
    if cfg.frontend == "vision":
        np_b["patch_embeds"] = rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        np_b["frames"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in np_b.items()}


def _max_scaled(a, b) -> float:
    """max |a − b| over max(1, max |b|): the CPU tests' scaled rule."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, float(np.abs(b).max())))


def _zoo_serve(arch, device, n_params) -> dict:
    """``serve`` at full width with the launch counts at 0, its tokens
    checked; the stats, the peak above what was held, the bytes bound."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import sgns_fused
    from repro_torch.launch.decode_llm import serve

    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats(device)
    held = torch.cuda.memory_allocated(device)
    sgns_fused.reset_launch_counts()
    t0 = time.perf_counter()
    gen, stats = serve(arch, device=device, **ZOO_SERVE)
    wall = time.perf_counter() - t0
    launches = dict(sgns_fused.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device) - held
    B, P, N = ZOO_SERVE["batch"], ZOO_SERVE["prompt_len"], ZOO_SERVE["new_tokens"]
    bound_ms = 4 * n_params / PEAK_BYTES_PER_S * 1e3
    out = {"params": n_params, "bytes": 4 * n_params, "peak_bytes": peak, "serve_wall_s": wall,
           "prefill_ms": stats["prefill_s"] / P * 1e3, "decode_ms": stats["decode_s"] / N * 1e3,
           "tok_per_s": stats["tok_per_s"], "bound_ms": bound_ms, "launches": launches}
    log(f"[archs] {arch}: serve(batch={B}, prompt_len={P}, new_tokens={N}, seed=0) on "
        f"{device}: {n_params} parameters ({4 * n_params / 1e9:.3f} GB); prefill "
        f"{out['prefill_ms']:.3f} ms/step, decode {out['decode_ms']:.3f} ms/step, "
        f"{stats['tok_per_s']:.1f} tok/s (the weights read once a step: {bound_ms:.3f} "
        f"ms/step, {B / bound_ms * 1e3:.0f} tok/s); wall with init {wall:.1f} s; peak device "
        f"memory {peak / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB held before")
    if any(launches.values()):
        raise RuntimeError(f"{arch}: the decode path launched a kernel: {launches}")
    if gen.shape != (B, N) or gen.dtype != torch.int32 or not (
            0 <= int(gen.min()) and int(gen.max()) < cfg.vocab_size):
        raise RuntimeError(f"{arch}: bad generated tokens: {gen.dtype} {tuple(gen.shape)}")
    log(f"[archs] {arch}: first sequence {gen[0, :16].tolist()}")
    return out


def _zoo_model(arch, device, **moe_overrides):
    import torch
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = get_config(arch)
    if moe_overrides:
        cfg = replace(cfg, moe=replace(cfg.moe, **moe_overrides))
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        model = Model(cfg, prng.PRNGKey(0), device=device)
    torch.cuda.synchronize(device)
    return model, time.perf_counter() - t0


def _decode_vs_forward(arch, model, device, b, s, enc_len=None) -> dict:
    """Teacher-forced decode of ``s`` tokens against the forward's last
    position (``tests/test_decode_consistency.py``'s atol = rtol = 2e-3);
    every MoE assignment of both passes kept."""
    import numpy as np
    import torch

    cfg = model.cfg
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)).to(device)
    batch = {"tokens": toks}
    if enc_len:
        batch["frames"] = torch.from_numpy(
            rng.normal(size=(b, enc_len, cfg.d_model)).astype(np.float32)).to(device)
    fwd_routes, dec_routes = [], []
    t0 = time.perf_counter()
    with torch.inference_mode():
        full, _, _ = model.forward_logits(batch, routes=fwd_routes)
        torch.cuda.synchronize(device)
        t_fwd = time.perf_counter() - t0
        cache = model.init_cache(b, s, enc_len=enc_len)
        if enc_len:
            cache = model.prefill_encoder(batch["frames"], cache)
        for i in range(s):
            out, cache = model.decode_step(cache, toks[:, i:i + 1], i, routes=dec_routes)
        torch.cuda.synchronize(device)
    t_dec = time.perf_counter() - t0 - t_fwd
    a, ref = out[:, 0].double().cpu(), full[:, -1].double().cpu()
    err = float(((a - ref).abs() - DECODE_LOGITS_TOL * ref.abs()).max())
    dropped = sum(int((~r["keep"]).sum()) for r in fwd_routes + dec_routes)
    kept = sum(int(r["keep"].sum()) for r in fwd_routes + dec_routes)
    log(f"[archs] {arch}: decode vs forward at B = {b}, S = {s}"
        f"{f', {enc_len} frames' if enc_len else ''}: max |diff| − 2e-3·|ref| = {err:.3e} "
        f"(forward {t_fwd:.2f} s, decode {t_dec:.2f} s); MoE assignments kept {kept}, "
        f"dropped {dropped}")
    if err > DECODE_LOGITS_TOL or not torch.isfinite(full).all():
        raise RuntimeError(f"{arch}: decode is not the forward")
    if dropped:
        raise RuntimeError(f"{arch}: {dropped} MoE assignments dropped")
    return {"excess": err, "kept": kept, "forward_s": t_fwd, "decode_s": t_dec}


def _replay(arch, model, device, steps) -> bool:
    """The serve prompt decoded into a cache, a snapshot, then ``steps``
    greedy steps twice from copies of it: the logits bitwise."""
    import numpy as np
    import torch

    cfg = model.cfg
    B, P = ZOO_SERVE["batch"], ZOO_SERVE["prompt_len"]
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, P), dtype=np.int32)).to(device)
    cache = model.init_cache(B, P + steps)
    for i in range(P):
        logits, cache = model.decode_step(cache, prompts[:, i:i + 1], i)
    snap = [{k: v.clone() for k, v in c.items()} for c in cache]
    runs = []
    for _ in range(2):
        c = [{k: v.clone() for k, v in layer.items()} for layer in snap]
        tok = torch.argmax(logits[:, :, :cfg.vocab_size], dim=-1).to(torch.int32)
        outs = []
        for i in range(steps):
            lg, c = model.decode_step(c, tok, P + i)
            outs.append(lg)
            tok = torch.argmax(lg[:, :, :cfg.vocab_size], dim=-1).to(torch.int32)
        runs.append(torch.cat(outs, dim=1))
    same = torch.equal(runs[0], runs[1])
    log(f"[archs] {arch}: {steps} decode steps replayed from a cache snapshot: bitwise {same}")
    if not same:
        raise RuntimeError(f"{arch}: decode does not repeat bit for bit")
    return same


def _profile_zoo_decode(arch, model, device, steps: int = ZOO_PROFILE_STEPS) -> dict:
    """``steps`` greedy decode steps after a 4-token prompt, at the serve
    batch, under torch.profiler: the loop's window and device busy time,
    its idle share, kernels launched a step, device µs a step by group."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    cfg = model.cfg
    B, enc_len = ZOO_SERVE["batch"], (ZOO_SERVE["prompt_len"] if cfg.encoder_layers else None)
    cache = model.init_cache(B, 4 + steps, enc_len=enc_len)
    if enc_len:          # serve's zero frames
        cache = model.prefill_encoder(torch.zeros((B, enc_len, cfg.d_model), device=device),
                                      cache)
    tok = torch.ones((B, 1), dtype=torch.int32, device=device)
    for i in range(4):
        logits, cache = model.decode_step(cache, tok, i)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("repro_torch.zoo_decode_loop"):
            for j in range(steps):
                tok = torch.argmax(logits[:, :, :cfg.vocab_size], dim=-1).to(torch.int32)
                logits, cache = model.decode_step(cache, tok, 4 + j)
            torch.cuda.synchronize(device)
    summary = _device_summary(prof, "repro_torch.zoo_decode_loop", steps,
                              PROFILE_GROUPS["archs"], DeviceType)
    launches = sum(k["count"] for k in summary["kernels"]) / steps
    summary["launches_per_step"] = launches
    _write_profile(f"archs_{arch}", prof, summary, trace=False)
    log(f"[archs] {arch}: profile of {steps} decode steps at B = {B}: "
        f"{summary['window_us'] / steps / 1e3:.3f} ms/step, device busy "
        f"{summary['device_busy_us'] / steps / 1e3:.3f} ms/step, idle share "
        f"{summary['idle_share']:.3f}, {launches:.0f} device ops a step")
    log(f"[archs] {arch}:   " + ", ".join(f"{g} {v / 1e3:.3f}" for g, v in
                                          summary["device_us_per_step"].items()) + " ms/step")
    for k in summary["kernels"][:4]:
        log(f"[archs] {arch}:     {k['device_us'] / steps / 1e3:8.3f} ms/step  "
            f"x{k['count']:<6d} {k['name'][:90]}")
    return {k: summary[k] for k in ("window_us", "device_busy_us", "idle_share",
                                    "device_us_per_step", "launches_per_step")}


def _zoo_reduced_vs_cpu(arch, device) -> dict:
    """One converted init of the reduced arch on the card and on the CPU:
    the forward's logits and MoE routes, 4 decode steps (logits, caches,
    routes), one step's loss and gradients."""
    import numpy as np
    import torch
    from repro_torch import convert, prng
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.tree import tree_paths

    cfg = get_config(arch).reduced()
    init = convert.to_jax_model_params(Model(cfg, prng.PRNGKey(0), device="cpu"))
    res = []
    for dev in (device, torch.device("cpu")):
        model = convert.from_jax_model_params(cfg, init, device=dev)
        batch = _zoo_batch(cfg, 2, 2, 16, dev)
        r = {"fwd_routes": [], "dec_routes": []}
        with torch.no_grad():
            r["logits"] = model.forward_logits(batch, routes=r["fwd_routes"])[0].cpu()
        enc_len = 6 if cfg.encoder_layers else None
        cache = model.init_cache(2, ZOO_REDUCED_DECODE, enc_len=enc_len)
        if enc_len:
            cache = model.prefill_encoder(batch["frames"][:, :enc_len], cache)
        r["dec"] = []
        for i in range(ZOO_REDUCED_DECODE):
            lg, cache = model.decode_step(cache, batch["tokens"][:, i:i + 1], i,
                                          routes=r["dec_routes"])
            r["dec"].append((lg.cpu(), tree_paths(convert.to_jax_cache(cfg, cache))))
        model.requires_grad_(True)
        names, ps = zip(*model.named_parameters())
        loss = model.loss_fn(batch)
        grads = torch.autograd.grad(loss, ps)
        r["loss"] = float(loss.detach())
        r["grads"] = tree_paths(convert.to_jax_opt_state(model.param_tree(dict(zip(names,
                                                                                  grads)))))
        res.append(r)
    card, cpu = res
    tol = _zoo_tol(arch)
    logits_err = _max_scaled(card["logits"], cpu["logits"])
    dec_err = max(max(_max_scaled(a[0], b[0]),
                      max(_max_scaled(a[1][k], b[1][k]) for k in b[1]))
                  for a, b in zip(card["dec"], cpu["dec"]))
    routes_equal = all(torch.equal(x[k].cpu(), y[k].cpu())
                       for rs in ("fwd_routes", "dec_routes")
                       for x, y in zip(card[rs], cpu[rs]) for k in ("top_idx", "keep"))
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    grad_rel = max(float(np.abs(card["grads"][k] - g).max() / max(np.abs(g).max(), 1e-30))
                   for k, g in cpu["grads"].items())
    log(f"[archs] {arch} (reduced) card vs CPU: logits {logits_err:.3e}, {ZOO_REDUCED_DECODE} "
        f"decode steps (logits, caches) {dec_err:.3e} (tolerance {tol:g}); MoE routes "
        f"equal {routes_equal} ({len(card['fwd_routes']) + len(card['dec_routes'])} "
        f"routings); loss {card['loss']!r} vs {cpu['loss']!r} (rel {loss_rel:.3e}); the "
        f"largest gradient difference {grad_rel:.3e} of its tensor's largest |g|")
    if (logits_err > tol or dec_err > tol or not routes_equal or loss_rel > LM_LOSS_RTOL
            or grad_rel > CHUNK_REL):
        raise RuntimeError(f"{arch}: the card's reduced model is not the CPU's")
    return {"logits": logits_err, "decode": dec_err, "routes_equal": routes_equal,
            "loss_rel": loss_rel, "grad_rel": grad_rel}


def _jamba_mamba_vs_cpu(device) -> dict:
    """One Mamba mixer at jamba-1.5-large's published widths, from a key, on
    the card and on the CPU: a forward at S = 1,024 (the chunked scan: two
    chunks of 512) and 8 decode steps."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.models.ssm import Mamba, init_mamba_cache

    cfg = get_config("jamba-1.5-large-398b")
    kw = dict(d_inner=cfg.ssm.expand * cfg.d_model, d_state=cfg.ssm.d_state,
              d_conv=cfg.ssm.d_conv, dt_rank=cfg.ssm.dt_rank, dtype=torch.float32)
    with torch.inference_mode():
        card = Mamba(prng.PRNGKey(0), cfg.d_model, device=device, **kw)
        cpu = Mamba(None, cfg.d_model, device="cpu", **kw)
        for name, p in card.named_parameters():
            cpu.get_parameter(name).copy_(p.cpu())
        n = sum(p.numel() for p in card.parameters())
        rng = np.random.default_rng(0)
        x = rng.standard_normal((1, ZOO_MAMBA_SEQ, cfg.d_model)).astype(np.float32)
        steps = rng.standard_normal((ZOO_MAMBA_DECODE, 1, 1, cfg.d_model)).astype(np.float32)
        t0 = time.perf_counter()
        y_card = card(torch.from_numpy(x).to(device)).cpu()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        y_cpu = cpu(torch.from_numpy(x))
        t_cpu = time.perf_counter() - t0
        fwd = float((y_card - y_cpu).abs().max() / y_cpu.abs().max())
        c_card = init_mamba_cache(1, kw["d_inner"], kw["d_state"], kw["d_conv"], torch.float32,
                                  device)
        c_cpu = init_mamba_cache(1, kw["d_inner"], kw["d_state"], kw["d_conv"], torch.float32)
        dec = 0.0
        for t in range(ZOO_MAMBA_DECODE):
            a = card.decode(c_card, torch.from_numpy(steps[t]).to(device)).cpu()
            b = cpu.decode(c_cpu, torch.from_numpy(steps[t]))
            dec = max(dec, float((a - b).abs().max() / b.abs().max()),
                      *(float((c_card[k].cpu() - c_cpu[k]).abs().max() / c_cpu[k].abs().max())
                        for k in ("conv", "h")))
    log(f"[archs] jamba's Mamba mixer at d = {cfg.d_model}, d_inner = {kw['d_inner']}, "
        f"d_state = {kw['d_state']}, dt_rank = {card.dt_rank}: {n} parameters; forward at "
        f"S = {ZOO_MAMBA_SEQ} card vs CPU {fwd:.3e} of the largest |y| (card {t_card:.2f} s, "
        f"CPU {t_cpu:.2f} s); {ZOO_MAMBA_DECODE} decode steps (outputs, conv and SSM states) "
        f"{dec:.3e} of the largest (tolerance {CHUNK_REL:g})")
    if not fwd <= CHUNK_REL or not dec <= CHUNK_REL:
        raise RuntimeError("jamba's Mamba mixer on the card is not the CPU's")
    return {"params": n, "forward_rel": fwd, "decode_rel": dec, "card_s": t_card}


def phase_archs(device) -> dict:
    """The rest of the model zoo (see the module doc, phase 18)."""
    import torch
    from repro_torch.kernels import sgns_fused

    torch.backends.cuda.matmul.allow_tf32 = False
    sgns_fused.reset_launch_counts()
    out: dict = {}
    for arch in ZOO_FULL:
        t_arch = time.perf_counter()
        n_params = sum(math.prod(s) for s in _param_shapes(_zoo_cfg(arch)))
        if arch == "deepseek-v2-lite-16b" and n_params != DEEPSEEK_PARAMS:
            raise RuntimeError(f"deepseek-v2-lite-16b has {n_params} parameters, "
                               f"not {DEEPSEEK_PARAMS}")
        r = _zoo_serve(arch, device, n_params)
        torch.cuda.empty_cache()
        check = ZOO_CONSISTENCY[arch]
        model, r["init_s"] = _zoo_model(arch, device, **check.get("moe", {}))
        log(f"[archs] {arch}: init {r['init_s']:.1f} s "
            f"({4 * n_params / r['init_s'] / 1e9:.2f} GB/s of weights drawn)")
        r["consistency"] = _decode_vs_forward(arch, model, device, check["b"], check["s"],
                                              check.get("enc_len"))
        model.cfg = _zoo_cfg(arch)              # deepseek: the published capacity factor
        if arch == "deepseek-v2-lite-16b":
            r["replay_bitwise"] = _replay(arch, model, device, ZOO_REPLAY_STEPS)
        r["profile"] = _profile_zoo_decode(arch, model, device)
        if arch == "qwen2-vl-7b":
            import numpy as np
            cfg = model.cfg
            toks = torch.from_numpy(np.random.default_rng(1).integers(
                0, cfg.vocab_size, (2, 12), dtype=np.int32)).to(device)
            pe = torch.zeros((2, ZOO_VL_PATCHES, cfg.d_model), device=device)
            t0 = time.perf_counter()
            with torch.inference_mode():
                logits, _, mask = model.forward_logits({"tokens": toks, "patch_embeds": pe})
            torch.cuda.synchronize(device)
            ok = (logits.shape == (2, ZOO_VL_PATCHES + 12, cfg.padded_vocab)
                  and bool(torch.isfinite(logits).all()) and not mask[:, :ZOO_VL_PATCHES].any()
                  and bool(mask[:, ZOO_VL_PATCHES:].all()))
            log(f"[archs] {arch}: forward of {ZOO_VL_PATCHES} zero patch embeddings + 12 "
                f"tokens: logits {tuple(logits.shape)} finite, the patches masked: {ok} "
                f"({time.perf_counter() - t0:.2f} s)")
            if not ok:
                raise RuntimeError(f"{arch}: the vision forward is wrong")
            del logits
        del model
        torch.cuda.empty_cache()
        r["wall_s"] = time.perf_counter() - t_arch
        out[arch] = r
    out["reduced"] = {arch: _zoo_reduced_vs_cpu(arch, device) for arch in ZOO_REDUCED}
    out["mamba"] = _jamba_mamba_vs_cpu(device)
    launches = dict(sgns_fused.LAUNCHES)
    log(f"[archs] launches over the phase: {launches}")
    if any(launches.values()):
        raise RuntimeError(f"the archs phase launched a kernel: {launches}")
    out["launches"] = launches
    return out


def _zoo_cfg(arch):
    from repro_torch.configs import get_config

    return get_config(arch)


# ---------------------------------------------------------------------------
# The elastic path (4 workers at the main width) and the contract checker.
# ---------------------------------------------------------------------------
def _elastic_setup(strategy: str, engine: str, rate=None):
    """``prepare_training`` at the main width for ELASTIC_WORKERS workers:
    1 epoch of STEPS steps in chunks of ELASTIC_CHUNK."""
    from repro_torch.core.driver import prepare_training

    corpus, _ = world()
    kw = train_kw(strategy, engine)
    return prepare_training(corpus, VOCAB, strategy, ELASTIC_WORKERS, kw["cfg"], epochs=1,
                            batch_size=BATCH, rate=rate, window=5, max_vocab=VOCAB,
                            base_min_count=10, max_steps_per_epoch=STEPS,
                            steps_per_chunk=ELASTIC_CHUNK, engine=engine,
                            process_index=0, process_count=1)


def _elastic_classes():
    """A store that times every save (wall and bytes) and a runner that
    counts the chunks it trains and times every load from the store (the
    disk read and the copy to the card)."""
    import torch
    from repro_torch.elastic import ElasticRunner, WorkerStateStore

    class TimedStore(WorkerStateStore):
        def __init__(self, state_dir):
            super().__init__(state_dir)
            self.saves = []                  # (wall s, bytes)

        def save(self, cursor, params):
            t0 = time.perf_counter()
            v = super().save(cursor, params)
            self.saves.append((time.perf_counter() - t0,
                               sum(t.numel() * t.element_size() for t in params.values())))
            return v

    class CountingRunner(ElasticRunner):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.chunks = 0
            self.loads = []                  # wall s of each load from the store

        def train_chunk(self, params, cursor, chunk):
            self.chunks += 1
            return super().train_chunk(params, cursor, chunk)

        def load_worker(self, worker, *, resume=True):
            stored = resume and self.store.cursor(worker) is not None
            t0 = time.perf_counter()
            out = super().load_worker(worker, resume=resume)
            torch.cuda.synchronize(self.device)
            if stored:
                self.loads.append(time.perf_counter() - t0)
            return out

    return TimedStore, CountingRunner


def _elastic_case(tag, label, device, setup, kernel, fn, *, keep_dir=None):
    """Run ``fn(runner)`` on a fresh runner over a state directory under a
    temporary root, with every launch count set to 0 just before, the
    collectives recorded, and the directory deleted after (unless it is
    ``keep_dir``). The kernel must have launched once per step trained
    (chunks trained × chunk steps) and K1 never; no collective."""
    import shutil
    import tempfile

    import torch
    from repro_torch.analysis.contracts import CollectiveRecorder, certify_zero_collective
    from repro_torch.kernels import sgns_fused

    TimedStore, CountingRunner = _elastic_classes()
    if keep_dir is not None:
        shutil.rmtree(keep_dir, ignore_errors=True)
    (ROOT / "build").mkdir(exist_ok=True)
    state = keep_dir or tempfile.mkdtemp(prefix="elastic_", dir=ROOT / "build")
    runner = CountingRunner(setup, TimedStore(state), ckpt_every=ELASTIC_CKPT_EVERY,
                            device=device)
    sgns_fused.reset_launch_counts()
    with CollectiveRecorder(cuda=True) as rec:
        t0 = time.perf_counter()
        out = fn(runner)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    launches = dict(sgns_fused.LAUNCHES)
    certify_zero_collective(rec.counts, label=f"elastic {label}")
    steps = runner.chunks * setup.sched.chunk_steps
    saves = runner.store.saves
    save_s = sorted(s for s, _ in saves)
    log(f"[{tag}] {label}: {wall:.3f} s wall under the recorder; {runner.chunks} chunks "
        f"trained ({steps} steps); {kernel} launches {launches[kernel]}, K1 "
        f"{launches['sample_negatives']}; collectives {rec.counts} over "
        f"{rec.device_kernels} device kernels; {len(saves)} saves of "
        f"{saves[0][1] / 1e6 if saves else 0:.1f} MB each, wall s min "
        f"{save_s[0] if saves else 0:.4f} median {save_s[len(save_s) // 2] if saves else 0:.4f}"
        f" max {save_s[-1] if saves else 0:.4f}; {len(runner.loads)} loads, wall s "
        + " ".join(f"{x:.4f}" for x in runner.loads))
    if launches[kernel] != steps or launches["sample_negatives"]:
        raise RuntimeError(f"{label}: expected {steps} launches of {kernel} and no K1, "
                           f"got {launches}")
    if rec.device_kernels == 0 and steps:
        raise RuntimeError(f"{label}: the recorder saw no device kernel")
    if keep_dir is None:
        shutil.rmtree(state, ignore_errors=True)
    return out, {"chunks": runner.chunks, "launches": launches[kernel], "runner": runner}


def _card_vs_cpu(tag, label, card, cpu, init, launches, want, loss_atol) -> float:
    """``card`` and ``cpu``: ``(params, losses)`` of one chunk trained from
    ``init`` on the card and on the CPU (the plain versions). ``launches``:
    the card run's kernel counts, which must hold ``want`` (each kernel's
    launches). W′/C′ within K2_TABLE_ATOL and CHUNK_REL of the largest update,
    the losses within ``loss_atol``; returns the largest difference."""
    (pg, lg), (pc, lc) = card, cpu
    moved = max(float((pc[k] - init[k].cpu()).abs().max()) for k in ("W", "C"))
    err_t = max(float((pg[k].cpu() - pc[k]).abs().max()) for k in ("W", "C"))
    err_l = float((lg.cpu() - lc).abs().max())
    log(f"[{tag}] {label} on the card vs the CPU's plain versions, same init, ids and key: "
        f"launches {({k: v for k, v in launches.items() if v})}; max |ΔW′, ΔC′| {err_t:.3e} (tol {K2_TABLE_ATOL:g} and "
        f"{CHUNK_REL:g} x the largest update {moved:.3e}); max |Δloss| {err_l:.3e} "
        f"(tol {loss_atol:g})")
    if any(launches.get(k, 0) != v for k, v in want.items()):
        raise RuntimeError(f"{label}: expected launches {want}, got {launches}")
    if not (math.isfinite(moved) and moved > 0.0):
        raise RuntimeError(f"{label}: the plain run left the tables at their init")
    if not (err_t <= K2_TABLE_ATOL and err_t <= CHUNK_REL * moved and err_l <= loss_atol):
        raise RuntimeError(f"{label} on the card disagrees with its plain version")
    return max(err_t, err_l)


def _elastic_vs_plain(tag, label, device, setup, kernel, loss_atol) -> float:
    """Worker 0's first chunk trained twice from the same ``init_params``,
    chunk, key and noise table: on the card, where the engine launches
    ``kernel`` once a step at the elastic path's shapes (n = 1), and on the
    CPU, where it runs the kernel's plain version. Launches here are not the
    path's: the cases reset the counts before they run."""
    import torch
    from repro_torch.elastic import ElasticRunner, WorkerCursor
    from repro_torch.kernels import sgns_fused

    cursor = WorkerCursor.start(0)
    out, init, launches = [], None, None
    for dev in (device, torch.device("cpu")):
        runner = ElasticRunner(setup, device=dev)
        if init is None:
            init = runner.init_params(0)
        chunk = next(runner.chunk_iter(0, cursor))
        sgns_fused.reset_launch_counts()
        params = runner.train_chunk({k: v.to(dev, copy=True) for k, v in init.items()},
                                    cursor, chunk)
        out.append((params, runner.chunk_losses[(0, 0)][0]))
        if launches is None:
            torch.cuda.synchronize(device)
            launches = dict(sgns_fused.LAUNCHES)
    return _card_vs_cpu(tag, f"{label}: worker 0's first chunk", out[0], out[1], init,
                        launches, {kernel: setup.sched.chunk_steps, "sample_negatives": 0},
                        loss_atol)


def _engine_vs_plain(label, eng, V: int, n: int, steps: int, device,
                     tag: str = "contracts") -> dict:
    """One chunk of ``steps`` steps of ``eng`` over ``n`` stacked (V, DIM)
    workers, Zipf(1) ids and a noise table of frequency-sorted counts, on the
    card and on the CPU (the plain versions) from the same init and key.
    Returns {kernel: max difference} for the kernels the card run launched;
    an engine without a kernel (``dense``, ``sparse``) is not compared."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.core.async_trainer import AsyncShardTrainer
    from repro_torch.core.sgns import SGNSConfig
    from repro_torch.data.pairs import stack_noise_tables
    from repro_torch.kernels import sgns_fused

    cfg = SGNSConfig(vocab_size=V, dim=DIM, negatives=5)
    table = stack_noise_tables([np.arange(V, 0, -1, dtype=np.int64) ** 2] * n,
                               kind=eng.table_kind)
    p = 1.0 / np.arange(1, V + 1)
    rng = np.random.default_rng(7)
    centers, contexts = (rng.choice(V, size=(n, steps, BATCH), p=p / p.sum())
                         .astype(np.int32) for _ in range(2))
    out, init, launches = [], None, None
    for dev in (device, torch.device("cpu")):
        tr = AsyncShardTrainer(cfg=cfg, num_workers=n, total_steps=steps, engine=eng,
                               device=dev)
        if init is None:
            init = tr.init(prng.PRNGKey(0))
        tab = ({k: v.to(dev) for k, v in table.items()} if isinstance(table, dict)
               else table.to(dev))
        sgns_fused.reset_launch_counts()
        out.append(tr.epoch({k: v.to(dev, copy=True) for k, v in init.items()},
                            centers, contexts, tab, prng.PRNGKey(1)))
        if launches is None:
            torch.cuda.synchronize(device)
            launches = dict(sgns_fused.LAUNCHES)
            if not any(launches.values()):
                log(f"[{tag}] {label}: no kernel on its path, no plain comparison")
                return {}
    err = _card_vs_cpu(tag, f"{label}, {steps} steps at n = {n}, V = {V}", out[0], out[1],
                       init, launches, {k: v for k, v in launches.items() if v}, K2_LOSS_ATOL)
    return {k: err for k, v in launches.items() if v}


def _same_tables(a: dict, b: dict, workers) -> bool:
    import numpy as np

    return all(np.array_equal(a[w][k], b[w][k]) for w in workers for k in ("W", "C"))


def _n1_vs_stacked(tag, device, setup_kw: dict, base: dict) -> None:
    """Whether an n = 1 elastic worker is bitwise the stacked run's slice:
    ``train_submodels`` of the same ELASTIC_WORKERS workers (one launch a
    step for all of them), W compared worker by worker. A finding, not a
    gate."""
    import numpy as np
    import torch
    from repro_torch.core.driver import train_submodels

    corpus, _ = world()
    res = train_submodels(corpus, VOCAB, device=device, **setup_kw)
    diffs = [float(np.abs(res.stacked.models[w].cpu().numpy() - base[w]["W"]).max())
             for w in range(ELASTIC_WORKERS)]
    same = all(d == 0.0 for d in diffs)
    log(f"[{tag}] n = 1 elastic workers vs the stacked run of {ELASTIC_WORKERS} "
        f"({setup_kw['engine']}): W bitwise {same}; max |ΔW| per worker "
        + " ".join(f"{d:.3e}" for d in diffs))
    del res
    torch.cuda.empty_cache()


def phase_elastic(device) -> dict:
    """Elastic training at the main width (``examples/train_w2v_100m.py``'s
    configuration: V = 89,611, d = 500, B = 1024, K = 5, window 5; 1 epoch of
    64 steps in chunks of 16), cut to 4 workers (every checkpoint moves 2 ×
    89,611 × 500 × 4 B = 358.4 MB a worker, so checkpoints every 2 chunks
    write ~2.9 GB a run) with each state directory under a temporary root,
    deleted after its case. ``fused`` (K2): the uninterrupted run twice,
    bitwise; a kill of host 0 of 2 at tick 3 (after its checkpoint at chunk
    2, so chunk 2 is lost and replayed) with a restart at tick 4, and the
    same kill with ``steal_after=1`` and no restart, each bitwise the
    uninterrupted run with K2 launched once per step trained (256 + 16 per
    replayed chunk) and K1 never; ``train_submodels_elastic`` resumed on the
    finished state directory (no K2 launch, W bitwise); ``merge_finished``
    (``alir``, ``quorum=3``) over a run whose last worker never finishes
    bitwise ``get_merger("alir").final()`` over the three survivors.
    ``rowgrad`` (K3, ``random`` at rate 1/10): the uninterrupted run, then a
    seeded kill-and-restart schedule (seed 3: a chunk of each of two workers
    lost and replayed), bitwise. For both engines worker 0's first chunk is
    held against the kernel's plain version (the same chunk on the CPU).
    Every case runs under the collective recorder and shows none; the n = 1
    runs are compared with the stacked run of the same 4 workers and the
    answer printed."""
    import numpy as np
    import torch
    from repro_torch.core.merge import get_merger
    from repro_torch.elastic import (
        FaultEvent, FaultSchedule, merge_finished, simulate_elastic,
        train_submodels_elastic)
    from repro_torch.kernels import sgns_fused

    gpu = nvidia_smi_line()
    t_phase = time.perf_counter()
    setup = _elastic_setup("shuffle", "fused")
    V, sched = setup.union_vocab.size, setup.sched
    log(f"[elastic] {ELASTIC_WORKERS} workers x ({V}, {DIM}), {sched.steps_per_epoch} steps "
        f"in {sched.num_chunks} chunks of {sched.chunk_steps}, checkpoints every "
        f"{ELASTIC_CKPT_EVERY} chunks ({gpu})")
    if sched.num_chunks != STEPS // ELASTIC_CHUNK:
        raise RuntimeError(f"unexpected schedule {sched}")
    base_steps = ELASTIC_WORKERS * sched.steps_per_epoch
    K2 = "sgns_fused_step"

    def case(label, fn, **kw):
        return _elastic_case("elastic", label, device, setup, K2, fn, **kw)

    base, info_a = case("uninterrupted", lambda r: r.run_all(),
                        keep_dir=str(ROOT / "build" / "elastic_finished"))
    runner_a = info_a["runner"]
    losses = runner_a.epoch_losses()
    moved = [float(np.abs(base[w]["W"] - runner_a.init_params(w)["W"].cpu().numpy()).max())
             for w in range(ELASTIC_WORKERS)]
    log(f"[elastic] epoch loss {losses}; max |W - W_init| per worker "
        + " ".join(f"{m:.3e}" for m in moved))
    if not (all(np.isfinite(base[w][k]).all() for w in base for k in "WC")
            and np.isfinite(losses).all() and all(m > 0 for m in moved)):
        raise RuntimeError("the elastic run's tables or losses are not finite, or W never moved")
    if info_a["launches"] != base_steps:
        raise RuntimeError(f"uninterrupted: {info_a['launches']} K2 launches, "
                           f"expected {base_steps}")
    again, _ = case("uninterrupted, again", lambda r: r.run_all())
    same = _same_tables(base, again, range(ELASTIC_WORKERS))
    log(f"[elastic] two uninterrupted runs bitwise equal: {same}")
    if not same:
        raise RuntimeError("two uninterrupted elastic runs differ")
    del again
    errs = {"fused": _elastic_vs_plain("elastic", "fused (K2)", device, setup, K2,
                                       K2_LOSS_ATOL)}

    for label, faults, steal in (
            ("kill/restart", FaultSchedule((FaultEvent("kill", 0, 3),
                                            FaultEvent("restart", 0, 4))), None),
            ("kill/steal", FaultSchedule((FaultEvent("kill", 0, 3),)), 1)):
        sim, info = case(label, lambda r, f=faults, s=steal:
                         simulate_elastic(r, 2, f, steal_after=s))
        replayed = info["chunks"] - ELASTIC_WORKERS * sched.num_chunks
        same = not sim.unfinished and _same_tables(sim.params, base, range(ELASTIC_WORKERS))
        log(f"[elastic] {label}: {sim.ticks} ticks, stolen {sim.stolen}, finished ticks "
            f"{sim.finished_tick}, {replayed} chunks replayed; bitwise the uninterrupted "
            f"run: {same}")
        # host 0 owns workers 0 and 1 and loses chunk 2 of each to the kill
        if not same or replayed != 2 or info["launches"] != base_steps + 2 * sched.chunk_steps:
            raise RuntimeError(f"{label}: not the uninterrupted run, or not the expected "
                               f"replay (replayed {replayed}, launches {info['launches']})")
        if (steal is not None) != bool(sim.stolen):
            raise RuntimeError(f"{label}: stolen {sim.stolen}")
        del sim

    # resume on the finished state directory: trains nothing
    corpus, _ = world()
    kw = train_kw("shuffle", "fused")
    sgns_fused.reset_launch_counts()
    t0 = time.perf_counter()
    res = train_submodels_elastic(
        corpus, VOCAB, "shuffle", ELASTIC_WORKERS, kw["cfg"],
        state_dir=str(ROOT / "build" / "elastic_finished"), resume=True,
        ckpt_every=ELASTIC_CKPT_EVERY, epochs=1, batch_size=BATCH, window=5,
        max_vocab=VOCAB, base_min_count=10, max_steps_per_epoch=STEPS, engine="fused",
        steps_per_chunk=ELASTIC_CHUNK, device=device)
    wall = time.perf_counter() - t0
    resumed = dict(sgns_fused.LAUNCHES)
    same = all(np.array_equal(res.stacked.models[w].cpu().numpy(), base[w]["W"])
               for w in range(ELASTIC_WORKERS))
    log(f"[elastic] train_submodels_elastic on the finished state directory: {wall:.3f} s "
        f"(train_s {res.timings['train_s']:.4f}: 4 loads), launches {resumed}; W bitwise "
        f"the uninterrupted run: {same}")
    if any(resumed.values()) or not same:
        raise RuntimeError("resuming a finished state directory trained or changed something")
    del res
    import shutil
    shutil.rmtree(ROOT / "build" / "elastic_finished", ignore_errors=True)

    # merge from whatever finished: 4 hosts, the last killed for good
    sim, info = case("quorum", lambda r: simulate_elastic(
        r, ELASTIC_WORKERS, FaultSchedule((FaultEvent("kill", ELASTIC_WORKERS - 1, 1),))))
    survivors = list(range(ELASTIC_WORKERS - 1))
    if sim.finished != survivors or not _same_tables(sim.params, base, survivors):
        raise RuntimeError(f"quorum: survivors {sim.finished}, or not the uninterrupted run")
    t0 = time.perf_counter()
    got = merge_finished(sim, setup.mask, merger="alir", quorum=3, device=device)
    torch.cuda.synchronize(device)
    merge_s = time.perf_counter() - t0
    ref = get_merger("alir", device=device)
    for w in survivors:
        ref.add(w, sim.params[w]["W"], setup.mask[w], fold=False)
    ref = ref.final()
    same = got.worker_ids == tuple(survivors) and all(
        torch.equal(getattr(got, f), getattr(ref, f)) for f in ("emb", "valid", "transforms"))
    try:
        merge_finished(sim, setup.mask, merger="alir", quorum=ELASTIC_WORKERS, device=device)
        refused = False
    except RuntimeError:
        refused = True
    log(f"[elastic] merge_finished(alir, quorum=3) over workers {sim.finished} "
        f"(worker {ELASTIC_WORKERS - 1} unfinished): {merge_s:.3f} s; bitwise "
        f"get_merger('alir').final() over the survivors: {same}; quorum={ELASTIC_WORKERS} "
        f"refused: {refused}")
    if not same or not refused:
        raise RuntimeError("merge_finished is not the survivors' final fold")
    del sim, got, ref
    _n1_vs_stacked("elastic", device, {**train_kw("shuffle", "fused"),
                                       "num_workers": ELASTIC_WORKERS,
                                       "steps_per_chunk": ELASTIC_CHUNK}, base)
    launches = {"fused": info_a["launches"]}
    del base, runner_a, info_a
    torch.cuda.empty_cache()

    # rowgrad (K3) on the random strategy
    setup = _elastic_setup("random", "rowgrad", rate=0.1)
    sched = setup.sched
    base, info = _elastic_case("elastic", "rowgrad uninterrupted", device, setup,
                               "sgns_row_grads", lambda r: r.run_all())
    launches["rowgrad"] = info["launches"]
    errs["rowgrad"] = _elastic_vs_plain("elastic", "rowgrad (K3)", device, setup,
                                        "sgns_row_grads", K3_LOSS_ATOL)
    # seed 3 kills host 1 at tick 3, after its checkpoint at chunk 2, and
    # restarts it at tick 5: chunk 2 of workers 2 and 3 is lost and replayed
    faults = FaultSchedule.seeded(3, hosts=2, horizon=sched.num_chunks, kills=1, restarts=1)
    sim, info = _elastic_case("elastic", "rowgrad seeded", device, setup, "sgns_row_grads",
                              lambda r: simulate_elastic(r, 2, faults))
    replayed = info["chunks"] - ELASTIC_WORKERS * sched.num_chunks
    same = not sim.unfinished and _same_tables(sim.params, base, range(ELASTIC_WORKERS))
    log(f"[elastic] rowgrad, union V {setup.union_vocab.size}: seeded schedule "
        f"{[(e.kind, e.host, e.tick) for e in faults.events]}, {sim.ticks} ticks, "
        f"{replayed} chunks replayed, {len(info['runner'].loads)} loads; bitwise the "
        f"uninterrupted run: {same}")
    if not same or {e.kind for e in faults.events} != {"kill", "restart"}:
        raise RuntimeError("the seeded rowgrad run is not the uninterrupted one")
    if replayed != 2 or not info["runner"].loads:
        raise RuntimeError(f"the seeded rowgrad run replayed {replayed} chunks after "
                           f"{len(info['runner'].loads)} loads, expected 2 after a load")
    _n1_vs_stacked("elastic", device, {**train_kw("random", "rowgrad"),
                                       "num_workers": ELASTIC_WORKERS,
                                       "steps_per_chunk": ELASTIC_CHUNK, "rate": 0.1}, base)
    log(f"[elastic] phase wall {time.perf_counter() - t_phase:.1f} s ({gpu})")
    return {"launches": launches, "max_abs_err": errs}


def phase_contracts(device) -> dict:
    """The contract checker on the card: every engine × sampler certified
    over one chunk of 8 steps at the main width with n = 2 (zero ``c10d::``
    ops, zero NCCL kernels, the (V, d) tables in place), the ``@zipf50k``
    planner traffic against the committed baseline; and, in an NCCL group
    of world size 1, the recorder's non-vacuity: the mesh Gram's one
    all-gather (rejected by the certifier), ``make_sync_epoch``'s three
    all-reduces a step and ``make_periodic_sync_epoch``'s two a sync plus
    one an epoch. Each engine's kernels are held against their plain
    versions at n = 2 (:func:`_engine_vs_plain`)."""
    import torch
    import torch.nn.functional as F
    from repro_torch import prng
    from repro_torch.analysis.contracts import (
        CollectiveRecorder, ContractViolation, certify_bench_traffic,
        certify_engine_contracts, certify_zero_collective, engine_matrix)
    from repro_torch.core.async_trainer import make_periodic_sync_epoch, make_sync_epoch
    from repro_torch.core.merge import sharded_gram
    from repro_torch.core.sgns import SGNSConfig
    from repro_torch.sharding.merge import mesh_sharded_gram

    gpu = nvidia_smi_line()
    t_phase = time.perf_counter()
    V, n = 89_611, 2
    errs = {}
    for eng in engine_matrix(V):
        label = eng.describe() + (" sequential" if getattr(eng, "sequential", False) else "")
        t0 = time.perf_counter()
        rep = certify_engine_contracts(eng, vocab_size=V, dim=DIM, negatives=5, steps=8,
                                       batch=BATCH, num_workers=n, device=device)
        log(f"[contracts] {label}: zero collectives over {rep.device_kernels} device "
            f"events (8 steps, n = {n}, V = {V}, d = {DIM}); tables in place "
            f"({rep.in_place.tables_in_place}/2, largest table-shaped copy "
            f"{rep.in_place.largest_copy}); {time.perf_counter() - t0:.2f} s")
        if rep.device_kernels == 0:
            raise RuntimeError(f"{label}: the recorder saw no device kernel")
        # K4b's plain version is a per-pair loop (seconds a step on the CPU)
        steps = 1 if getattr(eng, "sequential", False) else 8
        for k, e in _engine_vs_plain(label, eng, V, n, steps, device).items():
            errs[k] = max(errs.get(k, 0.0), e)
        torch.cuda.empty_cache()
    traffic = certify_bench_traffic(str(ROOT / "BENCH_wallclock.json"), device=device)
    log("[contracts] @zipf50k planner traffic on the card == the committed baseline: "
        + ", ".join(f"{r.engine} {r.predicted_rows}" for r in traffic))

    rng = torch.Generator(device=device).manual_seed(0)
    S, d = 4, DIM
    A = F.pad(torch.randn((V, d), generator=rng, device=device), (0, 0, 0, (-V) % S))
    cfg = SGNSConfig(vocab_size=V, dim=d, negatives=5)
    table = {k: v[0] for k, v in zipf_alias_table(V, 1, device).items()}
    ids = lambda *shape: torch.randint(0, V, shape, generator=rng, device=device,
                                       dtype=torch.int32)
    steps, outer, sync_every = 4, 2, 2

    def tables():
        return {"W": 0.01 * torch.randn((V, d), generator=rng, device=device),
                "C": torch.zeros((V, d), device=device)}

    seen = {}
    with _nccl_world_of_one("contracts", device) as group:
        with CollectiveRecorder(cuda=True) as rec:
            g = mesh_sharded_gram(A, A, group, num_shards=S)
        seen["gram"] = rec.counts
        if not torch.equal(g, sharded_gram(A, A, S)):
            raise RuntimeError("the mesh Gram is not sharded_gram")
        try:
            certify_zero_collective(rec.counts, label="merge-gram")
            rejected = False
        except ContractViolation:
            rejected = True
        with CollectiveRecorder(cuda=True) as rec:
            make_sync_epoch(cfg, table, steps, group=group, engine="fused", device=device)(
                tables(), ids(steps, BATCH), ids(steps, BATCH), prng.PRNGKey(1), 0)
        seen["sync"] = rec.counts
        with CollectiveRecorder(cuda=True) as rec:
            make_periodic_sync_epoch(cfg, table, outer * sync_every, sync_every,
                                     num_workers=n, group=group, engine="fused",
                                     device=device)(
                tables(), ids(outer, sync_every, BATCH), ids(outer, sync_every, BATCH),
                prng.PRNGKey(2), 0)
        seen["periodic"] = rec.counts
    c10d = {k: {op: c for op, c in v.items() if op.startswith("c10d::")}
            for k, v in seen.items()}
    nccl = {k: {op: c for op, c in v.items() if not op.startswith("c10d::")}
            for k, v in seen.items()}
    log(f"[contracts] NCCL group of one: c10d ops {c10d}; NCCL kernels {nccl}; the Gram "
        f"rejected by certify_zero_collective: {rejected} ({gpu})")
    want = {"gram": {"c10d::_allgather_base_": 1},
            "sync": {"c10d::allreduce_": 3 * steps},
            "periodic": {"c10d::allreduce_": 2 * outer + 1}}
    if c10d != want or not rejected:
        raise RuntimeError(f"collective counts {c10d}, expected {want}")
    log(f"[contracts] phase wall {time.perf_counter() - t_phase:.1f} s ({gpu})")
    return {"max_abs_err": errs}


def phase_random(device):
    """The ``random`` strategy on the ``rowgrad`` engine: per-worker
    vocabularies and CDF noise tables on the card, K3 in every step, and
    the merge rebuilding the rows each worker never saw."""
    import torch
    from repro_torch.core.merge import reconstruct_missing

    kw = train_kw("random", "rowgrad")
    res, launches, taken = _train("random", device, kw, ("sgns_row_grads",))
    mask = res.stacked.mask
    sizes = mask.sum(1).tolist()
    V = res.union_vocab.size
    log(f"[random] union vocabulary {V} rows; per-worker vocabularies {sizes}; "
        f"{int((~mask).sum())} of {mask.numel()} worker rows missing")
    if min(sizes) == V:
        raise RuntimeError("every worker saw the whole union: nothing to reconstruct")
    emb, _ = _merge_and_score("random", res, device, full_cover=False)
    completed = reconstruct_missing(res.stacked, emb)
    torch.cuda.synchronize(device)
    if not torch.isfinite(completed).all():
        raise RuntimeError("non-finite reconstructed rows")
    if not torch.equal(completed[mask], res.stacked.models[mask]):
        raise RuntimeError("reconstruct_missing changed a present row")
    log(f"[random] reconstructed {int((~mask).sum())} missing rows; all finite")
    repeat = _repeat_sparse_steps(device, res)
    return {"launches": launches, "steps": taken, "V": V, "mask": mask,
            "counts": res.union_vocab.counts, "train_kw": kw, "repeat": repeat}


def _repeat_sparse_steps(device, res, lr=0.025) -> dict:
    """One step of ``dense``, ``sparse`` and ``rowgrad`` run twice from the
    same state at the random path's shapes (its trained W, random C, ids
    from its union unigram distribution, negatives by the CDF sampler of
    its union noise table): the two runs must agree bit for bit. Then the
    sparse step's scatter timed both ways on the same addends: the ordered
    apply the port runs (``sgns.ordered_add_``) and ``index_add_``'s
    atomics (the yardstick, which the port no longer calls)."""
    import torch
    from repro_torch.core import sgns
    from repro_torch.core.engine import get_engine
    from repro_torch.data.pairs import build_noise_table

    W0 = res.stacked.models
    n, V, d = W0.shape
    K = 5
    gen = torch.Generator(device=device).manual_seed(13)
    uni = torch.tensor(res.union_vocab.counts, dtype=torch.float32, device=device)
    cen = torch.multinomial(uni, n * BATCH, replacement=True, generator=gen) \
        .view(n, BATCH).to(torch.int32)
    ctx = torch.multinomial(uni, n * BATCH, replacement=True, generator=gen) \
        .view(n, BATCH).to(torch.int32)
    cdf = build_noise_table(res.union_vocab.counts, kind="cdf").to(device) \
        .expand(n, V).contiguous()
    negs = get_engine("sparse:cdf").sample(cdf, seeds_for(n, 9, device), (BATCH, K))
    C0 = 0.1 * torch.randn((n, V, d), generator=gen, device=device)
    out = {}
    for name in ("dense", "sparse", "rowgrad"):
        runs = []
        for _ in range(2):
            p = {"W": W0.clone(), "C": C0.clone()}
            if name == "dense":
                loss = sgns.train_step_dense_(p, cen, ctx, negs, lr)
            else:
                kw = {}
                if name == "rowgrad":
                    from repro_torch.kernels.sgns_update import sgns_row_grads
                    kw["row_grads"] = sgns_row_grads
                loss = sgns.train_step_sparse_(p, cen, ctx, negs, lr, **kw)
            runs.append((p, loss))
        torch.cuda.synchronize(device)
        (p1, l1), (p2, l2) = runs
        same = (torch.equal(l1, l2) and torch.equal(p1["W"], p2["W"])
                and torch.equal(p1["C"], p2["C"]))
        moved = float((p1["C"] - C0).abs().max())
        log(f"[random] one {name} step twice from the same state (n={n} V={V} d={d} "
            f"B={BATCH} K={K}): W, C and loss bitwise equal: {same}; largest C update "
            f"{moved:.3e}")
        out[name] = same
        del runs, p1, p2
        if not same:
            raise RuntimeError(f"two {name} steps from the same state differ")
        if not moved > 0.0:
            raise RuntimeError(f"the {name} step left C unchanged")
    # the scatter alone, both ways, on the sparse step's own addends
    Wf, Cf, cenf, ctxf, negf = sgns._flat({"W": W0.clone(), "C": C0.clone()}, cen, ctx, negs)
    rows = sgns.sparse_row_grads_per_pair(Wf[cenf], Cf[ctxf], Cf[negf].view(n * BATCH, K, d))
    adds = [-lr * rows[1], -lr * rows[2], -lr * rows[3].reshape(-1, d)]

    def scatter(fn):
        fn(Wf, cenf, adds[0])
        fn(Cf, ctxf, adds[1])
        fn(Cf, negf, adds[2])

    ordered = _time_ms(lambda: scatter(sgns.ordered_add_), device, reps=20)
    atomics = _time_ms(lambda: scatter(lambda t, r, a: t.index_add_(0, r, a)), device,
                       reps=20)
    ordered2 = _time_ms(lambda: scatter(sgns.ordered_add_), device, reps=20)
    out.update(ordered_apply_ms=[ordered, ordered2], index_add_ms=atomics)
    log(f"[random] the sparse step's scatter (W at centers, C at contexts, C at "
        f"negatives): ordered apply {ordered:.4f} / {ordered2:.4f} ms a step, "
        f"index_add_ (atomics) {atomics:.4f} ms")
    del Wf, Cf, rows, adds
    return out


def phase_hbm(device, block_pairs=256, sequential_steps=8):
    """The main configuration on ``fused_hbm``: K4a by blocks, then K4b."""
    from repro_torch.core.engine import get_engine

    kw = train_kw("shuffle", get_engine("fused_hbm", block_pairs=block_pairs))
    res, launches, taken = _train("hbm", device, kw, ("sgns_fused_hbm_step",),
                                  absent=("sample_negatives",))
    kw_seq = train_kw("shuffle", get_engine("fused_hbm", sequential=True))
    _, launches_seq, taken_seq = _train("hbm-seq", device, kw_seq,
                                        ("sgns_fused_hbm_step", "sample_negatives"),
                                        steps=sequential_steps)
    return {"launches": launches, "steps": taken, "launches_seq": launches_seq,
            "steps_seq": taken_seq, "block_pairs": block_pairs, "train_kw": kw,
            "W": res.stacked.models, "chunk_losses": res.chunk_losses}


def phase_pipe(device, hbm: dict, hot_rows=256):
    """The main configuration on ``fused_pipe`` (K5) and ``fused_tiered``
    (K6) at the ``hbm`` phase's ``block_pairs``: the trained W and every
    step's losses must be bitwise the ``fused_hbm`` run's."""
    import numpy as np
    import torch
    from repro_torch.core.engine import get_engine

    out = {}
    for tag, engine, kernel in (
            ("pipe", get_engine("fused_pipe", block_pairs=hbm["block_pairs"], ring_depth=2),
             "sgns_fused_pipe_step"),
            ("tiered", get_engine("fused_tiered", block_pairs=hbm["block_pairs"],
                                  hot_rows=hot_rows), "sgns_fused_tiered_step")):
        res, launches, taken = _train(tag, device, train_kw("shuffle", engine),
                                      (kernel, "sample_negatives"))
        same_w = torch.equal(res.stacked.models, hbm["W"])
        same_loss = (len(res.chunk_losses) == len(hbm["chunk_losses"]) and all(
            np.array_equal(a, b) for a, b in zip(res.chunk_losses, hbm["chunk_losses"])))
        log(f"[{tag}] against the hbm phase's fused_hbm run: W bitwise equal: {same_w}; "
            f"every step's losses bitwise equal: {same_loss}")
        if not (same_w and same_loss):
            raise RuntimeError(f"{engine.describe()} training differs from fused_hbm's")
        out[tag] = {"launches": launches, "steps": taken,
                    "train_kw": train_kw("shuffle", engine)}
        del res
    return out


# ---------------------------------------------------------------------------
def _decode_cfg():
    from repro_torch.configs import get_config

    return get_config(DECODE["arch"])


def phase_decode(device, profile: bool = False) -> dict:
    """The LLM decode path: ``serve`` at full width with every launch count
    set to 0 just before and read just after (K7 once per layer and
    full-ring step, no other kernel); then the checks and K7's times from
    serve's own caches after the prompt, copied as its last prompt step
    returns (:func:`_decode_checks`)."""
    import torch
    from repro_torch.kernels import sgns_fused
    from repro_torch.launch.decode_llm import serve
    from repro_torch.models import Model

    cfg = _decode_cfg()
    B, P, N = DECODE["batch"], DECODE["prompt_len"], DECODE["new_tokens"]
    ring = min(P + N, cfg.attention_window)
    expected = cfg.num_layers * (P + N - (ring - 1))
    torch.cuda.reset_peak_memory_stats(device)
    held_before = torch.cuda.memory_allocated(device)      # earlier phases' tensors
    # the checks start from serve's own state after the prompt: the model and
    # a copy of its caches, taken as the last prompt step returns. The copy's
    # time and bytes are taken out of prefill_s and the peak, which measure
    # serve alone
    prefilled = {}
    step = Model.decode_step

    def snapshot_after_prompt(self, cache, token, pos, **kw):
        out = step(self, cache, token, pos, **kw)
        if pos == P - 1 and not prefilled:
            torch.cuda.synchronize(device)
            t1 = time.perf_counter()
            held = torch.cuda.memory_allocated(device)
            prefilled.update(model=self, peak_before=torch.cuda.max_memory_allocated(device),
                             cache=[{k: t.clone() for k, t in c.items()} for c in cache])
            torch.cuda.synchronize(device)
            prefilled.update(bytes=torch.cuda.memory_allocated(device) - held,
                             s=time.perf_counter() - t1)
            torch.cuda.reset_peak_memory_stats(device)
        return out

    sgns_fused.reset_launch_counts()
    Model.decode_step = snapshot_after_prompt
    t0 = time.perf_counter()
    try:
        gen, stats = serve(DECODE["arch"], batch=B, prompt_len=P, new_tokens=N,
                           seed=DECODE["seed"], device=device)
    finally:
        Model.decode_step = step
    wall = time.perf_counter() - t0
    launches = dict(sgns_fused.LAUNCHES)
    peak = max(prefilled["peak_before"],
               torch.cuda.max_memory_allocated(device) - prefilled["bytes"]) - held_before
    stats["prefill_s"] -= prefilled["s"]
    n_params = sum(math.prod(s) for s in _param_shapes(cfg))
    weight_bytes = 4 * n_params
    ring_bytes = 4 * 2 * cfg.num_layers * B * ring * cfg.num_kv_heads * cfg.resolved_head_dim
    step_bound_ms = (weight_bytes + ring_bytes) / PEAK_BYTES_PER_S * 1e3
    log(f"[decode] serve({DECODE['arch']!r}, batch={B}, prompt_len={P}, new_tokens={N}) "
        f"on {device}: {n_params} parameters ({weight_bytes / 1e9:.2f} GB), rings "
        f"{ring_bytes / 1e9:.2f} GB; prefill {stats['prefill_s']:.2f} s "
        f"({stats['prefill_s'] / P * 1e3:.3f} ms/step), decode {stats['decode_s']:.3f} s "
        f"({stats['decode_s'] / N * 1e3:.3f} ms/step), {stats['tok_per_s']:.1f} tok/s "
        f"(bound by bytes: {step_bound_ms:.3f} ms/step, {B / step_bound_ms * 1e3:.0f} "
        f"tok/s); wall with init {wall:.1f} s; peak device memory {peak / 2**30:.2f} GiB "
        f"above the {held_before / 2**30:.2f} GiB held before (the checks' copy of the "
        f"caches, {prefilled['bytes'] / 2**30:.2f} GiB and {prefilled['s'] * 1e3:.1f} ms, "
        f"taken out of both)")
    log(f"[decode] launches during serve: {launches}")
    if launches["swa_decode"] != expected:
        raise RuntimeError(f"expected {expected} launches of swa_decode "
                           f"({cfg.num_layers} layers x {P + N - (ring - 1)} full-ring "
                           f"steps), got {launches}")
    if any(n for name, n in launches.items() if name != "swa_decode"):
        raise RuntimeError(f"the decode path launched an SGNS kernel: {launches}")
    if gen.shape != (B, N) or gen.dtype != torch.int32 or not (
            0 <= int(gen.min()) and int(gen.max()) < cfg.vocab_size):
        raise RuntimeError(f"bad generated tokens: {gen.dtype} {tuple(gen.shape)}")
    log(f"[decode] first sequence: {gen[0, :16].tolist()}")
    out = {"launches": launches, "stats": stats, "peak_bytes": peak, "tokens": gen,
           "step_bound_ms": step_bound_ms}
    torch.cuda.empty_cache()
    out.update(_decode_checks(device, gen, profile, prefilled.pop("model"),
                              prefilled.pop("cache")))
    return out


def _param_shapes(cfg):
    from repro_torch.models import Model

    return [tuple(p.shape) for p in Model(cfg, device="meta").parameters()]


def _decode_checks(device, gen, profile: bool, model, cache) -> dict:
    """From serve's ``model`` and its ``cache`` after the prompt (a copy),
    and a snapshot of it, ``DECODE_CHECK_STEPS`` steps fed the generated
    tokens, with K7 (K7 held
    against its plain version on every layer's real cache on the first
    ``DECODE_KERNEL_CHECKS`` steps, float32 and bfloat16) and from the
    snapshot with the plain masked attention: the logits must agree. Then
    K7, its plain version and SDPA timed on layer 0's cache."""
    import torch
    from repro_torch.kernels.swa_decode import swa_decode, swa_decode_plain
    from repro_torch.models import attention

    cfg = _decode_cfg()
    P = DECODE["prompt_len"]
    with torch.inference_mode():
        snapshot = [{k: t.clone() for k, t in c.items()} for c in cache]

        errs = {"float32": 0.0, "bfloat16": 0.0}
        checked = []
        captured = {}

        def held(q, k, v, *, chunk):
            out = swa_decode(q, k, v, chunk=chunk)
            for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                a = [t.to(dt) for t in (q, k, v)]
                got = out if dt == torch.float32 else swa_decode(*a, chunk=chunk)
                ref = swa_decode_plain(*a, chunk=chunk)
                errs[name] = max(errs[name], float((got.float() - ref.float()).abs().max()))
            if len(checked) % cfg.num_layers == 0:       # layer 0
                captured.update(q=q.clone(), k=k, v=v, chunk=chunk)
            checked.append(chunk)
            return out

        tokens = gen[:, :DECODE_CHECK_STEPS]
        routes = {}
        for route, c in (("k7", cache), ("plain", snapshot)):
            logits = []
            for j in range(DECODE_CHECK_STEPS):
                if route == "k7" and j < DECODE_KERNEL_CHECKS:
                    attention.swa_decode = held
                try:
                    lg, _ = model.decode_step(c, tokens[:, j:j + 1], P + j,
                                              swa_kernel=route == "k7")
                finally:
                    attention.swa_decode = swa_decode
                logits.append(lg.float())
                if route == "k7" and j == DECODE_KERNEL_CHECKS - 1:
                    timed = dict(captured)      # layer 0's cache is cache[0]
            routes[route] = torch.cat(logits, 1)
        torch.cuda.synchronize(device)
        a, b = routes["k7"], routes["plain"]
        diff = (a - b).abs()
        excess = float((diff - DECODE_LOGITS_TOL * b.abs()).max())
        log(f"[decode] K7 against its plain version on every layer's cache, "
            f"{len(checked)} calls ({DECODE_KERNEL_CHECKS} full-ring steps x "
            f"{cfg.num_layers} layers, chunk {checked[0]}): max |diff| float32 "
            f"{errs['float32']:.3e} (tol {K7_ATOL['float32']:g}), bfloat16 "
            f"{errs['bfloat16']:.3e} (tol {K7_ATOL['bfloat16']:g})")
        log(f"[decode] {DECODE_CHECK_STEPS} teacher-forced steps from the snapshot, K7 "
            f"against the plain masked attention: logits {tuple(a.shape)}, max |diff| "
            f"{float(diff.max()):.3e}, max |diff| - rtol·|plain| {excess:.3e} (atol = rtol "
            f"= {DECODE_LOGITS_TOL:g}); max |logit| {float(b.abs().max()):.3f}")
        if len(checked) != DECODE_KERNEL_CHECKS * cfg.num_layers:
            raise RuntimeError(f"K7 was checked {len(checked)} times")
        for name, e in errs.items():
            if not e <= K7_ATOL[name]:
                raise RuntimeError(f"K7 ({name}) disagrees with its plain version: {e}")
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise RuntimeError("non-finite decode logits")
        if not excess <= DECODE_LOGITS_TOL:
            raise RuntimeError("the K7 route's logits disagree with the plain attention's")
        del snapshot, routes, a, b, diff
        if profile:
            _profile_decode(model, cache, gen, P + DECODE_CHECK_STEPS)
        del model, cache
        torch.cuda.empty_cache()
        result = _time_swa(device, timed)
    result["max_abs_err"] = errs["float32"]
    result["max_abs_err_bf16"] = errs["bfloat16"]
    return {"time": result}


def _time_swa(device, captured) -> dict:
    """K7, its plain version and SDPA (``enable_gqa``) on layer 0's real
    cache and query, each held against the plain version first."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.swa_decode import swa_decode, swa_decode_plain

    q, k, v, chunk = (captured[n] for n in ("q", "k", "v", "chunk"))
    B, H, D = q.shape
    W, Hkv = k.shape[1], k.shape[2]

    def library():
        return F.scaled_dot_product_attention(q[:, :, None], k.transpose(1, 2),
                                              v.transpose(1, 2), enable_gqa=True)[:, :, 0]

    ref = swa_decode_plain(q, k, v, chunk=chunk)
    lib_err = float((library() - ref).abs().max())
    ms = _time_ms(lambda: swa_decode(q, k, v, chunk=chunk), device, reps=200)
    plain_ms = _time_ms(lambda: swa_decode_plain(q, k, v, chunk=chunk), device, reps=50)
    library_ms = _time_ms(library, device, reps=200)
    nbytes = 2 * k.numel() * k.element_size() + 2 * q.numel() * q.element_size()
    flops = 4 * B * H * W * D                  # q·k and p·v, per query head
    r = _bound(ms, plain_ms, nbytes, flops)
    r["library_ms"] = library_ms
    log(f"[time] swa_decode B={B} W={W} H={H} Hkv={Hkv} D={D}: {ms:.4f} ms (the earlier "
        f"window-split kernel, PERF.md §6: 0.0714-0.0775 ms on an NVIDIA H100 80GB HBM3), "
        f"plain {plain_ms:.4f} ms, SDPA "
        f"(enable_gqa) {library_ms:.4f} ms (max |diff| to the plain version "
        f"{lib_err:.3e}); bound {r['bound_ms']:.5f} ms by {r['bound_by']} ({nbytes} B, "
        f"{flops} flop)")
    return r


def _profile_decode(model, cache, gen, pos0: int, steps: int = 16) -> None:
    """``steps`` full-ring decode steps under torch.profiler: device busy
    time inside a ``repro_torch.decode_loop`` span, its idle share, and
    device µs a step by kernel group."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    device = model.embed.device
    tokens = gen[:, -steps:]
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("repro_torch.decode_loop"):
            for j in range(steps):
                model.decode_step(cache, tokens[:, j:j + 1], pos0 + j)
            torch.cuda.synchronize(device)
    summary = _device_summary(prof, "repro_torch.decode_loop", steps,
                              PROFILE_GROUPS["decode"], DeviceType)
    # no timeline: 16 steps of ~1,100 launches make a trace of tens of MB
    _write_profile("decode", prof, summary, trace=False)
    log(f"[profile] decode (h2o-danube-1.8b, B={gen.shape[0]}, full rings): loop "
        f"{summary['window_us'] / 1e3:.1f} ms for {steps} steps "
        f"({summary['window_us'] / steps / 1e3:.3f} ms/step); device busy "
        f"{summary['device_busy_us'] / 1e3:.1f} ms, idle share {summary['idle_share']:.3f}")
    for g, v in summary["device_us_per_step"].items():
        log(f"[profile]   {g}: {v:.1f} us/step")
    for k in summary["kernels"][:8]:
        log(f"[profile]     {k['device_us'] / steps:8.1f} us/step  x{k['count']:<5d} "
            f"{k['name'][:90]}")


# ---------------------------------------------------------------------------
def _time_ms(fn, device, reps: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def _unique_rows(ids: "torch.Tensor") -> int:
    """Distinct rows per worker of ``ids`` ``(n, ...)``, summed over workers."""
    from repro_torch.launch.roofline import unique_rows

    return unique_rows(ids)


def phase_time(device, main: dict, rand: dict) -> dict:
    """Checks, then times, each kernel and its plain version at its path's
    shapes. K1, K2 and K4 at the main path's: its noise table (the shuffle
    vocabulary's unigram^0.75 alias table, shared by all workers), ids
    drawn from its unigram distribution, random tables. K3 at the
    ``random`` path's: its union vocabulary, n·B pairs gathered from
    random tables. The checks run first, on clones, since the timing loops
    update the tables in place."""
    import numpy as np
    import torch
    from repro_torch.data.pairs import build_noise_table
    from repro_torch.kernels.sgns_fused import (
        sample_negatives, sample_negatives_plain, sgns_fused_step,
        sgns_fused_step_plain)
    from repro_torch.kernels.sgns_fused_hbm import (
        sgns_fused_hbm_step, sgns_fused_hbm_step_plain)
    from repro_torch.kernels.sgns_update import sgns_row_grads, sgns_row_grads_plain

    n, V, d, B, K, lr = (main[k] for k in ("n", "V", "dim", "B", "K", "lr"))
    one = build_noise_table(main["counts"], kind="alias")
    table = {k: v.to(device).expand(n, V).contiguous() for k, v in one.items()}
    seeds = seeds_for(n, 5, device)
    gen = torch.Generator(device=device).manual_seed(7)
    uni = torch.tensor(main["counts"], dtype=torch.float32, device=device)
    centers = torch.multinomial(uni, n * B, replacement=True, generator=gen) \
        .view(n, B).to(torch.int32)
    contexts = torch.multinomial(uni, n * B, replacement=True, generator=gen) \
        .view(n, B).to(torch.int32)
    W = 0.1 * torch.randn((n, V, d), generator=gen, device=device)
    C = 0.1 * torch.randn((n, V, d), generator=gen, device=device)

    out = {}
    k1_err = _check_k1("time", seeds, table, (B, K))
    k2_err = _check_step("time", "K2", sgns_fused_step, sgns_fused_step_plain, W, C,
                         centers, contexts, table, seeds, lr, K)
    # K1 at the step's draw shape (n, B, K)
    draws = n * B * K
    k1 = _time_ms(lambda: sample_negatives(seeds, table["prob"], table["alias"],
                                           (B, K)), device, reps=200)
    k1p = _time_ms(lambda: sample_negatives_plain(seeds, table["prob"],
                                                  table["alias"], (B, K)),
                   device, reps=50)
    k1_bytes = draws * (4 + 4 + 4) + n * 8          # prob+alias read, id written
    k1_flops = draws * 2                            # u·V and the compare
    out["sample_negatives"] = _bound(k1, k1p, k1_bytes, k1_flops)
    out["sample_negatives"]["max_abs_err"] = k1_err
    variants = _variants({"sample_negatives": ["empty"], "sgns_row_grads": ["first"]})
    out["sample_negatives"].update(_k1_beside_empty(
        device, variants[("sample_negatives", "empty")],
        lambda: sample_negatives(seeds, table["prob"], table["alias"], (B, K))))

    # K2: the whole step (one launch, the draw inside it)
    pk = {"W": W.clone(), "C": C.clone()}
    k2 = _time_ms(lambda: sgns_fused_step(pk, centers, contexts, table, seeds, lr,
                                          negatives=K), device, reps=20)
    del pk
    pp = {"W": W.clone(), "C": C.clone()}
    k2p = _time_ms(lambda: sgns_fused_step_plain(pp, centers, contexts, table,
                                                 seeds, lr, negatives=K),
                   device, reps=10)
    del pp
    ids = sample_negatives(seeds, table["prob"], table["alias"], (B, K))
    uniq_w = _unique_rows(centers)
    uniq_c = _unique_rows(torch.cat([contexts, ids.view(n, -1)], 1))
    row = d * 4
    k2_bytes = _step_bytes(centers, contexts, ids, d)
    # dots 2d(K+1), dW 2d(K+1), dC d(K+1), apply 2d(K+1) C + 2d W, per pair
    k2_flops = n * B * d * (7 * (K + 1) + 2)
    out["sgns_fused_step"] = _bound(k2, k2p, k2_bytes, k2_flops)
    out["sgns_fused_step"]["max_abs_err"] = k2_err
    out["sgns_fused_step"]["touched_rows"] = {"W": uniq_w, "C": uniq_c,
                                              "gathered": n * B * (K + 2)}
    out["sgns_fused_step"].update(_beside_k5("K2", W, C, centers, contexts, table, seeds, lr,
                                             K, ids, B, k2))

    # K4a: the block chain, checked (ids bitwise, tolerance, repeat), then
    # with one block against K2 on the same inputs, then timed.
    blk = 256
    hbm_kw = dict(block_pairs=blk)
    k4_err = _check_step("time", "K4a", sgns_fused_hbm_step, sgns_fused_hbm_step_plain,
                         W, C, centers, contexts, table, seeds, lr, K, repeat=True,
                         **hbm_kw)
    one, l_one, _ = sgns_fused_hbm_step({"W": W.clone(), "C": C.clone()}, centers, contexts,
                                        table, seeds, lr, negatives=K, block_pairs=B)
    k2p_, l_k2, _ = sgns_fused_step({"W": W.clone(), "C": C.clone()}, centers, contexts,
                                    table, seeds, lr, negatives=K)
    k5p_, l_k5, _ = _pipe_steps({})[0]({"W": W.clone(), "C": C.clone()}, centers, contexts,
                                       table, seeds, lr, negatives=K, block_pairs=B)
    torch.cuda.synchronize(device)
    err_one = max(float((one[k] - k2p_[k]).abs().max()) for k in ("W", "C"))
    bitwise_one = (torch.equal(l_one, l_k2) and torch.equal(l_one, l_k5) and all(
        torch.equal(one[k], k2p_[k]) and torch.equal(one[k], k5p_[k]) for k in ("W", "C")))
    log(f"[time] K4a with block_pairs >= B against K2: max |Δtable| {err_one:.3e}; K2, "
        f"K4a and K5 (block_pairs = B) bitwise equal, tables and loss: {bitwise_one}")
    del one, k2p_, k5p_
    if not bitwise_one:
        raise RuntimeError("K2, K4a and K5 with one block are not bitwise equal")
    pk = {"W": W.clone(), "C": C.clone()}
    k4 = _time_ms(lambda: sgns_fused_hbm_step(pk, centers, contexts, table, seeds, lr,
                                              negatives=K, **hbm_kw), device, reps=20)
    del pk
    pp = {"W": W.clone(), "C": C.clone()}
    k4p = _time_ms(lambda: sgns_fused_hbm_step_plain(pp, centers, contexts, table, seeds,
                                                     lr, negatives=K, **hbm_kw),
                   device, reps=5, warmup=1)
    del pp
    # The chain computes K2's function on the same inputs, so its least
    # traffic is K2's: each distinct row of the step read once, written
    # once. The rows each block touches, which K4a moves, are reported.
    uniq_bw = sum(_unique_rows(centers[:, b0:b0 + blk]) for b0 in range(0, B, blk))
    uniq_bc = sum(_unique_rows(torch.cat([contexts[:, b0:b0 + blk],
                                          ids[:, b0:b0 + blk].reshape(n, -1)], 1))
                  for b0 in range(0, B, blk))
    out["sgns_fused_hbm_step"] = _bound(k4, k4p, k2_bytes, k2_flops)
    out["sgns_fused_hbm_step"]["max_abs_err"] = k4_err
    out["sgns_fused_hbm_step"]["touched_rows"] = {"W": uniq_bw, "C": uniq_bc,
                                                  "blocks": -(-B // blk)}
    out["sgns_fused_hbm_step"]["one_block_vs_k2"] = {"max_abs_err": err_one,
                                                     "bitwise": bitwise_one}
    out["sgns_fused_hbm_step"].update(_beside_k5("K4a", W, C, centers, contexts, table, seeds,
                                                 lr, K, ids, blk, k4))

    # K5 and K6 at the main path's shapes: each configuration checked
    # (against K4a bitwise; against its plain version), then timed beside
    # K4a's whole call of this run.
    k4a = sgns_fused_hbm_step({"W": W.clone(), "C": C.clone()}, centers, contexts, table,
                              seeds, lr, negatives=K, **hbm_kw)
    inputs = (W, C, centers, contexts, table, seeds, lr, K)
    for key, label, kw in (
            ("sgns_fused_pipe_step", "K5 ring 2", dict(ring_depth=2)),
            ("sgns_fused_pipe_step@ring3", "K5 ring 3", dict(ring_depth=3)),
            ("sgns_fused_tiered_step", "K6 hot 256", dict(hot_rows=256)),
            ("sgns_fused_tiered_step@hot2048", "K6 hot 2048", dict(hot_rows=2048)),
            ("sgns_fused_tiered_step@hotV", "K6 hot V", dict(hot_rows=V))):
        out[key] = _check_and_time_pipe(label, k4a, inputs, blk, kw, k2_bytes, k2_flops)
        out[key]["k4a_ms"] = k4
    del k4a

    # K4b: word2vec's per-pair order against its plain per-pair loop.
    seq_kw = dict(sequential=True)
    k4s_err = _check_step("time", "K4b", sgns_fused_hbm_step, sgns_fused_hbm_step_plain,
                          W, C, centers, contexts, table, seeds, lr, K, repeat=True,
                          **seq_kw)
    pk = {"W": W.clone(), "C": C.clone()}
    k4s = _time_ms(lambda: sgns_fused_hbm_step(pk, centers, contexts, table, seeds, lr,
                                               negatives=K, **seq_kw), device, reps=20,
                   warmup=2)
    del pk
    pp = {"W": W.clone(), "C": C.clone()}
    k4sp = _time_ms(lambda: sgns_fused_hbm_step_plain(pp, centers, contexts, table, seeds,
                                                      lr, negatives=K, **seq_kw),
                    device, reps=1, warmup=1)
    del pp
    # the least work: each distinct row of the step read once, written once
    out["sgns_fused_hbm_step_sequential"] = _bound(k4s, k4sp, k2_bytes, k2_flops)
    out["sgns_fused_hbm_step_sequential"]["max_abs_err"] = k4s_err
    log(f"[time] K4b (sequential) n={n} V={V} d={d} B={B} K={K}: {k4s:.4f} ms "
        f"(the earlier one-CTA-a-worker kernel, PERF.md §6: 8.5244 ms on an NVIDIA H100 "
        f"80GB HBM3), plain {k4sp:.4f} ms")
    del W, C
    torch.cuda.empty_cache()

    # K3 at the random path's shapes: n·B pairs gathered from random tables
    # with ids from its union unigram distribution.
    Vr = rand["V"]
    Wr = 0.1 * torch.randn((n, Vr, d), generator=gen, device=device)
    Cr = 0.1 * torch.randn((n, Vr, d), generator=gen, device=device)
    uni_r = torch.tensor(rand["counts"], dtype=torch.float32, device=device)
    draw = lambda m: torch.multinomial(uni_r, m, replacement=True, generator=gen)
    off = (torch.arange(n, device=device) * Vr)[:, None]
    cen_r = (draw(n * B).view(n, B) + off).reshape(-1)
    ctx_r = (draw(n * B).view(n, B) + off).reshape(-1)
    neg_r = (draw(n * B * K).view(n, B * K) + off).reshape(-1)
    Wf, Cf = Wr.view(n * Vr, d), Cr.view(n * Vr, d)
    w_rows, cp_rows, cn_rows = Wf[cen_r], Cf[ctx_r], Cf[neg_r].view(n * B, K, d)
    del Wr, Cr, Wf, Cf
    k3_err = _check_k3("time", w_rows, cp_rows, cn_rows)
    k3 = _time_ms(lambda: sgns_row_grads(w_rows, cp_rows, cn_rows), device, reps=50)
    k3p = _time_ms(lambda: sgns_row_grads_plain(w_rows, cp_rows, cn_rows), device,
                   reps=10)
    N = n * B
    k3_bytes = 2 * N * (K + 2) * row + N * 4       # rows in, gradients out, loss
    k3_flops = N * d * 5 * (K + 1)                 # dots 2d(K+1), dW 2d(K+1), dC d(K+1)
    out["sgns_row_grads"] = _bound(k3, k3p, k3_bytes, k3_flops)
    out["sgns_row_grads"]["max_abs_err"] = k3_err
    out["sgns_row_grads"].update(_k3_beside_first(
        device, variants[("sgns_row_grads", "first")], w_rows, cp_rows, cn_rows))
    del w_rows, cp_rows, cn_rows
    torch.cuda.empty_cache()

    for name, r in out.items():
        log(f"[time] {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms), "
            f"bound {r['bound_ms']:.5f} ms by {r['bound_by']} "
            f"({r['bytes']} B, {r['flops']} flop)")
    log(f"[time] K2 touched rows per step: {out['sgns_fused_step']['touched_rows']}")
    log(f"[time] K4a touched rows per step, summed over blocks: "
        f"{out['sgns_fused_hbm_step']['touched_rows']}")
    for name, label in (("sgns_fused_step", "K2"), ("sgns_fused_hbm_step", "K4a")):
        r = out[name]
        log(f"[time] {label}: whole call {r['ms']:.4f} ms, launch alone {r['alone_ms']:.4f} ms; "
            f"K5 at the same block size, whole call {r['k5_ms']:.4f} ms; the torch block "
            f"sorts it no longer runs {r['torch_sorts_ms']:.4f} ms; longest run "
            f"{r['longest_run']}")
    for name in [k for k in out if k.startswith("sgns_fused_pipe") or
                 k.startswith("sgns_fused_tiered")]:
        r = out[name]
        log(f"[time] {name}: whole call {r['ms']:.4f} ms, launch alone {r['alone_ms']:.4f} "
            f"ms, K4a's whole call {r['k4a_ms']:.4f} ms; bound {r['bound_ms']:.5f} ms; "
            f"the reference's row traffic {r['row_traffic']} rows")
    out["zipf50k"] = _zipf50k(device, lr)
    return out


def _longest_runs(runs, blk: int) -> dict:
    """The longest run of one row in any block of any worker's sorted
    lists ``runs`` (``block_sorts``' layout), per table."""
    import torch

    w_rows, _, c_rows, _ = runs
    n, B = w_rows.shape
    K = c_rows.shape[1] // B - 1
    out = {}
    for name, rows, per in (("C", c_rows, K + 1), ("W", w_rows, 1)):
        longest = 0
        for p0 in range(0, B, blk):
            seg = rows[:, p0 * per:min(p0 + blk, B) * per]
            for w in range(n):
                _, counts = torch.unique_consecutive(seg[w], return_counts=True)
                longest = max(longest, int(counts.max()))
        out[name] = longest
    return out


def _beside_k5(label, W, C, centers, contexts, table, seeds, lr, K, ids, blk, whole_ms):
    """K2's or K4a's launch at block size ``blk`` (the draw inside it):
    timed alone (``run_block_step``, without the wrapper's checks); K5's
    whole call at the same block size, timed in turn with this kernel's
    (kernel, K5, K5, kernel); the torch block sorts the launch replaced, on
    K1's draw ``ids`` of the same step; and the longest runs of the path's
    sorted lists."""
    from repro_torch.kernels import sgns_block_step as BS
    from repro_torch.kernels.sgns_fused_hbm import block_sorts

    device = W.device
    n, V, d = W.shape
    B = centers.shape[1]
    lib, sym, counter = (("sgns_fused_step", "sgns_fused_step_launch", "sgns_fused_step")
                         if label == "K2" else
                         ("sgns_fused_hbm", "sgns_hbm_chain_launch", "sgns_fused_hbm_step"))
    pk = {"W": W.clone(), "C": C.clone()}
    alone = _time_ms(lambda: BS.run_block_step(lib, sym, counter, pk, centers, contexts, table,
                                               seeds, lr, blk, K), device, reps=20)
    k5_step = _pipe_steps({})[0]
    k5 = [_time_ms(lambda: k5_step(pk, centers, contexts, table, seeds, lr, negatives=K,
                                   block_pairs=blk), device, reps=20) for _ in range(2)]
    step = _step_fn(label)
    again = _time_ms(lambda: step(pk, centers, contexts, table, seeds, lr, negatives=K,
                                  **({} if label == "K2" else {"block_pairs": blk})),
                     device, reps=20)
    del pk
    sorts = _time_ms(lambda: block_sorts(centers, contexts, ids, blk, V), device, reps=50)
    runs = block_sorts(centers, contexts, ids, blk, V)
    return {"alone_ms": alone, "k5_ms": min(k5), "k5_ms_both": k5,
            "whole_ms_again": again, "torch_sorts_ms": sorts,
            "longest_run": _longest_runs(runs, blk), "block_pairs": blk,
            "split": BS.SPLIT_RUNS, "whole_ms_first": whole_ms}


def _step_fn(label):
    from repro_torch.kernels.sgns_fused import sgns_fused_step
    from repro_torch.kernels.sgns_fused_hbm import sgns_fused_hbm_step

    return sgns_fused_step if label == "K2" else sgns_fused_hbm_step


def _pipe_steps(kw: dict):
    """K5's or K6's wrapper and plain version, by the dials."""
    from repro_torch.kernels import sgns_fused_pipe as P
    from repro_torch.kernels import sgns_fused_tiered as T

    if "hot_rows" in kw:
        return T.sgns_fused_tiered_step, T.sgns_fused_tiered_step_plain
    return P.sgns_fused_pipe_step, P.sgns_fused_pipe_step_plain


def _step_bytes(centers, contexts, ids, d: int) -> int:
    """The least bytes one step of K2's function moves, whatever its
    schedule (K2, K4, K5, K6): ``repro_torch.launch.roofline.step_bytes``."""
    from repro_torch.launch.roofline import step_bytes

    return step_bytes(centers, contexts, ids, d)


def _check_and_time_pipe(label, k4a, inputs, blk, kw, nbytes, flops) -> dict:
    """One K5/K6 configuration at the main path's shapes: against its
    plain version (ids bitwise, tolerance, repeat bitwise) and bitwise
    against the K4a step ``k4a`` on the same inputs; then timed beside its
    plain version: the whole call (K1, K4a's two block sorts, the launch)
    and the launch alone on fixed block sorts."""
    import torch
    from repro_torch.kernels.sgns_fused_hbm import block_sorts
    from repro_torch.kernels.sgns_fused_pipe import plan_blocks, plan_row_traffic, run_chain

    W, C, centers, contexts, table, seeds, lr, K = inputs
    device = W.device
    n, V, d = W.shape
    step, plain = _pipe_steps(kw)
    kw = dict(kw, block_pairs=blk)
    hot, S = min(kw.get("hot_rows", 0), V), kw.get("ring_depth", 2)
    err = _check_step("time", label, step, plain, W, C, centers, contexts, table, seeds, lr,
                      K, repeat=True, **kw)
    ref_p, ref_l, ref_ids = k4a
    p, loss, ids = step({"W": W.clone(), "C": C.clone()}, centers, contexts, table, seeds,
                        lr, negatives=K, **kw)
    torch.cuda.synchronize(device)
    same = (torch.equal(ids, ref_ids) and torch.equal(loss, ref_l)
            and all(torch.equal(p[k], ref_p[k]) for k in ("W", "C")))
    log(f"[time] {label}: ids, W′, C′ and loss bitwise K4a's: {same}")
    del p
    if not same:
        raise RuntimeError(f"{label} is not bitwise equal to K4a")
    runs = block_sorts(centers, contexts, ids, blk, V)
    pk = {"W": W.clone(), "C": C.clone()}
    ms = _time_ms(lambda: step(pk, centers, contexts, table, seeds, lr, negatives=K, **kw),
                  device, reps=20)
    alone_ms = _time_ms(lambda: run_chain(pk, centers, contexts, ids, runs, lr, blk,
                                          hot_rows=hot), device, reps=20)
    del pk
    pp = {"W": W.clone(), "C": C.clone()}
    plain_ms = _time_ms(lambda: plain(pp, centers, contexts, table, seeds, lr, negatives=K,
                                      **kw), device, reps=5, warmup=1)
    del pp
    # the bound counts the step's distinct rows (K2's and K4a's bytes); the
    # reference's row transfers (its ring's gathers and write-backs) are
    # reported beside it
    plan = plan_blocks(centers, contexts, ids, V, blk, hot_rows=hot, ring_depth=S)
    r = _bound(ms, plain_ms, nbytes, flops)
    r.update(max_abs_err=err, alone_ms=alone_ms, row_traffic=plan_row_traffic(plan, hot),
             longest_run=_longest_runs(runs, blk))
    return r


def _zipf50k(device, lr) -> dict:
    """The reference's ``@zipf50k`` shape: the planner's row traffic on the
    card at ``hot_rows`` 0 and 2,048 (the reference counts 91,386 and
    59,692), then K4a, K5 and K6 (hot 2,048) at ``block_pairs=128`` on
    random tables — K5 and K6 bitwise K4a's — each timed."""
    import torch
    from repro_torch.analysis.workloads import ZIPF50K, zipf50k_ids, zipf50k_row_traffic
    from repro_torch.kernels.sgns_fused_hbm import sgns_fused_hbm_step
    from repro_torch.kernels.sgns_fused_pipe import plan_blocks, plan_row_traffic

    V, d, B, K = ZIPF50K["V"], ZIPF50K["D"], ZIPF50K["B"], ZIPF50K["K"]
    blk, hot = ZIPF50K["BLK"], ZIPF50K["HOT"]
    traffic = {h: zipf50k_row_traffic(h, device) for h in (0, hot)}
    log(f"[time] @zipf50k planner row traffic on {device}: {traffic[0]} rows at "
        f"hot_rows=0, {traffic[hot]} at hot_rows={hot}")
    if (traffic[0], traffic[hot]) != (91_386, 59_692):
        raise RuntimeError(f"@zipf50k row traffic {traffic} != the reference's "
                           f"(91386, 59692)")
    c, x, _, table, seeds = zipf50k_ids(device)
    gen = torch.Generator(device=device).manual_seed(11)
    W = 0.1 * torch.randn((1, V, d), generator=gen, device=device)
    C = 0.1 * torch.randn((1, V, d), generator=gen, device=device)
    steps = (("sgns_fused_hbm_step", sgns_fused_hbm_step, {}),
             ("sgns_fused_pipe_step", _pipe_steps({})[0], {}),
             ("sgns_fused_tiered_step", _pipe_steps({"hot_rows": hot})[0],
              {"hot_rows": hot}))
    ref = None
    res = {}
    for name, step, kw in steps:
        p, loss, ids = step({"W": W.clone(), "C": C.clone()}, c, x, table, seeds, lr,
                            negatives=K, block_pairs=blk, **kw)
        torch.cuda.synchronize(device)
        if ref is None:
            ref = (p, loss, ids)
        same = (torch.equal(loss, ref[1]) and torch.equal(ids, ref[2])
                and all(torch.equal(p[k], ref[0][k]) for k in ("W", "C")))
        pk = {"W": W.clone(), "C": C.clone()}
        ms = _time_ms(lambda: step(pk, c, x, table, seeds, lr, negatives=K, block_pairs=blk,
                                   **kw), device, reps=20)
        del pk
        h = kw.get("hot_rows", 0)
        rows = plan_row_traffic(plan_blocks(c, x, ids, V, blk, hot_rows=h), h)
        nbytes = _step_bytes(c, x, ids, d)
        res[name] = {"ms": ms, "row_traffic": rows, "bytes": nbytes,
                     "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bitwise_k4a": same}
        log(f"[time] @zipf50k {name} (block_pairs={blk}{f', hot_rows={h}' if h else ''}): "
            f"{ms:.4f} ms; bitwise K4a's: {same}; row traffic {rows} rows, bound "
            f"{res[name]['bound_ms']:.5f} ms ({nbytes} B)")
        if not same:
            raise RuntimeError(f"@zipf50k {name} is not bitwise equal to K4a")
    return res


def _variants(wanted: dict) -> dict:
    """``kernel_variants``' patched copies ``wanted`` (``{library:
    [variant, ...]}``), built from the checkout's sources: ``{(library,
    variant): path}``."""
    from repro_torch.analysis import kernel_variants as KV
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    paths = KV.build_variants(build.build_dir().parent / "kernel_variants", wanted)
    log(f"[time] built the variants {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    return paths


def _in_turns(device, lib: str, paths: dict, call, reps: int, pattern: str) -> dict:
    """``call`` timed with each library of ``paths`` (``{label: path}``,
    the kernel's first) in turns — the kernel, the others, the others
    again, the kernel — as the whole call (ms) and on the device (µs a call,
    ``torch.profiler``); the kernel's own library is restored."""
    from repro_torch.analysis import kernel_variants as KV
    from repro_torch.kernels import build

    labels = list(paths)
    order = labels[:1] + labels[1:] + labels[1:] + labels[:1]
    ms = {k: [] for k in labels}
    dev = {}
    try:
        for k in order:
            KV.use(lib, paths[k])
            ms[k].append(_time_ms(call, device, reps=reps))
            if k not in dev:
                dev[k] = sum(KV.device_us(call, 20, pattern).values())
    finally:
        KV.use(lib, build.library_path(lib))
    return {"ms": ms, "device_us": dev}


def _k1_beside_empty(device, empty, call) -> dict:
    """K1's whole call and device time beside the same wrapper's on a copy
    of the kernel with its body taken out: the launch floor."""
    from repro_torch.kernels import build

    t = _in_turns(device, "sample_negatives",
                  {"k1": build.library_path("sample_negatives"), "empty": empty}, call, 200,
                  "sample_negatives")
    log(f"[time] K1 whole call {t['ms']['k1']} ms, {t['device_us']['k1']:.2f} us on the "
        f"device; an empty launch of the same grid through the same wrapper "
        f"{t['ms']['empty']} ms, {t['device_us']['empty']:.2f} us on the device")
    return {"empty_ms": min(t["ms"]["empty"]), "device_us": t["device_us"]["k1"],
            "empty_device_us": t["device_us"]["empty"], "turns_ms": t["ms"]}


def _k3_beside_first(device, first, w, c_pos, c_neg) -> dict:
    """K3 twice from the same rows (bitwise), the first design
    (``kernel_variants``' ``first``) on them (bitwise K3's), then both timed
    in turns as the whole call and on the device."""
    import torch
    from repro_torch.analysis import kernel_variants as KV
    from repro_torch.kernels import build
    from repro_torch.kernels.sgns_update import sgns_row_grads

    call = lambda: sgns_row_grads(w, c_pos, c_neg)        # noqa: E731
    a, b = call(), call()
    KV.use("sgns_row_grads", first)
    try:
        f = call()
    finally:
        KV.use("sgns_row_grads", build.library_path("sgns_row_grads"))
    torch.cuda.synchronize(device)
    repeat = all(torch.equal(x, y) for x, y in zip(a, b))
    same = all(torch.equal(x, y) for x, y in zip(a, f))
    del a, b, f
    t = _in_turns(device, "sgns_row_grads",
                  {"k3": build.library_path("sgns_row_grads"), "first": first}, call, 50,
                  "row_grads_")
    log(f"[time] K3 N={w.shape[0]} d={w.shape[1]} K={c_neg.shape[1]}: run twice bitwise "
        f"equal: {repeat}; bitwise the first design's: {same}; whole call {t['ms']['k3']} ms "
        f"({t['device_us']['k3']:.1f} us on the device), the first design "
        f"{t['ms']['first']} ms ({t['device_us']['first']:.1f} us)")
    if not repeat:
        raise RuntimeError("two K3 runs on the same rows differ")
    if not same:
        raise RuntimeError("K3 is not bitwise the first design")
    return {"first_ms": min(t["ms"]["first"]), "device_us": t["device_us"]["k3"],
            "first_device_us": t["device_us"]["first"], "turns_ms": t["ms"],
            "repeat_bitwise": repeat, "bitwise_first": same}


def _check_k3(tag, w, c_pos, c_neg) -> float:
    """K3 against its plain version on the same gathered rows."""
    import torch
    from repro_torch.kernels.sgns_update import sgns_row_grads, sgns_row_grads_plain

    got = sgns_row_grads(w, c_pos, c_neg)
    ref = sgns_row_grads_plain(w, c_pos, c_neg)
    torch.cuda.synchronize(w.device)
    err_l = float((got[0] - ref[0]).abs().max())
    err_g = max(float((g - r).abs().max()) for g, r in zip(got[1:], ref[1:]))
    log(f"[{tag}] K3 N={w.shape[0]} d={w.shape[1]} K={c_neg.shape[1]}: max |Δgrad| "
        f"{err_g:.3e} (tol {K3_GRAD_ATOL:g}), max |Δloss| {err_l:.3e} "
        f"(tol {K3_LOSS_ATOL:g}); largest |dW| {float(got[1].abs().max()):.3e}")
    if err_g > K3_GRAD_ATOL or err_l > K3_LOSS_ATOL:
        raise RuntimeError("K3 disagrees with its plain version beyond tolerance")
    if not all(bool(torch.isfinite(t).all()) for t in got):
        raise RuntimeError("K3 produced non-finite values")
    return max(err_g, err_l)




# ---------------------------------------------------------------------------
# The paper's workload at 300k x 500 (dryrun_sgns), multi-process training,
# and the on-chip budget and phase order held to the card.
# ---------------------------------------------------------------------------
def phase_dryrun(device) -> dict:
    """``repro_torch.launch.dryrun_sgns`` through its entry point at the
    paper's width (``configs/sgns_wiki.py``: V = 300,000, d = 500, K = 5, B =
    1024; one worker, DRYRUN_STEPS steps of Zipf(1) ids): the ten cases, zero
    collectives on every async case (the script asserts it), each case's
    kernel launches and collectives as expected; then each kernel on these
    paths held against its plain version at this width (K1 bitwise; K2, K3,
    K4a, K5, K6 over one chunk on the card and on the CPU from the same init,
    :func:`_engine_vs_plain`)."""
    import torch
    from repro_torch.core.engine import get_engine
    from repro_torch.launch import dryrun_sgns

    gpu = nvidia_smi_line()
    S = DRYRUN_STEPS
    out = ROOT / "chiprun_out" / "dryrun_sgns.json"
    out.parent.mkdir(exist_ok=True)
    out.unlink(missing_ok=True)
    rows = {r["case"]: r for r in dryrun_sgns.main(
        ["--cases", ",".join(dryrun_sgns.CASES), "--steps", str(S), "--json", str(out),
         "--vmem-budget-mb", str(DEFAULT_BUDGET_MB)])}
    k64 = max(S // 64, 1) * 64
    want = {"async": {}, "async_alias": {}, "async_pallas": {"sgns_row_grads": S},
            "async_fused": {"sgns_fused_step": S}, "async_fused_hbm": {"sgns_fused_hbm_step": S},
            "async_fused_pipe": {"sgns_fused_pipe_step": S, "sample_negatives": S},
            "async_fused_tiered": {"sgns_fused_tiered_step": S, "sample_negatives": S},
            "sync": {"sample_negatives": S}, "local_sgd_8": {"sgns_fused_step": S},
            "local_sgd_64": {"sgns_fused_step": k64}, "merge_alir_iter": {}}
    colls = {"sync": {"c10d::allreduce_": 3 * S},
             "local_sgd_8": {"c10d::allreduce_": 2 * (S // 8) + 1},
             "local_sgd_64": {"c10d::allreduce_": 2 * (k64 // 64) + 1},
             "merge_alir_iter": {"c10d::_allgather_base_": 1}}
    for case, r in rows.items():
        c10d = {k: v for k, v in r["collective_ops"].items() if k.startswith("c10d::")}
        log(f"[dryrun] {case}: {r['device_us_per_step']:.1f} us/step on the device, bound "
            f"{r['bound_s'] / r['measured_s']:.3f} of it ({r['dominant']}); launches "
            f"{r['launches']}; collectives {r['collective_ops']}, "
            f"{r['collective_bytes_per_chip'] / 1e9:.4f} GB counted; wall {r['wall_s']:.2f} s ({gpu})")
        if r["launches"] != want[case]:
            raise RuntimeError(f"{case}: launches {r['launches']}, expected {want[case]}")
        if c10d != colls.get(case, {}):
            raise RuntimeError(f"{case}: collectives {c10d}, expected {colls.get(case, {})}")
    errs = {}
    for spec in ("rowgrad", "fused", "fused_hbm", "fused_pipe", "fused_tiered"):
        for k, e in _engine_vs_plain(spec, get_engine(spec), DRYRUN_V, 1, 4, device,
                                     tag="dryrun").items():
            errs[k] = max(errs.get(k, 0.0), e)
        torch.cuda.empty_cache()
    errs["sample_negatives"] = _check_k1("dryrun", seeds_for(1, 0, device),
                                         zipf_alias_table(DRYRUN_V, 1, device), (BATCH, 5))
    launches = {}
    for r in rows.values():
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"rows": rows, "launches": launches, "max_abs_err": errs}


def multiproc_rank(rank: int, size: int, store: str) -> int:
    """One rank of :func:`phase_multiproc` (``--multiproc-rank``): train the
    main configuration's block of workers in a group of ``size`` ranks on
    this card (gloo over host copies: NCCL refuses two ranks on one device),
    under the collective recorder; then the merge phase's gathers under it
    again. Prints one JSON line: hashes of its block's W and chunk losses and
    of the gathered W, the counts, its launches and walls."""
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.analysis.contracts import CollectiveRecorder
    from repro_torch.core.driver import gather_submodels, train_submodels
    from repro_torch.kernels import sgns_fused
    from repro_torch.launch.mesh import make_worker_group

    device = torch.device("cuda", 0)
    group = make_worker_group(size, rank, device=device, store=dist.FileStore(store, size))
    corpus, _ = world()
    sgns_fused.reset_launch_counts()
    with CollectiveRecorder(cuda=True) as rec:
        res = train_submodels(corpus, VOCAB, device=device, process_index=rank,
                              process_count=size, group=group, **train_kw("shuffle", "fused"))
    train_counts, launches = rec.counts, dict(sgns_fused.LAUNCHES)
    sha = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
    block = {"w": sha(res.stacked.models.cpu().numpy()),
             "losses": sha(np.concatenate(res.chunk_losses, axis=1))}
    start = res.plan.start
    with CollectiveRecorder(cuda=True) as rec:
        res = gather_submodels(res)
    out = {"rank": rank, "start": start,
           "backend": dist.get_backend(group), "train_counts": train_counts,
           "gather_counts": rec.counts, "launches": launches, "block": block,
           "gathered_w": sha(res.stacked.models.cpu().numpy()),
           "losses": [float(x) for x in res.losses], "train_s": res.timings["train_s"],
           "gather_s": res.timings["gather_s"]}
    dist.destroy_process_group()
    print("MULTIPROC " + json.dumps(out), flush=True)
    return 0


def phase_multiproc(device, main: dict) -> dict:
    """Two processes on this card train the main configuration (10 workers
    × 89,611 × 500, 64 steps of K2), each its block of 5 workers, in a gloo
    group (rendezvous through a file under ``build/``): each block's W and
    chunk losses bitwise the ``main`` phase's one-process run's, the
    gathered sub-models and epoch losses too; zero collectives in training,
    and the merge phase's gathers counted (one ``all_gather`` for W, one for
    the chunk losses)."""
    import hashlib
    import os

    import numpy as np

    size = MULTIPROC_WORLD
    sha = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
    W = main["stacked"].models.cpu().numpy()
    L = np.concatenate(main["chunk_losses"], axis=1)
    store = ROOT / "build" / "multiproc_store"
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--multiproc-rank",
                               str(r), "--multiproc-store", str(store)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in range(size)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MULTIPROC_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        store.unlink(missing_ok=True)
    wall = time.perf_counter() - t0
    ranks = []
    for r, (p, text) in enumerate(zip(procs, outs)):
        line = next((ln for ln in text.splitlines() if ln.startswith("MULTIPROC ")), None)
        if p.returncode != 0 or line is None:
            raise RuntimeError(f"rank {r} failed ({p.returncode}):\n{text[-4000:]}")
        ranks.append(json.loads(line[len("MULTIPROC "):]))
    for info in ranks:
        lo = info["start"]
        hi = lo + NUM_WORKERS // size
        same = {"block W": info["block"]["w"] == sha(W[lo:hi]),
                "block chunk losses": info["block"]["losses"] == sha(L[lo:hi]),
                "gathered W": info["gathered_w"] == sha(W),
                "epoch losses": info["losses"] == [float(x) for x in main["losses"]]}
        gathers = {k: v for k, v in info["gather_counts"].items() if k.startswith("c10d::")}
        log(f"[multiproc] rank {info['rank']} of {size} ({info['backend']}), workers "
            f"[{lo}, {hi}): train {info['train_s']:.3f} s, launches "
            f"{ {k: v for k, v in info['launches'].items() if v} }, collectives in training "
            f"{info['train_counts']}; gather {info['gather_s']:.3f} s, {gathers}; bitwise the "
            f"one-process run: {same}")
        if not all(same.values()):
            raise RuntimeError(f"rank {info['rank']} is not bitwise the one-process run")
        if info["train_counts"]:
            raise RuntimeError(f"training made collectives: {info['train_counts']}")
        if gathers != {"c10d::allgather_": 2}:
            raise RuntimeError(f"the merge phase's gathers {gathers}, expected 2 all_gathers")
        if info["launches"].get("sgns_fused_step") != main["steps"]:
            raise RuntimeError(f"rank {info['rank']}: K2 launches {info['launches']}")
    log(f"[multiproc] {size} processes on one card: {wall:.1f} s in all "
        f"({nvidia_smi_line()})")
    return {"ranks": ranks, "wall_s": wall,
            "launches": {"sgns_fused_step": sum(i["launches"]["sgns_fused_step"]
                                                for i in ranks)}}


def phase_budget(device) -> dict:
    """The on-chip budget held to the card: one step of each engine with a
    kernel (K2, K3, K4a, K4b + K1, K5, K6) and one K7 call at the dryrun's
    width; ``cudaFuncGetAttributes`` of each instantiation they launched
    against :mod:`repro_torch.analysis.vmem`'s estimate (static and dynamic
    shared memory must be equal), the registers and spills of every
    instantiation of every library printed; then the ``stamps`` variant of
    K2's and K4a's launch (``analysis/block_step_variants.py``) at the main
    path's shapes, its ``%globaltimer`` marks held to
    ``analysis/dma_model.check_timeline``."""
    import ctypes

    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.analysis import block_step_variants as BV
    from repro_torch.analysis import dma_model, vmem
    from repro_torch.core.async_trainer import AsyncShardTrainer
    from repro_torch.core.engine import get_engine
    from repro_torch.core.sgns import SGNSConfig
    from repro_torch.data.pairs import stack_noise_tables
    from repro_torch.kernels import build, sgns_fused
    from repro_torch.kernels.sgns_block_step import _sms, run_block_step
    from repro_torch.kernels.swa_decode import swa_decode

    gpu = nvidia_smi_line()
    V, d, K, B = 5_000, DIM, 5, BATCH
    cfg = SGNSConfig(vocab_size=V, dim=d, negatives=K)
    rows, mismatched = [], []
    engines = [get_engine(s) for s in ("rowgrad", "fused", "fused_hbm", "fused_pipe",
                                       "fused_tiered")] + [
        get_engine("fused_hbm", sequential=True)]
    rng = np.random.default_rng(0)
    for eng in engines:
        tr = AsyncShardTrainer(cfg=cfg, num_workers=1, total_steps=2, engine=eng,
                               device=device)
        params = tr.init(prng.PRNGKey(0))
        table = tr.device_table(stack_noise_tables([np.arange(V, 0, -1)], kind=eng.table_kind))
        c, x = (rng.integers(0, V, (1, 1, B), dtype=np.int32) for _ in range(2))
        tr.epoch(params, c, x, table, prng.PRNGKey(1))
        torch.cuda.synchronize(device)
        est = vmem.check_vmem_budget(eng, vocab_size=V, dim=d, negatives=K, batch=B)
        rows += vmem.card_check(est)
    est = vmem.estimate_swa_decode(batch=4, window=4096, heads=32, kv_heads=8, head_dim=80)
    g = torch.Generator(device=device).manual_seed(0)
    swa_decode(torch.randn((4, 32, 80), generator=g, device=device),
               torch.randn((4, 4096, 8, 80), generator=g, device=device),
               torch.randn((4, 4096, 8, 80), generator=g, device=device))
    torch.cuda.synchronize(device)
    rows += vmem.card_check(est)
    for r in rows:
        log(f"[budget] {r['kernel']:40s} shared static {r['static']} (card {r['card_static']}), "
            f"dynamic {r['dynamic']} (card {r['card_dynamic']}); registers {r['regs']} "
            f"(bound {r['max_regs']}), spills {r['spill_bytes']} B: "
            f"{'match' if r['match'] else 'MISMATCH'}")
        if not r["match"]:
            mismatched.append(r["kernel"])
    spills = {}
    for lib in build.SOURCES:
        for a in build.kernel_attributes(lib):
            spills[a.name] = (a.regs, a.local_bytes)
            if a.local_bytes:
                log(f"[budget] spills: {lib} {a.name}: {a.regs} registers, {a.local_bytes} B "
                    f"of local memory a thread")
    log(f"[budget] {len(spills)} instantiations in {len(build.SOURCES)} libraries; "
        f"{sum(1 for _, s in spills.values() if s)} spill ({gpu})")
    if mismatched:
        raise RuntimeError(f"the vmem estimate disagrees with the card for {mismatched}")

    # the card's timeline against the launch's phase order
    paths = BV.build_variants(["stamps"], build.build_dir().parent / "block_step_variants")
    n, Vm = NUM_WORKERS, 89_611
    table = zipf_alias_table(Vm, n, device)
    cen = sgns_fused.sample_negatives_plain(seeds_for(n, 1, device), table["prob"],
                                            table["alias"], (B,))
    ctx = sgns_fused.sample_negatives_plain(seeds_for(n, 2, device), table["prob"],
                                            table["alias"], (B,))
    timeline = {}
    try:
        for label, blk in (("K2", B), ("K4a", 256)):
            lib, sym, counter = BV.LIBS[label]
            BV._use(lib, paths[("stamps", lib)])
            params = {"W": 0.1 * torch.randn((n, Vm, d), generator=g, device=device),
                      "C": 0.1 * torch.randn((n, Vm, d), generator=g, device=device)}
            run_block_step(lib, sym, counter, params, cen, ctx, table, seeds_for(n, 3, device),
                           0.025, blk, K)
            torch.cuda.synchronize(device)
            stamps = np.zeros((1024, 64), dtype=np.uint64)
            err = build._libs[lib].stamps_read(ctypes.c_void_p(stamps.ctypes.data))
            if err:
                raise RuntimeError(f"stamps_read failed with {err}")
            geo = dma_model.block_geometry(n, d, B, K, blk, _sms(device))
            bad = dma_model.check_timeline(stamps[:geo.groups * geo.group_ctas], geo, label)
            t = stamps[:geo.groups * geo.group_ctas].astype(np.int64)
            t0 = t[:, 0][t[:, 0] > 0].min()
            log(f"[budget] {label} stamps: {geo.groups} groups x {geo.group_ctas} CTAs, "
                f"{geo.nblocks} blocks, {geo.sorters} sorters; last draw written "
                f"{(t[:, 5].max() - t0) / 1e3:.1f} us, first C-list keys loaded "
                f"{(t[:geo.sorters:2, 1].min() - t0) / 1e3:.1f} us from the launch's first "
                f"mark; model violations: {[str(v) for v in bad] or 'none'}")
            timeline[label] = len(bad)
            del params
            if bad:
                raise RuntimeError(f"{label}'s timeline breaks the launch's phase order")
    finally:
        for lib in ("sgns_fused_step", "sgns_fused_hbm"):
            BV._use(lib, build.library_path(lib))
    return {"rows": rows, "spills": spills, "timeline": timeline}


PROFILE_GROUPS = {
    "main": (("K2", ("block_step_kernel",)),
             ("sorts (none since the launch sorts)", ("sort",)),
             ("copies and memsets", ("memcpy", "memset"))),
    "hbm": (("K4a", ("block_step_kernel",)),
            ("sorts (none since the launch sorts)", ("sort",)),
            ("copies and memsets", ("memcpy", "memset"))),
    "pipe": (("K5", ("pipe_chain_kernel",)), ("K1", ("sample_negatives_kernel",)),
             ("block sorts (K4a's two)", ("sort",)),
             ("copies", ("memcpy",))),
    "decode": (("K7", ("swa_partial_kernel", "swa_combine_kernel")),
               ("matmuls (cuBLAS)", ("gemm", "gemv")),
               ("copies", ("memcpy",))),
    "archs": (("matmuls (cuBLAS)", ("gemm", "gemv")),
              ("sorts (top-k)", ("sort",)),
              ("indexing (dispatch, combine, caches)", ("index", "scatter", "gather")),
              ("reductions", ("reduce",)),
              ("copies", ("memcpy", "copy")),
              ("elementwise", ("elementwise",))),
    "lm_train": (("matmuls (cuBLAS)", ("gemm", "gemv")),
                 ("softmax and log-sum-exp", ("softmax", "logsumexp")),
                 ("reductions", ("reduce",)),
                 ("copies", ("memcpy", "copy")),
                 ("elementwise", ("elementwise",))),
    "random": (("K3", ("row_grads_",)),
               ("ordered apply (index_put_: stable sort, serial adds)",
                ("indexing_backward", "index_put", "radixsort")),
               ("gathers (indexing)", ("index_elementwise", "gather", "indexselect")),
               ("-lr x gradients", ("aunaryfunctor<float, float, float",)),
               ("CDF draw: searchsorted", ("searchsorted",)),
               ("int64 ops (the CDF draw's threefry, id offsets)", ("<long", "add<long>")),
               ("copies", ("memcpy",))),
}


def phase_profile(device, label: str, kw: dict) -> None:
    """A path's training once more under torch.profiler: the device's busy
    time inside the driver's ``repro_torch.train_loop`` span (the union of
    kernel and copy intervals), its idle share, and device time per step
    by kernel group (``PROFILE_GROUPS[label]``; the rest is "other")."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.driver import train_submodels

    corpus, _ = world()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = train_submodels(corpus, VOCAB, device=device, **kw)
        torch.cuda.synchronize(device)
    steps = res.timings["steps_per_epoch"]
    summary = _device_summary(prof, "repro_torch.train_loop", steps, PROFILE_GROUPS[label],
                              DeviceType)
    summary = {"steps": steps, "train_loop_us": summary.pop("window_us"),
               "chunk_wait_s": res.timings["chunk_wait_s"], **summary}
    _write_profile(label, prof, summary)
    if label in ("main", "hbm") and any("sample_negatives" in k["name"]
                                        for k in summary["kernels"]):
        raise RuntimeError(f"the {label} path launched K1: its step draws inside its launch")
    window, busy = summary["train_loop_us"], summary["device_busy_us"]
    log(f"[profile] {label} ({kw['strategy']}, {kw['engine']}): train loop "
        f"{window / 1e3:.1f} ms for {steps} steps ({window / steps / 1e3:.3f} ms/step), "
        f"of which {res.timings['chunk_wait_s'] * 1e3:.1f} ms blocked on chunks; device "
        f"busy {busy / 1e3:.1f} ms, idle share {summary['idle_share']:.3f}")
    for g, v in summary["device_us_per_step"].items():
        log(f"[profile]   {g}: {v:.1f} us/step")
    for k in summary["kernels"][:8]:
        log(f"[profile]     {k['device_us'] / steps:8.1f} us/step  x{k['count']:<5d} "
            f"{k['name'][:90]}")


def _union_us(spans, start: float) -> float:
    """The length of the union of ``(start, end)`` intervals that begin at
    or after ``start``."""
    busy, end = 0.0, start
    for s, f in sorted(spans):
        if f > end:
            busy += f - max(s, end)
            end = f
    return busy


def _device_summary(prof, span: str, steps: int, groups, DeviceType) -> dict:
    """Inside the host span named ``span``: the window, the device's busy
    time (the union of kernel and copy intervals), its idle share, device
    µs a step by kernel group (a name goes to the first group it matches;
    the rest is "other") and the kernels by device time."""
    events = list(prof.events())
    loop = next(e for e in events if e.name == span)
    t0, t1 = loop.time_range.start, loop.time_range.end
    spans, by_kernel = [], {}
    for e in events:
        if (e.device_type != DeviceType.CUDA or "Command Buffer" in e.name
                or e.name.startswith("repro_torch.")):      # annotations
            continue
        s, f = max(e.time_range.start, t0), min(e.time_range.end, t1)
        if f <= s:
            continue
        spans.append((s, f))
        k = by_kernel.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += f - s
    busy = _union_us(spans, t0)
    per_step = {g: 0.0 for g, _ in groups}
    per_step["other"] = 0.0
    for name, (_, us) in by_kernel.items():
        g = next((g for g, pats in groups if any(p in name.lower() for p in pats)),
                 "other")
        per_step[g] += us / steps
    window = t1 - t0
    return {"window_us": window, "device_busy_us": busy, "idle_share": 1.0 - busy / window,
            "device_us_per_step": per_step,
            "kernels": sorted(({"name": n, "count": c, "device_us": us}
                               for n, (c, us) in by_kernel.items()),
                              key=lambda k: -k["device_us"])}


def _write_profile(label: str, prof, summary: dict, trace: bool = True) -> None:
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"profile_{label}.json").write_text(json.dumps(summary, indent=1))
    if trace:
        prof.export_chrome_trace(str(out / f"profile_{label}_trace.json"))


def _bound(ms, plain_ms, nbytes, flops) -> dict:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "bytes": int(nbytes), "flops": int(flops),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    # one rank of the multiproc phase (the phase starts these itself)
    ap.add_argument("--multiproc-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--multiproc-store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if "time" in phases and not {"main", "random"} <= set(phases):
        ap.error("the time phase needs the main and random phases")
    if "profile" in phases and not {"main", "random", "decode"} & set(phases):
        ap.error("the profile phase needs the main, random or decode phase")
    if "pipe" in phases and "hbm" not in phases:
        ap.error("the pipe phase needs the hbm phase")
    if {"sync", "merge", "serve", "multiproc"} & set(phases) and "main" not in phases:
        ap.error("the multiproc, sync, merge and serve phases need the main phase")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              f"(no src/repro_torch)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if args.multiproc_rank is not None:
        return multiproc_rank(args.multiproc_rank, MULTIPROC_WORLD, args.multiproc_store)
    device = torch.device("cuda", 0)
    gpu = nvidia_smi_line()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"on {torch.cuda.get_device_name(0)} ({gpu})")

    t_start = time.perf_counter()
    results: dict = {}
    walls: dict = {}

    def run(name, fn, *args, **kwargs):
        # each phase's wall, printed as it ends
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        walls[name] = time.perf_counter() - t0
        log(f"[env] phase {name}: {walls[name]:.1f} s")
        torch.cuda.empty_cache()
        return out

    if "build" in phases:
        run("build", phase_build)
    if "k1" in phases:
        results["k1"] = run("k1", phase_k1, device)
    if "k2" in phases:
        results["k2"] = run("k2", phase_k2, device)
    if "main" in phases:
        results["main"] = run("main", phase_main, device)
    if "multiproc" in phases:
        results["multiproc"] = run("multiproc", phase_multiproc, device, results["main"])
    if "sync" in phases:
        results["sync"] = run("sync", phase_sync, device, results["main"])
    if "merge" in phases:
        results["merge"] = run("merge", phase_merge, device, results["main"])
    if "serve" in phases:
        results["serve"] = run("serve", phase_serve, device, results["main"])
    if "main" in results:
        for k in ("stacked", "alir_pca"):          # the sub-models are merged and served
            results["main"].pop(k)
        torch.cuda.empty_cache()
    for name, fn in (("cli", phase_cli), ("random", phase_random), ("hbm", phase_hbm)):
        if name in phases:
            results[name] = run(name, fn, device)
    if "pipe" in phases:
        results["pipe"] = run("pipe", phase_pipe, device, results["hbm"])
    if "elastic" in phases:
        results["elastic"] = run("elastic", phase_elastic, device)
    if "contracts" in phases:
        results["contracts"] = run("contracts", phase_contracts, device)
    if "dryrun" in phases:
        results["dryrun"] = run("dryrun", phase_dryrun, device)
    if "budget" in phases:
        results["budget"] = run("budget", phase_budget, device)
    if "time" in phases:
        results["time"] = run("time", phase_time, device, results["main"], results["random"])
    if "profile" in phases:
        t0 = time.perf_counter()
        for label in ("main", "random", "hbm"):
            if label in results:
                phase_profile(device, label, results[label]["train_kw"])
        if "pipe" in results:
            phase_profile(device, "pipe", results["pipe"]["pipe"]["train_kw"])
        log(f"[env] phase profile (training loops): {time.perf_counter() - t0:.1f} s")
    if "decode" in phases:
        torch.cuda.empty_cache()
        results["decode"] = run("decode", phase_decode, device, profile="profile" in phases)
    if "lm_train" in phases:
        torch.cuda.empty_cache()
        results["lm_train"] = run("lm_train", phase_lm_train, device)
    if "archs" in phases:
        torch.cuda.empty_cache()
        results["archs"] = run("archs", phase_archs, device)
    if "sharding" in phases:
        torch.cuda.empty_cache()
        results["sharding"] = run("sharding", phase_sharding, device)

    if set(PHASES) - {"build", "profile"} <= set(phases):
        # launches: each kernel's count over its own path's training run
        launches = {
            # K1: the pipe path's draw (main and hbm draw inside their launch)
            "sample_negatives": results["pipe"]["pipe"]["launches"]["sample_negatives"],
            "sgns_fused_step": results["main"]["launches"]["sgns_fused_step"],
            "sgns_row_grads": results["random"]["launches"]["sgns_row_grads"],
            "sgns_fused_hbm_step": results["hbm"]["launches"]["sgns_fused_hbm_step"],
            "sgns_fused_hbm_step_sequential":
                results["hbm"]["launches_seq"]["sgns_fused_hbm_step"],
            "sgns_fused_pipe_step":
                results["pipe"]["pipe"]["launches"]["sgns_fused_pipe_step"],
            "sgns_fused_tiered_step":
                results["pipe"]["tiered"]["launches"]["sgns_fused_tiered_step"],
            "swa_decode": results["decode"]["launches"]["swa_decode"],
        }
        timed = {**results["time"], "swa_decode": results["decode"]["time"]}
        kernels = []
        for name, n_launches in launches.items():
            t = timed[name]
            kernels.append({
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": n_launches,
                # against the plain version at the path's shapes
                "max_abs_err": t["max_abs_err"],
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"],
                # K7: scaled_dot_product_attention(enable_gqa=True); no single
                # PyTorch call computes any of the others (torch.multinomial
                # draws other ids from the distribution)
                "library_ms": t.get("library_ms"),
            })
            if "row_traffic" in t:     # K5/K6: beside the launch alone and K4a
                kernels[-1].update({k: t[k] for k in ("alone_ms", "k4a_ms", "row_traffic")})
            if "k5_ms" in t:           # K2/K4a: the launch alone, beside K5
                kernels[-1].update({k: t[k] for k in ("alone_ms", "k5_ms", "torch_sorts_ms",
                                                      "block_pairs", "split")})
            if "longest_run" in t:     # each path's longest run of one row, per table
                kernels[-1]["longest_run"] = t["longest_run"]
            for k in ("empty_ms", "empty_device_us", "first_ms", "first_device_us",
                      "device_us"):   # K1 beside an empty launch, K3 beside its first design
                if k in t:
                    kernels[-1][k] = t[k]
        # K1 and K2 also run on this slice's paths: the sync baseline's draw
        # (K1 a step) and the periodic sync's local steps (K2 a step)
        dry = results["dryrun"]
        kernels[0]["launches_by_path"] = {
            "pipe": launches["sample_negatives"],
            "sync": results["sync"]["launches"]["sample_negatives"],
            "dryrun": dry["launches"].get("sample_negatives", 0)}
        kernels[1]["launches_by_path"] = {
            "main": launches["sgns_fused_step"],
            "periodic": results["sync"]["periodic_launches"]["sgns_fused_step"],
            "cli": results["cli"]["launches"]["sgns_fused_step"],
            "elastic": results["elastic"]["launches"]["fused"],
            "dryrun": dry["launches"].get("sgns_fused_step", 0),
            "multiproc": results["multiproc"]["launches"]["sgns_fused_step"]}
        # K3 also runs on the elastic path (rowgrad, 4 workers one at a time)
        kernels[2]["launches_by_path"] = {
            "random": launches["sgns_row_grads"],
            "elastic": results["elastic"]["launches"]["rowgrad"],
            "dryrun": dry["launches"].get("sgns_row_grads", 0)}
        for k in kernels[3:]:      # K4a, K5, K6 at the paper's width
            if k["name"] in dry["launches"]:
                k["launches_by_path"] = {"dryrun": dry["launches"][k["name"]]}
        # against the plain version on this slice's paths: the elastic path's
        # first chunk (n = 1), each engine's chunk in contracts (n = 2) and at
        # the paper's width in dryrun (n = 1)
        by_path = {"sgns_fused_step": results["elastic"]["max_abs_err"]["fused"],
                   "sgns_row_grads": results["elastic"]["max_abs_err"]["rowgrad"]}
        for k in kernels:
            k["max_abs_err_by_path"] = {
                **({"elastic": by_path[k["name"]]} if k["name"] in by_path else {}),
                **({"contracts": results["contracts"]["max_abs_err"][k["name"]]}
                   if k["name"] in results["contracts"]["max_abs_err"] else {}),
                **({"dryrun": dry["max_abs_err"][k["name"]]}
                   if k["name"] in dry["max_abs_err"] else {})}
            # registers, spills and shared memory a CTA as the card reports them
            lib = Path(k["source"]).stem
            k["budget"] = [{key: r[key] for key in ("kernel", "regs", "spill_bytes",
                                                    "card_static", "card_dynamic", "match")}
                           for r in results["budget"]["rows"] if r["lib"] == lib]
        print(json.dumps({"kernels": kernels}), flush=True)
    log(f"[env] phases {','.join(phases)} done in {time.perf_counter() - t_start:.1f} s")
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
