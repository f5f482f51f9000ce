// K2: one whole SGNS step for n workers — gathers, the forward in the
// softplus form max(x, 0) + log1p(exp(-|x|)) of the TPU kernel, the three
// row gradients and the accumulating apply — with every gradient taken from
// the pre-step tables.
//
// Replaces: repro/kernels/sgns_fused.py `_sgns_fused_kernel` (reached
// through `sgns_fused_step`). The TPU kernel holds both (V, d) tables in
// VMEM and applies the step with `.at[].add` on the resident copy. On the
// H100 the tables stay in HBM (80 GB holds the paper's 300k x 500 tables for
// ten workers). One persistent launch runs the step, as one kernel runs it on
// the TPU: K4a's block chain (`sgns_block_step.cuh`) with one block of all B
// pairs — the step's (n, B, K) negatives drawn inside it (the counter-hash
// `alias_draw` of K1, `sample_negatives.cu`, at the same counters, and
// written out for the wrapper to return), the sort of each worker's touched
// rows, every pair's gradients from the pre-step tables, then each touched
// row's addends applied serially in pair order and stored once (C at
// contexts, then negatives; W at centers). No float atomics, so the same
// inputs give the same bits on every run.
//
// Bound on the H100: memory. Per step the function must read each distinct
// touched row of W and C once and write it back once (195.5 MB at n = 10,
// V = 89,611, d = 500, B = 1024, K = 5: 0.058 ms at 3.35 TB/s), against ~7
// (K + 1) d flops a pair. The design's answers to the latency that held the
// earlier two-kernel version at a tenth of that bound (one launch; rows and
// addends fed by bulk copies; hot rows split over columns) are described in
// `sgns_block_step.cuh`.

#include "func_attrs.cuh"
#include "sgns_block_step.cuh"

// The arguments are `sgns::block_step_entry`'s; blk must be >= B.
extern "C" int sgns_fused_step_launch(
    void* W, void* C, void* loss, const void* centers, const void* contexts, void* ids,
    const void* seeds, const void* prob, const void* alias, void* w_rows, void* w_perm,
    void* c_rows, void* c_perm, void* coef, void* dW, void* wrows, void* items, void* n_items,
    void* counters, void* sort_mem, long long sort_bytes, int item_cap, int n, int V, int d,
    int B, int K, int blk, int group_ctas, int groups, int sorters, float neg_lr, int vec4,
    void* stream) {
  if (blk < B) return static_cast<int>(cudaErrorInvalidValue);
  return sgns::block_step_entry<false>(W, C, loss, centers, contexts, ids, seeds, prob, alias,
                                       w_rows, w_perm, c_rows, c_perm, coef, dW, wrows, items,
                                       n_items, counters, sort_mem, sort_bytes, item_cap, n, V,
                                       d, B, K, blk, group_ctas, groups, sorters, neg_lr, vec4,
                                       stream);
}

static const KernelEntry kKernels[] = {
    KERNEL_ENTRY("block_step_kernel<true,false>", sgns::block_step_kernel<true, false>),
    KERNEL_ENTRY("block_step_kernel<false,false>", sgns::block_step_kernel<false, false>),
};
KERNEL_ATTRS_EXPORT(kKernels)
