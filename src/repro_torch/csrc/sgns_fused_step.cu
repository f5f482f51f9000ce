// K2: one whole SGNS step for n workers — gathers, the forward in the
// softplus form max(x, 0) + log1p(exp(-|x|)) of the TPU kernel, the three
// row gradients and the accumulating apply — with every gradient taken from
// the pre-step tables.
//
// Replaces: repro/kernels/sgns_fused.py `_sgns_fused_kernel` (reached
// through `sgns_fused_step`). The TPU kernel holds both (V, d) tables in
// VMEM and applies the step with `.at[].add` on the resident copy. On the
// H100 the tables stay in HBM (80 GB holds the paper's 300k x 500 tables for
// ten workers), and a grid of independent blocks cannot carry "all reads
// before any write" through one launch, so the step is planned, then run in
// two phases:
//
//   draw and plan (the wrapper): K1 (`sample_negatives.cu`, the same
//     counter-hash `alias_draw`, counter = pair * K + k restarting at 0 for
//     each worker and step) draws the step's (n, B, K) negative ids; each
//     worker's touched-row lists are stable-sorted, the index planning that
//     `plan_blocks` does in the JAX package (which likewise replays the draw
//     outside its kernel). The ids are 20 bytes per pair.
//   phase 1 (sgns_pairs_kernel), one warp per (worker, pair): gather w,
//     c_pos and the K c_neg rows with 16-byte loads, reduce the K + 1 dot
//     products with warp shuffles, and write the per-pair loss, the K + 1
//     sigmoid coefficients and dW = g_pos c_pos + sum_k g_k c_k to scratch.
//     No table is written: dW needs the pre-step C rows, dC the pre-step w.
//   phase 2 (apply kernels), deterministic: one warp per distinct touched
//     row applies that row's addends one by one in pair order and stores the
//     row once: C at contexts then C at negatives (source rows: pre-step W,
//     still unwritten), then W at centers (source: the dW scratch). No float
//     atomics, so the same inputs give the same bits on every run.
//
// Both phases live in `sgns_step.cuh`, shared with K4 (`sgns_fused_hbm.cu`),
// which runs them once per pair block.
//
// Rounding: the apply computes each addend as (-lr) * (g * w_e) and each
// accumulation as a separate round-to-nearest add (__fmul_rn/__fadd_rn, so
// nvcc cannot contract them into FMAs), the same expression tree and order
// as the reference's scatter-adds. The dot products are reduced in another
// order than XLA's, which is where the port differs from the reference in
// the last bits.
//
// Bound on the H100: memory. Per step the function must read each touched
// row of W and C once and write it back once (at n = 10, B = 1024, K = 5,
// d = 500 at most n*B*(K+2) rows, ~143 MB each way), against ~5 flops per
// gathered element. This first version reads the gathered rows twice in
// phase 1 (the second pass mostly from L1/L2), writes and re-reads the dW
// scratch, and re-reads a center's W row once per C addend; a later
// version can keep rows in shared memory and fuse the phases per row.

#include "sgns_step.cuh"

// Phase 1. W, C (n, V, d) float32; centers, contexts (n, B) int32;
// ids (n, B, K) int32 (K1's draw). Writes loss (n, B), coef (n, B, K+1)
// and dW (n, B, d).
extern "C" int sgns_pairs_launch(const void* W, const void* C, const void* centers,
                                 const void* contexts, const void* ids, int n, int V,
                                 int d, int B, int K, void* loss, void* coef,
                                 void* dW, int vec4, void* stream) {
  if (n == 0 || B == 0) return 0;
  if (K < 1 || K > sgns::kMaxNegatives) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      vec4 ? sgns::launch_pairs<4, false>(n, V, d, B, K, 0, B, W, C, centers, contexts,
                                          ids, loss, coef, dW, s)
           : sgns::launch_pairs<1, false>(n, V, d, B, K, 0, B, W, C, centers, contexts,
                                          ids, loss, coef, dW, s);
  return static_cast<int>(err);
}

// Phase 2. c_keys/c_perm (n, B*(K+1)): sorted concat(contexts, ids);
// w_keys/w_perm (n, B): sorted centers. Updates C, then W, in place.
extern "C" int sgns_apply_launch(void* W, void* C, const void* centers,
                                 const void* coef, const void* dW,
                                 const void* c_keys, const void* c_perm,
                                 const void* w_keys, const void* w_perm, int n,
                                 int V, int d, int B, int K, float neg_lr, int vec4,
                                 void* stream) {
  if (n == 0 || B == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto* Cf = static_cast<float*>(C);
  auto* Wf = static_cast<float*>(W);
  const int Lc = B * (K + 1);
  cudaError_t err =
      vec4 ? sgns::launch_apply<4, true>(n, V, d, B, K, Lc, 0, Lc, Cf, W, centers, coef,
                                         dW, c_keys, c_perm, neg_lr, s)
           : sgns::launch_apply<1, true>(n, V, d, B, K, Lc, 0, Lc, Cf, W, centers, coef,
                                         dW, c_keys, c_perm, neg_lr, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = vec4 ? sgns::launch_apply<4, false>(n, V, d, B, K, B, 0, B, Wf, nullptr, centers,
                                            coef, dW, w_keys, w_perm, neg_lr, s)
             : sgns::launch_apply<1, false>(n, V, d, B, K, B, 0, B, Wf, nullptr, centers,
                                            coef, dW, w_keys, w_perm, neg_lr, s);
  return static_cast<int>(err);
}
