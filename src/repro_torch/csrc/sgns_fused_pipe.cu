// K5: the SGNS step as a chain of pair blocks over deduplicated rows through
// a two-slot ring, one cooperative launch per step for all workers.
//
// Replaces: repro/kernels/sgns_fused_pipe.py `_pipe_kernel`, reached through
// `sgns_fused_pipe_step`. The kernel, its design on the H100 (the ring lives
// in device memory) and its bound are described in `sgns_pipe.cuh`, which it
// shares with K6 (`sgns_fused_tiered.cu`).

#include "sgns_pipe.cuh"

// W, C (n, V, d) float32, updated in place; loss (n, B); the plan's int32
// tensors (`repro_torch.kernels.sgns_fused_pipe.PipelinePlan`) and the apply
// order (targets and elements sorted by (block, target)); ring (2, n, R_W +
// R_C, d), coef and dW scratch; kH must be 0.
extern "C" int sgns_pipe_launch(void* W, void* C, void* loss, const void* uw, const void* uc,
                                const void* n_w, const void* n_c, const void* hazard,
                                const void* w_pos, const void* cp_pos, const void* cn_pos,
                                const void* cen, const void* ctx, const void* neg,
                                const void* w_tgt, const void* w_el, const void* c_tgt,
                                const void* c_el, void* ring, void* coef, void* dW, int n,
                                int V, int d, int B, int K, int blk, int nb, int kH,
                                float neg_lr, int vec4, void* stream) {
  if (kH != 0) return static_cast<int>(cudaErrorInvalidValue);
  return sgns::pipe_launch<false>(W, C, loss, uw, uc, n_w, n_c, hazard, w_pos, cp_pos, cn_pos,
                                  cen, ctx, neg, w_tgt, w_el, c_tgt, c_el, ring, coef, dW, n,
                                  V, d, B, K, blk, nb, kH, neg_lr, vec4, stream);
}
