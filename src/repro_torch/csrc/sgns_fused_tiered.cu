// K6: K5's block chain with a hot tier: ids below kH are read and updated in
// place in the tables, never gathered into the ring; the rest go through K5's
// ring. One cooperative launch per step for all workers.
//
// Replaces: repro/kernels/sgns_fused_tiered.py `_tiered_kernel`, reached
// through `sgns_fused_tiered_step`. The reference pins a copy of the first kH
// rows of each table in VMEM for the whole step; on the H100 a copy would sit
// in device memory beside the rows it copies (2 x 256 x 500 x 4 B = 1 MB a
// worker at the main path's hot_rows = 256, beyond one SM's shared memory),
// so the rows stay where they are and the L2 keeps the hot ones. Nor is there
// a spill row: an element's update target is its slot or its hot row, never
// both. Design, bits and bound: `sgns_pipe.cuh`.

#include "sgns_pipe.cuh"

// K5's arguments (`sgns_fused_pipe.cu`) with kH >= 1; the plan was made with
// hot_rows = kH.
extern "C" int sgns_tiered_launch(void* W, void* C, void* loss, const void* uw,
                                  const void* uc, const void* n_w, const void* n_c,
                                  const void* hazard, const void* w_pos, const void* cp_pos,
                                  const void* cn_pos, const void* cen, const void* ctx,
                                  const void* neg, const void* w_tgt, const void* w_el,
                                  const void* c_tgt, const void* c_el, void* ring, void* coef,
                                  void* dW, int n, int V, int d, int B, int K, int blk, int nb,
                                  int kH, float neg_lr, int vec4, void* stream) {
  if (kH < 1 || kH > V) return static_cast<int>(cudaErrorInvalidValue);
  return sgns::pipe_launch<true>(W, C, loss, uw, uc, n_w, n_c, hazard, w_pos, cp_pos, cn_pos,
                                 cen, ctx, neg, w_tgt, w_el, c_tgt, c_el, ring, coef, dW, n, V,
                                 d, B, K, blk, nb, kH, neg_lr, vec4, stream);
}
