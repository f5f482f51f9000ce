// K6: K5's block chain with a hot tier: loads and stores of rows below kH
// carry an L2 evict_last policy (the others evict_first), and the step's hot
// rows go back to normal priority at its end. One persistent launch per step
// for all workers.
//
// Replaces: repro/kernels/sgns_fused_tiered.py `_tiered_kernel`, reached
// through `sgns_fused_tiered_step`. The reference pins a copy of the first kH
// rows of each table in VMEM for the whole step; on the H100 a copy would sit
// in device memory beside the rows it copies (2 x 256 x 500 x 4 B = 1 MB a
// worker at the main path's hot_rows = 256, beyond one SM's shared memory),
// so the rows stay where they are and the L2 is asked to keep the hot ones.
// Design, bits and bound: `sgns_pipe.cuh`.

#include "func_attrs.cuh"
#include "sgns_pipe.cuh"

// K5's arguments (`sgns_fused_pipe.cu`) with 1 <= kH <= V.
extern "C" int sgns_tiered_launch(void* W, void* C, void* loss, const void* centers,
                                  const void* contexts, const void* ids, const void* w_keys,
                                  const void* w_perm, const void* c_keys, const void* c_perm,
                                  void* coef, void* dW, void* wrows, void* arrive, int n, int V,
                                  int d, int B, int K, int blk, int kH, float neg_lr, int vec4,
                                  void* stream) {
  if (kH < 1 || kH > V) return static_cast<int>(cudaErrorInvalidValue);
  return sgns::chain_launch<true>(W, C, loss, centers, contexts, ids, w_keys, w_perm, c_keys,
                                  c_perm, coef, dW, wrows, arrive, n, V, d, B, K, blk, kH,
                                  neg_lr, vec4, stream);
}

static const KernelEntry kKernels[] = {
    KERNEL_ENTRY("pipe_chain_kernel<4,true>", sgns::pipe_chain_kernel<4, true>),
    KERNEL_ENTRY("pipe_chain_kernel<1,true>", sgns::pipe_chain_kernel<1, true>),
};
KERNEL_ATTRS_EXPORT(kKernels)
