// K5: the SGNS step as a chain of pair blocks, one persistent launch per step
// for all workers, rows in place.
//
// Replaces: repro/kernels/sgns_fused_pipe.py `_pipe_kernel`, reached through
// `sgns_fused_pipe_step`. The kernel, its design on the H100 (no staging
// ring: rows in place, a barrier per worker between phases) and its bound are
// described in `sgns_pipe.cuh`, which it shares with K6
// (`sgns_fused_tiered.cu`).

#include "func_attrs.cuh"
#include "sgns_pipe.cuh"

// W, C (n, V, d) float32, updated in place; loss (n, B); centers, contexts
// (n, B) and ids (n, B, K) int32; w_keys/w_perm (n, B) and c_keys/c_perm
// (n, B (K + 1)), int32 rows and int64 indices: each worker's touched rows
// sorted stably by (block, row), K4a's sort; coef (n, blk, K + 1), dW and
// wrows (n, blk, d) scratch; arrive (n) int32 scratch; kH must be 0.
extern "C" int sgns_pipe_launch(void* W, void* C, void* loss, const void* centers,
                                const void* contexts, const void* ids, const void* w_keys,
                                const void* w_perm, const void* c_keys, const void* c_perm,
                                void* coef, void* dW, void* wrows, void* arrive, int n, int V,
                                int d, int B, int K, int blk, int kH, float neg_lr, int vec4,
                                void* stream) {
  if (kH != 0) return static_cast<int>(cudaErrorInvalidValue);
  return sgns::chain_launch<false>(W, C, loss, centers, contexts, ids, w_keys, w_perm, c_keys,
                                   c_perm, coef, dW, wrows, arrive, n, V, d, B, K, blk, kH,
                                   neg_lr, vec4, stream);
}

static const KernelEntry kKernels[] = {
    KERNEL_ENTRY("pipe_chain_kernel<4,false>", sgns::pipe_chain_kernel<4, false>),
    KERNEL_ENTRY("pipe_chain_kernel<1,false>", sgns::pipe_chain_kernel<1, false>),
};
KERNEL_ATTRS_EXPORT(kKernels)
