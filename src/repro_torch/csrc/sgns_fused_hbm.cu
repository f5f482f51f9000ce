// K4: the SGNS step as a chain of pair blocks, and word2vec's per-pair order.
//
// Replaces: repro/kernels/sgns_fused_hbm.py `_hbm_block_kernel` (K4a) and
// `_hbm_sequential_kernel` (K4b), reached through `sgns_fused_hbm_step`. On
// the TPU the (V, d) tables stay in HBM and each pair block DMAs its touched
// rows into VMEM; the chain of aliased invocations makes block b + 1 read
// block b's writes. On the H100 the tables live in HBM anyway; what this
// kernel keeps is the chain's *semantics*, which change the results:
//
// K4a (sgns_hbm_blocks_launch), per block of `blk` pairs (a shorter tail
//   block covers any remainder): every gradient from the tables as of block
//   start, then a deterministic apply in which each touched row's addends
//   come in reference order (W at centers; C at contexts, then negatives) and
//   are added serially with no float atomics. The work of a block is K2's two
//   phases (`sgns_step.cuh`) over the block's pair range, with the loss in
//   the log-sigmoid form of `sparse_row_grads_per_pair`. The wrapper sorts
//   each worker's touched rows once per step by (block, row), stably, so each
//   block's runs are one contiguous range of the sorted lists; the blocks are
//   launched in order on one stream, so block b + 1 reads block b's writes.
//   The pair range of a block is a strided slice of the (n, B) worker-major
//   layout: the kernels take the batch stride B and the block's first pair.
// K4b (sgns_hbm_sequential_launch), one CTA per worker walks its B pairs in
//   order: each pair's rows are read as every earlier pair left them, its
//   W row and context row are written, then each negative row is re-read and
//   added to. Every thread owns fixed columns of every row, so a re-read of a
//   row this CTA wrote (the context row as a negative, a repeated negative,
//   the next pair's rows) is ordered by the thread's own program order; only
//   the K + 1 dot products cross threads (warp shuffles, then shared memory).
//
// Negatives: K1's draw of the whole step's (n, B, K) ids (the wrapper's
// launch of `sample_negatives.cu`), which equals the per-block draws at the
// pairs' global counters (`_block_negative_ids`).
//
// Bound on the H100: memory for K4a — per block, each unique touched row is
// read once and written once; the dot products and the apply are ~7 (K + 1)
// d + 2 d flops a pair. K4b is latency-bound by nature (B dependent rounds
// of loads, reduction and stores per worker; one SM per worker): it is the
// update-order oracle, not a throughput path.

#include "sgns_step.cuh"

namespace {

constexpr int kSeqThreads = 128;
constexpr int kSeqWarps = kSeqThreads / 32;

// W, C (n, V, d): no __restrict__ — the context row and the negative rows
// may be one row, written and re-read within a pair.
__global__ void __launch_bounds__(kSeqThreads)
sgns_sequential_kernel(float* W, float* C, const int* __restrict__ centers,
                       const int* __restrict__ contexts, const int* __restrict__ ids,
                       int V, int d, int B, int K, float neg_lr,
                       float* __restrict__ loss) {
  __shared__ float partial[kSeqWarps][sgns::kMaxNegatives + 1];
  __shared__ float total[sgns::kMaxNegatives + 1];
  const int w = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* Wt = W + static_cast<long long>(w) * V * d;
  float* Ct = C + static_cast<long long>(w) * V * d;

  for (int p = 0; p < B; ++p) {
    const long long wp = static_cast<long long>(w) * B + p;
    float* wrow = Wt + static_cast<long long>(centers[wp]) * d;
    float* cpos = Ct + static_cast<long long>(contexts[wp]) * d;
    float* cneg[sgns::kMaxNegatives];
#pragma unroll
    for (int k = 0; k < sgns::kMaxNegatives; ++k) {
      cneg[k] = Ct + static_cast<long long>(k < K ? ids[wp * K + k] : 0) * d;
    }

    // The K + 1 dot products on the rows as every earlier pair left them.
    float s[sgns::kMaxNegatives + 1];
#pragma unroll
    for (int k = 0; k <= sgns::kMaxNegatives; ++k) s[k] = 0.0f;
    for (int e = tid; e < d; e += kSeqThreads) {
      const float wv = wrow[e];
      s[0] += wv * cpos[e];
#pragma unroll
      for (int k = 0; k < sgns::kMaxNegatives; ++k) {
        if (k < K) s[k + 1] += wv * cneg[k][e];
      }
    }
#pragma unroll
    for (int k = 0; k <= sgns::kMaxNegatives; ++k) {
      if (k <= K) {
        const float v = sgns::warp_sum(s[k]);
        if (lane == 0) partial[warp][k] = v;
      }
    }
    __syncthreads();
    if (tid <= K) {
      float v = 0.0f;
#pragma unroll
      for (int i = 0; i < kSeqWarps; ++i) v += partial[i][tid];
      total[tid] = v;
    }
    __syncthreads();
    const float s_pos = total[0];
    const float g_pos = sgns::sigmoid(s_pos) - 1.0f;
    float g[sgns::kMaxNegatives];
    float l_neg = 0.0f;
#pragma unroll
    for (int k = 0; k < sgns::kMaxNegatives; ++k) {
      if (k < K) {
        g[k] = sgns::sigmoid(total[k + 1]);
        l_neg += sgns::log_sigmoid(-total[k + 1]);
      } else {
        g[k] = 0.0f;
      }
    }
    if (tid == 0) loss[wp] = -sgns::log_sigmoid(s_pos) - l_neg;

    // The batch-1 sparse step, column by column: dW from the pair's rows
    // (no column of C is written yet), then W, the context row, and each
    // negative row re-read after every earlier write to it.
    for (int e = tid; e < d; e += kSeqThreads) {
      const float wv = wrow[e];
      const float cp = cpos[e];
      float acc = __fmul_rn(g[0], cneg[0][e]);
#pragma unroll
      for (int k = 1; k < sgns::kMaxNegatives; ++k) {
        if (k < K) acc = __fadd_rn(acc, __fmul_rn(g[k], cneg[k][e]));
      }
      const float dw = __fadd_rn(__fmul_rn(g_pos, cp), acc);
      wrow[e] = __fadd_rn(wv, __fmul_rn(neg_lr, dw));
      cpos[e] = __fadd_rn(cp, __fmul_rn(neg_lr, __fmul_rn(g_pos, wv)));
#pragma unroll
      for (int k = 0; k < sgns::kMaxNegatives; ++k) {
        if (k < K) {
          cneg[k][e] = __fadd_rn(cneg[k][e], __fmul_rn(neg_lr, __fmul_rn(g[k], wv)));
        }
      }
    }
    __syncthreads();   // `total` is rewritten by the next pair
  }
}

}  // namespace

// K4a. W, C (n, V, d) float32, updated in place; centers, contexts (n, B)
// int32; ids (n, B, K) int32; loss (n, B); coef (n, B, K+1) and dW (n, B, d)
// scratch; c_keys/c_perm (n, B*(K+1)) and w_keys/w_perm (n, B): each
// worker's touched rows sorted stably by (block, row). Launches three kernels
// per block, blocks in order on `stream`.
extern "C" int sgns_hbm_blocks_launch(void* W, void* C, const void* centers,
                                      const void* contexts, const void* ids, int n, int V,
                                      int d, int B, int K, int blk, void* loss, void* coef,
                                      void* dW, const void* c_keys, const void* c_perm,
                                      const void* w_keys, const void* w_perm, float neg_lr,
                                      int vec4, void* stream) {
  if (n == 0 || B == 0) return 0;
  if (K < 1 || K > sgns::kMaxNegatives || blk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto* Wf = static_cast<float*>(W);
  auto* Cf = static_cast<float*>(C);
  for (int p0 = 0; p0 < B; p0 += blk) {
    const int nb = blk < B - p0 ? blk : B - p0;
    const cudaError_t err =
        vec4 ? sgns::run_block<4, true>(n, V, d, B, K, p0, nb, Wf, Cf, centers, contexts,
                                        ids, loss, coef, dW, c_keys, c_perm, w_keys,
                                        w_perm, neg_lr, s)
             : sgns::run_block<1, true>(n, V, d, B, K, p0, nb, Wf, Cf, centers, contexts,
                                        ids, loss, coef, dW, c_keys, c_perm, w_keys,
                                        w_perm, neg_lr, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// K4b. Same tables and ids; loss (n, B). One CTA per worker.
extern "C" int sgns_hbm_sequential_launch(void* W, void* C, const void* centers,
                                          const void* contexts, const void* ids, int n,
                                          int V, int d, int B, int K, float neg_lr,
                                          void* loss, void* stream) {
  if (n == 0 || B == 0) return 0;
  if (K < 1 || K > sgns::kMaxNegatives) return static_cast<int>(cudaErrorInvalidValue);
  sgns_sequential_kernel<<<n, kSeqThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(W), static_cast<float*>(C), static_cast<const int*>(centers),
      static_cast<const int*>(contexts), static_cast<const int*>(ids), V, d, B, K, neg_lr,
      static_cast<float*>(loss));
  return static_cast<int>(cudaGetLastError());
}
