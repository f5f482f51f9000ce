// Device code shared by the SGNS step kernels: K2 (`sgns_fused_step.cu`),
// K3 (`sgns_row_grads.cu`), K4 (`sgns_fused_hbm.cu`) and, through
// `sgns_pipe.cuh`, K5 and K6 (`sgns_fused_pipe.cu`, `sgns_fused_tiered.cu`).
//
// * 16-byte or scalar row loads, warp reductions, and the loss and sigmoid
//   forms of the JAX package's kernels;
// * the two phases of one sparse SGNS step over a range of pairs
//   [p0, p0 + nb) of every worker's batch:
//     sgns_pairs_kernel, one warp per (worker, pair): gathers w, c_pos and
//       the K c_neg rows, reduces the K + 1 dot products with warp shuffles,
//       writes the per-pair loss, the K + 1 sigmoid coefficients and
//       dW = g_pos c_pos + sum_k g_k c_k to scratch; no table is written;
//     sgns_apply_kernel, one warp per distinct touched row of a range of
//       each worker's stably sorted touched-row list: applies that row's
//       addends one by one in pair order and stores the row once. No float
//       atomics, so the same inputs give the same bits on every run.
//   K2 runs them once over the whole batch; K4 once per pair block. K5 and K6
//   (`sgns_pipe.cuh`) repeat the pair body's arithmetic, in its order, on
//   rows staged in shared memory.
//
// Rounding: every product and sum of the apply and of dW is a separate
// round-to-nearest operation (__fmul_rn/__fadd_rn, never contracted into an
// FMA), in the expression tree and order of the reference's scatter-adds.
// The dot products are reduced in another order than XLA's.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sgns {

constexpr int kMaxNegatives = 16;
constexpr int kWarps = 8;          // warps (pairs or rows) per block
constexpr int kTile = 4;           // VEC-wide loads per lane per row chunk
constexpr unsigned kFull = 0xFFFFFFFFu;

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// softplus(x) = max(x, 0) + log1p(exp(-|x|)), the form of the TPU kernels
// `_sgns_kernel` and `_sgns_fused_kernel`.
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// log σ(x) = min(x, 0) - log1p(exp(-|x|)), torch's form; the HBM kernels'
// loss is -log σ(s_pos) - sum_k log σ(-s_k) (`sparse_row_grads_per_pair`).
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// ---------------------------------------------------------------------------
// One pair's forward and row gradients, by one warp: the K + 1 dot products
// of `wrow` with `cpos` and the `cneg` rows (per-lane partial sums, then warp
// reductions), the loss (LOGSIG picks its form), the K + 1 sigmoid
// coefficients and dW = g_pos c_pos + sum_k g_k c_k, summed over k in order.
// Writes *loss_out, coef_out[0 .. K] and dw_out[0 .. d).
// ---------------------------------------------------------------------------
template <int VEC, bool LOGSIG>
__device__ __forceinline__ void pair_step(const float* wrow, const float* cpos,
                                          const float* const (&cneg)[kMaxNegatives], int K,
                                          int d, int lane, float* loss_out, float* coef_out,
                                          float* dw_out) {
  // K + 1 dot products: per-lane partial sums, then warp reductions.
  float s_pos = 0.0f;
  float s_neg[kMaxNegatives];
#pragma unroll
  for (int k = 0; k < kMaxNegatives; ++k) s_neg[k] = 0.0f;
  for (int e = lane * VEC; e < d; e += 32 * VEC) {
    float wv[VEC], cv[VEC];
    load_vec<VEC>(wrow + e, wv);
    load_vec<VEC>(cpos + e, cv);
#pragma unroll
    for (int v = 0; v < VEC; ++v) s_pos += wv[v] * cv[v];
#pragma unroll
    for (int k = 0; k < kMaxNegatives; ++k) {
      if (k < K) {
        load_vec<VEC>(cneg[k] + e, cv);
#pragma unroll
        for (int v = 0; v < VEC; ++v) s_neg[k] += wv[v] * cv[v];
      }
    }
  }
  s_pos = warp_sum(s_pos);
  float l_neg = 0.0f;
  float g_neg[kMaxNegatives];
#pragma unroll
  for (int k = 0; k < kMaxNegatives; ++k) {
    if (k < K) {
      s_neg[k] = warp_sum(s_neg[k]);
      l_neg += LOGSIG ? log_sigmoid(-s_neg[k]) : softplus(s_neg[k]);
      g_neg[k] = sigmoid(s_neg[k]);
    } else {
      g_neg[k] = 0.0f;
    }
  }
  const float g_pos = sigmoid(s_pos) - 1.0f;
  if (lane == 0) {
    *loss_out = LOGSIG ? -log_sigmoid(s_pos) - l_neg : softplus(-s_pos) + l_neg;
    coef_out[0] = g_pos;
  }
  float g_lane = 0.0f;   // g_neg[lane], without dynamic register indexing
#pragma unroll
  for (int k = 0; k < kMaxNegatives; ++k) {
    if (k == lane) g_lane = g_neg[k];
  }
  if (lane < K) coef_out[1 + lane] = g_lane;

  // dW = g_pos * c_pos + sum_k g_k * c_k, summed over k in order.
  for (int e = lane * VEC; e < d; e += 32 * VEC) {
    float acc[VEC], cv[VEC];
    load_vec<VEC>(cneg[0] + e, cv);
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = __fmul_rn(g_neg[0], cv[v]);
#pragma unroll
    for (int k = 1; k < kMaxNegatives; ++k) {
      if (k < K) {
        load_vec<VEC>(cneg[k] + e, cv);
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] = __fadd_rn(acc[v], __fmul_rn(g_neg[k], cv[v]));
      }
    }
    load_vec<VEC>(cpos + e, cv);
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = __fadd_rn(__fmul_rn(g_pos, cv[v]), acc[v]);
    store_vec<VEC>(dw_out + e, acc);
  }
}

// ---------------------------------------------------------------------------
// Phase 1: one warp per (worker, pair p in [p0, p0 + nb)). W, C (n, V, d);
// centers, contexts (n, B); ids (n, B, K); loss (n, B); coef (n, B, K + 1)
// and dW (n, B, d) scratch. LOGSIG picks the loss form.
// ---------------------------------------------------------------------------
template <int VEC, bool LOGSIG>
__global__ void __launch_bounds__(kWarps * 32)
sgns_pairs_kernel(const float* __restrict__ W, const float* __restrict__ C,
                  const int* __restrict__ centers, const int* __restrict__ contexts,
                  const int* __restrict__ ids, int V, int d, int B, int K, int p0,
                  int nb, float* __restrict__ loss, float* __restrict__ coef,
                  float* __restrict__ dW) {
  const int w = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int p = p0 + blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= p0 + nb) return;
  const long long wp = static_cast<long long>(w) * B + p;
  const long long table = static_cast<long long>(w) * V;

  const int my_id = lane < K ? ids[wp * K + lane] : 0;
  const float* Wt = W + table * d;
  const float* Ct = C + table * d;
  const float* wrow = Wt + static_cast<long long>(centers[wp]) * d;
  const float* cpos = Ct + static_cast<long long>(contexts[wp]) * d;
  const float* cneg[kMaxNegatives];
#pragma unroll
  for (int k = 0; k < kMaxNegatives; ++k) {
    const int id = __shfl_sync(kFull, my_id, k < K ? k : 0);
    cneg[k] = Ct + static_cast<long long>(id) * d;
  }
  pair_step<VEC, LOGSIG>(wrow, cpos, cneg, K, d, lane, loss + wp, coef + wp * (K + 1),
                         dW + wp * d);
}

// ---------------------------------------------------------------------------
// Phase 2: one warp per distinct touched row in positions [j_begin,
// j_begin + count) of each worker's sorted lists, addends in pair order.
// `keys` (n, L) are each worker's touched rows sorted stably, `perm` (n, L)
// the addend index each sorted position came from: for the C table an index
// into concat(contexts (B), ids (B * K)), for the W table a pair index. A
// range holds whole runs (the caller sorts by range first), so a run never
// crosses its ends.
// ---------------------------------------------------------------------------
template <int VEC, bool C_TABLE>
__global__ void __launch_bounds__(kWarps * 32)
sgns_apply_kernel(float* __restrict__ table, const float* __restrict__ W,
                  const int* __restrict__ centers, const float* __restrict__ coef,
                  const float* __restrict__ dW, const int* __restrict__ keys,
                  const long long* __restrict__ perm, int V, int d, int B, int K,
                  int L, int j_begin, int count, float neg_lr) {
  const int w = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int j0 = j_begin + blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int j_end = j_begin + count;
  if (j0 >= j_end) return;
  const int* wkeys = keys + static_cast<long long>(w) * L;
  const long long* wperm = perm + static_cast<long long>(w) * L;
  const int row = wkeys[j0];
  if (j0 > j_begin && wkeys[j0 - 1] == row) return;   // not the head of its run
  int j1 = j0 + 1;
  while (j1 < j_end && wkeys[j1] == row) ++j1;

  const long long wB = static_cast<long long>(w) * B;
  float* dst = table + (static_cast<long long>(w) * V + row) * d;
  const float* Wt = W + static_cast<long long>(w) * V * d;
  constexpr int kChunk = 32 * VEC * kTile;
  for (int c0 = 0; c0 < d; c0 += kChunk) {
    float acc[kTile][VEC];
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const int e = c0 + t * 32 * VEC + lane * VEC;
      if (e < d) load_vec<VEC>(dst + e, acc[t]);
    }
    for (int j = j0; j < j1; ++j) {
      const long long src = wperm[j];
      float g = 0.0f;
      const float* addend;
      if constexpr (C_TABLE) {
        // src < B: context of pair src; else negative (src - B) = p*K + k.
        const long long p = src < B ? src : (src - B) / K;
        const long long slot = src < B ? 0 : 1 + (src - B) % K;
        g = coef[(wB + p) * (K + 1) + slot];
        addend = Wt + static_cast<long long>(centers[wB + p]) * d;
      } else {
        addend = dW + (wB + src) * d;
      }
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const int e = c0 + t * 32 * VEC + lane * VEC;
        if (e < d) {
          float a[VEC];
          load_vec<VEC>(addend + e, a);
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            const float u = C_TABLE ? __fmul_rn(neg_lr, __fmul_rn(g, a[v]))
                                    : __fmul_rn(neg_lr, a[v]);
            acc[t][v] = __fadd_rn(acc[t][v], u);
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const int e = c0 + t * 32 * VEC + lane * VEC;
      if (e < d) store_vec<VEC>(dst + e, acc[t]);
    }
  }
}

inline unsigned blocks_for(long long items) {
  return static_cast<unsigned>((items + kWarps - 1) / kWarps);
}

template <int VEC, bool LOGSIG>
cudaError_t launch_pairs(int n, int V, int d, int B, int K, int p0, int nb, const void* W,
                         const void* C, const void* centers, const void* contexts,
                         const void* ids, void* loss, void* coef, void* dW,
                         cudaStream_t s) {
  const dim3 grid(blocks_for(nb), static_cast<unsigned>(n));
  sgns_pairs_kernel<VEC, LOGSIG><<<grid, kWarps * 32, 0, s>>>(
      static_cast<const float*>(W), static_cast<const float*>(C),
      static_cast<const int*>(centers), static_cast<const int*>(contexts),
      static_cast<const int*>(ids), V, d, B, K, p0, nb, static_cast<float*>(loss),
      static_cast<float*>(coef), static_cast<float*>(dW));
  return cudaGetLastError();
}

template <int VEC, bool C_TABLE>
cudaError_t launch_apply(int n, int V, int d, int B, int K, int L, int j_begin, int count,
                         float* table, const void* W, const void* centers,
                         const void* coef, const void* dW, const void* keys,
                         const void* perm, float neg_lr, cudaStream_t s) {
  const dim3 grid(blocks_for(count), static_cast<unsigned>(n));
  sgns_apply_kernel<VEC, C_TABLE><<<grid, kWarps * 32, 0, s>>>(
      table, static_cast<const float*>(W), static_cast<const int*>(centers),
      static_cast<const float*>(coef), static_cast<const float*>(dW),
      static_cast<const int*>(keys), static_cast<const long long*>(perm), V, d, B, K,
      L, j_begin, count, neg_lr);
  return cudaGetLastError();
}

// One sparse step over pairs [p0, p0 + nb) of every worker: phase 1, then
// the C apply over sorted positions [p0 (K + 1), (p0 + nb)(K + 1)) (its
// addends read W rows not yet written), then the W apply over [p0, p0 + nb).
template <int VEC, bool LOGSIG>
cudaError_t run_block(int n, int V, int d, int B, int K, int p0, int nb, float* W, float* C,
                      const void* centers, const void* contexts, const void* ids,
                      void* loss, void* coef, void* dW, const void* c_keys,
                      const void* c_perm, const void* w_keys, const void* w_perm,
                      float neg_lr, cudaStream_t s) {
  cudaError_t err = launch_pairs<VEC, LOGSIG>(n, V, d, B, K, p0, nb, W, C, centers,
                                              contexts, ids, loss, coef, dW, s);
  if (err != cudaSuccess) return err;
  err = launch_apply<VEC, true>(n, V, d, B, K, B * (K + 1), p0 * (K + 1), nb * (K + 1), C,
                                W, centers, coef, dW, c_keys, c_perm, neg_lr, s);
  if (err != cudaSuccess) return err;
  return launch_apply<VEC, false>(n, V, d, B, K, B, p0, nb, W, nullptr, centers, coef, dW,
                                  w_keys, w_perm, neg_lr, s);
}

}  // namespace sgns
