// Device code shared by the SGNS step kernels: K2 and K4a
// (`sgns_block_step.cuh`, included by `sgns_fused_step.cu` and
// `sgns_fused_hbm.cu`), K3 (`sgns_row_grads.cu`) and, through
// `sgns_pipe.cuh`, K5 and K6 (`sgns_fused_pipe.cu`, `sgns_fused_tiered.cu`):
//
// * 16-byte or scalar row loads, warp reductions, and the loss and sigmoid
//   forms of the JAX package's kernels;
// * `pair_step`, one pair's forward and row gradients by one warp, on rows
//   in global or shared memory. K5 and K6 (`pair_staged`) repeat its
//   arithmetic, in its order, on their own staging layout.
//
// Rounding: every product and sum of dW is a separate round-to-nearest
// operation (__fmul_rn/__fadd_rn, never contracted into an FMA), in the
// expression tree and order of the reference's row gradients. The dot
// products are reduced in another order than XLA's.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sgns {

constexpr int kMaxNegatives = 16;
constexpr int kWarps = 8;          // warps a CTA
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
// Writes *loss_out, coef_out[0 .. K], dw_out[0 .. d) and, unless it is null,
// a copy of the W row to w_out[0 .. d).
// ---------------------------------------------------------------------------
template <int VEC, bool LOGSIG>
__device__ __forceinline__ void pair_step(const float* wrow, const float* cpos,
                                          const float* const (&cneg)[kMaxNegatives], int K,
                                          int d, int lane, float* loss_out, float* coef_out,
                                          float* dw_out, float* w_out) {
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
    if (w_out != nullptr) store_vec<VEC>(w_out + e, wv);
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

inline unsigned blocks_for(long long items) {
  return static_cast<unsigned>((items + kWarps - 1) / kWarps);
}

}  // namespace sgns
