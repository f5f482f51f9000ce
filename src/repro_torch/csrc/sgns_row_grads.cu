// K3: SGNS forward and row gradients on gathered rows, one warp per pair.
//
// Replaces: repro/kernels/sgns_update.py `_sgns_kernel` (reached through
// `sgns_row_grads_kernel` and `ops.sgns_row_grads`, the `pallas` engine's
// row-gradient seam). Per pair, on rows w, c_pos (d,) and c_neg (K, d):
//   s_pos = w.c_pos, s_k = w.c_k;
//   loss  = softplus(-s_pos) + sum_k softplus(s_k)   (the TPU kernel's form);
//   g_pos = sigmoid(s_pos) - 1, g_k = sigmoid(s_k);
//   dW = g_pos c_pos + sum_k g_k c_k, dC_pos = g_pos w, dC_k = g_k w.
// The TPU kernel streams (Bt, D) VMEM tiles with D padded to 128 lanes; here
// nothing is padded: a warp walks its pair's d columns with 16-byte loads
// when d % 4 == 0 (and the rows are 16-byte aligned), else 4-byte loads.
// The gathers before this kernel and the accumulating scatter after it stay
// torch indexing and index_add_, as they stay XLA in the reference engine.
//
// Bound on the H100: memory. A pair reads K + 2 rows and writes K + 2 rows of
// d floats against ~7 (K + 1) d flops; at the `rowgrad` path's n B = 10,240
// pairs, K = 5, d = 500 that is ~287 MB a call, ~0.086 ms at 3.35 TB/s. This
// first version reads the rows twice (the dot products, then the outputs;
// the second pass mostly from L1/L2).

#include "sgns_step.cuh"

namespace {

using namespace sgns;

template <int VEC>
__global__ void __launch_bounds__(kWarps * 32)
sgns_row_grads_kernel(const float* __restrict__ w, const float* __restrict__ c_pos,
                      const float* __restrict__ c_neg, long long N, int d, int K,
                      float* __restrict__ loss, float* __restrict__ d_w,
                      float* __restrict__ d_cp, float* __restrict__ d_cn) {
  const int lane = threadIdx.x & 31;
  const long long p = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (p >= N) return;
  const float* wrow = w + p * d;
  const float* cpos = c_pos + p * d;
  const float* cneg = c_neg + p * K * d;

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
        load_vec<VEC>(cneg + k * d + e, cv);
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
      l_neg += softplus(s_neg[k]);
      g_neg[k] = sigmoid(s_neg[k]);
    } else {
      g_neg[k] = 0.0f;
    }
  }
  const float g_pos = sigmoid(s_pos) - 1.0f;
  if (lane == 0) loss[p] = softplus(-s_pos) + l_neg;

  float* dwrow = d_w + p * d;
  float* dcprow = d_cp + p * d;
  float* dcnrow = d_cn + p * K * d;
  for (int e = lane * VEC; e < d; e += 32 * VEC) {
    float wv[VEC], acc[VEC], cv[VEC], out[VEC];
    load_vec<VEC>(wrow + e, wv);
    load_vec<VEC>(cneg + e, cv);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      acc[v] = __fmul_rn(g_neg[0], cv[v]);
      out[v] = __fmul_rn(g_neg[0], wv[v]);
    }
    store_vec<VEC>(dcnrow + e, out);
#pragma unroll
    for (int k = 1; k < kMaxNegatives; ++k) {
      if (k < K) {
        load_vec<VEC>(cneg + k * d + e, cv);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          acc[v] = __fadd_rn(acc[v], __fmul_rn(g_neg[k], cv[v]));
          out[v] = __fmul_rn(g_neg[k], wv[v]);
        }
        store_vec<VEC>(dcnrow + k * d + e, out);
      }
    }
    load_vec<VEC>(cpos + e, cv);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      acc[v] = __fadd_rn(__fmul_rn(g_pos, cv[v]), acc[v]);
      out[v] = __fmul_rn(g_pos, wv[v]);
    }
    store_vec<VEC>(dwrow + e, acc);
    store_vec<VEC>(dcprow + e, out);
  }
}

}  // namespace

// w, c_pos (N, d), c_neg (N, K, d) float32 → loss (N,), d_w, d_cp (N, d),
// d_cn (N, K, d). Returns cudaGetLastError() after the launch.
extern "C" int sgns_row_grads_launch(const void* w, const void* c_pos, const void* c_neg,
                                     long long N, int d, int K, void* loss, void* d_w,
                                     void* d_cp, void* d_cn, int vec4, void* stream) {
  if (N == 0) return 0;
  if (K < 1 || K > sgns::kMaxNegatives) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(sgns::blocks_for(N));
  auto s = static_cast<cudaStream_t>(stream);
  const auto* wf = static_cast<const float*>(w);
  const auto* cpf = static_cast<const float*>(c_pos);
  const auto* cnf = static_cast<const float*>(c_neg);
  auto* lf = static_cast<float*>(loss);
  auto* dwf = static_cast<float*>(d_w);
  auto* dcpf = static_cast<float*>(d_cp);
  auto* dcnf = static_cast<float*>(d_cn);
  if (vec4) {
    sgns_row_grads_kernel<4><<<grid, sgns::kWarps * 32, 0, s>>>(wf, cpf, cnf, N, d, K, lf, dwf,
                                                          dcpf, dcnf);
  } else {
    sgns_row_grads_kernel<1><<<grid, sgns::kWarps * 32, 0, s>>>(wf, cpf, cnf, N, d, K, lf, dwf,
                                                          dcpf, dcnf);
  }
  return static_cast<int>(cudaGetLastError());
}
