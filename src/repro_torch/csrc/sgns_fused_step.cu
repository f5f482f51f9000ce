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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

// softplus(x) = max(x, 0) + log1p(exp(-|x|)), the TPU kernel's form.
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// ---------------------------------------------------------------------------
// Phase 1: one warp per (worker, pair).
// ---------------------------------------------------------------------------
template <int VEC>
__global__ void __launch_bounds__(kWarps * 32)
sgns_pairs_kernel(const float* __restrict__ W, const float* __restrict__ C,
                  const int* __restrict__ centers, const int* __restrict__ contexts,
                  const int* __restrict__ ids, int V, int d, int B, int K,
                  float* __restrict__ loss, float* __restrict__ coef,
                  float* __restrict__ dW) {
  const int w = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= B) return;
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
      l_neg += softplus(s_neg[k]);
      g_neg[k] = sigmoid(s_neg[k]);
    } else {
      g_neg[k] = 0.0f;
    }
  }
  const float g_pos = sigmoid(s_pos) - 1.0f;
  if (lane == 0) {
    loss[wp] = softplus(-s_pos) + l_neg;
    coef[wp * (K + 1)] = g_pos;
  }
  float g_lane = 0.0f;   // g_neg[lane], without dynamic register indexing
#pragma unroll
  for (int k = 0; k < kMaxNegatives; ++k) {
    if (k == lane) g_lane = g_neg[k];
  }
  if (lane < K) coef[wp * (K + 1) + 1 + lane] = g_lane;

  // dW = g_pos * c_pos + sum_k g_k * c_k, summed over k in order.
  float* dwrow = dW + wp * d;
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
    store_vec<VEC>(dwrow + e, acc);
  }
}

// ---------------------------------------------------------------------------
// Phase 2: one warp per distinct touched row, addends in pair order.
// `keys` (n, L) are each worker's touched rows sorted stably, `perm` (n, L)
// the addend index each sorted position came from.
// ---------------------------------------------------------------------------
template <int VEC, bool C_TABLE>
__global__ void __launch_bounds__(kWarps * 32)
sgns_apply_kernel(float* __restrict__ table, const float* __restrict__ W,
                  const int* __restrict__ centers, const float* __restrict__ coef,
                  const float* __restrict__ dW, const int* __restrict__ keys,
                  const long long* __restrict__ perm, int V, int d, int B, int K,
                  int L, float neg_lr) {
  const int w = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int j0 = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (j0 >= L) return;
  const int* wkeys = keys + static_cast<long long>(w) * L;
  const long long* wperm = perm + static_cast<long long>(w) * L;
  const int row = wkeys[j0];
  if (j0 > 0 && wkeys[j0 - 1] == row) return;   // not the head of its run
  int j1 = j0 + 1;
  while (j1 < L && wkeys[j1] == row) ++j1;

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

template <int VEC>
void launch_pairs(int n, int V, int d, int B, int K, const void* W, const void* C,
                  const void* centers, const void* contexts, const void* ids,
                  void* loss, void* coef, void* dW, cudaStream_t s) {
  const dim3 grid(blocks_for(B), static_cast<unsigned>(n));
  sgns_pairs_kernel<VEC><<<grid, kWarps * 32, 0, s>>>(
      static_cast<const float*>(W), static_cast<const float*>(C),
      static_cast<const int*>(centers), static_cast<const int*>(contexts),
      static_cast<const int*>(ids), V, d, B, K, static_cast<float*>(loss),
      static_cast<float*>(coef), static_cast<float*>(dW));
}

template <int VEC, bool C_TABLE>
void launch_apply(int n, int V, int d, int B, int K, int L, float* table,
                  const void* W, const void* centers, const void* coef,
                  const void* dW, const void* keys, const void* perm, float neg_lr,
                  cudaStream_t s) {
  const dim3 grid(blocks_for(L), static_cast<unsigned>(n));
  sgns_apply_kernel<VEC, C_TABLE><<<grid, kWarps * 32, 0, s>>>(
      table, static_cast<const float*>(W), static_cast<const int*>(centers),
      static_cast<const float*>(coef), static_cast<const float*>(dW),
      static_cast<const int*>(keys), static_cast<const long long*>(perm), V, d, B, K,
      L, neg_lr);
}

}  // namespace

// Phase 1. W, C (n, V, d) float32; centers, contexts (n, B) int32;
// ids (n, B, K) int32 (K1's draw). Writes loss (n, B), coef (n, B, K+1)
// and dW (n, B, d).
extern "C" int sgns_pairs_launch(const void* W, const void* C, const void* centers,
                                 const void* contexts, const void* ids, int n, int V,
                                 int d, int B, int K, void* loss, void* coef,
                                 void* dW, int vec4, void* stream) {
  if (n == 0 || B == 0) return 0;
  if (K < 1 || K > kMaxNegatives) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    launch_pairs<4>(n, V, d, B, K, W, C, centers, contexts, ids, loss, coef, dW, s);
  } else {
    launch_pairs<1>(n, V, d, B, K, W, C, centers, contexts, ids, loss, coef, dW, s);
  }
  return static_cast<int>(cudaGetLastError());
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
  if (vec4) {
    launch_apply<4, true>(n, V, d, B, K, Lc, Cf, W, centers, coef, dW, c_keys, c_perm,
                          neg_lr, s);
  } else {
    launch_apply<1, true>(n, V, d, B, K, Lc, Cf, W, centers, coef, dW, c_keys, c_perm,
                          neg_lr, s);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (vec4) {
    launch_apply<4, false>(n, V, d, B, K, B, Wf, nullptr, centers, coef, dW, w_keys, w_perm,
                           neg_lr, s);
  } else {
    launch_apply<1, false>(n, V, d, B, K, B, Wf, nullptr, centers, coef, dW, w_keys, w_perm,
                           neg_lr, s);
  }
  return static_cast<int>(cudaGetLastError());
}
