// K3: SGNS forward and row gradients on gathered rows, for Hopper: tiles of
// consecutive pairs streamed through a ring of shared-memory stages by bulk
// asynchronous copies, each pair's rows read once from device memory.
//
// Replaces: repro/kernels/sgns_update.py `_sgns_kernel` (reached through
// `sgns_row_grads_kernel` and `ops.sgns_row_grads`, the `pallas` engine's
// row-gradient seam). Per pair, on rows w, c_pos (d,) and c_neg (K, d):
//   s_pos = w.c_pos, s_k = w.c_k;
//   loss  = softplus(-s_pos) + sum_k softplus(s_k)   (the TPU kernel's form);
//   g_pos = sigmoid(s_pos) - 1, g_k = sigmoid(s_k);
//   dW = g_pos c_pos + sum_k g_k c_k, dC_pos = g_pos w, dC_k = g_k w.
// The TPU kernel streams (Bt, D) VMEM tiles with D padded to 128 lanes; here
// nothing is padded. The gathers before this kernel and the ordered scatter
// after it stay torch, as they stay XLA in the reference engine.
//
// Bound on the H100: memory. A pair reads K + 2 rows and writes K + 2 rows of
// d floats against ~7 (K + 1) d flops; at the `rowgrad` path's n B = 10,240
// pairs, K = 5, d = 500 that is 286.8 MB a call, 0.0856 ms at 3.35 TB/s.
//
// Design. The first design (one warp a pair, 8 warps a CTA, one CTA a
// tile of 8 pairs) read each pair's rows twice, once for the dot products
// and once for the outputs; with ~118 MB of rows in flight between the
// passes, more than the 50 MB of L2, the second pass went back to device
// memory. Here:
//
//   persistent CTAs, as many an SM as the ring's shared memory lets reside
//     (one at d = 500), walk tiles of kTilePairs consecutive pairs in a
//     fixed order (tile t goes to CTA t mod grid): no atomics, no work
//     counter. kTilePairs = 8 and kStages = 2 (224 KB of ring at d = 500)
//     came out of a sweep of 2 to 8 pairs and 2 to 4 stages
//     (`analysis/kernel_variants.py`): the consumer warps an SM set the
//     pace once ~110 KB an SM are in flight, and eight beat four.
//   the feed: a tile's inputs are three contiguous spans of the gathered
//     tensors, w[p0 : p0 + P], c_pos[p0 : p0 + P] and c_neg[p0 : p0 + P].
//     One producer warp fills a ring of kStages stages under full/empty
//     mbarriers (K7's ring, `swa_decode.cu`): one elected lane issues a
//     1-D bulk copy (cp.async.bulk) for each span whose address is 16-byte
//     aligned and whose size is a multiple of 16 bytes; a span that is not
//     (a tail tile at d = 50, or a tensor whose data pointer is not 16-byte
//     aligned) is copied by the warp's 32 lanes with 4-byte cp.async, each
//     lane's arrival on the stage's barrier made when its copies land. With
//     kTilePairs a multiple of 4, every full tile's spans meet the rule at
//     any d when the tensors are 16-byte aligned.
//   rows read once: one consumer warp a pair computes the dot products and
//     then every output from the staged rows.
//   streaming stores: the outputs go out with evict-first stores (st.global
//     .cs), so the ~143 MB of gradients do not push the next tiles' rows
//     out of L2.
//   registers: the per-pair arrays are sized by KMAX, 8 for K <= 8 (the
//     paths' K = 5) and 16 above.
//
// Bits: the per-lane column stride (VEC = 4 columns a lane on the 16-byte
// path, 1 on the scalar path, chosen as before from d and the tensors'
// alignment), the warp_sum butterfly and dW's __fmul_rn/__fadd_rn tree are
// the first design's, and each dot-product term is one fused multiply-add,
// as the first design's build contracted every one of them; so the outputs
// are bitwise the first design's. (The FMAs are written out: left to
// contraction, one build of the ring kernel kept a product apart from its
// sum, a different rounding in some pairs' s_pos.) Rows
// too long for kStages stages of one pair (K + 2 rows of d floats each) are
// read in place by the first design's schedule (`row_grads_in_place_kernel`).

#include "func_attrs.cuh"
#include "sgns_step.cuh"
#include "sm90_async.cuh"

namespace {

using namespace sgns;

constexpr int kTilePairs = 8;    // pairs a tile: one consumer warp each
constexpr int kStages = 2;       // ring stages
constexpr int kBarBytes = 128;   // full and empty mbarriers, ahead of the ring
constexpr int kRingThreads = (kTilePairs + 1) * 32;   // + the producer warp

inline long long align_up(long long x, long long a) { return (x + a - 1) / a * a; }

// A stage holds the w, c_pos and c_neg tiles of `tile` pairs, each starting
// 16-byte aligned. tile == 0: rows too long to stage.
struct Ring {
  int tile;           // pairs a stage
  int cp_off, cn_off; // byte offsets of the c_pos and c_neg tiles in a stage
  int stage_bytes;    // a stage's stride (a multiple of 128)
  int smem_bytes;     // dynamic shared memory: the barriers, then kStages stages
};

// The largest tile of at most kTilePairs pairs whose kStages stages fit
// `smem_optin` bytes of shared memory.
Ring ring_shape(int d, int K, int smem_optin) {
  Ring r{0, 0, 0, 0, 0};
  for (int t = kTilePairs; t >= 1; --t) {
    const long long row_tile = align_up(4LL * t * d, 16);
    const long long stage = align_up(2 * row_tile + 4LL * t * K * d, 128);
    const long long smem = kBarBytes + kStages * stage;
    if (smem <= smem_optin) {
      r = Ring{t, static_cast<int>(row_tile), static_cast<int>(2 * row_tile),
               static_cast<int>(stage), static_cast<int>(smem)};
      break;
    }
  }
  return r;
}

struct RowArgs {
  const float* w;       // (N, d)
  const float* c_pos;   // (N, d)
  const float* c_neg;   // (N, K, d)
  float* loss;          // (N,)
  float* d_w;           // (N, d)
  float* d_cp;          // (N, d)
  float* d_cn;          // (N, K, d)
  long long N;
  int d, K;
  Ring ring;
};

template <int VEC, bool CS>
__device__ __forceinline__ void put(float* p, const float (&v)[VEC]) {
  if constexpr (!CS) {
    store_vec<VEC>(p, v);
  } else if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    __stcs(p, v[0]);
  }
}

// One pair by one warp: the K + 1 dot products, the loss, then dW, dC_pos
// and dC_k from the same rows. CS: evict-first stores.
template <int VEC, int KMAX, bool CS>
__device__ __forceinline__ void pair_grads(const float* wrow, const float* cpos,
                                           const float* cneg, int d, int K, int lane,
                                           float* loss, float* dwrow, float* dcprow,
                                           float* dcnrow) {
  float s_pos = 0.0f;
  float s_neg[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) s_neg[k] = 0.0f;
  for (int e = lane * VEC; e < d; e += 32 * VEC) {
    float wv[VEC], cv[VEC];
    load_vec<VEC>(wrow + e, wv);
    load_vec<VEC>(cpos + e, cv);
#pragma unroll
    for (int v = 0; v < VEC; ++v) s_pos = __fmaf_rn(wv[v], cv[v], s_pos);
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) {
        load_vec<VEC>(cneg + k * d + e, cv);
#pragma unroll
        for (int v = 0; v < VEC; ++v) s_neg[k] = __fmaf_rn(wv[v], cv[v], s_neg[k]);
      }
    }
  }
  s_pos = warp_sum(s_pos);
  float l_neg = 0.0f;
  float g_neg[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
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
    const float l = softplus(-s_pos) + l_neg;
    if constexpr (CS) {
      __stcs(loss, l);
    } else {
      *loss = l;
    }
  }

  for (int e = lane * VEC; e < d; e += 32 * VEC) {
    float wv[VEC], acc[VEC], cv[VEC], out[VEC];
    load_vec<VEC>(wrow + e, wv);
    load_vec<VEC>(cneg + e, cv);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      acc[v] = __fmul_rn(g_neg[0], cv[v]);
      out[v] = __fmul_rn(g_neg[0], wv[v]);
    }
    put<VEC, CS>(dcnrow + e, out);
#pragma unroll
    for (int k = 1; k < KMAX; ++k) {
      if (k < K) {
        load_vec<VEC>(cneg + k * d + e, cv);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          acc[v] = __fadd_rn(acc[v], __fmul_rn(g_neg[k], cv[v]));
          out[v] = __fmul_rn(g_neg[k], wv[v]);
        }
        put<VEC, CS>(dcnrow + k * d + e, out);
      }
    }
    load_vec<VEC>(cpos + e, cv);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      acc[v] = __fadd_rn(__fmul_rn(g_pos, cv[v]), acc[v]);
      out[v] = __fmul_rn(g_pos, wv[v]);
    }
    put<VEC, CS>(dwrow + e, acc);
    put<VEC, CS>(dcprow + e, out);
  }
}

// The ring: warp kTilePairs produces, warps 0 .. kTilePairs - 1 consume
// (warp j takes pair j of each tile).
template <int VEC, int KMAX>
__global__ void __launch_bounds__(kRingThreads) row_grads_ring_kernel(RowArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  unsigned char* ring = smem + kBarBytes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d = a.d, K = a.K, P = a.ring.tile;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1 + 32);    // the expected bytes, then the 32 lanes' copies
      sm90::mbar_init(&empty[s], kTilePairs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long ntiles = (a.N + P - 1) / P;

  if (warp == kTilePairs) {
    int i = 0;
    for (long long t = blockIdx.x; t < ntiles; t += gridDim.x, ++i) {
      const int s = i % kStages;
      sm90::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
      const long long p0 = t * P;
      const int r = static_cast<int>(a.N - p0 < P ? a.N - p0 : P);
      unsigned char* st = ring + s * a.ring.stage_bytes;
      const float* src[3] = {a.w + p0 * d, a.c_pos + p0 * d, a.c_neg + p0 * K * d};
      float* dst[3] = {reinterpret_cast<float*>(st), reinterpret_cast<float*>(st + a.ring.cp_off),
                       reinterpret_cast<float*>(st + a.ring.cn_off)};
      const int count[3] = {r * d, r * d, r * K * d};
      unsigned bytes = 0;
      bool bulk[3], narrow = false;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        bulk[k] = (reinterpret_cast<uintptr_t>(src[k]) & 15) == 0 && (count[k] & 3) == 0;
        if (bulk[k]) {
          bytes += static_cast<unsigned>(count[k]) * 4;
        } else {
          narrow = true;
        }
      }
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(&full[s], bytes);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          if (bulk[k]) {
            sm90::bulk_load(dst[k], src[k], static_cast<unsigned>(count[k]) * 4, &full[s]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if (!bulk[k]) {
          for (int e = lane; e < count[k]; e += 32) sm90::copy4(dst[k] + e, src[k] + e);
        }
      }
      if (narrow) {
        sm90::copy_arrive_noinc(&full[s]);
      } else {
        sm90::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  int i = 0;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x, ++i) {
    const int s = i % kStages;
    sm90::mbar_wait(&full[s], (i / kStages) & 1);
    const long long p = t * P + warp;
    if (warp < P && p < a.N) {
      const unsigned char* st = ring + s * a.ring.stage_bytes;
      const float* ws = reinterpret_cast<const float*>(st) + warp * d;
      const float* cps = reinterpret_cast<const float*>(st + a.ring.cp_off) + warp * d;
      const float* cns = reinterpret_cast<const float*>(st + a.ring.cn_off) + warp * K * d;
      pair_grads<VEC, KMAX, true>(ws, cps, cns, d, K, lane, a.loss + p, a.d_w + p * d,
                                  a.d_cp + p * d, a.d_cn + p * K * d);
    }
    __syncwarp();                      // the stage is read before it is released
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }
}

// Rows too long to stage: the first design, one warp a pair on its rows in
// place, 8 pairs a CTA.
template <int VEC, int KMAX>
__global__ void __launch_bounds__(kWarps * 32) row_grads_in_place_kernel(RowArgs a) {
  const int lane = threadIdx.x & 31;
  const long long p = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (p >= a.N) return;
  const int d = a.d, K = a.K;
  pair_grads<VEC, KMAX, false>(a.w + p * d, a.c_pos + p * d, a.c_neg + p * K * d, d, K, lane,
                               a.loss + p, a.d_w + p * d, a.d_cp + p * d, a.d_cn + p * K * d);
}

template <int VEC, int KMAX>
int run(const RowArgs& a, int sms, cudaStream_t stream) {
  const bool staged = a.ring.tile > 0;
  if (!staged) {
    row_grads_in_place_kernel<VEC, KMAX><<<blocks_for(a.N), kWarps * 32, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  auto kernel = row_grads_ring_kernel<VEC, KMAX>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.ring.smem_bytes);
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRingThreads,
                                                        a.ring.smem_bytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ntiles = (a.N + a.ring.tile - 1) / a.ring.tile;
  const long long slots = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const unsigned grid = static_cast<unsigned>(ntiles < slots ? ntiles : slots);
  kernel<<<grid, kRingThreads, a.ring.smem_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w, c_pos (N, d), c_neg (N, K, d) float32 → loss (N,), d_w, d_cp (N, d),
// d_cn (N, K, d). vec4: d % 4 == 0 and the inputs 16-byte aligned (the
// 16-byte column stride). Returns cudaGetLastError() after the launch.
extern "C" int sgns_row_grads_launch(const void* w, const void* c_pos, const void* c_neg,
                                     long long N, int d, int K, void* loss, void* d_w,
                                     void* d_cp, void* d_cn, int vec4, void* stream) {
  if (N == 0) return 0;
  if (K < 1 || K > sgns::kMaxNegatives || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  RowArgs a{static_cast<const float*>(w), static_cast<const float*>(c_pos),
            static_cast<const float*>(c_neg), static_cast<float*>(loss),
            static_cast<float*>(d_w), static_cast<float*>(d_cp), static_cast<float*>(d_cn),
            N, d, K, ring_shape(d, K, optin)};
  auto s = static_cast<cudaStream_t>(stream);
  if (vec4) return K <= 8 ? run<4, 8>(a, sms, s) : run<4, 16>(a, sms, s);
  return K <= 8 ? run<1, 8>(a, sms, s) : run<1, 16>(a, sms, s);
}

static const KernelEntry kKernels[] = {
    KERNEL_ENTRY("row_grads_ring_kernel<4,8>", row_grads_ring_kernel<4, 8>),
    KERNEL_ENTRY("row_grads_ring_kernel<4,16>", row_grads_ring_kernel<4, 16>),
    KERNEL_ENTRY("row_grads_ring_kernel<1,8>", row_grads_ring_kernel<1, 8>),
    KERNEL_ENTRY("row_grads_ring_kernel<1,16>", row_grads_ring_kernel<1, 16>),
    KERNEL_ENTRY("row_grads_in_place_kernel<4,8>", row_grads_in_place_kernel<4, 8>),
    KERNEL_ENTRY("row_grads_in_place_kernel<4,16>", row_grads_in_place_kernel<4, 16>),
    KERNEL_ENTRY("row_grads_in_place_kernel<1,8>", row_grads_in_place_kernel<1, 8>),
    KERNEL_ENTRY("row_grads_in_place_kernel<1,16>", row_grads_in_place_kernel<1, 16>),
};
KERNEL_ATTRS_EXPORT(kKernels)
