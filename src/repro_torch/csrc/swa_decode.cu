// K7: single-token sliding-window attention decode over a full ring-buffer
// KV cache, with GQA, for Hopper: the window's rows streamed through a ring
// of shared-memory stages by bulk asynchronous copies (TMA) under mbarrier
// completion, a producer warp ahead of eight consumer warps.
//
// Replaces: repro/kernels/swa_decode.py `_swa_kernel` (reached through
// `swa_decode_kernel`): q (B, H, D), k/v (B, W, H, D) -> out (B, H, D), an
// online softmax (running max m, sum l, accumulator acc) over the window;
// scores (q.k) * (1/sqrt(D)), m from -1e30, out = acc / max(l, 1e-30),
// accumulated in float32, written in q's type (float32 or bfloat16). Here
// k/v carry Hkv heads, H % Hkv == 0, and query head h reads KV head
// h / (H / Hkv) (the grouping of repro/models/attention.py `_sdpa`);
// Hkv == H is the TPU kernel's signature.
//
// Bound on the H100: memory. K and V are read once; at the decode path's
// shape (h2o-danube-1.8b: B = 4, W = 4096, Hkv = 8, D = 80, float32) that is
// 83.9 MB, 25.0 us at 3.35 TB/s, and its 168 MFLOP do not bound it.
//
// Design. The TPU grid walks (batch, chunk) in order and carries m, l and
// acc in VMEM from chunk to chunk. Here one CTA takes batch b and a range
// of window rows with ALL its KV heads: the Hkv heads of a row are
// contiguous (Hkv * D elements), so a tile of T rows is one contiguous
// range of K and one of V, and one elected thread of the producer warp
// moves each with a single `cp.async.bulk` into a ring of up to four
// stages (about 40 KB of K + V a stage), completing on the stage's `full`
// mbarrier; the consumer warps release a stage on its `empty` mbarrier. So
// the loads of the next stages are in flight while a stage is computed,
// with no thread spending registers or instructions on them. The window is
// split so that the grid fills every SM once (B * n_split CTAs), each CTA
// streaming its rows with the ring full.
//
// Each consumer warp owns one KV head (several when Hkv > 8; when Hkv < 8,
// 8 / Hkv warps share a head and take alternate rows of each tile) and its
// H / Hkv query heads: q in registers, lanes over the D columns, so every
// shared-memory read is 32 consecutive elements of one row (no bank
// conflicts, no padding, which a bulk copy could not write). A warp takes
// its rows in groups of 32 / QP (QP: its query heads, padded to a power of
// two), so a group has 32 dot products; one transposing reduction (31
// shuffles, not 5 a dot product) leaves each in its own lane, the softmax
// update of all the warp's heads then runs across the lanes at once (max,
// exp, sum over groups of lanes), and P.V broadcasts each weight with a
// shuffle. Warps never wait for one another: all the state of a KV head
// stays inside its warp. (Reducing each row's scores with a butterfly a
// head and updating the softmax head by head left the warps waiting on
// chains of dependent shuffles.)
//
// Every (CTA, warp) writes a partial (m, l, acc[D]) per query head;
// swa_combine_kernel merges the partials in a fixed order with the same
// rescaling and floor, so the output repeats bit for bit. float32
// accumulation, expf, no fast math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "func_attrs.cuh"
#include "sm90_async.cuh"

namespace {

using namespace sm90;   // mbarriers and bulk copies

constexpr int kConsumerWarps = 8;
constexpr int kThreads = (kConsumerWarps + 1) * 32;   // + the producer warp
constexpr int kMaxStages = 4;
constexpr int kStageBytes = 40 * 1024;   // K + V bytes a stage aims at
constexpr int kRingBytes = 200 * 1024;   // the most the ring may take
constexpr int kRingOffset = 128;         // barriers first, then the ring
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// How the window is cut: rows per tile, stages, CTAs per batch row, warps
// per KV head, and the register shapes. Computed on the host for the launch
// and for the caller's scratch.
struct Plan {
  int align;      // rows whose bytes are a multiple of 16
  int rows;       // T, rows a tile (a multiple of align)
  int stages;
  int n_split;    // CTAs per batch row
  int wph;        // consumer warps per KV head (Hkv < 8), else 1
  int nc;         // columns a lane: the kernel's NC, >= ceil(D / 32)
  int qp;         // query heads a warp, padded to a power of two: the kernel's QP
  int units;      // window rows / align
  size_t smem;
  __host__ __device__ int parts() const { return n_split * wph; }
};

// Query heads a consumer warp serves.
__host__ __device__ inline int warp_heads(int H, int Hkv) {
  const int rep = H / Hkv;
  return Hkv >= kConsumerWarps ? (Hkv + kConsumerWarps - 1) / kConsumerWarps * rep : rep;
}

int gcd_int(int a, int b) { return b == 0 ? a : gcd_int(b, a % b); }

// Why make_plan refuses a shape (its other failures are cudaError_t codes).
constexpr int kTooWide = -1001;  // a warp's query heads exceed its registers
constexpr int kNoTiles = -1002;  // no 16-byte-aligned tiles of two rows fit the ring

// 0 on success, kTooWide or kNoTiles, else a cudaError_t.
int make_plan(int B, int W, int H, int Hkv, int D, int elem, Plan* p) {
  if (B <= 0 || W <= 0 || D <= 0 || Hkv <= 0 || H % Hkv != 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int need = (D + 31) / 32;
  p->nc = need <= 2 ? 2 : need <= 4 ? need : 8;
  const int qw = warp_heads(H, Hkv);
  p->qp = 1;
  while (p->qp < qw) p->qp *= 2;
  if (need > 8 || p->qp > 8 || p->qp * p->nc > 32) return kTooWide;
  const long long row_bytes = static_cast<long long>(Hkv) * D * elem;
  p->align = 16 / gcd_int(static_cast<int>(row_bytes % 16), 16);
  if (W % p->align != 0) return kNoTiles;
  p->wph = Hkv >= kConsumerWarps ? 1 : kConsumerWarps / Hkv;
  // a tile: whole groups of 32 / qp rows for every warp of a head, as many
  // as fit half a stage; fewer (a partial group) only for very wide rows
  const long long group = static_cast<long long>(32 / p->qp) * p->wph;
  long long rows = kStageBytes / 2 / row_bytes;
  rows = rows >= group ? rows / group * group : rows;
  rows = rows / p->align * p->align;
  if (rows < p->align) rows = p->align;
  if (rows > W) rows = W;
  p->rows = static_cast<int>(rows);
  const long long stage = 2 * rows * row_bytes;
  long long stages = kRingBytes / stage;
  if (stages > kMaxStages) stages = kMaxStages;
  if (stages < 2) return kNoTiles;
  p->stages = static_cast<int>(stages);
  p->smem = kRingOffset + static_cast<size_t>(stages * stage);
  p->units = W / p->align;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int per_sm_smem = static_cast<int>((227 * 1024) / p->smem);
  const int per_sm_threads = 2048 / kThreads;
  const int per_sm = per_sm_smem < per_sm_threads ? per_sm_smem : per_sm_threads;
  int n_split = sms * (per_sm > 0 ? per_sm : 1) / B;
  if (n_split < 1) n_split = 1;
  if (n_split > p->units) n_split = p->units;
  p->n_split = n_split;
  return 0;
}

// One step of transpose_sum: the lanes whose bit H is set keep the upper
// half of their H * 2 values, the others the lower, and add the partner's.
template <int H>
__device__ __forceinline__ void transpose_step(float (&x)[32], int lane) {
  const bool up = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? x[i] : x[i + H];
    const float keep = up ? x[i + H] : x[i];
    x[i] = keep + __shfl_xor_sync(kFull, send, H);
  }
}

// The 32 values x[v] of every lane summed across the warp, value v ending
// in lane v: 31 shuffles for 32 sums (a butterfly a value would take 160).
// Each step is its own instantiation, so every index is a constant and x
// stays in registers.
__device__ __forceinline__ float transpose_sum(float (&x)[32], int lane) {
  transpose_step<16>(x, lane);
  transpose_step<8>(x, lane);
  transpose_step<4>(x, lane);
  transpose_step<2>(x, lane);
  transpose_step<1>(x, lane);
  return x[0];
}

// One CTA: batch b = blockIdx.y, window units [u0, u1) of split blockIdx.x,
// all KV heads. Writes the partial m, l (B * H, parts) and acc (B * H,
// parts, D) of each query head, part = split * wph + (the warp's share of
// its head). A warp serves QP query heads (padded; qw real) and takes its
// rows of a tile in groups of TR = 32 / QP: the QP x TR scores of a group
// are one value a lane after transpose_sum, lane r * TR + i holding head r
// and the group's i-th row, so the softmax update of every head runs at
// once across the lanes.
template <typename T, int NC, int QP, bool MULTI>
__global__ void __launch_bounds__(kThreads, 1)
swa_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, float* __restrict__ m_part,
                   float* __restrict__ l_part, float* __restrict__ acc_part, int W, int H,
                   int Hkv, int D, Plan plan, float scale) {
  constexpr int TR = 32 / QP;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  unsigned char* ring = smem + kRingOffset;

  const int split = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rep = H / Hkv;
  const int S = plan.stages;
  const int Tr = plan.rows;
  const int u0 = static_cast<int>(static_cast<long long>(split) * plan.units / plan.n_split);
  const int u1 = static_cast<int>(static_cast<long long>(split + 1) * plan.units / plan.n_split);
  const int row0 = u0 * plan.align;
  const int nrows = (u1 - u0) * plan.align;
  const int ntiles = (nrows + Tr - 1) / Tr;
  const int row_elems = Hkv * D;
  const unsigned half = static_cast<unsigned>(Tr) * row_elems * sizeof(T);   // K or V of a tile
  const int active = Hkv >= kConsumerWarps ? kConsumerWarps : plan.wph * Hkv;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], active);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long first = (static_cast<long long>(b) * W + row0) * row_elems;
  if (warp == kConsumerWarps) {
    // The producer: one elected lane keeps the ring full.
    if (lane == 0) {
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % S;
        const int rows = min(Tr, nrows - i * Tr);
        const unsigned bytes = static_cast<unsigned>(rows) * row_elems * sizeof(T);
        mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * bytes);
        const long long off = first + static_cast<long long>(i) * Tr * row_elems;
        bulk_load(ring + s * 2 * half, k + off, bytes, &full[s]);
        bulk_load(ring + s * 2 * half + half, v + off, bytes, &full[s]);
      }
    }
    return;
  }
  if (warp >= active) return;

  // This warp's KV heads and query heads: r = j * rep + i serves query head
  // (g0 + 8 j) * rep + i; r >= qw pads QP with zero queries.
  const int sub = Hkv >= kConsumerWarps ? 0 : warp % plan.wph;
  const int g0 = Hkv >= kConsumerWarps ? warp : warp / plan.wph;
  const int step = plan.wph;     // the warp takes rows sub, sub + wph, ... of a tile
  const int qw = Hkv >= kConsumerWarps ? (Hkv - warp + kConsumerWarps - 1) / kConsumerWarps * rep
                                       : rep;
  int koff[QP];                  // offset of query head r's KV head in a row
  float qr[QP][NC];
  float acc[QP][NC];
#pragma unroll
  for (int r = 0; r < QP; ++r) {
    const int g = g0 + kConsumerWarps * (r / rep);
    koff[r] = g * D;
    const T* qh = q + (static_cast<long long>(b) * H + g * rep + r % rep) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      qr[r][c] = (r < qw && col < D) ? to_float(qh[col]) : 0.0f;
      acc[r][c] = 0.0f;
    }
  }
  bool in_d[NC];                 // this lane's columns that exist
#pragma unroll
  for (int c = 0; c < NC; ++c) in_d[c] = lane + 32 * c < D;
  const int hr = lane / TR;      // the head and the group row of this lane's score
  const int tr = lane % TR;
  float m = kNegInf, l = 0.0f;   // head hr's running max and sum

  // A KV head's segment of tile row t: every query head's in one load (one
  // KV head a warp), or each query head's own (MULTI: past 8 KV heads).
  auto segment = [&](const T* tile, int t, int r, float (&x)[NC]) {
    const T* p = tile + t * row_elems + koff[r] + lane;
#pragma unroll
    for (int c = 0; c < NC; ++c) x[c] = in_d[c] ? to_float(p[32 * c]) : 0.0f;
  };

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % S;
    const int rows = min(Tr, nrows - i * Tr);
    mbar_wait(&full[s], (i / S) & 1);
    const T* ks = reinterpret_cast<const T*>(ring + s * 2 * half);
    const T* vs = reinterpret_cast<const T*>(ring + s * 2 * half + half);

    for (int g0row = sub; g0row < rows; g0row += step * TR) {
      // scores of the group's rows g0row + step * j, j < TR; a row past the
      // tile reads its last row, and its score is masked below
      float x[32];
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        const int t = min(g0row + step * j, rows - 1);
        float kr[NC];
        if (!MULTI) segment(ks, t, 0, kr);
#pragma unroll
        for (int r = 0; r < QP; ++r) {
          if (MULTI) segment(ks, t, r, kr);
          float p = 0.0f;
#pragma unroll
          for (int c = 0; c < NC; ++c) p = fmaf(qr[r][c], kr[c], p);
          x[r * TR + j] = p;
        }
      }
      const float dot = transpose_sum(x, lane);
      const bool valid = hr < qw && g0row + step * tr < rows;
      const float sv = valid ? dot * scale : kNegInf;
      // the online-softmax update of every head at once (groups of TR lanes)
      float gm = sv;
#pragma unroll
      for (int o = TR / 2; o > 0; o >>= 1) gm = fmaxf(gm, __shfl_xor_sync(kFull, gm, o));
      const float m_new = fmaxf(m, gm);
      const float alpha = expf(m - m_new);
      const float pw = valid ? expf(sv - m_new) : 0.0f;
      float ps = pw;
#pragma unroll
      for (int o = TR / 2; o > 0; o >>= 1) ps += __shfl_xor_sync(kFull, ps, o);
      l = l * alpha + ps;
      m = m_new;
#pragma unroll
      for (int r = 0; r < QP; ++r) {
        const float a = __shfl_sync(kFull, alpha, r * TR);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] *= a;
      }
      // acc += P . V over the group's rows (a masked row's weight is 0)
#pragma unroll
      for (int j = 0; j < TR; ++j) {
        const int t = min(g0row + step * j, rows - 1);
        float vr[NC];
        if (!MULTI) segment(vs, t, 0, vr);
#pragma unroll
        for (int r = 0; r < QP; ++r) {
          if (MULTI) segment(vs, t, r, vr);
          const float pr = __shfl_sync(kFull, pw, r * TR + j);
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(pr, vr[c], acc[r][c]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const int parts = plan.parts();
  const int part = split * plan.wph + sub;
  const long long head_g0 = static_cast<long long>(b) * H;
  if (tr == 0 && hr < qw) {
    const int h = (g0 + kConsumerWarps * (hr / rep)) * rep + hr % rep;
    m_part[(head_g0 + h) * parts + part] = m;
    l_part[(head_g0 + h) * parts + part] = l;
  }
#pragma unroll
  for (int r = 0; r < QP; ++r) {
    if (r < qw) {
      const int h = (g0 + kConsumerWarps * (r / rep)) * rep + r % rep;
      const long long idx = (head_g0 + h) * parts + part;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = lane + 32 * c;
        if (col < D) acc_part[idx * D + col] = acc[r][c];
      }
    }
  }
}

// One CTA per query head (b, h): out = sum_s acc_s e^(m_s - M) /
// max(sum_s l_s e^(m_s - M), 1e-30), M = max_s m_s. The weights e^(m_s - M)
// are computed once a part into shared memory; every sum runs in a fixed
// order (the acc sums part by part, L strided over one warp's lanes, then
// its butterfly), so the output repeats bit for bit.
template <typename T>
__global__ void __launch_bounds__(128)
swa_combine_kernel(const float* __restrict__ m_part, const float* __restrict__ l_part,
                   const float* __restrict__ acc_part, T* __restrict__ out, int parts,
                   int D) {
  extern __shared__ float weight[];     // parts
  __shared__ float warp_max_s[4];
  __shared__ float total;
  const long long bh = blockIdx.x;
  const float* m = m_part + bh * parts;
  const float* l = l_part + bh * parts;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float mx = kNegInf;
  for (int s = tid; s < parts; s += 128) mx = fmaxf(mx, m[s]);
  mx = warp_max(mx);
  if (lane == 0) warp_max_s[warp] = mx;
  __syncthreads();
  const float M = fmaxf(fmaxf(warp_max_s[0], warp_max_s[1]), fmaxf(warp_max_s[2], warp_max_s[3]));
  for (int s = tid; s < parts; s += 128) weight[s] = expf(m[s] - M);
  __syncthreads();
  if (warp == 0) {
    float x = 0.0f;
    for (int s = lane; s < parts; s += 32) x += l[s] * weight[s];
    x = warp_sum(x);
    if (lane == 0) total = x;
  }
  __syncthreads();
  const float denom = fmaxf(total, 1e-30f);
  const float* acc = acc_part + bh * parts * D;
  for (int d = tid; d < D; d += 128) {
    float a = 0.0f;
#pragma unroll 8
    for (int s = 0; s < parts; ++s) a += acc[static_cast<long long>(s) * D + d] * weight[s];
    store_as(out + bh * D + d, a / denom);
  }
}

template <typename T, int NC, int QP, bool MULTI>
int launch(const Plan& plan, const void* q, const void* k, const void* v, void* out,
           void* m_part, void* l_part, void* acc_part, int B, int W, int H, int Hkv, int D,
           float scale, cudaStream_t stream) {
  auto kernel = swa_partial_kernel<T, NC, QP, MULTI>;
  static size_t granted = 0;      // the shared memory this instantiation may use
  cudaError_t e;
  if (plan.smem > granted) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(plan.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = plan.smem;
  }
  kernel<<<dim3(plan.n_split, B), kThreads, plan.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<float*>(m_part), static_cast<float*>(l_part), static_cast<float*>(acc_part),
      W, H, Hkv, D, plan, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  swa_combine_kernel<T><<<B * H, 128, plan.parts() * sizeof(float), stream>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<const float*>(acc_part), static_cast<T*>(out), plan.parts(), D);
  return static_cast<int>(cudaGetLastError());
}

#define SWA_ARGS plan, q, k, v, out, m_part, l_part, acc_part, B, W, H, Hkv, D, scale, s

template <typename T, int NC, int QP>
int launch_multi(const Plan& plan, const void* q, const void* k, const void* v, void* out,
                 void* m_part, void* l_part, void* acc_part, int B, int W, int H, int Hkv,
                 int D, float scale, cudaStream_t s) {
  // past 8 KV heads a warp serves two or more of them: QP >= 2
  if constexpr (QP > 1) {
    if (Hkv > kConsumerWarps) return launch<T, NC, QP, true>(SWA_ARGS);
  }
  return launch<T, NC, QP, false>(SWA_ARGS);
}

template <typename T, int NC>
int launch_qp(const Plan& plan, const void* q, const void* k, const void* v, void* out,
              void* m_part, void* l_part, void* acc_part, int B, int W, int H, int Hkv, int D,
              float scale, cudaStream_t s) {
  switch (plan.qp) {
    case 1: return launch_multi<T, NC, 1>(SWA_ARGS);
    case 2: return launch_multi<T, NC, 2>(SWA_ARGS);
    case 4: return launch_multi<T, NC, 4>(SWA_ARGS);
    default:
      if constexpr (NC * 8 <= 32) return launch_multi<T, NC, 8>(SWA_ARGS);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_nc(const Plan& plan, const void* q, const void* k, const void* v, void* out,
              void* m_part, void* l_part, void* acc_part, int B, int W, int H, int Hkv, int D,
              float scale, cudaStream_t s) {
  switch (plan.nc) {
    case 2: return launch_qp<T, 2>(SWA_ARGS);
    case 3: return launch_qp<T, 3>(SWA_ARGS);
    case 4: return launch_qp<T, 4>(SWA_ARGS);
    default: return launch_qp<T, 8>(SWA_ARGS);
  }
}

#undef SWA_ARGS

}  // namespace

// The number of partials per query head the launch below writes (the
// caller's scratch: m_part, l_part (B * H, parts), acc_part (B * H, parts,
// D) float32), or for a shape the kernel does not take kTooWide (a warp
// serves more than 8 query heads, padded to a power of two, or more than 32
// accumulators a lane: ceil(D / 32) columns a lane, at least 2, 5 to 8
// rounding to 8, D <= 256), kNoTiles (a tile of two rows over the ring, or
// a window whose rows cannot be cut into 16-byte-aligned tiles), or another
// cudaError_t, negated.
extern "C" int swa_decode_parts(int B, int W, int H, int Hkv, int D, int bf16) {
  Plan plan;
  const int err = make_plan(B, W, H, Hkv, D, bf16 ? 2 : 4, &plan);
  if (err != 0) return err < 0 ? err : -err;
  return plan.parts();
}

// q (B, H, D), k/v (B, W, Hkv, D) of one type (bf16 != 0: bfloat16, else
// float32), contiguous, k and v 16-byte aligned -> out (B, H, D) of that
// type. Returns cudaGetLastError() after the two launches,
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int swa_decode_launch(const void* q, const void* k, const void* v, void* out,
                                 void* m_part, void* l_part, void* acc_part, int B, int W,
                                 int H, int Hkv, int D, float scale, int bf16, void* stream) {
  Plan plan;
  const int err = make_plan(B, W, H, Hkv, D, bf16 ? 2 : 4, &plan);
  if (err != 0) return err < 0 ? static_cast<int>(cudaErrorInvalidValue) : err;
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_nc<__nv_bfloat16>(plan, q, k, v, out, m_part, l_part, acc_part, B, W, H, Hkv,
                                    D, scale, s);
  return launch_nc<float>(plan, q, k, v, out, m_part, l_part, acc_part, B, W, H, Hkv, D, scale,
                          s);
}

// every instantiation `launch_nc` reaches
static const KernelEntry kKernels[] = {
    KERNEL_ENTRY("swa_partial_kernel<float,2,1,false>", swa_partial_kernel<float, 2, 1, false>),
    KERNEL_ENTRY("swa_partial_kernel<float,2,2,true>", swa_partial_kernel<float, 2, 2, true>),
    KERNEL_ENTRY("swa_partial_kernel<float,2,2,false>", swa_partial_kernel<float, 2, 2, false>),
    KERNEL_ENTRY("swa_partial_kernel<float,2,4,true>", swa_partial_kernel<float, 2, 4, true>),
    KERNEL_ENTRY("swa_partial_kernel<float,2,4,false>", swa_partial_kernel<float, 2, 4, false>),
    KERNEL_ENTRY("swa_partial_kernel<float,2,8,true>", swa_partial_kernel<float, 2, 8, true>),
    KERNEL_ENTRY("swa_partial_kernel<float,2,8,false>", swa_partial_kernel<float, 2, 8, false>),
    KERNEL_ENTRY("swa_partial_kernel<float,3,1,false>", swa_partial_kernel<float, 3, 1, false>),
    KERNEL_ENTRY("swa_partial_kernel<float,3,2,true>", swa_partial_kernel<float, 3, 2, true>),
    KERNEL_ENTRY("swa_partial_kernel<float,3,2,false>", swa_partial_kernel<float, 3, 2, false>),
    KERNEL_ENTRY("swa_partial_kernel<float,3,4,true>", swa_partial_kernel<float, 3, 4, true>),
    KERNEL_ENTRY("swa_partial_kernel<float,3,4,false>", swa_partial_kernel<float, 3, 4, false>),
    KERNEL_ENTRY("swa_partial_kernel<float,3,8,true>", swa_partial_kernel<float, 3, 8, true>),
    KERNEL_ENTRY("swa_partial_kernel<float,3,8,false>", swa_partial_kernel<float, 3, 8, false>),
    KERNEL_ENTRY("swa_partial_kernel<float,4,1,false>", swa_partial_kernel<float, 4, 1, false>),
    KERNEL_ENTRY("swa_partial_kernel<float,4,2,true>", swa_partial_kernel<float, 4, 2, true>),
    KERNEL_ENTRY("swa_partial_kernel<float,4,2,false>", swa_partial_kernel<float, 4, 2, false>),
    KERNEL_ENTRY("swa_partial_kernel<float,4,4,true>", swa_partial_kernel<float, 4, 4, true>),
    KERNEL_ENTRY("swa_partial_kernel<float,4,4,false>", swa_partial_kernel<float, 4, 4, false>),
    KERNEL_ENTRY("swa_partial_kernel<float,4,8,true>", swa_partial_kernel<float, 4, 8, true>),
    KERNEL_ENTRY("swa_partial_kernel<float,4,8,false>", swa_partial_kernel<float, 4, 8, false>),
    KERNEL_ENTRY("swa_partial_kernel<float,8,1,false>", swa_partial_kernel<float, 8, 1, false>),
    KERNEL_ENTRY("swa_partial_kernel<float,8,2,true>", swa_partial_kernel<float, 8, 2, true>),
    KERNEL_ENTRY("swa_partial_kernel<float,8,2,false>", swa_partial_kernel<float, 8, 2, false>),
    KERNEL_ENTRY("swa_partial_kernel<float,8,4,true>", swa_partial_kernel<float, 8, 4, true>),
    KERNEL_ENTRY("swa_partial_kernel<float,8,4,false>", swa_partial_kernel<float, 8, 4, false>),
    KERNEL_ENTRY("swa_combine_kernel<float>", swa_combine_kernel<float>),
    KERNEL_ENTRY("swa_partial_kernel<bf16,2,1,false>", swa_partial_kernel<__nv_bfloat16, 2, 1, false>),
    KERNEL_ENTRY("swa_partial_kernel<bf16,2,2,true>", swa_partial_kernel<__nv_bfloat16, 2, 2, true>),
    KERNEL_ENTRY("swa_partial_kernel<bf16,2,2,false>", swa_partial_kernel<__nv_bfloat16, 2, 2, false>),
    KERNEL_ENTRY("swa_partial_kernel<bf16,2,4,true>", swa_partial_kernel<__nv_bfloat16, 2, 4, true>),
    KERNEL_ENTRY("swa_partial_kernel<bf16,2,4,false>", swa_partial_kernel<__nv_bfloat16, 2, 4, false>),
    KERNEL_ENTRY("swa_partial_kernel<bf16,2,8,true>", swa_partial_kernel<__nv_bfloat16, 2, 8, true>),
    KERNEL_ENTRY("swa_partial_kernel<bf16,2,8,false>", swa_partial_kernel<__nv_bfloat16, 2, 8, false>),
    KERNEL_ENTRY("swa_partial_kernel<bf16,3,1,false>", swa_partial_kernel<__nv_bfloat16, 3, 1, false>),
    KERNEL_ENTRY("swa_partial_kernel<bf16,3,2,true>", swa_partial_kernel<__nv_bfloat16, 3, 2, true>),
    KERNEL_ENTRY("swa_partial_kernel<bf16,3,2,false>", swa_partial_kernel<__nv_bfloat16, 3, 2, false>),
    KERNEL_ENTRY("swa_partial_kernel<bf16,3,4,true>", swa_partial_kernel<__nv_bfloat16, 3, 4, true>),
    KERNEL_ENTRY("swa_partial_kernel<bf16,3,4,false>", swa_partial_kernel<__nv_bfloat16, 3, 4, false>),
    KERNEL_ENTRY("swa_partial_kernel<bf16,3,8,true>", swa_partial_kernel<__nv_bfloat16, 3, 8, true>),
    KERNEL_ENTRY("swa_partial_kernel<bf16,3,8,false>", swa_partial_kernel<__nv_bfloat16, 3, 8, false>),
    KERNEL_ENTRY("swa_partial_kernel<bf16,4,1,false>", swa_partial_kernel<__nv_bfloat16, 4, 1, false>),
    KERNEL_ENTRY("swa_partial_kernel<bf16,4,2,true>", swa_partial_kernel<__nv_bfloat16, 4, 2, true>),
    KERNEL_ENTRY("swa_partial_kernel<bf16,4,2,false>", swa_partial_kernel<__nv_bfloat16, 4, 2, false>),
    KERNEL_ENTRY("swa_partial_kernel<bf16,4,4,true>", swa_partial_kernel<__nv_bfloat16, 4, 4, true>),
    KERNEL_ENTRY("swa_partial_kernel<bf16,4,4,false>", swa_partial_kernel<__nv_bfloat16, 4, 4, false>),
    KERNEL_ENTRY("swa_partial_kernel<bf16,4,8,true>", swa_partial_kernel<__nv_bfloat16, 4, 8, true>),
    KERNEL_ENTRY("swa_partial_kernel<bf16,4,8,false>", swa_partial_kernel<__nv_bfloat16, 4, 8, false>),
    KERNEL_ENTRY("swa_partial_kernel<bf16,8,1,false>", swa_partial_kernel<__nv_bfloat16, 8, 1, false>),
    KERNEL_ENTRY("swa_partial_kernel<bf16,8,2,true>", swa_partial_kernel<__nv_bfloat16, 8, 2, true>),
    KERNEL_ENTRY("swa_partial_kernel<bf16,8,2,false>", swa_partial_kernel<__nv_bfloat16, 8, 2, false>),
    KERNEL_ENTRY("swa_partial_kernel<bf16,8,4,true>", swa_partial_kernel<__nv_bfloat16, 8, 4, true>),
    KERNEL_ENTRY("swa_partial_kernel<bf16,8,4,false>", swa_partial_kernel<__nv_bfloat16, 8, 4, false>),
    KERNEL_ENTRY("swa_combine_kernel<bf16>", swa_combine_kernel<__nv_bfloat16>),
};
KERNEL_ATTRS_EXPORT(kKernels)
