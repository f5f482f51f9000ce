// K7: single-token sliding-window attention decode over a full ring-buffer
// KV cache, the window split across CTAs (flash-decoding), with GQA.
//
// Replaces: repro/kernels/swa_decode.py `_swa_kernel` (reached through
// `swa_decode_kernel`): q (B, H, D), k/v (B, W, H, D) -> out (B, H, D), an
// online softmax (running max m, sum l, accumulator acc) over window chunks;
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
// The TPU grid walks (batch, chunk) in order and carries m, l and acc in
// VMEM from one chunk to the next. On the H100 such a grid is B * Hkv = 32
// CTAs, a quarter of the 132 SMs left to read 84 MB. So the window is split:
// one CTA per (batch, KV head, chunk), (W / chunk) x (B * Hkv) CTAs (256 at
// chunk 512). Each CTA reads its chunk's K and V rows once, 16 bytes a
// thread and coalesced, in tiles of kTile rows through shared memory, and
// serves all H / Hkv query heads of its group from them: GQA's saving is
// that K and V are read once, not once per query head. It writes a partial
// (m, l, acc[D]) per query head; swa_combine_kernel merges the partials
// with the same rescaling and the same floor. expf, no fast math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;     // window rows per shared-memory tile
constexpr int kMaxAcc = 8;    // accumulator entries a thread: (H / Hkv) * D <= 2048
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// VEC consecutive elements at src as floats: one 16-byte load when VEC > 1.
template <typename T, int VEC>
struct Loader;

template <>
struct Loader<float, 1> {
  static __device__ __forceinline__ void load(const float* __restrict__ src, float* dst) {
    dst[0] = __ldg(src);
  }
};

template <>
struct Loader<float, 4> {
  static __device__ __forceinline__ void load(const float* __restrict__ src, float* dst) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(src));
    dst[0] = x.x;
    dst[1] = x.y;
    dst[2] = x.z;
    dst[3] = x.w;
  }
};

template <>
struct Loader<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ src,
                                              float* dst) {
    dst[0] = __bfloat162float(src[0]);
  }
};

template <>
struct Loader<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ src,
                                              float* dst) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
    const unsigned int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // little-endian: the lower half-word is the first element
      dst[2 * i] = __uint_as_float(words[i] << 16);
      dst[2 * i + 1] = __uint_as_float(words[i] & 0xFFFF0000u);
    }
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xFFFFFFFFu, x, o);
  return x;
}

// Shared memory of one CTA, in floats.
__host__ __device__ inline int smem_floats(int rep, int D) {
  return kTile * (D + 1)   // K tile, rows padded by one float: conflict-free dot products
         + kTile * D       // V tile
         + rep * D         // the group's query rows
         + rep * kTile     // scores, then softmax weights
         + 3 * rep;        // m, l, and the tile's rescale alpha
}

// One CTA: batch b, KV head g (blockIdx.y = b * Hkv + g), window rows
// [split * chunk, (split + 1) * chunk) (blockIdx.x = split). Writes the
// partial m, l (B * H, n_split) and acc (B * H, n_split, D) of each of the
// group's rep = H / Hkv query heads.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
swa_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, float* __restrict__ m_part,
                   float* __restrict__ l_part, float* __restrict__ acc_part, int W, int H,
                   int Hkv, int D, int chunk, float scale) {
  extern __shared__ float smem[];
  const int rep = H / Hkv;
  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int b = blockIdx.y / Hkv;
  const int g = blockIdx.y - b * Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int Dp = D + 1;
  float* k_s = smem;
  float* v_s = k_s + kTile * Dp;
  float* q_s = v_s + kTile * D;
  float* p_s = q_s + rep * D;
  float* m_s = p_s + rep * kTile;
  float* l_s = m_s + rep;
  float* a_s = l_s + rep;

  const long long head0 = static_cast<long long>(b) * H + static_cast<long long>(g) * rep;
  const T* q_g = q + head0 * D;
  for (int i = tid; i < rep * D; i += kThreads) q_s[i] = to_float(q_g[i]);
  for (int r = tid; r < rep; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.0f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) acc[j] = 0.0f;

  const long long row_stride = static_cast<long long>(Hkv) * D;
  const long long first_row = static_cast<long long>(b) * W + static_cast<long long>(split) * chunk;
  const T* k_g = k + first_row * row_stride + static_cast<long long>(g) * D;
  const T* v_g = v + first_row * row_stride + static_cast<long long>(g) * D;
  const int dv = D / VEC;

  for (int t0 = 0; t0 < chunk; t0 += kTile) {
    const int rows = min(kTile, chunk - t0);
    // 1. this tile's K and V rows into shared memory, as floats
    const int units = rows * dv;
    for (int u = tid; u < units; u += kThreads) {
      const int t = u / dv;
      const int c = (u - t * dv) * VEC;
      const long long off = static_cast<long long>(t0 + t) * row_stride + c;
      float kv[VEC], vv[VEC];
      Loader<T, VEC>::load(k_g + off, kv);
      Loader<T, VEC>::load(v_g + off, vv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        k_s[t * Dp + c + i] = kv[i];
        v_s[t * D + c + i] = vv[i];
      }
    }
    __syncthreads();
    // 2. scores s[r][t] = (q_r . k_t) * scale
    for (int i = tid; i < rep * rows; i += kThreads) {
      const int r = i / rows;
      const int t = i - r * rows;
      const float* kr = k_s + t * Dp;
      const float* qr = q_s + r * D;
      float s = 0.0f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      p_s[r * kTile + t] = s * scale;
    }
    __syncthreads();
    // 3. one warp per query head: the tile's max, the rescale alpha of what
    //    came before, the weights p = exp(s - m_new) and their sum
    for (int r = warp; r < rep; r += kWarps) {
      float* pr = p_s + r * kTile;
      float mx = kNegInf;
      for (int t = lane; t < rows; t += 32) mx = fmaxf(mx, pr[t]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int t = lane; t < rows; t += 32) {
        const float p = expf(pr[t] - m_new);
        pr[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // 4. acc[r][d] = acc[r][d] * alpha_r + sum_t p[r][t] * v[t][d]
#pragma unroll
    for (int j = 0; j < kMaxAcc; ++j) {
      const int i = tid + j * kThreads;
      if (i < rep * D) {
        const int r = i / D;
        const int d = i - r * D;
        const float* pr = p_s + r * kTile;
        float a = acc[j] * a_s[r];
        for (int t = 0; t < rows; ++t) a = fmaf(pr[t], v_s[t * D + d], a);
        acc[j] = a;
      }
    }
    __syncthreads();
  }

  for (int r = tid; r < rep; r += kThreads) {
    m_part[(head0 + r) * n_split + split] = m_s[r];
    l_part[(head0 + r) * n_split + split] = l_s[r];
  }
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) {
    const int i = tid + j * kThreads;
    if (i < rep * D) {
      const int r = i / D;
      const int d = i - r * D;
      acc_part[((head0 + r) * n_split + split) * D + d] = acc[j];
    }
  }
}

// One CTA per query head (b, h): out = sum_s acc_s e^(m_s - M) /
// max(sum_s l_s e^(m_s - M), 1e-30), M = max_s m_s.
template <typename T>
__global__ void __launch_bounds__(128)
swa_combine_kernel(const float* __restrict__ m_part, const float* __restrict__ l_part,
                   const float* __restrict__ acc_part, T* __restrict__ out, int n_split,
                   int D) {
  const long long bh = blockIdx.x;
  const float* m = m_part + bh * n_split;
  const float* l = l_part + bh * n_split;
  float M = kNegInf;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, m[s]);
  float L = 0.0f;
  for (int s = 0; s < n_split; ++s) L += l[s] * expf(m[s] - M);
  const float denom = fmaxf(L, 1e-30f);
  const float* acc = acc_part + bh * n_split * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.0f;
    for (int s = 0; s < n_split; ++s) a += acc[s * D + d] * expf(m[s] - M);
    store_as(out + bh * D + d, a / denom);
  }
}

template <typename T, int VEC>
int launch(const void* q, const void* k, const void* v, void* out, void* m_part,
           void* l_part, void* acc_part, int B, int W, int H, int Hkv, int D, int chunk,
           float scale, cudaStream_t stream) {
  const int rep = H / Hkv;
  const size_t smem = static_cast<size_t>(smem_floats(rep, D)) * sizeof(float);
  auto kernel = swa_partial_kernel<T, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_split = W / chunk;
  kernel<<<dim3(n_split, B * Hkv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<float*>(m_part), static_cast<float*>(l_part), static_cast<float*>(acc_part),
      W, H, Hkv, D, chunk, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  swa_combine_kernel<T><<<B * H, 128, 0, stream>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(l_part),
      static_cast<const float*>(acc_part), static_cast<T*>(out), n_split, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H, D), k/v (B, W, Hkv, D) of one type (bf16 != 0: bfloat16, else
// float32), contiguous -> out (B, H, D) of that type. Scratch from the
// caller: m_part, l_part (B * H, W / chunk) and acc_part (B * H, W / chunk,
// D) float32. vec != 0: 16-byte loads (D a multiple of 4 floats or 8
// bfloat16s, pointers 16-byte aligned). Returns cudaGetLastError() after the
// launches, cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int swa_decode_launch(const void* q, const void* k, const void* v, void* out,
                                 void* m_part, void* l_part, void* acc_part, int B, int W,
                                 int H, int Hkv, int D, int chunk, float scale, int bf16,
                                 int vec, void* stream) {
  if (B <= 0 || W <= 0 || D <= 0 || Hkv <= 0 || chunk <= 0 || H % Hkv != 0 ||
      W % chunk != 0 || (H / Hkv) * D > kMaxAcc * kThreads || B * Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<size_t>(smem_floats(H / Hkv, D)) * sizeof(float) > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (vec) return launch<__nv_bfloat16, 8>(q, k, v, out, m_part, l_part, acc_part, B, W, H,
                                             Hkv, D, chunk, scale, s);
    return launch<__nv_bfloat16, 1>(q, k, v, out, m_part, l_part, acc_part, B, W, H, Hkv, D,
                                    chunk, scale, s);
  }
  if (vec) return launch<float, 4>(q, k, v, out, m_part, l_part, acc_part, B, W, H, Hkv, D,
                                   chunk, scale, s);
  return launch<float, 1>(q, k, v, out, m_part, l_part, acc_part, B, W, H, Hkv, D, chunk,
                          scale, s);
}
