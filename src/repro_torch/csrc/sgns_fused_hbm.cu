// K4: the SGNS step as a chain of pair blocks, and word2vec's per-pair order.
//
// Replaces: repro/kernels/sgns_fused_hbm.py `_hbm_block_kernel` (K4a) and
// `_hbm_sequential_kernel` (K4b), reached through `sgns_fused_hbm_step`. On
// the TPU the (V, d) tables stay in HBM and each pair block DMAs its touched
// rows into VMEM; the chain of aliased invocations makes block b + 1 read
// block b's writes. On the H100 the tables live in HBM anyway; what this
// kernel keeps is the chain's *semantics*, which change the results:
//
// K4a (sgns_hbm_chain_launch), per block of `blk` pairs (a shorter tail
//   block covers any remainder): every gradient from the tables as of block
//   start, then a deterministic apply in which each touched row's addends
//   come in reference order (W at centers; C at contexts, then negatives) and
//   are added serially with no float atomics; the loss in the log-sigmoid
//   form of `sparse_row_grads_per_pair`. One persistent launch runs every
//   worker's whole chain, the sort of its touched rows by (block, row)
//   included: `sgns_block_step.cuh`, shared with K2, which is this chain
//   with one block.
// K4b (sgns_hbm_sequential_launch): word2vec's per-pair order. Each pair's
//   K + 1 dot products read its rows as every earlier pair left them; then
//   its W row and context row are written, and each negative row is re-read
//   after every earlier write to it (a context that is also a negative, a
//   repeated negative) and added to. The work is a chain of B dependent
//   pairs per worker, so what bounds it is the latency of each link, not
//   bytes. The design shortens the link:
//   * a thread block cluster of kSeqCluster CTAs per worker, each CTA owning
//     a fixed slice of the d columns and each thread fixed columns of every
//     row, so a thread orders its own re-reads by program order and no
//     table value crosses threads; only the K + 1 dot products do: every
//     warp pushes its partial sums into a slot of every CTA's shared memory
//     (distributed shared memory), one cluster barrier
//     (barrier.cluster.arrive.release / wait.acquire) follows, and every
//     warp sums the slots in the same fixed order, so all CTAs hold the same
//     bits of s and the run repeats;
//   * the worker's indices staged in shared memory in chunks, so no pair
//     chases index -> address -> row through device memory;
//   * the rows of pair p + 1 loaded at the start of pair p, after every
//     earlier pair's stores in the thread's program order, and pair p's new
//     values forwarded in registers to the rows of pair p + 1 they equal
//     (exact: it is the value a later load would return), so the loads of
//     one pair overlap the previous pair's reduction, barrier and apply;
//   * few instructions a link, since each SM runs a warp or two whose
//     instructions issue one after another: the partial sums are reduced
//     by one transposing shuffle pass, each lane e <= K sums slot e and
//     takes its own sigmoid (shuffles hand the coefficients round), the
//     row-id comparisons that forwarding and a row repeated within a pair
//     need are made for a whole chunk of pairs when its indices are
//     staged, so a pair reads one flag word and selects per column only
//     when a comparison hit (a few per cent of pairs:
//     analysis/pair_conflicts.py), and the losses are taken per chunk from
//     the kept dot products. Prefetching deeper than one pair only added
//     forwarding work.
//   The apply's arithmetic is the batch-1 sparse step's, rounded as before
//   (__fmul_rn / __fadd_rn).
//
// Negatives: the whole step's (n, B, K) draw at the pairs' global counters,
// which equals the per-block draws (`block_negative_ids`): K4a makes it
// inside its launch (`sgns_block_step.cuh`); K4b takes K1's
// (`sample_negatives.cu`, the wrapper's launch before this one).
//
// Bound on the H100: memory for K4a — the step's distinct touched rows read
// once and written once (what bounds the launch and what its design does
// about it: `sgns_block_step.cuh`). K4b is latency-bound by nature (B
// dependent links per worker, one cluster per worker; see above).

#include <cooperative_groups.h>

#include "func_attrs.cuh"
#include "sgns_block_step.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kSeqCluster = 8;        // CTAs a worker (the portable cluster size)
constexpr int kSeqMaxThreads = 128;
constexpr int kSeqMaxWarps = kSeqMaxThreads / 32;
constexpr int kSeqChunk = 256;        // pairs whose indices are staged at once

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A worker's pairs [p0 - 1, p0 + chunk] in shared memory (the pair before
// the chunk, whose writes the chunk's first pair reads; the pair after it,
// loaded during its last): their ids, and what the row-id comparisons say,
// worked out for the whole chunk at once, off the chain of pairs:
//   flags bit 0: a C slot of the pair repeats an earlier one; rep[e] is the
//     latest earlier slot with slot e's row (-1: none);
//   flags bit 1: a C row of the pair is one the pair before wrote; fwd[e]
//     is the latest slot of the pair before with slot e's row (-1: none);
//   flags bit 2: the pair's center is the pair before's.
// C slot e of a pair is its context (e = 0) or its negative e - 1.
template <int KM>
struct Staged {
  static constexpr int kInts = KM + 3;   // center, context, KM negatives, flags
  int* ids;                              // (pairs, kInts)
  signed char* rep;                      // (pairs, KM + 1)
  signed char* fwd;                      // (pairs, KM + 1)
  __device__ __forceinline__ int cen(int q) const { return ids[q * kInts]; }
  __device__ __forceinline__ int c_id(int q, int e) const { return ids[q * kInts + 1 + e]; }
  __device__ __forceinline__ int flags(int q) const { return ids[q * kInts + KM + 2]; }
  static size_t bytes(int pairs) {
    return static_cast<size_t>(pairs) * (kInts * sizeof(int) + 2 * (KM + 1));
  }
};

// Pair q's row ids (id[0] the center, id[1 + e] C slot e; -1 past K) and
// this thread's columns of its rows (w; c[e]; zeros past K). Plain loads:
// the kernel writes the tables.
template <int KM, int CPT>
__device__ __forceinline__ void load_pair(const Staged<KM>& st, int q, int K, const float* Wt,
                                          const float* Ct, int d, const int (&col)[CPT],
                                          const bool (&ok)[CPT], int (&id)[KM + 2],
                                          float (&w)[CPT], float (&c)[KM + 1][CPT]) {
  id[0] = st.cen(q);
#pragma unroll
  for (int e = 0; e <= KM; ++e) id[1 + e] = e <= K ? st.c_id(q, e) : -1;
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    w[j] = ok[j] ? Wt[static_cast<long long>(id[0]) * d + col[j]] : 0.0f;
#pragma unroll
    for (int e = 0; e <= KM; ++e) {
      c[e][j] = (id[1 + e] >= 0 && ok[j]) ? Ct[static_cast<long long>(id[1 + e]) * d + col[j]]
                                          : 0.0f;
    }
  }
}

// The K + 1 partial dot products s[0 .. KM] summed over the warp. For up to
// 8 values, a transposing reduction (9 shuffles): on return lane l holds
// value 4 b4 + 2 b3 + b2 (bX: bit X of l), and 8 lanes, one a value, push;
// past 8 values, a butterfly a value. Either way the same bits in every
// warp for the same inputs.
template <int KM>
__device__ __forceinline__ void push_sums(float (&s)[KM + 1], int lane, int K,
                                          cg::cluster_group& cluster, float* slot_row) {
  if constexpr (KM + 1 <= 8) {
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e <= KM ? s[e] : 0.0f;
    const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float send = b4 ? v[i] : v[i + 4];
      v[i] = (b4 ? v[i + 4] : v[i]) + __shfl_xor_sync(sgns::kFull, send, 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float send = b3 ? v[i] : v[i + 2];
      v[i] = (b3 ? v[i + 2] : v[i]) + __shfl_xor_sync(sgns::kFull, send, 8);
    }
    const float send = b2 ? v[0] : v[1];
    float x = (b2 ? v[1] : v[0]) + __shfl_xor_sync(sgns::kFull, send, 4);
    x += __shfl_xor_sync(sgns::kFull, x, 2);
    x += __shfl_xor_sync(sgns::kFull, x, 1);
    const int e = (b4 ? 4 : 0) + (b3 ? 2 : 0) + (b2 ? 1 : 0);
    if ((lane & 3) == 0 && e <= K) {
#pragma unroll
      for (int r = 0; r < kSeqCluster; ++r) *cluster.map_shared_rank(slot_row + e, r) = x;
    }
  } else {
#pragma unroll
    for (int e = 0; e <= KM; ++e) s[e] = sgns::warp_sum(s[e]);
    if (lane <= K) {
      float v = s[0];
#pragma unroll
      for (int e = 1; e <= KM; ++e) {
        if (e == lane) v = s[e];
      }
#pragma unroll
      for (int r = 0; r < kSeqCluster; ++r) *cluster.map_shared_rank(slot_row + lane, r) = v;
    }
  }
}

// One cluster per worker (blockIdx.x / kSeqCluster). W, C (n, V, d): no
// __restrict__, a pair's rows may be one row, written and re-read.
template <int KM, int CPT>
__global__ void __cluster_dims__(kSeqCluster, 1, 1) __launch_bounds__(kSeqMaxThreads, 1)
sgns_sequential_kernel(float* W, float* C, const int* __restrict__ centers,
                       const int* __restrict__ contexts, const int* __restrict__ ids,
                       int V, int d, int B, int K, float neg_lr,
                       float* __restrict__ loss) {
  // Partial dot products, double-buffered by pair parity: slot
  // rank * warps + warp of every CTA holds that warp's K + 1 sums.
  __shared__ float slots[2][kSeqCluster * kSeqMaxWarps][KM + 1];
  // Rank 0 keeps each pair's K + 1 dot products; the chunk's losses are
  // taken from them at its end, off the chain.
  __shared__ float dots[kSeqChunk][KM + 1];
  extern __shared__ int staged_mem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int w = blockIdx.x / kSeqCluster;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int n_slots = kSeqCluster * warps;
  const int me = rank * warps + warp;
  const int chunk = B < kSeqChunk ? B : kSeqChunk;
  const int cap = chunk + 2;
  Staged<KM> st;
  st.ids = staged_mem;
  st.rep = reinterpret_cast<signed char*>(staged_mem + cap * Staged<KM>::kInts);
  st.fwd = st.rep + cap * (KM + 1);
  float* Wt = W + static_cast<long long>(w) * V * d;
  float* Ct = C + static_cast<long long>(w) * V * d;
  const int* cen_g = centers + static_cast<long long>(w) * B;
  const int* ctx_g = contexts + static_cast<long long>(w) * B;
  const int* ids_g = ids + static_cast<long long>(w) * B * K;
  float* loss_w = loss + static_cast<long long>(w) * B;

  // This thread's columns: the CTA's slice [rank * per_cta, ...), strided.
  const int per_cta = (d + kSeqCluster - 1) / kSeqCluster;
  int col[CPT];
  bool ok[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int c = j * blockDim.x + tid;
    col[j] = rank * per_cta + c;
    ok[j] = c < per_cta && col[j] < d;
  }

  // Pair p lives in slot p & 1; pair p + 1's rows are loaded at the start
  // of pair p, after every earlier pair's stores by this thread.
  int id[2][KM + 2];
  float wv[2][CPT], cv[2][KM + 1][CPT];
  int chunk0 = 0;

  // The losses of pairs [chunk0, end), from rank 0's kept dot products, in
  // the form and order of sparse_row_grads_per_pair.
  auto chunk_losses = [&](int end) {
    if (rank != 0) return;
    for (int i = tid; i < end - chunk0; i += blockDim.x) {
      float l_neg = 0.0f;
      for (int k = 0; k < K; ++k) l_neg += sgns::log_sigmoid(-dots[i][1 + k]);
      loss_w[chunk0 + i] = -sgns::log_sigmoid(dots[i][0]) - l_neg;
    }
  };

  for (int p0 = 0; p0 < B; p0 += 2) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {     // unrolled: the slot indices are constants
      const int p = p0 + u;
      if (p < B) {
        if (p % chunk == 0) {          // the next chunk's indices and comparisons
          __syncthreads();
          if (p > 0) chunk_losses(p);
          chunk0 = p;
          const int first = p > 0 ? p - 1 : 0;
          const int n = min(p + chunk + 1, B) - first;   // staged pairs
          const int off = p - first;                     // 1, or 0 at the start
          for (int i = tid; i < n; i += blockDim.x) {
            int* row = st.ids + (i + 1 - off) * Staged<KM>::kInts;
            row[0] = cen_g[first + i];
            row[1] = ctx_g[first + i];
            for (int k = 0; k < KM; ++k) {
              row[2 + k] = k < K ? ids_g[static_cast<long long>(first + i) * K + k] : -1;
            }
          }
          __syncthreads();
          for (int i = tid; i < n; i += blockDim.x) {
            const int q = i + 1 - off;
            if (q == 0) continue;          // the pair before the chunk: done
            signed char* rep = st.rep + q * (KM + 1);
            signed char* fwd = st.fwd + q * (KM + 1);
            int flags = 0;
            for (int e = 0; e <= K; ++e) {
              const int x = st.c_id(q, e);
              int r = -1, f = -1;
              for (int a = 0; a < e; ++a) {
                if (st.c_id(q, a) == x) r = a;
              }
              if (first + i > 0) {
                for (int a = 0; a <= K; ++a) {
                  if (st.c_id(q - 1, a) == x) f = a;
                }
              }
              rep[e] = static_cast<signed char>(r);
              fwd[e] = static_cast<signed char>(f);
              flags |= (r >= 0 ? 1 : 0) | (f >= 0 ? 2 : 0);
            }
            if (first + i > 0 && st.cen(q) == st.cen(q - 1)) flags |= 4;
            st.ids[q * Staged<KM>::kInts + KM + 2] = flags;
          }
          __syncthreads();
          if (p == 0) {
            load_pair<KM, CPT>(st, 1, K, Wt, Ct, d, col, ok, id[0], wv[0], cv[0]);
            cluster.sync();            // every CTA of the cluster runs: slots may be written
          }
        }
        const int q = p - chunk0 + 1;  // pair p's staged row
        const int nx = 1 - u;
        const bool more = p + 1 < B;
        if (more) load_pair<KM, CPT>(st, q + 1, K, Wt, Ct, d, col, ok, id[nx], wv[nx], cv[nx]);

        // The K + 1 dot products: lanes, then warps, then CTAs, in fixed
        // order (slots past K hold zeros).
        float s[KM + 1];
#pragma unroll
        for (int e = 0; e <= KM; ++e) {
          s[e] = 0.0f;
#pragma unroll
          for (int j = 0; j < CPT; ++j) s[e] += wv[u][j] * cv[u][e][j];
        }
        float(*buf)[KM + 1] = slots[p & 1];
        push_sums<KM>(s, lane, K, cluster, buf[me]);
        cluster_arrive_release();
        cluster_wait_acquire();

        // Lane e <= K sums slot e over every warp of the cluster in a fixed
        // order (so every CTA holds the same bits) and takes its sigmoid
        // coefficient; shuffles hand the coefficients round.
        float tot = 0.0f;
        if (lane <= K) {
          for (int i = 0; i < n_slots; ++i) tot += buf[i][lane];
          if (rank == 0 && warp == 0) dots[p - chunk0][lane] = tot;
        }
        const float sg = sgns::sigmoid(tot);
        const float gl = lane == 0 ? sg - 1.0f : (lane <= K ? sg : 0.0f);
        const float g_pos = __shfl_sync(sgns::kFull, gl, 0);
        float g[KM];
#pragma unroll
        for (int k = 0; k < KM; ++k) g[k] = __shfl_sync(sgns::kFull, gl, 1 + k);

        // The batch-1 sparse step on this thread's columns: dW from the
        // pair's rows, then W, the context row, and each negative row after
        // every earlier write to it within the pair (rep: rare).
        const int flags = st.flags(q);
        float new_w[CPT], new_c[KM + 1][CPT] = {};
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const float wj = wv[u][j];
          float acc = __fmul_rn(g[0], cv[u][1][j]);
#pragma unroll
          for (int k = 1; k < KM; ++k) {
            if (k < K) acc = __fadd_rn(acc, __fmul_rn(g[k], cv[u][1 + k][j]));
          }
          const float dw = __fadd_rn(__fmul_rn(g_pos, cv[u][0][j]), acc);
          new_w[j] = __fadd_rn(wj, __fmul_rn(neg_lr, dw));
          new_c[0][j] = __fadd_rn(cv[u][0][j], __fmul_rn(neg_lr, __fmul_rn(g_pos, wj)));
#pragma unroll
          for (int k = 0; k < KM; ++k) {
            float base = cv[u][1 + k][j];
            if (flags & 1) {
              const int from = st.rep[q * (KM + 1) + 1 + k];
#pragma unroll
              for (int a = 0; a < KM; ++a) {
                if (a == from) base = new_c[a][j];
              }
            }
            if (k < K) new_c[1 + k][j] = __fadd_rn(base, __fmul_rn(neg_lr, __fmul_rn(g[k], wj)));
          }
          if (ok[j]) {
            Wt[static_cast<long long>(id[u][0]) * d + col[j]] = new_w[j];
#pragma unroll
            for (int e = 0; e <= KM; ++e) {
              if (e <= K) Ct[static_cast<long long>(id[u][1 + e]) * d + col[j]] = new_c[e][j];
            }
          }
        }

        // Forward pair p's new values to the rows of pair p + 1 they equal,
        // loaded before pair p's stores (rare).
        if (more) {
          const int next = st.flags(q + 1);
          if (next & 4) {
#pragma unroll
            for (int j = 0; j < CPT; ++j) wv[nx][j] = new_w[j];
          }
          if (next & 2) {
#pragma unroll
            for (int e = 0; e <= KM; ++e) {
              const int from = st.fwd[(q + 1) * (KM + 1) + e];
#pragma unroll
              for (int j = 0; j < CPT; ++j) {
#pragma unroll
                for (int a = 0; a <= KM; ++a) {
                  if (e <= K && a == from) cv[nx][e][j] = new_c[a][j];
                }
              }
            }
          }
        }
      }
    }
  }
  __syncthreads();
  chunk_losses(B);
  cluster.sync();   // no CTA leaves while another may still read its slots
}

template <int KM, int CPT>
cudaError_t launch_sequential(float* W, float* C, const int* centers, const int* contexts,
                              const int* ids, int n, int V, int d, int B, int K,
                              float neg_lr, float* loss, int threads, cudaStream_t s) {
  const int chunk = B < kSeqChunk ? B : kSeqChunk;
  const size_t smem = Staged<KM>::bytes(chunk + 2);
  auto kernel = sgns_sequential_kernel<KM, CPT>;
  static size_t granted = 0;      // past 48 KB with the static arrays (KM = 16)
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    granted = smem;
  }
  kernel<<<n * kSeqCluster, threads, smem, s>>>(
      W, C, centers, contexts, ids, V, d, B, K, neg_lr, loss);
  return cudaGetLastError();
}

}  // namespace

// K4a. The arguments are `sgns::block_step_entry`'s.
extern "C" int sgns_hbm_chain_launch(
    void* W, void* C, void* loss, const void* centers, const void* contexts, void* ids,
    const void* seeds, const void* prob, const void* alias, void* w_rows, void* w_perm,
    void* c_rows, void* c_perm, void* coef, void* dW, void* wrows, void* items, void* n_items,
    void* counters, void* sort_mem, long long sort_bytes, int item_cap, int n, int V, int d,
    int B, int K, int blk, int group_ctas, int groups, int sorters, float neg_lr, int vec4,
    void* stream) {
  return sgns::block_step_entry<true>(W, C, loss, centers, contexts, ids, seeds, prob, alias,
                                      w_rows, w_perm, c_rows, c_perm, coef, dW, wrows, items,
                                      n_items, counters, sort_mem, sort_bytes, item_cap, n, V, d,
                                      B, K, blk, group_ctas, groups, sorters, neg_lr, vec4,
                                      stream);
}

// K4b. Same tables and ids; loss (n, B). One cluster of kSeqCluster CTAs
// per worker; d <= 4,096 (at most 4 columns a thread).
extern "C" int sgns_hbm_sequential_launch(void* W, void* C, const void* centers,
                                          const void* contexts, const void* ids, int n,
                                          int V, int d, int B, int K, float neg_lr,
                                          void* loss, void* stream) {
  if (n == 0 || B == 0) return 0;
  if (K < 1 || K > sgns::kMaxNegatives || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int per_cta = (d + kSeqCluster - 1) / kSeqCluster;
  int threads = (per_cta + 31) / 32 * 32;
  if (threads > kSeqMaxThreads) threads = kSeqMaxThreads;
  const int cols = (per_cta + threads - 1) / threads;
  if (cols > 4) return static_cast<int>(cudaErrorInvalidValue);
  auto* Wf = static_cast<float*>(W);
  auto* Cf = static_cast<float*>(C);
  auto* cen = static_cast<const int*>(centers);
  auto* ctx = static_cast<const int*>(contexts);
  auto* neg = static_cast<const int*>(ids);
  auto* out = static_cast<float*>(loss);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define SEQ_ARGS Wf, Cf, cen, ctx, neg, n, V, d, B, K, neg_lr, out, threads, s
  if (K <= 5) {
    err = cols == 1 ? launch_sequential<5, 1>(SEQ_ARGS)
        : cols == 2 ? launch_sequential<5, 2>(SEQ_ARGS)
                    : launch_sequential<5, 4>(SEQ_ARGS);
  } else if (K <= 8) {
    err = cols == 1 ? launch_sequential<8, 1>(SEQ_ARGS)
        : cols == 2 ? launch_sequential<8, 2>(SEQ_ARGS)
                    : launch_sequential<8, 4>(SEQ_ARGS);
  } else {
    err = cols == 1 ? launch_sequential<16, 1>(SEQ_ARGS)
        : cols == 2 ? launch_sequential<16, 2>(SEQ_ARGS)
                    : launch_sequential<16, 4>(SEQ_ARGS);
  }
#undef SEQ_ARGS
  return static_cast<int>(err);
}

static const KernelEntry kKernels[] = {
    KERNEL_ENTRY("block_step_kernel<true,true>", sgns::block_step_kernel<true, true>),
    KERNEL_ENTRY("block_step_kernel<false,true>", sgns::block_step_kernel<false, true>),
    KERNEL_ENTRY("sgns_sequential_kernel<5,1>", sgns_sequential_kernel<5, 1>),
    KERNEL_ENTRY("sgns_sequential_kernel<5,2>", sgns_sequential_kernel<5, 2>),
    KERNEL_ENTRY("sgns_sequential_kernel<5,4>", sgns_sequential_kernel<5, 4>),
    KERNEL_ENTRY("sgns_sequential_kernel<8,1>", sgns_sequential_kernel<8, 1>),
    KERNEL_ENTRY("sgns_sequential_kernel<8,2>", sgns_sequential_kernel<8, 2>),
    KERNEL_ENTRY("sgns_sequential_kernel<8,4>", sgns_sequential_kernel<8, 4>),
    KERNEL_ENTRY("sgns_sequential_kernel<16,1>", sgns_sequential_kernel<16, 1>),
    KERNEL_ENTRY("sgns_sequential_kernel<16,2>", sgns_sequential_kernel<16, 2>),
    KERNEL_ENTRY("sgns_sequential_kernel<16,4>", sgns_sequential_kernel<16, 4>),
};
KERNEL_ATTRS_EXPORT(kKernels)
