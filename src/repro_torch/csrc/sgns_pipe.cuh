// K5 and K6: the SGNS step as a chain of pair blocks over deduplicated rows,
// one cooperative launch per step for all workers.
//
// Replaces: repro/kernels/sgns_fused_pipe.py `_pipe_kernel` (K5) and
// repro/kernels/sgns_fused_tiered.py `_tiered_kernel` (K6). On the TPU each
// block DMAs its unique touched rows from HBM into a ring of VMEM slots,
// computes there, and writes each row back once; K6 also pins a hot prefix of
// the frequency-sorted tables in VMEM for the whole step. The H100 has no
// VMEM of that size: one slot holds blk (K + 2) rows (3.6 MB per worker at
// blk = 256, d = 500), far beyond an SM's 227 KB of shared memory. So the
// ring, (2, n, R_W + R_C, d), lives in device memory, allocated by the
// wrapper, and K6 reads and updates its hot rows in place in the tables: a
// copy in device memory would only move them from HBM to HBM, and the hot
// rows the steps keep touching stay in the 50 MB L2 on their own. What the
// kernel keeps is the chain's semantics and the reference's row traffic: per
// block, each unique cold row is gathered once and written back once.
//
// One persistent grid, two CTAs of 8 warps an SM, co-resident by cooperative
// launch (a grid that cannot be co-resident is refused by the launch and the
// wrapper raises); phases are separated by grid.sync(). Every phase strides
// its items (a slot, a pair, a position of the sorted lists) over all warps,
// one item a warp:
//
//   gather(0)
//   for each block b (slot s = b % 2):
//     pairs(b)      one warp per (worker, pair): K2's pair body (`pair_step`)
//                   on the slot's rows (K6: a hot id's row in the table);
//                   loss, coefficients and dW to scratch. Padded pairs
//                   (global index >= B) do nothing.
//                   + gather(b + 1) for the workers whose hazard[b + 1] == 0
//     apply C(b)    one warp per run of the (block, target)-sorted C
//                   elements: the slot row (or hot row) plus its addends
//                   -lr g_k W_center in element order (contexts, then
//                   negatives), stored once: to the table for a cold slot —
//                   the write-back — or in place for a hot row. The lanes
//                   find the run's end and read 32 addends' rows and
//                   coefficients at once; the adds stay serial, in order.
//     apply W(b)    the same over the W elements, addends -lr dW
//     gather(b + 1) for the workers whose hazard[b + 1] != 0
//
// Two slots are enough at any ring depth the planner was run with: block
// b + 1's gathers, the earliest, run after every read of block b - 1's slot
// (its applies end before pairs(b) starts), so no more than two slots are
// ever live. A plan made for a deeper ring only flags more hazards: its
// look-behind covers block b, the one this order needs.
//
// Hazards: block b + 1's gathers overtake block b's write-backs only where
// the planner found no cold row in common (hazard[b + 1] == 0); a hazard
// moves the gathers after the applies and never changes the result. Hot rows
// are never gathered, so they need no flag. The C apply reads the W rows of
// the block's pairs, so the W apply (which rewrites hot W rows in place in K6)
// comes after it. Cold W stores go to the table, not to the slot, so the slot
// keeps the block-start rows the C apply reads.
//
// Bits: the pair body, the addends (__fmul_rn(neg_lr, __fmul_rn(g, w)) and
// __fmul_rn(neg_lr, dW)) and their order per row are K4a's
// (`sgns_fused_hbm.cu`), and the slot holds exact copies of the rows K4a
// reads, so the tables and the loss are bitwise K4a's at the same block size.
// No float atomics: the same inputs give the same bits on every run.
//
// Bound on the H100: memory. The least a step must move is each distinct row
// it touches read once and written once, K4a's and K2's count; per block the
// kernel moves each unique cold row in and out (the planner's row traffic,
// `plan_row_traffic`) and copies it through the ring, all above that bound.
// The phases run far from it: each is a round of dependent loads per warp,
// and a grid barrier separates them.
#pragma once

#include <cooperative_groups.h>

#include "sgns_step.cuh"

namespace sgns {
namespace cg = cooperative_groups;

struct PipeArgs {
  float* W;                  // (n, V, d), updated in place
  float* C;                  // (n, V, d)
  float* loss;               // (n, B)
  const int* uw;             // (n, nb, RW) sorted unique cold center rows
  const int* uc;             // (n, nb, RC) sorted unique cold context/negative rows
  const int* n_w;            // (n, nb)
  const int* n_c;            // (n, nb)
  const int* hazard;         // (n, nb)
  const int* w_pos;          // (n, nb, blk)
  const int* cp_pos;         // (n, nb, blk)
  const int* cn_pos;         // (n, nb, blk K)
  const int* cen;            // (n, nb, blk) ids (K6's hot routing)
  const int* ctx;            // (n, nb, blk)
  const int* neg;            // (n, nb, blk K)
  const int* w_tgt;          // (n, nb blk) targets sorted by (block, target)
  const int* w_el;           // (n, nb blk) element (pair) index within its block
  const int* c_tgt;          // (n, nb LC), LC = blk (K + 1)
  const int* c_el;           // (n, nb LC) element index: context j, or blk + j K + k
  float* ring;               // (2, n, RW + RC, d)
  float* coef;               // (n, blk, K + 1)
  float* dW;                 // (n, blk, d)
  int n, V, d, B, K, blk, nb, kH;
  float neg_lr;
};

template <int VEC>
__device__ __forceinline__ void copy_row(float* dst, const float* src, int d, int lane) {
  for (int e = lane * VEC; e < d; e += 32 * VEC) {
    float v[VEC];
    load_vec<VEC>(src + e, v);
    store_vec<VEC>(dst + e, v);
  }
}

// Gather block b's valid rows into slot b % 2 for the workers whose
// hazard[b] == want (want < 0: every worker), one warp per slot. The flag,
// the count and the row id are read together, not one after another.
template <int VEC>
__device__ void gather_block(const PipeArgs& a, int b, int want, long long warp,
                             long long nwarps, int lane) {
  const int RW = a.blk, RC = a.blk * (a.K + 1), R = RW + RC;
  const int s = b % 2;
  const long long items = static_cast<long long>(a.n) * R;
  for (long long it = warp; it < items; it += nwarps) {
    const int w = static_cast<int>(it / R);
    const int r = static_cast<int>(it % R);
    const long long wb = static_cast<long long>(w) * a.nb + b;
    const bool c_row = r >= RW;
    const int hz = want >= 0 ? a.hazard[wb] : 0;
    const int count = c_row ? a.n_c[wb] : a.n_w[wb];
    const int row = c_row ? a.uc[wb * RC + (r - RW)] : a.uw[wb * RW + r];
    if (want >= 0 && (hz != 0) != (want != 0)) continue;
    if ((c_row ? r - RW : r) >= count) continue;
    copy_row<VEC>(a.ring + ((static_cast<long long>(s) * a.n + w) * R + r) * a.d,
                  (c_row ? a.C : a.W) + (static_cast<long long>(w) * a.V + row) * a.d, a.d,
                  lane);
  }
}

// An element's row: K6's hot id in place in the worker's table rows
// `rows`, else its slot.
template <bool TIERED>
__device__ __forceinline__ const float* hot_or_slot(const PipeArgs& a, const float* slot_base,
                                                    const float* rows, int id, int pos) {
  if (TIERED && id < a.kH) return rows + static_cast<long long>(id) * a.d;
  return slot_base + static_cast<long long>(pos) * a.d;
}

template <int VEC, bool TIERED>
__device__ void pairs_block(const PipeArgs& a, int b, long long warp, long long nwarps,
                            int lane) {
  const int RW = a.blk, RC = a.blk * (a.K + 1), R = RW + RC;
  const int s = b % 2;
  const long long items = static_cast<long long>(a.n) * a.blk;
  for (long long it = warp; it < items; it += nwarps) {
    const int w = static_cast<int>(it / a.blk);
    const int j = static_cast<int>(it % a.blk);
    const int p = b * a.blk + j;
    if (p >= a.B) continue;
    const long long e = (static_cast<long long>(w) * a.nb + b) * a.blk + j;
    const float* slot_w = a.ring + (static_cast<long long>(s) * a.n + w) * R * a.d;
    const float* slot_c = slot_w + static_cast<long long>(RW) * a.d;
    const float* table_w = a.W + static_cast<long long>(w) * a.V * a.d;
    const float* table_c = a.C + static_cast<long long>(w) * a.V * a.d;
    const float* wrow = hot_or_slot<TIERED>(a, slot_w, table_w, TIERED ? a.cen[e] : 0,
                                            a.w_pos[e]);
    const float* cpos = hot_or_slot<TIERED>(a, slot_c, table_c, TIERED ? a.ctx[e] : 0,
                                            a.cp_pos[e]);
    const int my_pos = lane < a.K ? a.cn_pos[e * a.K + lane] : 0;
    const int my_id = TIERED && lane < a.K ? a.neg[e * a.K + lane] : 0;
    const float* cneg[kMaxNegatives];
#pragma unroll
    for (int k = 0; k < kMaxNegatives; ++k) {
      const int src = k < a.K ? k : 0;
      const int pos = __shfl_sync(kFull, my_pos, src);
      const int id = __shfl_sync(kFull, my_id, src);
      cneg[k] = hot_or_slot<TIERED>(a, slot_c, table_c, id, pos);
    }
    const long long wj = static_cast<long long>(w) * a.blk + j;
    pair_step<VEC, true>(wrow, cpos, cneg, a.K, a.d, lane,
                         a.loss + static_cast<long long>(w) * a.B + p,
                         a.coef + wj * (a.K + 1), a.dW + wj * a.d);
  }
}

// One run of equal targets starting at position i0 of worker w's block-b
// range of the sorted lists (C_TABLE: the C elements; else the W elements),
// by one warp: the row (slot or hot) plus its addends in element order,
// stored once. The run's end and each 32 addends' coefficient and row are
// read by the warp's lanes at once; the adds stay serial, in order.
template <int VEC, bool TIERED, bool C_TABLE>
__device__ void apply_run(const PipeArgs& a, int b, int w, int i0, int lane) {
  const int RW = a.blk, RC = a.blk * (a.K + 1), R = RW + RC;
  const int L = C_TABLE ? RC : RW;         // elements (and slots) per block
  const int s = b % 2;
  const long long wb = static_cast<long long>(w) * a.nb + b;
  const int* tgt = (C_TABLE ? a.c_tgt : a.w_tgt) + wb * L;
  const int* el = (C_TABLE ? a.c_el : a.w_el) + wb * L;
  const int t = tgt[i0];
  int i1 = i0 + 1;
  for (;;) {
    const int i = i1 + lane;
    const unsigned ends = __ballot_sync(kFull, i >= L || tgt[i] != t);
    if (ends) {
      i1 += __ffs(ends) - 1;
      break;
    }
    i1 += 32;
  }

  float* slot = a.ring + ((static_cast<long long>(s) * a.n + w) * R + (C_TABLE ? RW : 0)) *
                             a.d;
  float* rows = (C_TABLE ? a.C : a.W) + static_cast<long long>(w) * a.V * a.d;
  const float* src;
  float* dst;
  if (t < L) {
    if (t >= (C_TABLE ? a.n_c[wb] : a.n_w[wb])) return;   // a pad slot: never written back
    const int row = (C_TABLE ? a.uc : a.uw)[wb * L + t];
    src = slot + static_cast<long long>(t) * a.d;
    dst = rows + static_cast<long long>(row) * a.d;
  } else {
    src = dst = rows + static_cast<long long>(t - L) * a.d;   // a hot row, in place
  }
  const float* slot_w = a.ring + (static_cast<long long>(s) * a.n + w) * R * a.d;
  const float* w_rows = a.W + static_cast<long long>(w) * a.V * a.d;
  constexpr int kChunk = 32 * VEC * kTile;
  for (int c0 = 0; c0 < a.d; c0 += kChunk) {
    float acc[kTile][VEC];
#pragma unroll
    for (int tt = 0; tt < kTile; ++tt) {
      const int e = c0 + tt * 32 * VEC + lane * VEC;
      if (e < a.d) load_vec<VEC>(src + e, acc[tt]);
    }
    for (int j0 = i0; j0 < i1; j0 += 32) {
      // lane j: addend j0 + j — its row and coefficient, or none for a
      // padded pair. C: x < blk is pair x's context; else negative
      // x - blk = q K + k.
      unsigned long long ptr = 0;
      float g = 0.0f;
      if (j0 + lane < i1) {
        const int x = el[j0 + lane];
        const int q = C_TABLE ? (x < a.blk ? x : (x - a.blk) / a.K) : x;
        if (b * a.blk + q < a.B) {
          if constexpr (C_TABLE) {
            const int k1 = x < a.blk ? 0 : 1 + (x - a.blk) % a.K;
            g = a.coef[(static_cast<long long>(w) * a.blk + q) * (a.K + 1) + k1];
            const long long e = wb * a.blk + q;
            ptr = reinterpret_cast<unsigned long long>(
                hot_or_slot<TIERED>(a, slot_w, w_rows, TIERED ? a.cen[e] : 0, a.w_pos[e]));
          } else {
            ptr = reinterpret_cast<unsigned long long>(
                a.dW + (static_cast<long long>(w) * a.blk + q) * a.d);
          }
        }
      }
      const int cnt = i1 - j0 < 32 ? i1 - j0 : 32;
      for (int j = 0; j < cnt; ++j) {
        const float* addend = reinterpret_cast<const float*>(__shfl_sync(kFull, ptr, j));
        const float gj = __shfl_sync(kFull, g, j);
        if (addend == nullptr) continue;   // a padded pair adds nothing
#pragma unroll
        for (int tt = 0; tt < kTile; ++tt) {
          const int e = c0 + tt * 32 * VEC + lane * VEC;
          if (e < a.d) {
            float v[VEC];
            load_vec<VEC>(addend + e, v);
#pragma unroll
            for (int u = 0; u < VEC; ++u) {
              const float up = C_TABLE ? __fmul_rn(a.neg_lr, __fmul_rn(gj, v[u]))
                                       : __fmul_rn(a.neg_lr, v[u]);
              acc[tt][u] = __fadd_rn(acc[tt][u], up);
            }
          }
        }
      }
    }
#pragma unroll
    for (int tt = 0; tt < kTile; ++tt) {
      const int e = c0 + tt * 32 * VEC + lane * VEC;
      if (e < a.d) store_vec<VEC>(dst + e, acc[tt]);
    }
  }
}

// Every run of block b, for every worker: one warp per position of the
// sorted lists; the warp at the head of a run applies it.
template <int VEC, bool TIERED, bool C_TABLE>
__device__ void apply_block(const PipeArgs& a, int b, long long warp, long long nwarps,
                            int lane) {
  const int L = C_TABLE ? a.blk * (a.K + 1) : a.blk;
  const int* tgt_all = C_TABLE ? a.c_tgt : a.w_tgt;
  const long long items = static_cast<long long>(a.n) * L;
  for (long long it = warp; it < items; it += nwarps) {
    const int w = static_cast<int>(it / L);
    const int i = static_cast<int>(it % L);
    const int* tgt = tgt_all + (static_cast<long long>(w) * a.nb + b) * L;
    if (i > 0 && tgt[i - 1] == tgt[i]) continue;   // not the head of its run
    apply_run<VEC, TIERED, C_TABLE>(a, b, w, i, lane);
  }
}

// Whether any worker's block b has a hazard. Every CTA reads the same flags,
// so every CTA takes the same grid.sync()s.
__device__ __forceinline__ bool any_hazard(const PipeArgs& a, int b) {
  int h = 0;
  for (int w = threadIdx.x; w < a.n; w += blockDim.x) {
    h |= a.hazard[static_cast<long long>(w) * a.nb + b];
  }
  return __syncthreads_or(h) != 0;
}

// Two CTAs per SM: the phases are latency-bound, so warps in flight count.
template <int VEC, bool TIERED>
__global__ void __launch_bounds__(kWarps * 32, 2) pipe_kernel(PipeArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const long long warp = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;

  gather_block<VEC>(a, 0, -1, warp, nwarps, lane);
  grid.sync();
  for (int b = 0; b < a.nb; ++b) {
    const bool next = b + 1 < a.nb;
    pairs_block<VEC, TIERED>(a, b, warp, nwarps, lane);
    if (next) gather_block<VEC>(a, b + 1, 0, warp, nwarps, lane);
    grid.sync();
    apply_block<VEC, TIERED, true>(a, b, warp, nwarps, lane);
    grid.sync();
    apply_block<VEC, TIERED, false>(a, b, warp, nwarps, lane);
    grid.sync();
    if (next && any_hazard(a, b + 1)) {
      gather_block<VEC>(a, b + 1, 1, warp, nwarps, lane);
      grid.sync();
    }
  }
}

// Sizes the persistent grid to what the card holds at once and launches it
// cooperatively on `stream`.
template <int VEC, bool TIERED>
cudaError_t launch_pipe_kernel(const PipeArgs& a, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pipe_kernel<VEC, TIERED>,
                                                      kWarps * 32, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  PipeArgs args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(pipe_kernel<VEC, TIERED>),
                                    dim3(static_cast<unsigned>(per_sm * sms)),
                                    dim3(kWarps * 32), params, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The C entry points' common body: checks and packs the arguments.
template <bool TIERED>
int pipe_launch(void* W, void* C, void* loss, const void* uw, const void* uc,
                const void* n_w, const void* n_c, const void* hazard, const void* w_pos,
                const void* cp_pos, const void* cn_pos, const void* cen, const void* ctx,
                const void* neg, const void* w_tgt, const void* w_el, const void* c_tgt,
                const void* c_el, void* ring, void* coef, void* dW, int n, int V, int d, int B,
                int K, int blk, int nb, int kH, float neg_lr, int vec4, void* stream) {
  if (n == 0 || B == 0) return 0;
  if (K < 1 || K > kMaxNegatives || blk < 1 || nb < 1 || kH < 0 ||
      (TIERED && kH < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PipeArgs a;
  a.W = static_cast<float*>(W);
  a.C = static_cast<float*>(C);
  a.loss = static_cast<float*>(loss);
  a.uw = static_cast<const int*>(uw);
  a.uc = static_cast<const int*>(uc);
  a.n_w = static_cast<const int*>(n_w);
  a.n_c = static_cast<const int*>(n_c);
  a.hazard = static_cast<const int*>(hazard);
  a.w_pos = static_cast<const int*>(w_pos);
  a.cp_pos = static_cast<const int*>(cp_pos);
  a.cn_pos = static_cast<const int*>(cn_pos);
  a.cen = static_cast<const int*>(cen);
  a.ctx = static_cast<const int*>(ctx);
  a.neg = static_cast<const int*>(neg);
  a.w_tgt = static_cast<const int*>(w_tgt);
  a.w_el = static_cast<const int*>(w_el);
  a.c_tgt = static_cast<const int*>(c_tgt);
  a.c_el = static_cast<const int*>(c_el);
  a.ring = static_cast<float*>(ring);
  a.coef = static_cast<float*>(coef);
  a.dW = static_cast<float*>(dW);
  a.n = n; a.V = V; a.d = d; a.B = B; a.K = K; a.blk = blk; a.nb = nb;
  a.kH = TIERED ? kH : 0;
  a.neg_lr = neg_lr;
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = vec4 ? launch_pipe_kernel<4, TIERED>(a, s)
                               : launch_pipe_kernel<1, TIERED>(a, s);
  return static_cast<int>(err);
}

}  // namespace sgns
