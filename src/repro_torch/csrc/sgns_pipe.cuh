// K5 and K6: the SGNS step as a chain of pair blocks, one launch per step for
// all workers, every row read and updated in place in the tables.
//
// Replaces: repro/kernels/sgns_fused_pipe.py `_pipe_kernel` (K5) and
// repro/kernels/sgns_fused_tiered.py `_tiered_kernel` (K6). On the TPU each
// block DMAs its unique touched rows from HBM into a ring of VMEM slots,
// computes there and writes each row back once; K6 also pins a hot prefix of
// the frequency-sorted tables in VMEM for the whole step. The function is
// K4a's (`sgns_fused_hbm.cu`): per block of `blk` pairs, every gradient from
// the tables as of block start, then each touched row's addends in reference
// order. The H100 has no VMEM of that size (one slot of blk (K + 2) rows is
// 3.6 MB at blk = 256, d = 500) and gains nothing from a staging copy in
// device memory: the rows stay where they are, and the 50 MB L2 keeps a
// block's rows close between its phases.
//
// One persistent launch, two CTAs of 8 warps an SM, co-resident by
// cooperative launch. Its CTAs are split into groups, one worker a group (a
// group takes several workers in turn when there are more workers than
// groups). The workers share no rows, so a group's phases are separated by a
// group barrier (an arrival counter in global memory: red.release.gpu, then
// ld.acquire.gpu until every CTA of the group has arrived), and one worker's
// slow phase stalls no other worker. Per block b of a worker:
//
//   pairs(b)    one warp per pair: K2's pair body (`pair_step`'s
//               arithmetic, in its order) on the pair's K + 2 rows, first
//               copied into the warp's shared-memory stage by cp.async (all
//               of their column steps at once, 14 KB at d = 500, K = 5; dW
//               reads them again from there); loss, coefficients, dW and
//               the pair's W row (as of block start) to per-worker scratch.
//   | barrier
//   applies(b)  items of (window of kWindow positions of one table's
//               (block, row)-sorted list, column chunk of 32 VEC floats),
//               the C list's and the W list's in one phase: both read only
//               scratch (C's addends -lr g_k W_center from the W-row copy,
//               W's -lr dW from dW) and they write disjoint tables. Each run
//               that starts in a window is applied to its chunk by one warp,
//               the row plus its addends in element order (C: contexts, then
//               negatives), stored once. The lanes fetch 32 positions' rows,
//               addend offsets and coefficients at once, and a run that goes
//               on past them has its next 32 fetched before these are added;
//               the next kAhead addend chunks (and the chunks of the rows
//               whose runs they start) are staged by cp.async before they
//               are added, strictly in order. A Zipf-hot row's run is split
//               over its column chunks.
//   | barrier   (not after the worker's last block)
//
// K6 (TIERED) is this kernel with L2 cache hints, the card's counterpart of
// the reference's VMEM-resident prefix: loads and stores of table rows < kH
// carry an evict_last policy, the others evict_first, and at the end of a
// worker's step its hot rows go back to normal priority (applypriority
// .L2::evict_normal). At the main path's hot_rows = 256 the hot rows of both
// tables of all ten workers are 256 x 2 x 10 x 2,000 B = 10 MB of the 50 MB.
//
// Bits: the pair body, the addends (__fmul_rn(neg_lr, __fmul_rn(g, w)) and
// __fmul_rn(neg_lr, dW)) and their order per element are K4a's, on the same
// values (the W-row copy is exact), so the tables and the loss are bitwise
// K4a's at the same block size, at every hot tier. No float atomics: the
// same inputs give the same bits on every run.
//
// Bound on the H100: memory. The least a step must move is each distinct row
// it touches read once and written once (K2's and K4a's count). The kernel
// reads each pair's rows in the pairs phase and each run's row again in the
// applies, the second time mostly from L2, and writes two rows of scratch a
// pair. What keeps it above the bound is latency: a phase is a few rounds of
// dependent loads per warp (a pair's stage; a window's index fetch and its
// staged batches), 256 pairs a block share ~208 warps a worker, and a
// barrier (~2 us) separates the phases. Staging in shared memory, not
// registers, is what lets the lookahead grow without spilling: both phases
// live in one kernel at 128 registers.
#pragma once

#include <algorithm>
#include <cstdint>

#include "sgns_step.cuh"
#include "sm90_async.cuh"

namespace sgns {

using sm90::group_barrier;   // the group barrier between a worker's phases

constexpr int kWindow = 16;    // sorted positions per apply item (<= 32)
constexpr int kAhead = 8;      // addend chunks staged before they are added
constexpr int kMinGroup = 8;   // CTAs a worker's group has at least, where the card has them
constexpr int kStageBytes = 14336;   // a warp's shared-memory stage: 7 rows of 512 floats
static_assert(kWindow <= 32, "an apply item's window is fetched by one warp's lanes");

struct ChainArgs {
  float* W;                  // (n, V, d), updated in place
  float* C;                  // (n, V, d)
  float* loss;               // (n, B)
  const int* centers;        // (n, B)
  const int* contexts;       // (n, B)
  const int* ids;            // (n, B, K)
  const int* w_keys;         // (n, B) center rows sorted stably by (block, row)
  const long long* w_perm;   // (n, B) the pair each came from
  const int* c_keys;         // (n, B (K + 1)) context and negative rows, so sorted
  const long long* c_perm;   // (n, B (K + 1)) index into concat(contexts, ids)
  float* coef;               // (n, blk, K + 1) scratch
  float* dW;                 // (n, blk, d) scratch
  float* wrows;              // (n, blk, d) scratch: the pairs' W rows as of block start
  int* arrive;               // (groups) barrier counters, zeroed by the launch
  int n, V, d, B, K, blk, kH, group_ctas, groups, stage_steps, stage_floats;
  float neg_lr;
};

// ---------------------------------------------------------------------------
// L2 cache policies (K6)
// ---------------------------------------------------------------------------
__device__ __forceinline__ unsigned long long l2_policy(bool last) {
  unsigned long long p;
  if (last) {
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  } else {
    asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  }
  return p;
}

template <int VEC>
__device__ __forceinline__ void load_hint(const float* p, float (&v)[VEC],
                                          unsigned long long pol) {
  if constexpr (VEC == 4) {
    asm volatile("ld.global.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
                 : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
                 : "l"(p), "l"(pol)
                 : "memory");
  } else {
    asm volatile("ld.global.L2::cache_hint.f32 %0, [%1], %2;"
                 : "=f"(v[0])
                 : "l"(p), "l"(pol)
                 : "memory");
  }
}

template <int VEC>
__device__ __forceinline__ void store_hint(float* p, const float (&v)[VEC],
                                           unsigned long long pol) {
  if constexpr (VEC == 4) {
    asm volatile("st.global.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, %5;"
                 :
                 : "l"(p), "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]), "l"(pol)
                 : "memory");
  } else {
    asm volatile("st.global.L2::cache_hint.f32 [%0], %1, %2;"
                 :
                 : "l"(p), "f"(v[0]), "l"(pol)
                 : "memory");
  }
}

// VEC floats from global memory at p into this thread's shared memory at s,
// asynchronously (cp.async; complete after wait_staged()).
template <int VEC>
__device__ __forceinline__ void stage_plain(const float* p, float* s) {
  const auto dst = static_cast<unsigned>(__cvta_generic_to_shared(s));
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" : : "r"(dst), "l"(p) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" : : "r"(dst), "l"(p) : "memory");
  }
}

// Table row loads and stores: plain (K5), or with the policy of a hot
// (evict_last) or cold (evict_first) row (K6).
template <bool HINT>
struct RowIO {
  unsigned long long hot = 0, cold = 0;
  __device__ __forceinline__ RowIO() {
    if constexpr (HINT) {
      hot = l2_policy(true);
      cold = l2_policy(false);
    }
  }
  template <int VEC>
  __device__ __forceinline__ void load(const float* p, float (&v)[VEC], bool is_hot) const {
    if constexpr (HINT) {
      load_hint<VEC>(p, v, is_hot ? hot : cold);
    } else {
      load_vec<VEC>(p, v);
    }
  }
  template <int VEC>
  __device__ __forceinline__ void store(float* p, const float (&v)[VEC], bool is_hot) const {
    if constexpr (HINT) {
      store_hint<VEC>(p, v, is_hot ? hot : cold);
    } else {
      store_vec<VEC>(p, v);
    }
  }
  // VEC floats from global memory at p into this thread's shared memory at
  // s, asynchronously (cp.async; complete after wait_staged()).
  template <int VEC>
  __device__ __forceinline__ void stage(const float* p, float* s, bool is_hot) const {
    if constexpr (HINT) {
      const auto dst = static_cast<unsigned>(__cvta_generic_to_shared(s));
      const unsigned long long pol = is_hot ? hot : cold;
      if constexpr (VEC == 4) {
        asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;"
                     : : "r"(dst), "l"(p), "l"(pol) : "memory");
      } else {
        asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2;"
                     : : "r"(dst), "l"(p), "l"(pol) : "memory");
      }
    } else {
      stage_plain<VEC>(p, s);
    }
  }
};

// Waits for this thread's cp.async copies.
__device__ __forceinline__ void wait_staged() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" : : : "memory");
}

// ---------------------------------------------------------------------------
// One pair's forward and row gradients, by one warp: `pair_step`'s
// arithmetic (`sgns_step.cuh`) in its order — per-lane partial dot products
// over the lane's columns in increasing order, warp reductions, the
// log-sigmoid loss, the K + 1 coefficients, dW = g_pos c_pos + sum_k g_k c_k
// — on rows first copied into the warp's shared-memory stage, `steps` column
// steps of 32 VEC floats at a time: all K + 2 rows' steps are in flight at
// once, so the pair costs a round trip per stage (one at the main path's
// shapes, where the stage holds the whole rows and dW reads them again from
// it) rather than one per column step and row. Also writes the W row to
// w_out. `hot` holds a bit per row (0: W, 1: context, 2 + k: negative k).
// ---------------------------------------------------------------------------
template <int VEC, bool HINT>
__device__ __forceinline__ void pair_staged(const float* wrow, const float* cpos,
                                            const float* const (&cneg)[kMaxNegatives],
                                            unsigned hot, const RowIO<HINT>& io, int K, int d,
                                            int lane, float* stage, int steps, float* loss_out,
                                            float* coef_out, float* dw_out, float* w_out) {
  constexpr int kStep = 32 * VEC;
  const int T = (d + kStep - 1) / kStep;
  // row r's column step t of the current stage: this lane's VEC floats
  auto at = [&](int r, int t) { return stage + ((r * steps + t) * 32 + lane) * VEC; };
  auto copy = [&](int t0, int ts, bool with_w) {
    for (int t = 0; t < ts; ++t) {
      const int e = (t0 + t) * kStep + lane * VEC;
      if (e >= d) break;
      if (with_w) io.template stage<VEC>(wrow + e, at(0, t), (hot & 1u) != 0u);
      io.template stage<VEC>(cpos + e, at(1, t), (hot & 2u) != 0u);
#pragma unroll
      for (int k = 0; k < kMaxNegatives; ++k) {
        if (k < K) io.template stage<VEC>(cneg[k] + e, at(2 + k, t), ((hot >> (2 + k)) & 1u) != 0u);
      }
    }
    wait_staged();
  };

  // K + 1 dot products: per-lane partial sums, then warp reductions.
  float s_pos = 0.0f;
  float s_neg[kMaxNegatives];
#pragma unroll
  for (int k = 0; k < kMaxNegatives; ++k) s_neg[k] = 0.0f;
  for (int t0 = 0; t0 < T; t0 += steps) {
    const int ts = T - t0 < steps ? T - t0 : steps;
    copy(t0, ts, true);
    for (int t = 0; t < ts; ++t) {
      const int e = (t0 + t) * kStep + lane * VEC;
      if (e >= d) break;
      float wv[VEC], cv[VEC];
      load_vec<VEC>(at(0, t), wv);
      load_vec<VEC>(at(1, t), cv);
#pragma unroll
      for (int v = 0; v < VEC; ++v) s_pos += wv[v] * cv[v];
#pragma unroll
      for (int k = 0; k < kMaxNegatives; ++k) {
        if (k < K) {
          load_vec<VEC>(at(2 + k, t), cv);
#pragma unroll
          for (int v = 0; v < VEC; ++v) s_neg[k] += wv[v] * cv[v];
        }
      }
      store_vec<VEC>(w_out + e, wv);
    }
  }
  s_pos = warp_sum(s_pos);
  float l_neg = 0.0f;
  float g_neg[kMaxNegatives];
#pragma unroll
  for (int k = 0; k < kMaxNegatives; ++k) {
    if (k < K) {
      s_neg[k] = warp_sum(s_neg[k]);
      l_neg += log_sigmoid(-s_neg[k]);
      g_neg[k] = sigmoid(s_neg[k]);
    } else {
      g_neg[k] = 0.0f;
    }
  }
  const float g_pos = sigmoid(s_pos) - 1.0f;
  if (lane == 0) {
    *loss_out = -log_sigmoid(s_pos) - l_neg;
    coef_out[0] = g_pos;
  }
  float g_lane = 0.0f;   // g_neg[lane], without dynamic register indexing
#pragma unroll
  for (int k = 0; k < kMaxNegatives; ++k) {
    if (k == lane) g_lane = g_neg[k];
  }
  if (lane < K) coef_out[1 + lane] = g_lane;

  // dW = g_pos * c_pos + sum_k g_k * c_k, summed over k in order; from the
  // stage as it stands when it holds every column step.
  for (int t0 = 0; t0 < T; t0 += steps) {
    const int ts = T - t0 < steps ? T - t0 : steps;
    if (T > steps) copy(t0, ts, false);
    for (int t = 0; t < ts; ++t) {
      const int e = (t0 + t) * kStep + lane * VEC;
      if (e >= d) break;
      float acc[VEC], cv[VEC];
      load_vec<VEC>(at(2, t), cv);
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = __fmul_rn(g_neg[0], cv[v]);
#pragma unroll
      for (int k = 1; k < kMaxNegatives; ++k) {
        if (k < K) {
          load_vec<VEC>(at(2 + k, t), cv);
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[v] = __fadd_rn(acc[v], __fmul_rn(g_neg[k], cv[v]));
        }
      }
      load_vec<VEC>(at(1, t), cv);
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = __fadd_rn(__fmul_rn(g_pos, cv[v]), acc[v]);
      store_vec<VEC>(dw_out + e, acc);
    }
  }
}


// ---------------------------------------------------------------------------
// Pairs [p0, p0 + nb) of worker w, one warp a pair over the group's warps:
// loss, coefficients, dW and the pair's W row as of block start to scratch.
// ---------------------------------------------------------------------------
template <int VEC, bool HINT>
__device__ void chain_pairs(const ChainArgs& a, const RowIO<HINT>& io, int w, int p0, int nb,
                            int gwarp, int gwarps, int lane, float* stage) {
  const long long table = static_cast<long long>(w) * a.V * a.d;
  for (int j = gwarp; j < nb; j += gwarps) {
    const long long wp = static_cast<long long>(w) * a.B + p0 + j;
    const int my_id = lane < a.K ? __ldg(a.ids + wp * a.K + lane) : 0;
    const int cen = __ldg(a.centers + wp);
    const int ctx = __ldg(a.contexts + wp);
    const float* cneg[kMaxNegatives];
#pragma unroll
    for (int k = 0; k < kMaxNegatives; ++k) {
      const int id = __shfl_sync(kFull, my_id, k < a.K ? k : 0);
      cneg[k] = a.C + table + static_cast<long long>(id) * a.d;
    }
    unsigned hot = 0;
    if constexpr (HINT) {
      hot = (cen < a.kH ? 1u : 0u) | (ctx < a.kH ? 2u : 0u) |
            (__ballot_sync(kFull, lane < a.K && my_id < a.kH) << 2);
    }
    const long long wj = static_cast<long long>(w) * a.blk + j;
    pair_staged<VEC, HINT>(a.W + table + static_cast<long long>(cen) * a.d,
                           a.C + table + static_cast<long long>(ctx) * a.d, cneg, hot, io, a.K,
                           a.d, lane, stage, a.stage_steps, a.loss + wp,
                           a.coef + wj * (a.K + 1), a.dW + wj * a.d, a.wrows + wj * a.d);
  }
}

// ---------------------------------------------------------------------------
// One apply item of the block [p0, p0 + nb) of worker w: window `win` of one
// table's sorted list (C_TABLE: the C list's positions [p0 (K + 1),
// (p0 + nb)(K + 1)); else the W list's [p0, p0 + nb)), column chunk `chunk`.
// The warp applies, to its chunk, every run that starts in the window,
// following the last one past the window to its end. Addends come from
// scratch: C's from the block-start W rows, W's from dW.
// ---------------------------------------------------------------------------
template <int VEC, bool HINT, bool C_TABLE>
__device__ void apply_item(const ChainArgs& a, const RowIO<HINT>& io, int w, int p0, int nb,
                           int win, int chunk, int lane, float* stage) {
  // batch slot i of the warp's stage: this lane's VEC floats
  auto slot = [&](int i) { return stage + (i * 32 + lane) * VEC; };
  const int K = a.K, d = a.d, B = a.B;
  const int L = C_TABLE ? B * (K + 1) : B;
  const int s0 = C_TABLE ? p0 * (K + 1) : p0;
  const int s1 = C_TABLE ? (p0 + nb) * (K + 1) : p0 + nb;
  const int* keys = (C_TABLE ? a.c_keys : a.w_keys) + static_cast<long long>(w) * L;
  const long long* perm = (C_TABLE ? a.c_perm : a.w_perm) + static_cast<long long>(w) * L;
  float* table = (C_TABLE ? a.C : a.W) + static_cast<long long>(w) * a.V * d;
  const float* addends = (C_TABLE ? a.wrows : a.dW) + static_cast<long long>(w) * a.blk * d;
  constexpr int kSpan = 32 * VEC;
  const int c0 = chunk * kSpan;
  const int col = c0 + lane * VEC;
  const bool on = col < d;

  // Lane l's view of sorted position base + l: its row, whether it starts a
  // run, its addend row and coefficient.
  struct Slot {
    int key;    // row
    bool head;  // starts a run
    int src;    // addend row: its offset from `addends`
    float g;    // coefficient (C)
  };
  auto fetch = [&](int base) {
    const int q = base + lane;
    Slot t{-1, false, 0, 0.0f};
    if (q < s1) {
      t.key = __ldg(keys + q);
      t.head = q == s0 || __ldg(keys + q - 1) != t.key;
      const long long x = __ldg(perm + q);
      // C: x < B is the context of pair x, else negative x - B = p K + k
      const int pq = static_cast<int>(C_TABLE ? (x < B ? x : (x - B) / K) : x);
      t.src = (pq - p0) * d;
      if constexpr (C_TABLE) {
        const int k1 = x < B ? 0 : 1 + static_cast<int>((x - B) % K);
        t.g = a.coef[(static_cast<long long>(w) * a.blk + (pq - p0)) * (K + 1) + k1];
      }
    }
    return t;
  };

  const int i0 = s0 + win * kWindow;
  int base = i0;
  Slot cur = fetch(base);
  const unsigned heads = __ballot_sync(kFull, cur.head && lane < kWindow);
  if (heads == 0u) return;   // the window lies inside a run begun before it
  int j = __ffs(heads) - 1;
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
  float* dst = nullptr;
  bool dst_hot = false;
  for (;;) {
    // this fetch ends at the list's end or at a run that starts past the window
    const unsigned stops = __ballot_sync(kFull, base + lane >= s1 ||
                                                    (base + lane >= i0 + kWindow && cur.head));
    const int stop = stops ? __ffs(stops) - 1 : 32;
    // a run that goes on past this fetch: the next one's indices load now
    Slot next{};
    if (stop == 32) next = fetch(base + 32);
    for (int u0 = j; u0 < stop; u0 += kAhead) {
      // the next kAhead addend chunks, and the chunks of the rows whose runs
      // they start, into the warp's stage first; then the adds, in order
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int l = (u0 + u) & 31;
        const bool live = u0 + u < stop && on;
        const int src = __shfl_sync(kFull, cur.src, l);
        const bool hd = __shfl_sync(kFull, static_cast<int>(cur.head), l) != 0;
        const int k = __shfl_sync(kFull, cur.key, l);
        if (live) stage_plain<VEC>(addends + src + col, slot(2 * u));
        if (live && hd) {
          io.template stage<VEC>(table + static_cast<long long>(k) * d + col, slot(2 * u + 1),
                                 k < a.kH);
        }
      }
      wait_staged();
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int l = (u0 + u) & 31;
        const bool hd = __shfl_sync(kFull, static_cast<int>(cur.head), l) != 0;
        const int k = __shfl_sync(kFull, cur.key, l);
        const float gu = __shfl_sync(kFull, cur.g, l);
        if (u0 + u >= stop || !on) continue;
        if (hd) {   // a new run: store the last one, start from this row
          if (dst != nullptr) io.store(dst + col, acc, dst_hot);
          dst = table + static_cast<long long>(k) * d;
          dst_hot = k < a.kH;
          load_vec<VEC>(slot(2 * u + 1), acc);
        }
        float v[VEC];
        load_vec<VEC>(slot(2 * u), v);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float up = C_TABLE ? __fmul_rn(a.neg_lr, __fmul_rn(gu, v[e]))
                                   : __fmul_rn(a.neg_lr, v[e]);
          acc[e] = __fadd_rn(acc[e], up);
        }
      }
    }
    if (stop < 32) break;
    base += 32;
    j = 0;
    cur = next;
  }
  if (dst != nullptr && on) io.store(dst + col, acc, dst_hot);
}

// Both tables' applies of the block [p0, p0 + nb) of worker w, items strided
// over the group's warps: the C list's windows, then the W list's, each in
// its column chunks. They read only scratch and write disjoint tables, so
// they run in one phase.
template <int VEC, bool HINT>
__device__ void chain_applies(const ChainArgs& a, const RowIO<HINT>& io, int w, int p0, int nb,
                              int gwarp, int gwarps, int lane, float* stage) {
  const int chunks = (a.d + 32 * VEC - 1) / (32 * VEC);
  const int c_items = (nb * (a.K + 1) + kWindow - 1) / kWindow * chunks;
  const int items = c_items + (nb + kWindow - 1) / kWindow * chunks;
  for (int it = gwarp; it < items; it += gwarps) {
    if (it < c_items) {
      apply_item<VEC, HINT, true>(a, io, w, p0, nb, it / chunks, it % chunks, lane, stage);
    } else {
      apply_item<VEC, HINT, false>(a, io, w, p0, nb, (it - c_items) / chunks,
                                   (it - c_items) % chunks, lane, stage);
    }
  }
}

// K6: the rows below kH that worker w's step touched, back to normal L2
// priority (each 128-byte line of each run's row).
__device__ void release_hot(const ChainArgs& a, int w, int gwarp, int gwarps, int lane) {
  const long long tbase = static_cast<long long>(w) * a.V * a.d;
  const int LC = a.B * (a.K + 1);
  for (int i = gwarp * 32 + lane; i < a.B + LC; i += gwarps * 32) {
    const bool c = i >= a.B;
    const int q = c ? i - a.B : i;
    const int* keys = c ? a.c_keys + static_cast<long long>(w) * LC
                        : a.w_keys + static_cast<long long>(w) * a.B;
    const int key = __ldg(keys + q);
    if (key >= a.kH || (q > 0 && __ldg(keys + q - 1) == key)) continue;
    const auto row = reinterpret_cast<uintptr_t>((c ? a.C : a.W) + tbase +
                                                 static_cast<long long>(key) * a.d);
    const uintptr_t end = row + static_cast<uintptr_t>(a.d) * 4u;
    for (uintptr_t line = row & ~static_cast<uintptr_t>(127); line < end; line += 128) {
      asm volatile("applypriority.global.L2::evict_normal [%0], 128;" : : "l"(line) : "memory");
    }
  }
}

// ---------------------------------------------------------------------------
// The persistent kernel: group g = blockIdx / group_ctas walks workers g,
// g + groups, ..., each through all its blocks. Two CTAs an SM: the phases
// are latency-bound, so warps in flight count.
// ---------------------------------------------------------------------------
template <int VEC, bool TIERED>
__global__ void __launch_bounds__(kWarps * 32, 2) pipe_chain_kernel(ChainArgs a) {
  const int g = blockIdx.x / a.group_ctas;
  const int lane = threadIdx.x & 31;
  const int gwarp = static_cast<int>(blockIdx.x % a.group_ctas) * kWarps +
                    static_cast<int>(threadIdx.x >> 5);
  const int gwarps = a.group_ctas * kWarps;
  int* counter = a.arrive + g;
  extern __shared__ float4 smem[];   // a stage of stage_floats a warp
  float* stage = reinterpret_cast<float*>(smem) + (threadIdx.x >> 5) * a.stage_floats;
  int arrivals = 0;
  const RowIO<TIERED> io;
  const int nblocks = (a.B + a.blk - 1) / a.blk;
  for (int w = g; w < a.n; w += a.groups) {
    for (int b = 0; b < nblocks; ++b) {
      const int p0 = b * a.blk;
      const int nb = min(a.blk, a.B - p0);
      chain_pairs<VEC, TIERED>(a, io, w, p0, nb, gwarp, gwarps, lane, stage);
      group_barrier(counter, ++arrivals * a.group_ctas);
      chain_applies<VEC, TIERED>(a, io, w, p0, nb, gwarp, gwarps, lane, stage);
      if (b + 1 < nblocks) group_barrier(counter, ++arrivals * a.group_ctas);
    }
    if constexpr (TIERED) release_hot(a, w, gwarp, gwarps, lane);
  }
}

// Sizes the groups to what the card holds at once — about (CTAs the card
// holds) / n CTAs a worker, at least kMinGroup, at most what a block's pairs
// or C apply items can use — zeroes the barrier counters and launches the
// grid cooperatively on `stream`.
template <int VEC, bool TIERED>
cudaError_t launch_chain(ChainArgs a, cudaStream_t stream) {
  // a warp's stage: for the pairs, as many column steps of the K + 2 rows as
  // kStageBytes holds (at least one: 18 rows of 512 B), at most the whole
  // row; for the applies, 2 kAhead chunks (addend, row)
  const int step_floats = (a.K + 2) * 32 * VEC;
  const int steps = (a.d + 32 * VEC - 1) / (32 * VEC);
  a.stage_steps = std::max(1, std::min(steps, kStageBytes / 4 / step_floats));
  a.stage_floats = std::max(a.stage_steps * step_floats, 2 * kAhead * 32 * VEC);
  const size_t smem = static_cast<size_t>(kWarps) * a.stage_floats * 4;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(pipe_chain_kernel<VEC, TIERED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pipe_chain_kernel<VEC, TIERED>,
                                                      kWarps * 32, smem);
  if (err != cudaSuccess) return err;
  const int capacity = per_sm * sms;
  if (capacity < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int chunks = (a.d + 32 * VEC - 1) / (32 * VEC);
  const int items = ((a.blk * (a.K + 1) + kWindow - 1) / kWindow +
                     (a.blk + kWindow - 1) / kWindow) * chunks;
  const int cap = ((a.blk > items ? a.blk : items) + kWarps - 1) / kWarps;
  int per = capacity / a.n;
  if (per < kMinGroup) per = kMinGroup;
  per = std::min(per, std::min(cap, capacity));
  a.group_ctas = per;
  a.groups = std::min(a.n, capacity / per);
  err = cudaMemsetAsync(a.arrive, 0, sizeof(int) * static_cast<size_t>(a.groups), stream);
  if (err != cudaSuccess) return err;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(pipe_chain_kernel<VEC, TIERED>),
                                    dim3(static_cast<unsigned>(a.groups * per)),
                                    dim3(kWarps * 32), params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The C entry points' common body: checks and packs the arguments.
template <bool TIERED>
int chain_launch(void* W, void* C, void* loss, const void* centers, const void* contexts,
                 const void* ids, const void* w_keys, const void* w_perm, const void* c_keys,
                 const void* c_perm, void* coef, void* dW, void* wrows, void* arrive, int n,
                 int V, int d, int B, int K, int blk, int kH, float neg_lr, int vec4,
                 void* stream) {
  if (n == 0 || B == 0) return 0;
  if (K < 1 || K > kMaxNegatives || blk < 1 || d < 1 || kH < 0 || kH > V ||
      (TIERED && kH < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ChainArgs a;
  a.W = static_cast<float*>(W);
  a.C = static_cast<float*>(C);
  a.loss = static_cast<float*>(loss);
  a.centers = static_cast<const int*>(centers);
  a.contexts = static_cast<const int*>(contexts);
  a.ids = static_cast<const int*>(ids);
  a.w_keys = static_cast<const int*>(w_keys);
  a.w_perm = static_cast<const long long*>(w_perm);
  a.c_keys = static_cast<const int*>(c_keys);
  a.c_perm = static_cast<const long long*>(c_perm);
  a.coef = static_cast<float*>(coef);
  a.dW = static_cast<float*>(dW);
  a.wrows = static_cast<float*>(wrows);
  a.arrive = static_cast<int*>(arrive);
  a.n = n; a.V = V; a.d = d; a.B = B; a.K = K; a.blk = blk < B ? blk : B;
  a.kH = TIERED ? kH : 0;
  a.group_ctas = 1; a.groups = 1; a.stage_steps = 1; a.stage_floats = 0;
  a.neg_lr = neg_lr;
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = vec4 ? launch_chain<4, TIERED>(a, s) : launch_chain<1, TIERED>(a, s);
  return static_cast<int>(err);
}

}  // namespace sgns
