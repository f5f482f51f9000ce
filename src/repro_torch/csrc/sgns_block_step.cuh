// K2 and K4a: one SGNS step for every worker as a chain of pair blocks, in
// one persistent launch — the negative draw and the row sort inside it, pair
// rows and apply addends fed by bulk asynchronous copies, hot runs split over
// columns.
//
// Replaces: repro/kernels/sgns_fused.py `_sgns_fused_kernel` (K2,
// `sgns_fused_step.cu`: one block of B pairs, the loss in the softplus form)
// and repro/kernels/sgns_fused_hbm.py `_hbm_block_kernel` (K4a,
// `sgns_fused_hbm.cu`: blocks of `blk` pairs and a tail block, the loss in
// the log-sigmoid form; the two forms give the same bits). Per block, every
// gradient is taken from the tables as of block start, then each touched
// row's addends are added serially in reference order (W at centers; C at
// contexts, then at negatives); block b + 1 reads block b's writes. The
// negatives are the counter-hash alias draw (`counter_prng.cuh`), made inside
// the launch as the TPU kernel makes them inside itself (the reference's
// `_sgns_fused_kernel`: "ids live only in VMEM/registers"): negative k of
// pair p of worker w is alias_draw at counter p K + k under w's seed and
// table, a pure function that any thread needing it computes where it stands.
//
// Bound on the H100: memory. A step must read each distinct touched row once
// and write it once (195.5 MB at the main path's n = 10, d = 500, B = 1024,
// K = 5: 0.058 ms at 3.35 TB/s); the arithmetic is ~7 (K + 1) d flops a
// pair. What kept the earlier two-kernel design at a tenth of that was
// latency: a hot row's addends applied as one serial chain of dependent
// loads (perm -> coefficient and center -> W row, then the add), the rows
// read twice from device memory, dW and the coefficients sent through it,
// the torch sorts and five launches a step. Here:
//
//   one launch a step, the draw included: CTAs are split into one group
//     per worker (a group takes several workers in turn when there are more
//     workers than groups), co-resident by cooperative launch; a worker's
//     phases are separated by a group barrier (`sm90_async.cuh`). Per
//     block: pairs | barrier | applies | barrier (none after the worker's
//     last block).
//   the draw: in the first phase, the CTAs that run the first block's
//     pairs first make the worker's whole (B, K) draw into `ids` (which the
//     wrappers return), one thread a draw, each CTA the negatives of the
//     pairs its own warps take, and arrive on a per-worker counter. Spread
//     over the group's SMs its scattered table loads take about one round
//     trip; one sorting CTA alone took ~40 us for K2's 5,120 draws (the
//     table is not in L2 after a step's row traffic).
//   the sort: in the first phase, `sorters` CTAs of the group sort the
//     step's touched rows, one (block, table) list a task, while the others
//     run the first block's pairs. A list's rows, in element order (C:
//     contexts, then negatives, read from `ids` once every drawing CTA has
//     arrived; W: centers), are sorted stably by row in
//     shared memory (global scratch for a list too long): a radix sort of
//     4-bit digits, each pass stable, so the order is exactly
//     torch.sort(stable=True)'s on (block, row). The rows and indices go to
//     scratch in `block_sorts`' layout, and the list's apply items are made
//     from them by two prefix sums. At the main path's shapes the sort ends
//     before the first block's pairs do.
//   pairs: one warp a pair; lane k < K reads negative k from `ids` (a pair
//     ahead): in the first block its own CTA's draws, in later blocks the
//     group's. The K + 2 rows are brought into the warp's shared-memory
//     region by 1-D bulk copies (cp.async.bulk, one a row,
//     completing on an mbarrier), or by 4-byte cp.async copies where rows
//     are not 16-byte multiples (d = 50); where two pairs' rows fit, the
//     next pair's copies are in flight while this one reduces. `pair_step`
//     (`sgns_step.cuh`) then runs on the staged rows, in its order, and
//     writes the loss, the K + 1 coefficients, dW and a copy of the pair's
//     W row as of block start to scratch, so the C and W applies read only
//     scratch and share one phase.
//   applies: items of whole runs of one table's sorted list and a column
//     chunk, W's list then C's, each in list order (hot rows first), taken
//     by the warps from a per-(worker, block) integer counter: a run of at
//     least kSplitRuns addends is an item of its own in narrow chunks of 32
//     columns (the Zipf-hot rows, spread over many warps); the shorter runs
//     whose heads share a window of 32 sorted positions form one item in
//     chunks of 32 VEC columns. A warp fetches
//     an item's metadata 32 positions at a time (perm -> pair, slot,
//     coefficient) and streams the addend slices (and, for each run's first
//     addend, the row's own slice) through a ring of kStages stages of its
//     region by bulk copies, each lane issuing its position's; each element
//     is added serially in pair order: __fadd_rn(acc, __fmul_rn(neg_lr,
//     __fmul_rn(g, w))) for C, __fmul_rn(neg_lr, dW) for W, and stored once.
//     No float atomics: which warp takes an item changes no bit.
//
// Bits: the pair body, the addends and their order per element are those of
// K5 (`sgns_pipe.cuh`), the independent implementation of the same chain,
// so the tables and the loss are bitwise K5's at the same block size.
#pragma once

#include <cstdint>

#include "counter_prng.cuh"
#include "sgns_step.cuh"
#include "sm90_async.cuh"

namespace sgns {

constexpr int kWarpBytes = 14336;   // a warp's shared-memory region: 7 rows of 512 floats
constexpr int kStages = 4;          // apply ring stages a warp
constexpr int kNarrow = 32;         // columns of a hot run's chunk
constexpr int kWideCols = 128;      // columns of a short runs' chunk (16-byte path)
constexpr int kItemWindow = 32;     // sorted positions whose short runs share an item
// Runs of at least this many addends are items of their own in kNarrow-column
// chunks (16-byte path; the scalar path's chunks are kNarrow columns anyway).
constexpr int kSplitRuns = 32;
constexpr int kSmemBytes = kWarps * kWarpBytes;

struct StepArgs {
  float* W;                  // (n, V, d), updated in place
  float* C;                  // (n, V, d)
  float* loss;               // (n, B)
  const int* centers;        // (n, B)
  const int* contexts;       // (n, B)
  int* ids;                  // (n, B, K) written: the step's draw
  const uint32_t* seeds;     // (n, 2) each worker's seed words
  const float* prob;         // (n, V) each worker's alias table
  const int* alias;          // (n, V)
  int* w_rows;               // (n, B) center rows sorted stably by (block, row): written
  long long* w_perm;         // (n, B) the pair each came from
  int* c_rows;               // (n, B (K + 1)) context and negative rows, so sorted
  long long* c_perm;         // (n, B (K + 1)) index into concat(contexts, ids)
  float* coef;               // (n, blk, K + 1) scratch
  float* dW;                 // (n, blk, d) scratch
  float* wrows;              // (n, blk, d) scratch: the pairs' W rows as of block start
  int4* items;               // (n, nblocks, 2, item_cap): {position, length, col0, width}
  int* n_items;              // (n, nblocks, 2)
  int* arrive;               // (groups) barrier counters, zeroed by the launch
  int* work;                 // (n, nblocks) item counters, zeroed by the launch
  int* drawn;                // (n) draw-pass arrivals, zeroed by the launch
  unsigned char* sort_mem;   // (n, 2 nblocks, sort_bytes): lists too long for shared memory
  long long sort_bytes;
  int item_cap, n, V, d, B, K, blk, nblocks, group_ctas, groups, sorters;
  float neg_lr;
};

// ---------------------------------------------------------------------------
// The sort
// ---------------------------------------------------------------------------
// An exclusive prefix sum of one int a thread over the CTA; *total gets the sum.
__device__ __forceinline__ int cta_exclusive_sum(int x, int* total) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, t, off);
      if (lane >= off) t += y;
    }
    if (lane < kWarps) warp_sums[lane] = t;
  }
  __syncthreads();
  const int base = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kWarps - 1];
  __syncthreads();
  return base + inc - x;
}

// Sorts ids[0 .. N) (element indices, in element order on entry) stably by
// rows[id] < 2^bits, by the CTA: a least-significant-digit radix sort of
// kRadixBits a pass. Thread t holds the contiguous positions [t E, t E + E)
// (E odd, so a warp's lanes read distinct banks) of each pass's order and
// counts its digits in its own column of `counters` (digit-major, kDigits x
// blockDim), so a position's rank is its digit's start, plus the counts of
// the threads before it, plus its rank in its own thread: each pass is
// stable, and so is the sort. `tmp` and `rank` hold N ints each. Returns the
// buffer (ids or tmp) that holds the order.
constexpr int kRadixBits = 4;
constexpr int kDigits = 1 << kRadixBits;

__device__ __forceinline__ int* cta_radix_sort(const int* rows, int* ids, int* tmp, int* rank,
                                               int* counters, int N, int bits) {
  const int t = threadIdx.x, T = blockDim.x;
  const int E = ((N + T - 1) / T) | 1;
  const int q0 = min(N, t * E), q1 = min(N, q0 + E);
  for (int q = q0; q < q1; ++q) ids[q] = q;
  for (int shift = 0; shift < bits; shift += kRadixBits) {
    for (int i = t; i < kDigits * T; i += T) counters[i] = 0;
    __syncthreads();
    for (int q = q0; q < q1; q += 4) {   // four positions' loads at once
      int digit[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        digit[u] = q + u < q1 ? (rows[ids[q + u]] >> shift) & (kDigits - 1) : -1;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (digit[u] >= 0) rank[q + u] = counters[digit[u] * T + t]++;
      }
    }
    __syncthreads();
    int sum = 0;                                  // thread t scans entries [t kDigits, ...)
    for (int i = 0; i < kDigits; ++i) sum += counters[t * kDigits + i];
    int total = 0;
    int run = cta_exclusive_sum(sum, &total);
    for (int i = 0; i < kDigits; ++i) {
      const int c = counters[t * kDigits + i];
      counters[t * kDigits + i] = run;
      run += c;
    }
    __syncthreads();
    for (int q = q0; q < q1; q += 4) {
      int x[4], to[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) x[u] = q + u < q1 ? ids[q + u] : 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        to[u] = q + u < q1
                    ? counters[((rows[x[u]] >> shift) & (kDigits - 1)) * T + t] + rank[q + u]
                    : 0;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (q + u < q1) tmp[to[u]] = x[u];
      }
    }
    __syncthreads();
    int* swap = ids;
    ids = tmp;
    tmp = swap;
  }
  return ids;
}

// The apply items of one sorted list rows[0 .. N) (block-relative positions;
// s0 the list's first position in the worker's list). An item is a range of
// whole runs and a column chunk: a run of at least kSplitRuns addends on its
// own, in chunks of kNarrow columns (where `wide` is wider); the other runs
// grouped by the window of kItemWindow positions their heads lie in (a group
// also ends where a long run begins), in chunks of `wide` columns. An item
// ends where the next begins. Items go out in list order. `flag`, `spos` and
// `soff` hold N ints each.
__device__ __forceinline__ void make_items(const StepArgs& a, const int* rows, int N, int s0,
                                           int wide, int* flag, int* spos, int* soff, int4* out,
                                           int* count) {
  const int T = wide > kNarrow ? kSplitRuns : 1 << 30;
  auto head = [&](int q) { return q == 0 || rows[q] != rows[q - 1]; };
  auto long_head = [&](int q) { return T <= N - q && rows[q + T - 1] == rows[q]; };
  auto starts = [&](int q) {
    if (!head(q)) return false;
    if (q == 0 || long_head(q)) return true;
    if (q >= T && rows[q - T] == rows[q - 1]) return true;    // after a long run
    const int ws = q & ~(kItemWindow - 1);                     // the first head of its window
    return q == ws || (!head(ws) && rows[ws] == rows[q - 1]);
  };
  const int cw = (a.d + wide - 1) / wide, cn = (a.d + kNarrow - 1) / kNarrow;
  // flag[q]: 0, or the chunks of the item that starts at q
  for (int q = threadIdx.x; q < N; q += blockDim.x) {
    flag[q] = starts(q) ? (long_head(q) ? cn : cw) : 0;
  }
  __syncthreads();
  const int per = ((N + blockDim.x - 1) / blockDim.x) | 1;   // odd: distinct banks
  const int q0 = min(N, static_cast<int>(threadIdx.x) * per), q1 = min(N, q0 + per);
  int n_starts = 0, n_chunks = 0;
  for (int q = q0; q < q1; ++q) {
    n_starts += flag[q] != 0;
    n_chunks += flag[q];
  }
  int total_starts = 0, total_items = 0;
  int k = cta_exclusive_sum(n_starts, &total_starts);
  int at = cta_exclusive_sum(n_chunks, &total_items);
  for (int q = q0; q < q1; ++q) {
    if (flag[q] != 0) {
      spos[k] = q;
      soff[k++] = at;
      at += flag[q];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < total_starts; i += blockDim.x) {
    const int q = spos[i];
    const int end = i + 1 < total_starts ? spos[i + 1] : N;
    const bool hot = long_head(q);
    const int width = hot ? kNarrow : wide, chunks = hot ? cn : cw;
    for (int c = 0; c < chunks; ++c) {
      out[soff[i] + c] = make_int4(s0 + q, end - q, c * width, width);
    }
  }
  if (threadIdx.x == 0) *count = total_items;
}

// The CTAs of a group that draw in the first phase: those that run the first
// block's pairs (all of them when every CTA also sorts).
__device__ __forceinline__ int drawers(const StepArgs& a) {
  return a.group_ctas > a.sorters ? a.group_ctas - a.sorters : a.group_ctas;
}

// Worker w's whole draw, (B, K) ids at counters p K + k, by the drawing CTA
// `index`, one thread a draw: in each block the negatives of the pairs
// that this CTA's warps take in the first block's pairs phase (pair j of a
// block goes to warp j mod (drawers kWarps)), so each warp of the first
// block reads its own CTA's writes; then one release arrival on the
// worker's `drawn` counter, which the C lists' sort tasks wait for. Spread
// over the group's SMs, the draw's scattered table loads take about one
// round trip; one sorting CTA alone took ~40 us for K2's 5,120 draws
// (`block_step_variants` stamps: the table is out of L2 after a step's row
// traffic).
__device__ __forceinline__ void draw_pass(const StepArgs& a, int w, int index) {
  const int K = a.K;
  const uint32_t seed0 = a.seeds[2 * w], seed1 = a.seeds[2 * w + 1];
  const float* prob = a.prob + static_cast<long long>(w) * a.V;
  const int* alias = a.alias + static_cast<long long>(w) * a.V;
  int* out = a.ids + static_cast<long long>(w) * a.B * K;
  const int gw = drawers(a) * kWarps;
  const int per_block = (a.blk + gw - 1) / gw * kWarps * K;   // this CTA's (pair, k) slots
  const int slots = a.nblocks * per_block;
  constexpr int kDraws = 2;   // draws a thread with their table loads in flight together
  for (int x0 = threadIdx.x; x0 < slots; x0 += kDraws * blockDim.x) {
    int i[kDraws], al[kDraws];
    float pr[kDraws];
    AliasPick pick[kDraws];
#pragma unroll
    for (int u = 0; u < kDraws; ++u) {
      const int x = x0 + u * blockDim.x;
      const int b = x / per_block, y = x - b * per_block;
      const int q = y / K, k = y - q * K;                 // slot y: its q-th pair of block b
      const int j = index * kWarps + q % kWarps + q / kWarps * gw;
      i[u] = -1;
      al[u] = 0;
      pr[u] = 0.0f;
      pick[u] = AliasPick{0, 0.0f};
      if (x < slots && j < min(a.blk, a.B - b * a.blk)) {
        i[u] = (b * a.blk + j) * K + k;
        pick[u] = alias_pick(seed0, seed1, a.V, static_cast<uint32_t>(i[u]));
        pr[u] = __ldg(prob + pick[u].idx);
        al[u] = __ldg(alias + pick[u].idx);
      }
    }
#pragma unroll
    for (int u = 0; u < kDraws; ++u) {
      if (i[u] >= 0) out[i[u]] = alias_take(pick[u], pr[u], al[u]);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("red.release.gpu.global.add.s32 [%0], 1;" : : "l"(a.drawn + w) : "memory");
  }
}

// The shared memory (or global scratch) a sort task of N entries takes: its
// rows, three int arrays of the sort and the digit counters.
__host__ __device__ inline size_t sort_need(int N) {
  return static_cast<size_t>(4) * N * sizeof(int) +
         static_cast<size_t>(kDigits) * kWarps * 32 * sizeof(int);
}

// Sort task t of worker w: the C list (t even) or the W list (t odd) of
// block t / 2, by the whole CTA, in `buf` (shared memory, or this task's
// global scratch when the list does not fit): the list's rows in element
// order (C: contexts, then negatives; W: centers), sorted stably by row; the
// rows and their indices out in `block_sorts`' layout (index into
// concat(contexts, ids) for C, the pair for W); then the list's items.
__device__ __forceinline__ void sort_task(const StepArgs& a, int w, int t, int wide, int bits,
                          unsigned char* buf) {
  const int b = t >> 1;
  const bool c_table = (t & 1) == 0;
  const int p0 = b * a.blk, nb = min(a.blk, a.B - p0), K = a.K, B = a.B;
  const int N = c_table ? nb * (K + 1) : nb;
  const long long L = c_table ? static_cast<long long>(B) * (K + 1) : B;
  const int s0 = c_table ? p0 * (K + 1) : p0;
  int* rows = reinterpret_cast<int*>(buf);
  int* ids = rows + N;
  int* tmp = ids + N;
  int* rank = tmp + N;
  int* counters = rank + N;
  const long long wB = static_cast<long long>(w) * B;
  // element e's index: C, the context of pair p0 + e (e < nb), else
  // negative p0 K + (e - nb); W, pair p0 + e
  auto index_of = [&](int e) {
    return (!c_table || e < nb) ? static_cast<long long>(p0 + e)
                                : B + static_cast<long long>(p0) * K + (e - nb);
  };
  if (c_table) {   // the worker's draw is in `ids` once every drawing CTA has arrived
    if (threadIdx.x == 0) {
      int seen = 0;
      do {
        asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
                     : "=r"(seen)
                     : "l"(a.drawn + w)
                     : "memory");
      } while (seen < drawers(a));
    }
    __syncthreads();
  }
  const int T = blockDim.x;
  for (int e0 = threadIdx.x; e0 < N; e0 += 4 * T) {   // four independent loads a thread
    int v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * T;
      v[u] = 0;
      if (e < N) {
        v[u] = !c_table ? __ldg(a.centers + wB + p0 + e)
               : e < nb ? __ldg(a.contexts + wB + p0 + e)
                        : __ldcg(a.ids + wB * K + index_of(e) - B);   // written in this launch
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (e0 + u * T < N) rows[e0 + u * T] = v[u];
    }
  }
  __syncthreads();
  int* order = cta_radix_sort(rows, ids, tmp, rank, counters, N, bits);
  int* rows_out = (c_table ? a.c_rows : a.w_rows) + w * L + s0;
  long long* perm_out = (c_table ? a.c_perm : a.w_perm) + w * L + s0;
  for (int q = threadIdx.x; q < N; q += T) {
    const int x = order[q];
    rank[q] = rows[x];                            // the sorted rows
    rows_out[q] = rows[x];
    perm_out[q] = index_of(x);
  }
  __syncthreads();
  int* spos = order == ids ? tmp : ids;           // free: both order buffers, and rows
  const long long slot = (static_cast<long long>(w) * a.nblocks + b) * 2 + (c_table ? 0 : 1);
  make_items(a, rank, N, s0, wide, rows, spos, order,
             a.items + slot * a.item_cap, a.n_items + slot);
  __syncthreads();
}

// Worker w's sort tasks taken by sorting CTA `rank`; `wide` is the short
// runs' chunk: 32 VEC columns.
__device__ __forceinline__ void sort_tasks(const StepArgs& a, int w, int rank, int wide,
                                           unsigned char* smem) {
  const int bits = a.V > 1 ? 32 - __clz(a.V - 1) : 1;   // rows < 2^bits
  for (int t = rank; t < 2 * a.nblocks; t += a.sorters) {
    const int nb = min(a.blk, a.B - (t >> 1) * a.blk);
    const int N = (t & 1) == 0 ? nb * (a.K + 1) : nb;
    __syncthreads();   // the CTA's warps are done with their regions
    // two inlined copies, so that the first addresses shared memory as such
    if (sort_need(N) <= static_cast<size_t>(kSmemBytes)) {
      sort_task(a, w, t, wide, bits, smem);
    } else {
      sort_task(a, w, t, wide, bits,
                a.sort_mem + (static_cast<long long>(w) * 2 * a.nblocks + t) * a.sort_bytes);
    }
  }
}

// ---------------------------------------------------------------------------
// Pairs
// ---------------------------------------------------------------------------
// Pairs [p0, p0 + nb) of worker w, one warp a pair over the phase's warps.
// BULK: rows by bulk copies (16-byte rows), else by 4-byte cp.async copies.
template <bool BULK, bool LOGSIG>
__device__ __forceinline__ void pairs_phase(const StepArgs& a, int w, int p0, int nb, int gwarp,
                                            int gwarps, int lane, float* region, uint64_t* bar,
                                            unsigned& phase) {
  constexpr int VEC = BULK ? 4 : 1;
  const int K = a.K, d = a.d;
  const long long table = static_cast<long long>(w) * a.V * d;
  const float* Wt = a.W + table;
  const float* Ct = a.C + table;
  const int row_floats = (K + 2) * d;
  const int stages = row_floats * 4 > kWarpBytes ? 0 : (2 * row_floats * 4 <= kWarpBytes ? 2 : 1);

  // Pair j's row ids (lane k < K holds negative k's, from the draw pass:
  // this CTA's own writes in the first block, the group's after a barrier
  // in later blocks), loaded a pair ahead, and its row pointers (0: W at
  // the center, 1: C at the context, 2 + k: C at negative k).
  struct Ids {
    int cen = 0, ctx = 0, neg = 0;
  };
  auto ids_of = [&](int j) {
    const long long wp = static_cast<long long>(w) * a.B + p0 + j;
    Ids x;
    x.cen = __ldg(a.centers + wp);
    x.ctx = __ldg(a.contexts + wp);
    if (lane < K) x.neg = __ldcg(a.ids + wp * K + lane);   // written in this launch
    return x;
  };
  auto rows_of = [&](const Ids& x, const float* (&row)[kMaxNegatives + 2]) {
    row[0] = Wt + static_cast<long long>(x.cen) * d;
    row[1] = Ct + static_cast<long long>(x.ctx) * d;
#pragma unroll
    for (int k = 0; k < kMaxNegatives; ++k) {
      const int id = __shfl_sync(kFull, x.neg, k < K ? k : 0);
      row[2 + k] = Ct + static_cast<long long>(id) * d;
    }
  };
  auto issue = [&](const Ids& x, int st) {
    const float* row[kMaxNegatives + 2];
    rows_of(x, row);
    float* stage = region + st * row_floats;
    if constexpr (BULK) {
      if (lane == 0) sm90::mbar_arrive_expect_tx(&bar[st], static_cast<unsigned>(row_floats) * 4);
      __syncwarp();
      const float* src = row[0];
#pragma unroll
      for (int r = 1; r < kMaxNegatives + 2; ++r) {
        if (r == lane) src = row[r];
      }
      if (lane < K + 2) {
        sm90::bulk_load(stage + lane * d, src, static_cast<unsigned>(d) * 4, &bar[st]);
      }
    } else {
      for (int r = 0; r < K + 2; ++r) {
        for (int e = lane; e < d; e += 32) sm90::copy4(stage + r * d + e, row[r] + e);
      }
      sm90::copy_commit();
    }
  };
  auto wait = [&](int st, bool newer) {
    if constexpr (BULK) {
      sm90::mbar_wait(&bar[st], (phase >> st) & 1u);
      phase ^= 1u << st;
    } else if (newer) {
      sm90::copy_wait<1>();
    } else {
      sm90::copy_wait<0>();
    }
  };

  int st = 0;
  Ids cur;
  if (gwarp < nb) cur = ids_of(gwarp);
  if (stages > 0 && gwarp < nb) issue(cur, 0);
  for (int j = gwarp; j < nb; j += gwarps) {
    const int jn = j + gwarps;
    Ids nxt;
    if (jn < nb) nxt = ids_of(jn);
    const float* row[kMaxNegatives + 2];
    if (stages == 0) {
      rows_of(cur, row);               // rows too long to stage: read in place
    } else {
      if (stages == 2 && jn < nb) issue(nxt, st ^ 1);
      wait(st, stages == 2 && jn < nb);
      const float* stage = region + st * row_floats;
#pragma unroll
      for (int r = 0; r < kMaxNegatives + 2; ++r) row[r] = stage + (r < K + 2 ? r : 2) * d;
    }
    const float* cneg[kMaxNegatives];
#pragma unroll
    for (int k = 0; k < kMaxNegatives; ++k) cneg[k] = row[2 + k];
    const long long wp = static_cast<long long>(w) * a.B + p0 + j;
    const long long wj = static_cast<long long>(w) * a.blk + j;
    pair_step<VEC, LOGSIG>(row[0], row[1], cneg, K, d, lane, a.loss + wp,
                           a.coef + wj * (K + 1), a.dW + wj * d, a.wrows + wj * d);
    __syncwarp();                      // the stage is read before it is refilled
    if (stages == 2) {
      st ^= 1;
    } else if (stages == 1 && jn < nb) {
      issue(nxt, 0);
    }
    cur = nxt;
  }
}

// ---------------------------------------------------------------------------
// Applies
// ---------------------------------------------------------------------------
// Lane l's view of sorted position base + l of an item: its row, whether it
// starts a run, its addend's offset from the addends' base, its coefficient.
struct Meta {
  int key = 0;
  int head = 0;
  int src = 0;
  float g = 0.0f;
};

// Item `it` of worker w's block [p0, p0 + nb), table C (C_TABLE) or W.
template <bool BULK, bool C_TABLE>
__device__ __forceinline__ void apply_item(const StepArgs& a, int w, int p0, int4 it, int lane,
                                           float* region, uint64_t* bar, unsigned& phase) {
  const int K = a.K, d = a.d, B = a.B;
  const int s = it.x, len = it.y, col0 = it.z, width = it.w;
  constexpr int kMaxNv = kWideCols / 32;
  const int nv = width / 32;                     // floats a lane: kMaxNv or 1
  const int ncols = min(width, d - col0);
  const unsigned sb = static_cast<unsigned>(ncols) * 4;   // bytes of one slice
  // slots a stage: a power of two, at most 32 / kStages, so that the ring
  // never runs more than one fetch of 32 positions ahead
  int A = 1;
  while (2 * A * kStages <= 32) A *= 2;
  while (A > 1 && kStages * 2 * A * width * 4 > kWarpBytes) A >>= 1;
  const int spf = 32 / A;                        // sub-batches a fetch
  const int nsub = (len + A - 1) / A;
  const long long L = C_TABLE ? static_cast<long long>(B) * (K + 1) : B;
  const int* keys = (C_TABLE ? a.c_rows : a.w_rows) + w * L;
  const long long* perm = (C_TABLE ? a.c_perm : a.w_perm) + w * L;
  float* table = (C_TABLE ? a.C : a.W) + static_cast<long long>(w) * a.V * d;
  const float* adds = (C_TABLE ? a.wrows : a.dW) + static_cast<long long>(w) * a.blk * d;
  const float* coef = a.coef + static_cast<long long>(w) * a.blk * (K + 1);
  // stage st's slot i: the addend, then (a run's first position) the row
  auto slot = [&](int st, int i, bool row) {
    return region + ((st * 2 + (row ? 1 : 0)) * A + i) * width;
  };
  const int col = col0 + lane * nv;
  const bool on = col < d;

  auto fetch = [&](int f) {
    Meta m;
    const int o = f * 32 + lane;
    if (o < len) {
      const int q = s + o;
      m.key = keys[q];
      m.head = o == 0 || keys[q - 1] != m.key;
      const long long x = perm[q];
      // C: x < B is the context of pair x, else negative x - B = p K + k
      const int pq = static_cast<int>(C_TABLE ? (x < B ? x : (x - B) / K) : x);
      m.src = (pq - p0) * d + col0;
      if constexpr (C_TABLE) {
        const int k1 = x < B ? 0 : 1 + static_cast<int>((x - B) % K);
        m.g = coef[(pq - p0) * (K + 1) + k1];
      }
    }
    return m;
  };

  Meta cur = fetch(0), nxt;
  if (len > 32) nxt = fetch(1);
  int fc = 0;                                     // cur's fetch
  auto issue = [&](int v) {
    const int st = v % kStages;
    const int lo = (v % spf) * A;                 // the sub-batch's first lane
    const Meta& m = v / spf == fc ? cur : nxt;
    if constexpr (BULK) {
      const bool mine = lane >= lo && lane < lo + A && v * A + (lane - lo) < len;
      const bool hd = mine && m.head;
      const unsigned n = __popc(__ballot_sync(kFull, mine)) + __popc(__ballot_sync(kFull, hd));
      if (lane == 0) sm90::mbar_arrive_expect_tx(&bar[st], n * sb);
      __syncwarp();
      if (mine) {
        sm90::bulk_load(slot(st, lane - lo, false), adds + m.src, sb, &bar[st]);
        if (hd) {
          sm90::bulk_load(slot(st, lane - lo, true),
                          table + static_cast<long long>(m.key) * d + col0, sb, &bar[st]);
        }
      }
    } else {
      for (int i = 0; i < A; ++i) {
        const bool live = v * A + i < len;
        const int src = __shfl_sync(kFull, m.src, lo + i);
        const bool hd = __shfl_sync(kFull, m.head, lo + i) != 0;
        const int key = __shfl_sync(kFull, m.key, lo + i);
        if (live && on) {   // this lane's column of the addend (and of the row)
          sm90::copy4(slot(st, i, false) + lane, adds + src + lane);
          if (hd) {
            sm90::copy4(slot(st, i, true) + lane, table + static_cast<long long>(key) * d + col);
          }
        }
      }
      sm90::copy_commit();
    }
  };

  for (int v = 0; v < kStages; ++v) {
    if (v < nsub || !BULK) issue(v);
  }
  // this lane's nv floats at p: float4s, or one float
  auto lane_load = [&](const float* p, float (&v)[kMaxNv]) {
    if (nv == 1) {
      v[0] = p[0];
      return;
    }
#pragma unroll
    for (int e = 0; e < kMaxNv; e += 4) {
      if (e < nv) {
        const float4 r = *reinterpret_cast<const float4*>(p + e);
        v[e] = r.x; v[e + 1] = r.y; v[e + 2] = r.z; v[e + 3] = r.w;
      }
    }
  };
  float acc[kMaxNv] = {};
  float* dst = nullptr;
  auto store = [&]() {
    if (dst == nullptr || !on) return;
    if (nv == 1) {
      dst[col] = acc[0];
      return;
    }
#pragma unroll
    for (int e = 0; e < kMaxNv; e += 4) {
      if (e < nv) {
        *reinterpret_cast<float4*>(dst + col + e) =
            make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
      }
    }
  };
  for (int u = 0; u < nsub; ++u) {
    if (u > 0 && u % spf == 0) {                  // on to the next 32 positions
      cur = nxt;
      ++fc;
      if (len > (fc + 1) * 32) nxt = fetch(fc + 1);
    }
    const int st = u % kStages;
    if constexpr (BULK) {
      sm90::mbar_wait(&bar[st], (phase >> st) & 1u);
      phase ^= 1u << st;
    } else {
      sm90::copy_wait<kStages - 1>();
    }
    const int lo = (u % spf) * A;
    for (int i = 0; i < A && u * A + i < len; ++i) {
      const bool hd = __shfl_sync(kFull, cur.head, lo + i) != 0;
      const int key = __shfl_sync(kFull, cur.key, lo + i);
      const float g = __shfl_sync(kFull, cur.g, lo + i);
      if (!on) continue;
      const float* add = slot(st, i, false) + lane * nv;
      if (hd) {                                   // a new run: store the last, start from the row
        store();
        dst = table + static_cast<long long>(key) * d;
        lane_load(slot(st, i, true) + lane * nv, acc);
      }
      float v[kMaxNv];
      lane_load(add, v);
#pragma unroll
      for (int e = 0; e < kMaxNv; ++e) {
        if (e < nv) {
          const float up = C_TABLE ? __fmul_rn(a.neg_lr, __fmul_rn(g, v[e]))
                                   : __fmul_rn(a.neg_lr, v[e]);
          acc[e] = __fadd_rn(acc[e], up);
        }
      }
    }
    __syncwarp();                                 // the stage is read before it is refilled
    if (u + kStages < nsub) {
      issue(u + kStages);
    } else if (!BULK) {
      sm90::copy_commit();                       // keeps kStages - 1 groups after the next
    }
  }
  store();
  if constexpr (!BULK) sm90::copy_wait<0>();
}

// The items of worker w's block b, W's then C's (each list's hot rows
// first), taken from the block's counter by the group's warps until none is
// left.
template <bool BULK>
__device__ __forceinline__ void applies_phase(const StepArgs& a, int w, int b, int p0, int lane,
                                              float* region, uint64_t* bar, unsigned& phase) {
  const long long slot = (static_cast<long long>(w) * a.nblocks + b) * 2;
  const int n_c = a.n_items[slot], n_w = a.n_items[slot + 1];
  int* counter = a.work + static_cast<long long>(w) * a.nblocks + b;
  for (;;) {
    int t = 0;
    if (lane == 0) t = atomicAdd(counter, 1);
    t = __shfl_sync(kFull, t, 0);
    if (t >= n_c + n_w) break;
    if (t < n_w) {
      apply_item<BULK, false>(a, w, p0, a.items[(slot + 1) * a.item_cap + t], lane, region, bar,
                              phase);
    } else {
      apply_item<BULK, true>(a, w, p0, a.items[slot * a.item_cap + (t - n_w)], lane, region, bar,
                             phase);
    }
  }
}

// ---------------------------------------------------------------------------
// The persistent kernel: group g = blockIdx / group_ctas walks workers g,
// g + groups, ..., each through all its blocks; two CTAs an SM.
// ---------------------------------------------------------------------------
template <bool BULK, bool LOGSIG>
__global__ void __launch_bounds__(kWarps * 32, 2) block_step_kernel(StepArgs a) {
  __shared__ uint64_t bars[kWarps][kStages];
  extern __shared__ float4 smem4[];
  auto* smem = reinterpret_cast<unsigned char*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.x / a.group_ctas;
  const int rank = blockIdx.x % a.group_ctas;
  float* region = reinterpret_cast<float*>(smem + warp * kWarpBytes);
  uint64_t* bar = bars[warp];
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWarps; ++i) {
      for (int s = 0; s < kStages; ++s) sm90::mbar_init(&bars[i][s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  unsigned phase = 0;
  int* counter = a.arrive + g;
  int arrivals = 0;
  for (int w = g; w < a.n; w += a.groups) {
    for (int b = 0; b < a.nblocks; ++b) {
      const int p0 = b * a.blk;
      const int nb = min(a.blk, a.B - p0);
      int first = 0;                   // the first CTA of the pairs phase
      if (b == 0) {
        first = a.group_ctas > a.sorters ? a.sorters : 0;
        if (rank >= first) draw_pass(a, w, rank - first);
        if (rank < a.sorters) sort_tasks(a, w, rank, BULK ? kWideCols : 32, smem);
      }
      if (rank >= first) {
        pairs_phase<BULK, LOGSIG>(a, w, p0, nb, (rank - first) * kWarps + warp,
                                  (a.group_ctas - first) * kWarps, lane, region, bar, phase);
      }
      sm90::fence_proxy_async();
      sm90::group_barrier(counter, ++arrivals * a.group_ctas);
      sm90::fence_proxy_async();
      applies_phase<BULK>(a, w, b, p0, lane, region, bar, phase);
      if (b + 1 < a.nblocks) {
        sm90::fence_proxy_async();
        sm90::group_barrier(counter, ++arrivals * a.group_ctas);
        sm90::fence_proxy_async();
      }
    }
  }
}

// Checks the arguments, zeroes the barrier, item and draw counters
// (`counters`: groups, then n nblocks, then n ints) and launches the grid
// cooperatively on `stream`. LOGSIG picks the loss form.
template <bool LOGSIG>
int block_step_launch(StepArgs a, int* counters, int vec4, cudaStream_t stream) {
  if (a.n == 0 || a.B == 0) return 0;
  if (a.K < 1 || a.K > kMaxNegatives || a.blk < 1 || a.d < 1 || a.group_ctas < 1 ||
      a.groups < 1 || a.sorters < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.blk = a.blk < a.B ? a.blk : a.B;
  a.sorters = a.sorters < a.group_ctas ? a.sorters : a.group_ctas;
  a.nblocks = (a.B + a.blk - 1) / a.blk;
  // the items a list can have: one start a position, at most d / 32 chunks each
  const long long cap = static_cast<long long>(a.blk) * (a.K + 1) * ((a.d + kNarrow - 1) / kNarrow);
  const long long need = sort_need(a.blk * (a.K + 1));
  if (a.item_cap < cap || a.sort_bytes < need) return static_cast<int>(cudaErrorInvalidValue);
  a.arrive = counters;
  a.work = counters + a.groups;
  a.drawn = a.work + static_cast<long long>(a.n) * a.nblocks;
  auto kernel = vec4 ? block_step_kernel<true, LOGSIG> : block_step_kernel<false, LOGSIG>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarps * 32, kSmemBytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<long long>(a.groups) * a.group_ctas > static_cast<long long>(per_sm) * sms) {
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  err = cudaMemsetAsync(counters, 0,
                        sizeof(int) * (static_cast<size_t>(a.groups) +
                                       static_cast<size_t>(a.n) * (a.nblocks + 1)),
                        stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(static_cast<unsigned>(a.groups * a.group_ctas)),
                                    dim3(kWarps * 32), params, kSmemBytes, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The C entry points' common body (K2: LOGSIG false, blk >= B; K4a: true).
// W, C (n, V, d) float32, updated in place; loss (n, B); centers, contexts
// (n, B) int32; ids (n, B, K) int32, written: the draw from seeds (n, 2)
// uint32 and the alias tables prob (n, V) float32, alias (n, V) int32;
// w_rows/w_perm (n, B) and c_rows/c_perm (n, B (K + 1)), int32 and int64,
// written: the block sorts; coef (n, blk, K + 1), dW and wrows (n, blk, d),
// items (n, nblocks, 2, item_cap) int4, n_items (n, nblocks, 2) int32,
// counters (groups + n (nblocks + 1)) int32 and sort_mem (n, 2 nblocks,
// sort_bytes) scratch.
template <bool LOGSIG>
int block_step_entry(void* W, void* C, void* loss, const void* centers, const void* contexts,
                     void* ids, const void* seeds, const void* prob, const void* alias,
                     void* w_rows, void* w_perm, void* c_rows, void* c_perm,
                     void* coef, void* dW, void* wrows, void* items, void* n_items,
                     void* counters, void* sort_mem, long long sort_bytes, int item_cap, int n,
                     int V, int d, int B, int K, int blk, int group_ctas, int groups,
                     int sorters, float neg_lr, int vec4, void* stream) {
  StepArgs a;
  a.W = static_cast<float*>(W);
  a.C = static_cast<float*>(C);
  a.loss = static_cast<float*>(loss);
  a.centers = static_cast<const int*>(centers);
  a.contexts = static_cast<const int*>(contexts);
  a.ids = static_cast<int*>(ids);
  a.seeds = static_cast<const uint32_t*>(seeds);
  a.prob = static_cast<const float*>(prob);
  a.alias = static_cast<const int*>(alias);
  a.w_rows = static_cast<int*>(w_rows);
  a.w_perm = static_cast<long long*>(w_perm);
  a.c_rows = static_cast<int*>(c_rows);
  a.c_perm = static_cast<long long*>(c_perm);
  a.coef = static_cast<float*>(coef);
  a.dW = static_cast<float*>(dW);
  a.wrows = static_cast<float*>(wrows);
  a.items = static_cast<int4*>(items);
  a.n_items = static_cast<int*>(n_items);
  a.arrive = nullptr;
  a.work = nullptr;
  a.drawn = nullptr;
  a.sort_mem = static_cast<unsigned char*>(sort_mem);
  a.sort_bytes = sort_bytes;
  a.item_cap = item_cap;
  a.n = n; a.V = V; a.d = d; a.B = B; a.K = K; a.blk = blk; a.nblocks = 1;
  a.group_ctas = group_ctas; a.groups = groups; a.sorters = sorters;
  a.neg_lr = neg_lr;
  return block_step_launch<LOGSIG>(a, static_cast<int*>(counters), vec4,
                                   static_cast<cudaStream_t>(stream));
}

}  // namespace sgns
