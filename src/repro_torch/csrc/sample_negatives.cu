// K1: the counter-hash alias negative draw, one thread per draw.
//
// Replaces: repro/kernels/sgns_fused.py `_sampler_kernel` (reached through
// `sample_negatives_fused`), which runs `fused_negative_ids` on a whole
// VMEM-resident alias table. Here every worker has its own seed and its
// own (V,) table row; worker w's draws restart at counter 0, as each
// worker's draw does under the reference's vmap.
//
// Bound on the H100: memory. A draw reads 8 bytes of table (prob + alias,
// at a random index) and writes 4 bytes; the hash is ~20 integer ops. At
// the main path's shapes (51,200 draws) the whole call is 614 KB, 0.18 us at
// 3.35 TB/s, far below one launch's fixed cost: what bounds this kernel is
// the launch floor. So the draw runs where it can ride another launch: K2
// and K4a (`sgns_block_step.cuh`) make it inside their own launch with the
// same `alias_draw` at the same counters, and the `main` and `hbm` (block)
// paths launch this kernel no more. It stays the counterpart of the TPU
// kernel and the draw of K4b, K5 and K6, whose bits K2 and K4a are held to;
// its design is the simplest one that is exact: one thread per draw,
// read-only-cache loads (__ldg) for the gathered table entries, coalesced
// stores.

#include "counter_prng.cuh"
#include "func_attrs.cuh"

namespace {

__global__ void sample_negatives_kernel(const uint32_t* __restrict__ seeds,
                                        const float* __restrict__ prob,
                                        const int* __restrict__ alias,
                                        int* __restrict__ out, int V,
                                        long long per_worker) {
  const int w = blockIdx.y;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= per_worker) return;
  const uint32_t s0 = seeds[2 * w];
  const uint32_t s1 = seeds[2 * w + 1];
  const long long row = static_cast<long long>(w) * V;
  out[static_cast<long long>(w) * per_worker + i] =
      alias_draw(s0, s1, prob + row, alias + row, V, static_cast<uint32_t>(i));
}

}  // namespace

// seeds (n, 2) uint32, prob (n, V) float32, alias (n, V) int32,
// out (n, per_worker) int32. Returns cudaGetLastError() after the launch.
extern "C" int sample_negatives_launch(const void* seeds, const void* prob,
                                       const void* alias, void* out, int n,
                                       int V, long long per_worker,
                                       void* stream) {
  if (n == 0 || per_worker == 0) return 0;
  constexpr int kThreads = 256;
  const dim3 grid(static_cast<unsigned>((per_worker + kThreads - 1) / kThreads),
                  static_cast<unsigned>(n));
  sample_negatives_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(seeds), static_cast<const float*>(prob),
      static_cast<const int*>(alias), static_cast<int*>(out), V, per_worker);
  return static_cast<int>(cudaGetLastError());
}

static const KernelEntry kKernels[] = {
    KERNEL_ENTRY("sample_negatives_kernel", sample_negatives_kernel),
};
KERNEL_ATTRS_EXPORT(kKernels)
