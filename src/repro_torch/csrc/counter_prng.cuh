// Counter-based alias draw shared by the sampler and the fused SGNS step.
//
// Bit-identical to the JAX package's `fused_negative_ids`
// (repro/kernels/sgns_fused.py: _mix32, counter_uniforms,
// alias_draw_from_counters) and to the plain torch version in
// repro_torch/kernels/sgns_fused.py. That holds only because every step is
// exact or correctly rounded:
//   * uint32 arithmetic throughout the hash (wrap-around multiply);
//   * the top 24 bits of a hash, converted to float and scaled by 2^-24,
//     are exact;
//   * u * V is one round-to-nearest multiply (__fmul_rn, never contracted
//     or approximated), truncated toward zero (__float2int_rz) and clamped
//     to V - 1;
//   * the build never passes --use_fast_math.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// lowbias32 avalanche round (bijective on uint32).
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// U[0,1) float for one counter under the (s0, s1) seed words.
__device__ __forceinline__ float counter_uniform(uint32_t s0, uint32_t s1,
                                                 uint32_t counter) {
  const uint32_t bits = mix32(mix32(counter ^ s0) + s1);
  return __fmul_rn(__uint2float_rn(bits >> 8), 5.9604644775390625e-08f);
}

// One alias-table draw for the draw at row-major position `n`: counters 2n
// (index pick) and 2n+1 (acceptance).
__device__ __forceinline__ int alias_draw(uint32_t s0, uint32_t s1,
                                          const float* __restrict__ prob,
                                          const int* __restrict__ alias,
                                          int V, uint32_t n) {
  const float u_idx = counter_uniform(s0, s1, n * 2u);
  const float u_acc = counter_uniform(s0, s1, n * 2u + 1u);
  int idx = __float2int_rz(__fmul_rn(u_idx, static_cast<float>(V)));
  idx = min(idx, V - 1);
  return u_acc < __ldg(prob + idx) ? idx : __ldg(alias + idx);
}
