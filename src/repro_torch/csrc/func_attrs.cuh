// What the CUDA runtime reports for each kernel a library launches: its
// registers a thread, its static shared memory, the dynamic shared memory it
// may take (as the launch last set it) and its local memory (its stack frame
// and ptxas' spills). Every library of the port exports `kernel_attrs` from
// a table of its instantiations, so that the static estimate of
// `repro_torch/analysis/vmem.py` is held to what the card reports. Host code
// only: the kernels themselves do not change.
#pragma once

#include <cuda_runtime.h>

struct KernelEntry {
  const char* name;   // the instantiation as `analysis/vmem.py` names it
  const void* fn;
};

// which < 0: the number of entries. Otherwise entry `which`'s name and
// {numRegs, sharedSizeBytes, maxDynamicSharedSizeBytes, localSizeBytes} in
// out[0..3]; returns a cudaError_t.
inline int kernel_attrs_of(const KernelEntry* table, int count, int which, int* out,
                           const char** name) {
  if (which < 0) return count;
  if (which >= count) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, table[which].fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = attr.maxDynamicSharedSizeBytes;
  out[3] = static_cast<int>(attr.localSizeBytes);
  *name = table[which].name;
  return 0;
}

#define KERNEL_ENTRY(label, ...) {label, reinterpret_cast<const void*>(__VA_ARGS__)}

#define KERNEL_ATTRS_EXPORT(table)                                                   \
  extern "C" int kernel_attrs(int which, int* out, const char** name) {              \
    return kernel_attrs_of(table, static_cast<int>(sizeof(table) / sizeof(table[0])), \
                           which, out, name);                                         \
  }
