// Staging helpers of the kernels that stage a block in shared memory (B2's
// staged variant in dcd_block.cu, B5 in dcd_feature.cu): cp.async copies
// from device to shared memory, and the block's repeated ids.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// dst and src 16-byte aligned
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// All threads, a thread an id: for each t < m, prev[t] = the last s < t
// with ids[s] == ids[t] (or -1; a repeated id reads that update's running
// α) and last[t] = no s > t has the same id (its α is the one written
// back).  ids, prev and last in shared memory; the caller synchronises.
__device__ __forceinline__ void dcd_repeats(const int* ids, int m, int* prev,
                                            int* last) {
  for (int t = threadIdx.x; t < m; t += blockDim.x) {
    const int i = ids[t];
    int p = -1;
    bool later = false;
    for (int s = 0; s < m; ++s) {
      const bool eq = ids[s] == i;
      if (eq && s < t) p = s;
      later |= eq && s > t;
    }
    prev[t] = p;
    last[t] = !later;
  }
}
