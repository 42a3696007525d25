// Staging helpers of the kernels that stage rows in shared memory (B1's
// and B2's staged and stream variants, B3's stream variant, B5):
// cp.async copies from device to shared memory, the mbarriers of a ring of
// stages, and the repeated ids of a block or of a ring's lookahead.
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

// dst and src 8-byte aligned
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// close this thread's cp.async copies issued so far into one group
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ bool aligned8(const void* p) {
  return ((unsigned long long)p & 7ull) == 0;
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

// mbarriers and 1-D bulk copies (sm_90), for the rings of stages
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar,
                                                      unsigned bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// an arrival on bar once every cp.async this thread issued has landed
__device__ __forceinline__ void mbar_arrive_cp_async(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// dst, src 16-byte aligned, bytes a multiple of 16
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((unsigned long long)p & 15ull) == 0;
}

// The most stages a stream kernel's ring holds (its producer keeps the
// ids of the last RING_MAX_STAGES − 1 stages in registers).
#define RING_MAX_STAGES 4

// A stream kernel's producer warp, lane l holding `id`, the id of row l of
// stage kk (`rows` rows, T a stage, S stages in the ring), and hist[b − 1]
// the id of row l of stage kk − b: returns to each lane the position of
// the latest earlier update of its id whose α the consumer may not have
// stored yet when this stage's α was copied — an earlier row of this
// stage or a row of the S − 1 stages before it — or -1.  A stage's α is
// copied once the consumer has released the stage S before it, so every
// earlier update outside that lookahead is in α already.  Registers and
// shuffles only: a __match_any_sync for this stage, (S − 1)·T shuffles
// for the stages before it.  Every lane of the warp calls it.
__device__ __forceinline__ int ring_prev(
    int id, const int (&hist)[RING_MAX_STAGES - 1], int lane, int rows,
    int kk, int T, int S) {
  const unsigned valid = rows >= 32 ? 0xffffffffu : (1u << rows) - 1u;
  const unsigned same = __match_any_sync(0xffffffffu, id) & valid &
                        ((1u << lane) - 1u);
  int prev = same ? kk * T + 31 - __clz(same) : -1;
#pragma unroll
  for (int b = 1; b < RING_MAX_STAGES; ++b) {  // the latest stage first
    if (b < S && b <= kk) {
      int hit = -1;
      for (int j = 0; j < T; ++j)
        if (__shfl_sync(0xffffffffu, hist[b - 1], j) == id) hit = j;
      if (prev < 0 && hit >= 0) prev = (kk - b) * T + hit;
    }
  }
  return prev;
}

// Row gathers by bulk copy.  A row of n words at src (4-byte aligned) is
// copied as the 16-byte-aligned window around it into a slot of
// row_slot(n) words, the row starting row_off(src) words (0..3) into the
// slot: the lane arrives on bar with the window's bytes as its
// transaction count, and the copy completes them.  A window that would
// start before `start` or run past `end` (the array's first word and its
// end: an array need not be 16-byte aligned) is copied with 4-byte
// cp.async instead (the lane arrives plainly; its cp.async arrival covers
// the copies).
__host__ __device__ inline int row_slot(int n) { return (n + 6) / 4 * 4; }

__device__ __forceinline__ int row_off(const void* src) {
  return (int)((unsigned long long)src & 15ull) >> 2;
}

__device__ __forceinline__ void row_window(void* dst, const void* src,
                                           int n, const void* start,
                                           const void* end,
                                           unsigned long long* bar) {
  const int o = row_off(src);
  const char* base = reinterpret_cast<const char*>(src) - 4 * o;
  const unsigned bytes = (unsigned)((4 * (o + n) + 15) & ~15);
  if (base >= reinterpret_cast<const char*>(start) &&
      base + bytes <= reinterpret_cast<const char*>(end)) {
    mbar_arrive_expect_tx(bar, bytes);
    bulk_copy(dst, base, bytes, bar);
  } else {
    mbar_arrive(bar);
    const int* s = reinterpret_cast<const int*>(src);
    int* t = reinterpret_cast<int*>(dst) + o;
    for (int e = 0; e < n; ++e) cp_async4(t + e, s + e);
  }
}
