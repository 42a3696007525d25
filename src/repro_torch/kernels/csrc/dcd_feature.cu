// B4 and B5: the two kernels of the feature-sharded (2-D) block round, for
// Hopper (sm_90a).
//
// The 2-D solver splits the features into m contiguous shards; shard j
// holds, for every row, its nonzeros as a local ELL slice of k entries
// (cols, vals: (n, m, k), local ids in [0, d_loc), padding id d_loc, value
// 0) and its own primal slice w[j] of d1 = d_loc + 1 words (dummy slot at
// d_loc).  A block of B sequential updates rests on
//     wᵀx_t at step t = base_t + Σ_{s<t} δ̃_s·G[s, t],
// base_t = w₀ᵀx_t and G the block's Gram matrix, both sums over shards.
//
// B4, dcd_feature_gram_kernel, replaces the Pallas TPU kernel
// repro/kernels/dcd_feature.py (_gram_kernel, reached through
// dcd_feature_gram_pallas_call): every shard's partial base (m, B) and
// Gram (m, B, B); the caller sums them over shards (the reference's psum
// over "model").  Like the TPU kernel it scatters row t into a d1-word
// scratch, gathers every row s of the block against it for column
// G[:, t], and clears the scratch again.  The TPU kept the scratch in
// VMEM; d1 (4.15M words for webspam at m = 4) does not fit in shared
// memory, so the scratch lives in device memory, one per (shard, CTA),
// allocated zeroed once per solve by the caller.  Grid (m, R): CTA (j, r)
// takes the columns t ≡ r (mod R) of shard j, so R CTAs share a shard's
// B² work.  Row t is cleared by WRITING 0 to the slots it touched, not by
// adding −v back: exact even for a row that repeats a column, where
// (a + b) − a − b need not be 0 in float32.  Padding lanes (id d_loc) are
// skipped in the gather and the scatter, so the dummy slot is never
// touched.  Each warp takes one row s at a time (lanes stride over its k
// entries, a shuffle tree sums them), so G has a fixed summation order.
// What bounds it: each gather is two dependent loads (the id, then the
// scratch word), B·k of them per column, from L2 — latency on the SMs of
// the widest shard, not HBM bytes (the block's rows are about 6 MB at
// webspam).  The wrapper runs up to 1,024 threads a CTA, so 32 warps keep
// gathers in flight.
//
// B5, dcd_feature_update_kernel, replaces repro/kernels/dcd_feature.py
// (_update_kernel, reached through dcd_feature_update_pallas_call): the
// B-step δ recursion against the summed (base, G), the α update, and the
// scatter of δ̃_t·vals_t into this shard's slice only.  One CTA per shard;
// each runs the same recursion on the same inputs (the same δ, as α is
// replicated along "model" in the reference) and scatters only its own
// slice, so slices need no atomics across CTAs.  α is shared: the port
// holds one (n,) α, so each CTA carries the RUNNING α of the block's ids
// in shared memory — a repeated id reads its own earlier update — reads
// the seed α from the input, never from the output, and only CTA 0 writes
// the output, in block order.  The δ̃ history is B floats in shared
// memory; warp 0 runs the recursion (its dot with G[:, t] is O(B)), then
// the CTA scatters row after row (atomicAdd within a row, as B1, so a
// repeated column accumulates; a barrier between rows keeps the reference's
// row order).  What bounds it: the wrapper's copy of w (m·d1 words in and
// out) in bytes, and the serial recursion in latency.
//
// Both build with --fmad=false, as B1–B3, so δ̃·v and the adds round as
// the plain version's do.

#include "dcd_delta.cuh"

#define DCD_FEATURE_MAX_B 1024

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// The CTA's sum of v, valid in thread 0; `red` is DCD_MAX_WARPS floats of
// shared memory.  Every thread must call it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float tot = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) tot += red[w];
  __syncthreads();
  return tot;
}

__global__ void dcd_feature_gram_kernel(
    const int* __restrict__ idx, int B, const int* __restrict__ cols,
    const float* __restrict__ vals, int m, int k, int d_loc,
    const float* __restrict__ w, int d1, float* scratch,
    float* __restrict__ base_p, float* __restrict__ gram_p) {
  __shared__ float red[DCD_MAX_WARPS];
  const int j = blockIdx.x, r = blockIdx.y, R = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float* sc = scratch + ((long long)r * m + j) * d1;
  const float* wj = w + (long long)j * d1;
  for (int t = r; t < B; t += R) {
    const long long rt = ((long long)idx[t] * m + j) * k;
    const int* ct = cols + rt;
    const float* vt = vals + rt;
    float part = 0.0f;
    for (int e = threadIdx.x; e < k; e += blockDim.x) {
      const int c = ct[e];
      if ((unsigned)c < (unsigned)d_loc) {
        const float v = vt[e];
        part += wj[c] * v;
        atomicAdd(sc + c, v);
      }
    }
    // the barriers inside block_sum also publish the scatter
    const float base = block_sum(part, red);
    if (threadIdx.x == 0) base_p[(long long)j * B + t] = base;
    for (int s = warp; s < B; s += nwarps) {
      const long long rs = ((long long)idx[s] * m + j) * k;
      const int* cs = cols + rs;
      const float* vs = vals + rs;
      float acc = 0.0f;
      for (int e = lane; e < k; e += 32) {
        const int c = cs[e];
        if ((unsigned)c < (unsigned)d_loc) acc += sc[c] * vs[e];
      }
      acc = warp_sum(acc);
      if (lane == 0) gram_p[((long long)j * B + s) * B + t] = acc;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < k; e += blockDim.x) {
      const int c = ct[e];
      if ((unsigned)c < (unsigned)d_loc) sc[c] = 0.0f;
    }
    __syncthreads();
  }
}

__global__ void dcd_feature_update_kernel(
    const int* __restrict__ idx, int B, const int* __restrict__ cols,
    const float* __restrict__ vals, int m, int k, int d_loc,
    const float* __restrict__ alpha_in, float* __restrict__ alpha_out,
    const float* __restrict__ q, const float* __restrict__ act,
    const float* __restrict__ y, float* w, int d1,
    const float* __restrict__ base, const float* __restrict__ gram,
    DcdLoss L) {
  __shared__ float dtil[DCD_FEATURE_MAX_B];   // δ̃_t = δ_t·y_t
  __shared__ float a_run[DCD_FEATURE_MAX_B];  // α of idx[t] after update t
  __shared__ int prev[DCD_FEATURE_MAX_B];     // last s < t, idx[s] == idx[t]
  const int j = blockIdx.x;
  for (int t = threadIdx.x; t < B; t += blockDim.x) {
    int p = -1;
    const int it = idx[t];
    for (int s = 0; s < t; ++s)
      if (idx[s] == it) p = s;
    prev[t] = p;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    for (int t = 0; t < B; ++t) {
      float part = 0.0f;
      for (int s = lane; s < t; s += 32)
        part += dtil[s] * gram[(long long)s * B + t];
      part = warp_sum(part);
      if (lane == 0) {
        const long long i = idx[t];
        const float yi = y ? y[i] : 1.0f;
        const float wx = yi * (base[t] + part);
        const float a = prev[t] >= 0 ? a_run[prev[t]] : alpha_in[i];
        float dl = dcd_delta(L, a, wx, q[i]);
        if (act && !(act[i] > 0.0f)) dl = 0.0f;
        a_run[t] = a + dl;
        dtil[t] = dl * yi;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  float* wj = w + (long long)j * d1;
  for (int t = 0; t < B; ++t) {
    const float s = dtil[t];
    if (s != 0.0f) {
      const long long rt = ((long long)idx[t] * m + j) * k;
      for (int e = threadIdx.x; e < k; e += blockDim.x) {
        const int c = cols[rt + e];
        if ((unsigned)c < (unsigned)d_loc) atomicAdd(wj + c, s * vals[rt + e]);
      }
    }
    __syncthreads();
  }
  if (j == 0 && threadIdx.x == 0)
    for (int t = 0; t < B; ++t) alpha_out[idx[t]] = a_run[t];
}

// Plain C entries for ctypes.  Each returns cudaGetLastError() after its
// launch (0 = launched).  act and y may be null.
extern "C" int dcd_feature_gram_launch(const int* idx, int B, const int* cols,
                                       const float* vals, int m, int k,
                                       int d_loc, const float* w, int d1,
                                       float* scratch, int R, float* base_p,
                                       float* gram_p, int threads,
                                       void* stream) {
  dcd_feature_gram_kernel<<<dim3(m, R), threads, 0, (cudaStream_t)stream>>>(
      idx, B, cols, vals, m, k, d_loc, w, d1, scratch, base_p, gram_p);
  return (int)cudaGetLastError();
}

extern "C" int dcd_feature_update_launch(
    const int* idx, int B, const int* cols, const float* vals, int m, int k,
    int d_loc, const float* alpha_in, float* alpha_out, const float* q,
    const float* act, const float* y, float* w, int d1, const float* base,
    const float* gram, int kind, float C, float inv_two_c, float eps_c,
    int newton_steps, int threads, void* stream) {
  if (B > DCD_FEATURE_MAX_B) return (int)cudaErrorInvalidValue;
  const DcdLoss L{kind, C, inv_two_c, eps_c, newton_steps};
  dcd_feature_update_kernel<<<m, threads, 0, (cudaStream_t)stream>>>(
      idx, B, cols, vals, m, k, d_loc, alpha_in, alpha_out, q, act, y, w, d1,
      base, gram, L);
  return (int)cudaGetLastError();
}
