// B2 and B3: DCD over a dense row shard, for Hopper (sm_90a).
//
// B2 replaces the Pallas TPU kernel repro/kernels/dcd_block.py
// (_dcd_indexed_kernel, reached through dcd_epoch_pallas_call(idx=...)):
// for each row id i = idx[t] in order, wx = y_i·(w·x_i),
// δ = loss.delta(α_i, wx, q_i) (0 where act_i = 0), α_i += δ,
// w += δ·y_i·x_i, with α and w carried across all m ids.
// B3 replaces _dcd_tile_kernel (dcd_epoch_pallas_call(idx=None)): one
// in-order epoch over rows 0..n-1, no mask, no labels.  It is this same
// kernel with idx = act = y = null (i = t, all-ones); it has its own C
// entry, wrapper and launch count.
//
// B2 has two variants, chosen by shape (repro_torch/dist/mesh.py:
// dcd_dense_plan); B3 runs the wide one.
//
// dcd_dense_staged_kernel, for a block whose rows fit in shared memory
// (the main path: 64 ids of covtype's 54 floats, 13.8 KB).  What bounds B2
// is the chain of m dependent updates, not bytes (the block's rows, α and
// w are a few KB); the design takes every global access and every CTA
// barrier off that chain.
//   1. Prologue, all threads: the ids, then cp.async copies of the
//      block's rows into shared memory (4-byte copies: a 54-float row is
//      only 8-byte aligned), waited for once; each id's α, q, y and act
//      are gathered beside them; each id's previous occurrence in the
//      block, whose running α a repeated id reads, and whether a later
//      one follows (a thread an id, scanning the ids in shared memory).
//   2. Updates, on warp 0: lane l holds w[l + 32u], u < W, in registers
//      (W, a template, is a power of two ≥ ⌈d / 32⌉).  Each update is
//      W multiply-adds from the staged row (the next row's entries load
//      while this one runs), a 5-step xor-shuffle butterfly that leaves
//      the same bits of the dot in every lane (float addition commutes),
//      δ taken by every lane, and the axpy in registers.  The next
//      update's scalars load a step ahead.  No __syncthreads and no global
//      access; a __syncwarp orders the running α.
//   3. Epilogue: α of each id at its last update in the block, w from the
//      registers.
// Two launches give the same bits.
//
// dcd_dense_kernel, the wide variant (rows of more than 256 floats, or
// blocks too large to stage) and B3: ONE CTA loops over the whole
// sequence.  Thread j owns w entries j, j + blockDim.x, … for the whole
// launch: it gathers its slice of the dot from them and applies the axpy
// to them, so the axpy needs no atomics and each thread reads back only
// its own writes.  The dot reduces with warp shuffles and shared memory
// and thread 0 takes δ (dcd_delta.cuh); the trailing __syncthreads orders
// the shared scratch between updates.  It is latency-bound: each update
// is a row load from device memory, a CTA reduction, a scalar δ and an
// axpy, with three barriers.
//
// The wrappers copy α and w into the output buffers; the kernels update
// them in place and allocate nothing.  A δ of exactly 0 skips the axpy.

#include "dcd_delta.cuh"
#include "dcd_stage.cuh"

__global__ void dcd_dense_kernel(const int* __restrict__ idx, int m,
                                 const float* __restrict__ X, int d,
                                 float* alpha, const float* __restrict__ q,
                                 const float* __restrict__ act,
                                 const float* __restrict__ y, float* w,
                                 DcdLoss L) {
  for (int t = 0; t < m; ++t) {
    const long long i = idx ? idx[t] : t;
    const float* xi = X + i * d;
    float part = 0.0f;
    for (int j = threadIdx.x; j < d; j += blockDim.x) part += w[j] * xi[j];
    const float s = dcd_update_scale(part, i, alpha, q, act, y, L);
    if (s != 0.0f) {
      for (int j = threadIdx.x; j < d; j += blockDim.x) w[j] += s * xi[j];
    }
    __syncthreads();
  }
}

template <int W>
__global__ void dcd_dense_staged_kernel(const int* __restrict__ idx, int m,
                                        const float* __restrict__ X, int d,
                                        float* alpha,
                                        const float* __restrict__ q,
                                        const float* __restrict__ act,
                                        const float* __restrict__ y, float* w,
                                        DcdLoss L) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* rows = reinterpret_cast<float*>(smem);  // m rows of d floats
  int* ids = reinterpret_cast<int*>(rows + (long long)m * d);
  float* a0 = reinterpret_cast<float*>(ids + m);  // α_i at block entry
  float* qs = a0 + m;
  float* ys = qs + m;
  float* acts = ys + m;
  float* arun = acts + m;  // α_i after update t
  int* prev = reinterpret_cast<int*>(arun + m);  // last s < t, same id
  int* last = prev + m;  // no s > t has the same id
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;

  // 1. prologue
  for (int t = tid; t < m; t += nt) ids[t] = idx[t];
  __syncthreads();
  const int E = m * d;
  for (int e = tid; e < E; e += nt) {
    const int t = e / d;
    cp_async4(rows + e, X + (long long)ids[t] * d + (e - t * d));
  }
  for (int t = tid; t < m; t += nt) {
    const int i = ids[t];
    a0[t] = alpha[i];
    qs[t] = q[i];
    ys[t] = y ? y[i] : 1.0f;
    acts[t] = act ? act[i] : 1.0f;
  }
  dcd_repeats(ids, m, prev, last);
  cp_async_wait_all();
  __syncthreads();

  // 2. the m updates, on warp 0, w in registers; the next update's row
  // and scalars load while this one runs
  if (warp == 0) {
    float wr[W], x[W], xn[W];
#pragma unroll
    for (int u = 0; u < W; ++u) {
      const int j = lane + 32 * u;
      wr[u] = j < d ? w[j] : 0.0f;
      x[u] = j < d ? rows[j] : 0.0f;
      xn[u] = 0.0f;
    }
    int pt = prev[0];
    float yi = ys[0], qi = qs[0], ai = acts[0], a0t = a0[0], a_last = 0.0f;
    for (int t = 0; t < m; ++t) {
      float part = 0.0f;
#pragma unroll
      for (int u = 0; u < W; ++u)
        if (lane + 32 * u < d) part += wr[u] * x[u];
      int pt_n = -1;
      float y_n = 1.0f, q_n = 1.0f, act_n = 1.0f, a0_n = 0.0f;
      if (t + 1 < m) {
        const float* rn = rows + (long long)(t + 1) * d;
#pragma unroll
        for (int u = 0; u < W; ++u) {
          const int j = lane + 32 * u;
          xn[u] = j < d ? rn[j] : 0.0f;
        }
        pt_n = prev[t + 1];
        y_n = ys[t + 1];
        q_n = qs[t + 1];
        act_n = acts[t + 1];
        a0_n = a0[t + 1];
      }
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      // a repeated id reads its running α (the last update's from
      // registers)
      const float a = pt < 0 ? a0t : (pt == t - 1 ? a_last : arun[pt]);
      float dl = dcd_delta(L, a, yi * part, qi);
      if (!(ai > 0.0f)) dl = 0.0f;
      a_last = a + dl;
      if (lane == 0) arun[t] = a_last;
      const float sc = dl * yi;
      if (sc != 0.0f) {
#pragma unroll
        for (int u = 0; u < W; ++u) wr[u] = wr[u] + sc * x[u];
      }
#pragma unroll
      for (int u = 0; u < W; ++u) x[u] = xn[u];
      pt = pt_n;
      yi = y_n;
      qi = q_n;
      ai = act_n;
      a0t = a0_n;
      __syncwarp();
    }
#pragma unroll
    for (int u = 0; u < W; ++u) {
      const int j = lane + 32 * u;
      if (j < d) w[j] = wr[u];
    }
  }
  __syncthreads();

  // 3. epilogue: α at each id's last update
  for (int t = tid; t < m; t += nt)
    if (last[t]) alpha[ids[t]] = arun[t];
}

// Plain C entries for ctypes.  act and y may be null.  Each returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a layout the kernel cannot take.
extern "C" int dcd_block_indexed_launch(const int* idx, int m,
                                        const float* X, int d, float* alpha,
                                        const float* q, const float* act,
                                        const float* y, float* w, int kind,
                                        float C, float inv_two_c,
                                        float eps_c, int newton_steps,
                                        int threads, void* stream) {
  const DcdLoss L{kind, C, inv_two_c, eps_c, newton_steps};
  dcd_dense_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      idx, m, X, d, alpha, q, act, y, w, L);
  return (int)cudaGetLastError();
}

extern "C" int dcd_block_tile_launch(int n, const float* X, int d,
                                     float* alpha, const float* q, float* w,
                                     int kind, float C, float inv_two_c,
                                     float eps_c, int newton_steps,
                                     int threads, void* stream) {
  const DcdLoss L{kind, C, inv_two_c, eps_c, newton_steps};
  dcd_dense_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      nullptr, n, X, d, alpha, q, nullptr, nullptr, w, L);
  return (int)cudaGetLastError();
}

template <int W>
static int dense_staged_launch(const int* idx, int m, const float* X, int d,
                               float* alpha, const float* q, const float* act,
                               const float* y, float* w, const DcdLoss& L,
                               int threads, int smem_bytes,
                               cudaStream_t st) {
  static int smem_set = 0;  // the limit raised so far (this process)
  if (smem_bytes > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dcd_dense_staged_kernel<W>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem_bytes;
  }
  dcd_dense_staged_kernel<W><<<1, threads, smem_bytes, st>>>(
      idx, m, X, d, alpha, q, act, y, w, L);
  return (int)cudaGetLastError();
}

extern "C" int dcd_block_staged_launch(const int* idx, int m, const float* X,
                                       int d, float* alpha, const float* q,
                                       const float* act, const float* y,
                                       float* w, int kind, float C,
                                       float inv_two_c, float eps_c,
                                       int newton_steps, int per_lane,
                                       int threads, int smem_bytes,
                                       void* stream) {
  // the bytes the kernel carves (repro_torch/dist/mesh.py:
  // dcd_dense_staged_bytes): the block's rows, eight m-word arrays
  const long long need = 4LL * m * d + 32LL * m;
  if (m < 1 || d < 1 || d > 32 * per_lane || threads < 32 ||
      threads % 32 != 0 || threads > 1024 || smem_bytes < need)
    return (int)cudaErrorInvalidValue;
  const DcdLoss L{kind, C, inv_two_c, eps_c, newton_steps};
  cudaStream_t st = (cudaStream_t)stream;
  switch (per_lane) {
    case 1: return dense_staged_launch<1>(idx, m, X, d, alpha, q, act, y, w,
                                          L, threads, smem_bytes, st);
    case 2: return dense_staged_launch<2>(idx, m, X, d, alpha, q, act, y, w,
                                          L, threads, smem_bytes, st);
    case 4: return dense_staged_launch<4>(idx, m, X, d, alpha, q, act, y, w,
                                          L, threads, smem_bytes, st);
    case 8: return dense_staged_launch<8>(idx, m, X, d, alpha, q, act, y, w,
                                          L, threads, smem_bytes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
