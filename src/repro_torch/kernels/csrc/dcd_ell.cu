// B1: indexed DCD over an ELL row shard, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/dcd_ell.py
// (_dcd_ell_indexed_kernel, reached through dcd_ell_epoch_pallas_call).
// For each row id i = idx[t], t = 0..m-1, in order:
//   wx = y_i · Σ_j w[cols_ij]·vals_ij,  δ = loss.delta(α_i, wx, q_i)
//   (0 where act_i = 0),  α_i += δ,  w[cols_ij] += δ·y_i·vals_ij.
// α and w carry across all m ids: each update reads the previous one's
// writes (serial-DCD semantics).
//
// Design.  The TPU kernel leans on its grid running in order; Hopper runs
// blocks in parallel and in no order, so ONE CTA runs the whole id
// sequence in a loop, with one thread per ELL slot (whole warps).  The
// wrapper copies α and w into the output buffers first; the kernel
// updates them in place and allocates nothing.  The dot reduces with warp
// shuffles and shared memory, thread 0 takes δ (dcd_delta.cuh) and the
// threads scatter.  Padding slots (col == d, value 0) are skipped in both
// the gather and the scatter, so the dummy slot w[d] stays exactly 0 and
// no two threads store to it; real columns scatter with atomicAdd, so a
// row that repeats a column accumulates it as .at[].add does.  The
// __syncthreads after the scatter makes this update's writes visible to
// the next update's gather (w is read with plain loads, never through the
// read-only cache).  A δ of exactly 0 (a row at its box, or frozen)
// scatters nothing: adding 0·v would leave w unchanged.
//
// What bounds it.  A chain of m dependent updates, each a gather of k
// values of w (L2) behind a load of the row (HBM), a CTA reduction, a
// scalar δ and a scatter, with a barrier between updates: latency bounds
// it, not bytes — one CTA on one SM moves a few KB per update.  w at
// rcv1's d = 47,236 is 189 KB and fits in the 227 KB of shared memory one
// CTA can use: keeping w there for the whole launch is the next lever.

#include "dcd_delta.cuh"

__global__ void dcd_ell_kernel(const int* __restrict__ idx, int m,
                               const int* __restrict__ cols,
                               const float* __restrict__ vals, int k, int d,
                               float* alpha, const float* __restrict__ q,
                               const float* __restrict__ act,
                               const float* __restrict__ y, float* w,
                               DcdLoss L) {
  for (int t = 0; t < m; ++t) {
    const long long i = idx[t];
    const int* ci = cols + i * k;
    const float* vi = vals + i * k;
    float part = 0.0f;
    for (int j = threadIdx.x; j < k; j += blockDim.x) {
      const int c = ci[j];
      if ((unsigned)c < (unsigned)d) part += w[c] * vi[j];
    }
    const float s = dcd_update_scale(part, i, alpha, q, act, y, L);
    if (s != 0.0f) {
      for (int j = threadIdx.x; j < k; j += blockDim.x) {
        const int c = ci[j];
        if ((unsigned)c < (unsigned)d) atomicAdd(w + c, s * vi[j]);
      }
    }
    __syncthreads();
  }
}

// Plain C entry for ctypes.  act and y may be null.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int dcd_ell_launch(const int* idx, int m, const int* cols,
                              const float* vals, int k, int d, float* alpha,
                              const float* q, const float* act,
                              const float* y, float* w, int kind, float C,
                              float inv_two_c, float eps_c, int newton_steps,
                              int threads, void* stream) {
  const DcdLoss L{kind, C, inv_two_c, eps_c, newton_steps};
  dcd_ell_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      idx, m, cols, vals, k, d, alpha, q, act, y, w, L);
  return (int)cudaGetLastError();
}
