// B2 and B3: DCD over a dense row shard, for Hopper (sm_90a).
//
// B2 replaces the Pallas TPU kernel repro/kernels/dcd_block.py
// (_dcd_indexed_kernel, reached through dcd_epoch_pallas_call(idx=...)):
// for each row id i = idx[t] in order, wx = y_i·(w·x_i),
// δ = loss.delta(α_i, wx, q_i) (0 where act_i = 0), α_i += δ,
// w += δ·y_i·x_i, with α and w carried across all m ids.
// B3 replaces _dcd_tile_kernel (dcd_epoch_pallas_call(idx=None)): one
// in-order epoch over rows 0..n-1, no mask, no labels: for t = 0..n-1,
// wx = w·x_t, δ = loss.delta(α_t, wx, q_t), α_t += δ, w += δ·x_t.
//
// Each has two variants, chosen by shape (repro_torch/dist/mesh.py:
// dcd_dense_plan for B2, dcd_tile_plan for B3).
//
// dcd_dense_staged_kernel, B2 for a block whose rows fit in shared memory
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
//
// dcd_tile_stream_kernel, B3 for rows of at most 256 floats (the main
// path: the whole covtype shard, 581,012 rows of 54 floats, in one
// launch).  An in-order epoch is one serial chain of n dependent updates
// by definition, so one SM does the work and the card's other SMs stay
// idle; the bound is the latency of one update times n, not bytes (216 B
// an update is a few GB/s).  The design takes every device-memory load
// and every CTA barrier off that chain:
//   - A producer warp streams the rows, in order, through a ring of S
//     stages in shared memory, each T consecutive rows with their α and
//     q, and keeps the next stages in flight while the consumer works.
//     Rows of an in-order epoch are contiguous, so a stage is three 1-D
//     bulk copies (the TMA's cp.async.bulk, completing on the stage's
//     "full" mbarrier); a stage whose source is not 16-byte aligned (a
//     view such as X[1001:]) or whose size is not a multiple of 16 bytes
//     (the ragged last tile) is copied by the warp's lanes with 4-byte
//     cp.async instead, completing on the same barrier.
//   - A consumer warp holds w in registers, as B2's staged kernel does:
//     lane l holds w[l + 32u], u < W (W a power of two ≥ ⌈d / 32⌉).  Each
//     update is W multiply-adds from the staged row (the next row and its
//     α and q load a step ahead), a 5-step xor-shuffle butterfly that
//     leaves the same bits of the dot in every lane, δ taken by every
//     lane, and the axpy in registers.  One lane stores α_t to device
//     memory (a store, off the chain).  At the end of a tile the consumer
//     arrives on the stage's "empty" mbarrier; at the end of the epoch it
//     writes w from its registers.
//   - The loss is a template parameter, so δ's dispatch on the loss is
//     resolved at compile time, and the row loop is unrolled by two, so
//     the copies of x, α and q a step ahead become register renames: both
//     cut the instructions one warp issues per update, which is what a
//     lone warp pays for besides its chain.
// What stays on the chain is the dot, the butterfly, δ (an IEEE division
// for hinge; 20 Newton steps with two logf each for the logistic loss)
// and the axpy.
//
// dcd_dense_kernel, the wide variant of both (rows of more than 256
// floats; for B2 also blocks too large to stage): ONE CTA loops over the
// whole sequence.  Thread j owns w entries j, j + blockDim.x, … for the
// whole launch: it gathers its slice of the dot from them and applies the
// axpy to them, so the axpy needs no atomics and each thread reads back
// only its own writes.  The dot reduces with warp shuffles and shared
// memory and thread 0 takes δ (dcd_delta.cuh); the trailing __syncthreads
// orders the shared scratch between updates.  It is latency-bound: each
// update is a row load from device memory, a CTA reduction, a scalar δ and
// an axpy, with three barriers.
//
// The wrappers copy α (and w, or its replicas) into the output buffers;
// the kernels update them in place and allocate nothing.  A δ of exactly 0
// skips the axpy.  Two launches on the same inputs give the same bits (no
// atomics).
//
// B2's data shards.  The reference's p devices along "data" each run their
// own block against their replica of w and psum their Δw; here they are a
// grid of p CTAs, CTA s one shard: its ids are idx[s·m .. s·m + m) of the
// shard's rows [s·n_loc, (s+1)·n_loc) (row s·n_loc + id).  The staged
// kernel reads w + s·w_stride (w_stride 0: one w for every shard) into its
// warp's registers and writes its d-word Δw slice dw[s] = w_new − w; the
// wide kernel updates its own replica w + s·d in place (the wrapper fills
// the replicas and takes Δw = replica − w).  No CTA reads what another
// writes, so the result does not depend on which CTAs run together.  B3,
// and B2 for the serial solvers, are one CTA with n_loc = 0 that updates w
// in place.
//
// B2's tasks.  The multi-task (one-vs-rest) solver's K binary problems on
// one unfolded X are the grid's y dimension: CTA (s, k) runs data shard s
// of task k on the shared rows and q, with its ids at idx + k·idx_ts
// (idx_ts 0: every task draws the same blocks), its α and y at
// + k·row_ts, its act at + k·act_ts (0: one mask for every task), its
// view of w at w + k·w_ts + s·w_stride (staged; it writes the Δw slice
// dw[k·p + s]) or its replica w + (k·p + s)·d (wide).  No CTA's arithmetic
// changes with the task dimension: K = 1 gives the bits of the task-free
// grid.

#include "dcd_delta.cuh"
#include "dcd_stage.cuh"

__global__ void dcd_dense_kernel(const int* __restrict__ idx, int m,
                                 long long n_loc,
                                 const float* __restrict__ X, int d,
                                 float* alpha, const float* __restrict__ q,
                                 const float* __restrict__ act,
                                 const float* __restrict__ y, float* w,
                                 DcdLoss L, long long idx_ts,
                                 long long row_ts, long long act_ts) {
  // data shard blockIdx.x of task blockIdx.y: its ids, its rows, its α, y
  // and act, its replica of w
  const long long task = blockIdx.y;
  const long long row0 = (long long)blockIdx.x * n_loc;
  if (idx) idx += task * idx_ts + (long long)blockIdx.x * m;
  alpha += task * row_ts;
  if (y) y += task * row_ts;
  if (act) act += task * act_ts;
  w += (task * gridDim.x + blockIdx.x) * (long long)d;
  for (int t = 0; t < m; ++t) {
    const long long i = idx ? row0 + idx[t] : t;
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
                                        long long n_loc,
                                        const float* __restrict__ X, int d,
                                        float* alpha,
                                        const float* __restrict__ q,
                                        const float* __restrict__ act,
                                        const float* __restrict__ y, float* w,
                                        long long w_stride, float* dw,
                                        DcdLoss L, long long idx_ts,
                                        long long row_ts, long long act_ts,
                                        long long w_ts) {
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
  // data shard blockIdx.x of task blockIdx.y: its ids, its rows, its α, y
  // and act, its view of w, its Δw slice
  const long long task = blockIdx.y;
  const long long row0 = (long long)blockIdx.x * n_loc;
  idx += task * idx_ts + (long long)blockIdx.x * m;
  alpha += task * row_ts;
  if (y) y += task * row_ts;
  if (act) act += task * act_ts;
  w += task * w_ts + (long long)blockIdx.x * w_stride;
  float* dws =
      dw ? dw + (task * gridDim.x + blockIdx.x) * (long long)d : nullptr;

  // 1. prologue
  for (int t = tid; t < m; t += nt) ids[t] = (int)(row0 + idx[t]);
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
      if (j < d) {
        if (dws)
          dws[j] = wr[u] - w[j];
        else
          w[j] = wr[u];
      }
    }
  }
  __syncthreads();

  // 3. epilogue: α at each id's last update
  for (int t = tid; t < m; t += nt)
    if (last[t]) alpha[ids[t]] = arun[t];
}

// mbarriers and 1-D bulk copies (sm_90), for B3's ring of stages
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

// One update of B3's stream kernel, in every lane of the consumer warp:
// the dot of the lane's W entries of x_t with its words of w (a tree), the
// butterfly over the warp, δ, α_t stored by lane 0, and the axpy into w's
// registers.
template <int W>
__device__ __forceinline__ void stream_update(const DcdLoss& L, int lane,
                                              float* at, float a, float qt,
                                              const float (&x)[W],
                                              float (&wr)[W]) {
  float p[W];
#pragma unroll
  for (int u = 0; u < W; ++u) p[u] = wr[u] * x[u];
#pragma unroll
  for (int h = W / 2; h > 0; h >>= 1)
#pragma unroll
    for (int u = 0; u < h; ++u) p[u] += p[u + h];
  float part = p[0];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, o);
  const float dl = dcd_delta(L, a, part, qt);
  if (lane == 0) *at = a + dl;
  if (dl != 0.0f) {
#pragma unroll
    for (int u = 0; u < W; ++u) wr[u] = wr[u] + dl * x[u];
  }
}

// Shared memory: S "full" and S "empty" mbarriers, then S stages of
// T rows (T·d floats), their α (T) and q (T).  T is a multiple of 4.
// 64 threads: warp 0 consumes, warp 1 produces.
template <int K, int W>
__global__ void dcd_tile_stream_kernel(int n, const float* __restrict__ X,
                                       int d, float* alpha,
                                       const float* __restrict__ q, float* w,
                                       DcdLoss L, int T, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* empty = full + S;
  float* ring = reinterpret_cast<float*>(empty + S);
  const long long stage_words = (long long)T * (d + 2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 32);   // the producer's lanes
      mbar_init(empty + s, 32);  // the consumer's lanes
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tiles = (n + T - 1) / T;

  if (warp == 1) {
    // producer: tile k into stage k mod S, once the consumer has
    // released that stage's previous tile
    for (int k = 0, s = 0, ph = 0; k < tiles; ++k) {
      mbar_wait(empty + s, ph ^ 1);
      const long long t0 = (long long)k * T;
      const int rows = min(T, n - (int)t0);
      float* xs = ring + s * stage_words;
      float* as = xs + (long long)T * d;
      float* qs = as + T;
      const float* xg = X + t0 * d;
      const unsigned xb = 4u * rows * d, ab = 4u * rows;
      if (aligned16(xg) && aligned16(alpha + t0) && aligned16(q + t0) &&
          xb % 16 == 0 && ab % 16 == 0) {
        if (lane == 0) {
          mbar_arrive_expect_tx(full + s, xb + 2 * ab);
          bulk_copy(xs, xg, xb, full + s);
          bulk_copy(as, alpha + t0, ab, full + s);
          bulk_copy(qs, q + t0, ab, full + s);
        } else {
          mbar_arrive(full + s);
        }
      } else {
        const int e_end = rows * d;
        for (int e = lane; e < e_end; e += 32) cp_async4(xs + e, xg + e);
        for (int r = lane; r < rows; r += 32) {
          cp_async4(as + r, alpha + t0 + r);
          cp_async4(qs + r, q + t0 + r);
        }
        mbar_arrive_cp_async(full + s);
      }
      if (++s == S) {
        s = 0;
        ph ^= 1;
      }
    }
    cp_async_wait_all();  // no copy of this thread outlives it
  } else {
    // consumer: the n updates, tile by tile, w in registers
    const DcdLoss Lk{K, L.C, L.inv_two_c, L.eps_c, L.newton_steps};
    float wr[W], x[W], xn[W];
#pragma unroll
    for (int u = 0; u < W; ++u) {
      const int j = lane + 32 * u;
      wr[u] = j < d ? w[j] : 0.0f;
    }
    float* at = alpha;  // α_t of the update under way
    for (int k = 0, s = 0, ph = 0; k < tiles; ++k) {
      // the tile's stage: wait for it, then its first row and scalars
      mbar_wait(full + s, ph);
      const float* xr = ring + s * stage_words + lane;  // this lane's row
      const float* ar = ring + s * stage_words + (long long)T * d;  // α
      const float* qr = ar + T;
      const int rows = min(T, n - k * T);
#pragma unroll
      for (int u = 0; u < W; ++u) x[u] = lane + 32 * u < d ? xr[32 * u] : 0.0f;
      float a = ar[0], qt = qr[0];
      // rows 0..rows-2 load the next row a step ahead; the last loads none
      // (unrolled by two, so that the copies of x, α and q become renames)
#pragma unroll 2
      for (int r = 1; r < rows; ++r) {
        xr += d;
#pragma unroll
        for (int u = 0; u < W; ++u)
          xn[u] = lane + 32 * u < d ? xr[32 * u] : 0.0f;
        const float a_n = ar[r], q_n = qr[r];
        stream_update<W>(Lk, lane, at++, a, qt, x, wr);
#pragma unroll
        for (int u = 0; u < W; ++u) x[u] = xn[u];
        a = a_n;
        qt = q_n;
      }
      stream_update<W>(Lk, lane, at++, a, qt, x, wr);
      mbar_arrive(empty + s);  // the producer may refill the stage
      if (++s == S) {
        s = 0;
        ph ^= 1;
      }
    }
#pragma unroll
    for (int u = 0; u < W; ++u) {
      const int j = lane + 32 * u;
      if (j < d) w[j] = wr[u];
    }
  }
}

// Plain C entries for ctypes.  act and y may be null.  Each returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a layout the kernel cannot take.
extern "C" int dcd_block_indexed_launch(const int* idx, int m, int shards,
                                        long long n_loc, const float* X,
                                        int d, float* alpha, const float* q,
                                        const float* act, const float* y,
                                        float* w, int kind, float C,
                                        float inv_two_c, float eps_c,
                                        int newton_steps, int threads,
                                        int tasks, long long idx_ts,
                                        long long row_ts, long long act_ts,
                                        void* stream) {
  if (shards < 1 || shards > 65535 || tasks < 1 || tasks > 65535)
    return (int)cudaErrorInvalidValue;
  const DcdLoss L{kind, C, inv_two_c, eps_c, newton_steps};
  dcd_dense_kernel<<<dim3(shards, tasks), threads, 0, (cudaStream_t)stream>>>(
      idx, m, n_loc, X, d, alpha, q, act, y, w, L, idx_ts, row_ts, act_ts);
  return (int)cudaGetLastError();
}

extern "C" int dcd_block_tile_launch(int n, const float* X, int d,
                                     float* alpha, const float* q, float* w,
                                     int kind, float C, float inv_two_c,
                                     float eps_c, int newton_steps,
                                     int threads, void* stream) {
  const DcdLoss L{kind, C, inv_two_c, eps_c, newton_steps};
  dcd_dense_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      nullptr, n, 0, X, d, alpha, q, nullptr, nullptr, w, L, 0, 0, 0);
  return (int)cudaGetLastError();
}

template <int W>
static int dense_staged_launch(const int* idx, int m, int shards,
                               long long n_loc, const float* X, int d,
                               float* alpha, const float* q, const float* act,
                               const float* y, float* w, long long w_stride,
                               float* dw, const DcdLoss& L, int threads,
                               int smem_bytes, int tasks, long long idx_ts,
                               long long row_ts, long long act_ts,
                               long long w_ts, cudaStream_t st) {
  static int smem_set = 0;  // the limit raised so far (this process)
  if (smem_bytes > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dcd_dense_staged_kernel<W>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem_bytes;
  }
  dcd_dense_staged_kernel<W><<<dim3(shards, tasks), threads, smem_bytes, st>>>(
      idx, m, n_loc, X, d, alpha, q, act, y, w, w_stride, dw, L, idx_ts,
      row_ts, act_ts, w_ts);
  return (int)cudaGetLastError();
}

extern "C" int dcd_block_staged_launch(
    const int* idx, int m, int shards, long long n_loc, const float* X,
    int d, float* alpha, const float* q, const float* act, const float* y,
    float* w, long long w_stride, float* dw, int kind, float C,
    float inv_two_c, float eps_c, int newton_steps, int per_lane,
    int threads, int smem_bytes, int tasks, long long idx_ts,
    long long row_ts, long long act_ts, long long w_ts, void* stream) {
  // the bytes the kernel carves (repro_torch/dist/mesh.py:
  // dcd_dense_staged_bytes): the block's rows, eight m-word arrays.  More
  // than one (shard, task) pair writes Δw slices, never w in place.
  const long long need = 4LL * m * d + 32LL * m;
  if (m < 1 || d < 1 || d > 32 * per_lane || threads < 32 ||
      threads % 32 != 0 || threads > 1024 || smem_bytes < need ||
      shards < 1 || shards > 65535 || tasks < 1 || tasks > 65535 ||
      ((shards > 1 || tasks > 1) && !dw))
    return (int)cudaErrorInvalidValue;
  const DcdLoss L{kind, C, inv_two_c, eps_c, newton_steps};
  cudaStream_t st = (cudaStream_t)stream;
#define B2_LAUNCH(W)                                                       \
  return dense_staged_launch<W>(idx, m, shards, n_loc, X, d, alpha, q, act, \
                                y, w, w_stride, dw, L, threads, smem_bytes, \
                                tasks, idx_ts, row_ts, act_ts, w_ts, st)
  switch (per_lane) {
    case 1: B2_LAUNCH(1);
    case 2: B2_LAUNCH(2);
    case 4: B2_LAUNCH(4);
    case 8: B2_LAUNCH(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef B2_LAUNCH
}

template <int K, int W>
static int tile_stream_launch(int n, const float* X, int d, float* alpha,
                              const float* q, float* w, const DcdLoss& L,
                              int T, int S, int smem_bytes, cudaStream_t st) {
  static int smem_set = 0;  // the limit raised so far (this process)
  if (smem_bytes > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dcd_tile_stream_kernel<K, W>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem_bytes;
  }
  dcd_tile_stream_kernel<K, W><<<1, 64, smem_bytes, st>>>(n, X, d, alpha, q,
                                                          w, L, T, S);
  return (int)cudaGetLastError();
}

template <int K>
static int tile_stream_per_lane(int n, const float* X, int d, float* alpha,
                                const float* q, float* w, const DcdLoss& L,
                                int per_lane, int T, int S, int smem_bytes,
                                cudaStream_t st) {
  switch (per_lane) {
    case 1: return tile_stream_launch<K, 1>(n, X, d, alpha, q, w, L, T, S,
                                            smem_bytes, st);
    case 2: return tile_stream_launch<K, 2>(n, X, d, alpha, q, w, L, T, S,
                                            smem_bytes, st);
    case 4: return tile_stream_launch<K, 4>(n, X, d, alpha, q, w, L, T, S,
                                            smem_bytes, st);
    case 8: return tile_stream_launch<K, 8>(n, X, d, alpha, q, w, L, T, S,
                                            smem_bytes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int dcd_block_tile_stream_launch(int n, const float* X, int d,
                                            float* alpha, const float* q,
                                            float* w, int kind, float C,
                                            float inv_two_c, float eps_c,
                                            int newton_steps, int per_lane,
                                            int tile_rows, int stages,
                                            int smem_bytes, void* stream) {
  // the bytes the kernel carves (repro_torch/dist/mesh.py:
  // dcd_tile_stream_bytes): two mbarriers a stage, and each stage's rows,
  // α and q
  const long long need =
      (long long)stages * (16LL + 4LL * tile_rows * (d + 2LL));
  if (n < 1 || d < 1 || d > 32 * per_lane || tile_rows < 4 ||
      tile_rows % 4 != 0 || stages < 2 || smem_bytes < need)
    return (int)cudaErrorInvalidValue;
  const DcdLoss L{kind, C, inv_two_c, eps_c, newton_steps};
  cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {  // the loss is a template: no dispatch on the chain
    case DCD_HINGE:
      return tile_stream_per_lane<DCD_HINGE>(n, X, d, alpha, q, w, L,
                                             per_lane, tile_rows, stages,
                                             smem_bytes, st);
    case DCD_SQUARED_HINGE:
      return tile_stream_per_lane<DCD_SQUARED_HINGE>(
          n, X, d, alpha, q, w, L, per_lane, tile_rows, stages, smem_bytes,
          st);
    case DCD_LOGISTIC:
      return tile_stream_per_lane<DCD_LOGISTIC>(n, X, d, alpha, q, w, L,
                                                per_lane, tile_rows, stages,
                                                smem_bytes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
