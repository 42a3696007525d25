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
// B2 has four variants, B3 three, chosen by shape (repro_torch/dist/
// mesh.py: dcd_dense_plan for B2, dcd_tile_plan for B3).
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
// dcd_dense_stream_kernel, B2 for every other block of rows of at most
// 256 floats (a whole covtype epoch's order, CoCoA's rounds): B3's stream
// kernel fed by an id list.  The producer gathers the rows by id, lane r
// row r of a stage as one bulk copy of the 16-byte-aligned window around
// it (row_window: a covtype row is 216 bytes, 8-byte aligned; cp.async
// copies by the lanes hold too few rows in flight), with each id's α, q,
// y and act (cp.async), completing on the stage's "full" mbarrier; the
// consumer is B3's (stream_update: w in registers, the butterfly, δ in
// every lane), with the label folded in and the mask applied.  α is the
// hazard, as in B1's stream kernel (dcd_ell.cu): a stage's α is copied
// once the stage S before it is released, so the producer records each
// row's latest earlier position among the last S·T, and the consumer
// reads that position's running α instead.  Each update stores α_i.
//
// dcd_dense_split_kernel, B2 and B3 for rows of 256 < d ≤ 8,192 floats
// (the LM probe's 5,120-float features; repro_torch/dist/mesh.py:
// DENSE_SPLIT_MAX_D), every path: B2's indexed launches and their shard,
// task and pod grids, and B3's in-order epoch (no ids: row t is update
// t).  One warp cannot hold such a w in registers, so w is split over C
// consumer warps (C ≤ 16): lane l of warp c holds w[c·32W + 32u + l],
// u < W (W = 8 up to 4,096 floats, else 16).  The producer is B2
// stream's: a warp gathering each row by id as one bulk copy of its
// 16-byte-aligned window into a ring of S stages of T rows (T·S rows in
// flight, as many as fit: 8 at d = 5,120), with each id's α, q, y and
// act, and ring_prev's previous occurrence of a repeated id (B3's ids
// are distinct).  Each update, in every consumer warp:
//   1. W multiply-adds of its slice of the staged row (a tree) and the
//      xor butterfly: the warp's partial dot in every lane;
//   2. lane 0 writes it to the update's slot of a double-buffered array
//      of partials in shared memory (16 a slot, those past C kept 0);
//   3. one named barrier of the C consumer warps (bar.sync 1, not
//      __syncthreads: the producer never waits on it);
//   4. every lane reads the slot (four float4 loads) and sums it in one
//      fixed tree, so every warp holds the same bits of the dot;
//   5. δ in every lane (the label folded in, the mask applied), and the
//      axpy into the warp's registers.
// The next row's words and scalars load a step ahead, as in the stream
// kernels.  Every warp keeps its own copy of the running α of the last
// S·T positions (it takes the same δ as every other warp), so no warp
// reads what another writes between barriers; warp 0 stores α_i (the
// only global access on the chain, a store).  Two slots of partials
// suffice: a warp writes update t + 2's slot only after every warp has
// passed update t + 1's barrier, i.e. has read update t's partials.  The
// grids keep the stream kernels' layout: CTA (shard, task) updates its own
// replica of w.  What bounds it: the chain of m updates, about 100
// instructions a consumer warp an update, so one SM issuing C + 1 warps;
// the bytes (a row an update, 20 KB at the probe's rows) stream beside it.
//
// dcd_dense_kernel, the wide variant of both (rows of more than 8,192
// floats; launched for narrower rows only when asked for): ONE CTA loops
// over the whole sequence.  Thread j owns w entries j, j + blockDim.x, … for the
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
// wide, stream and split kernels update their own replica w + s·d in
// place (the wrapper fills
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
// dw[k·p + s]) or its replica w + (k·p + s)·d (wide, stream, split).
// No CTA's arithmetic changes with the task dimension: K = 1 gives the
// bits of the task-free grid.
//
// B2's pods.  The pod solver's P pods of p data shards are the grid's x
// dimension, P·p CTAs (CTA s: data shard s mod p of pod s / p), pod k's
// shards reading pod k's own w: the staged kernel reads its view at
// w + k·w_ts + (s / pod_shards)·w_stride, pod_shards = p (1: a w a
// shard); the wrapper sums each pod's p slices in shard order.  The wide
// and stream kernels' replicas are a pair's own already.  P = 1 gives the
// bits of the pod-free grid.

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
                                        long long w_ts, int pod_shards) {
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
  w += task * w_ts + (long long)(blockIdx.x / pod_shards) * w_stride;
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

// One update of a stream kernel, in every lane of the consumer warp: the
// dot of the lane's W entries of x_t with its words of w (a tree), the
// butterfly over the warp, δ, α stored by lane 0 at `at`, and the axpy
// into w's registers; returns the new α.  FED (B2's id-fed kernel) folds
// the label y_t into wx and the scale and zeroes δ where act_t = 0; B3's
// in-order epoch has neither.
template <int W, bool FED = false>
__device__ __forceinline__ float stream_update(const DcdLoss& L, int lane,
                                               float* at, float a, float qt,
                                               const float (&x)[W],
                                               float (&wr)[W],
                                               float yt = 1.0f,
                                               float actt = 1.0f) {
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
  float dl = dcd_delta(L, a, FED ? yt * part : part, qt);
  if (FED && !(actt > 0.0f)) dl = 0.0f;
  if (lane == 0) *at = a + dl;
  const float sc = FED ? dl * yt : dl;
  if (sc != 0.0f) {
#pragma unroll
    for (int u = 0; u < W; ++u) wr[u] = wr[u] + sc * x[u];
  }
  return a + dl;
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

// words of one stage of B2's id-fed stream kernel, T rows of d floats:
// the rows' windows (row_slot(d) words each), then their id, prev, offset
// into the window, α, q, y and act (T each), padded to 16 bytes
__host__ __device__ inline long long dense_stream_stage_words(int T, int d) {
  return ((long long)T * row_slot(d) + 7LL * T + 3) / 4 * 4;
}

// The producer warp of B2's id-fed kernels (stream and split): stage kk
// of T rows into slot kk mod S once the consumers have released the stage
// S before it — the ids (loaded a stage ahead; idx null: row t is update
// t, B3's in-order epoch, whose rows never repeat), each row's previous
// occurrence in the lookahead (ring_prev), lane r's row as one bulk copy
// of its 16-byte-aligned window (row_window; covtype's 216-byte rows are
// only 8-byte aligned), and cp.async copies of the rows' α, q, y and act.
__device__ __forceinline__ void dense_stream_produce(
    const int* idx, int m, long long row0, const float* X, long long n_x,
    int d, const float* alpha, const float* q, const float* act,
    const float* y, float* ring, long long sw, unsigned long long* full,
    unsigned long long* empty, int T, int S, int lane) {
  const int dw = row_slot(d), n_st = (m + T - 1) / T;
  const long long rd = (long long)T * dw;
  const float* x_end = X + n_x * d;
  auto row_id = [&](int t) { return idx ? (int)(row0 + idx[t]) : t; };
  int id_n = lane < T && lane < m ? row_id(lane) : 0;
  int hist[RING_MAX_STAGES - 1] = {0, 0, 0};
  for (int kk = 0, s = 0, ph = 0; kk < n_st; ++kk) {
    mbar_wait(empty + s, ph ^ 1);
    const int t0 = kk * T, rows = min(T, m - t0);
    float* xs = ring + s * sw;
    int* sid = reinterpret_cast<int*>(xs + rd);
    int* sprev = sid + T;
    int* soff = sprev + T;
    float* sa = reinterpret_cast<float*>(soff + T);
    float* sq = sa + T;
    float* sy = sq + T;
    float* sact = sy + T;
    const int id = id_n;
    if (kk + 1 < n_st) {
      const int tn = t0 + T + lane;
      id_n = lane < T && tn < m ? row_id(tn) : 0;
    }
    const int prev = idx ? ring_prev(id, hist, lane, rows, kk, T, S) : -1;
    if (lane < rows) {
      sid[lane] = id;
      sprev[lane] = prev;
      cp_async4(sa + lane, alpha + id);
      cp_async4(sq + lane, q + id);
      if (y)
        cp_async4(sy + lane, y + id);
      else
        sy[lane] = 1.0f;
      if (act)
        cp_async4(sact + lane, act + id);
      else
        sact[lane] = 1.0f;
      const float* src = X + (long long)id * d;
      soff[lane] = row_off(src);  // stored before the lane arrives
      row_window(xs + (long long)lane * dw, src, d, X, x_end, full + s);
    } else {
      mbar_arrive(full + s);
    }
    mbar_arrive_cp_async(full + s);
#pragma unroll
    for (int b = RING_MAX_STAGES - 2; b > 0; --b) hist[b] = hist[b - 1];
    hist[0] = id;
    if (++s == S) {
      s = 0;
      ph ^= 1;
    }
  }
  cp_async_wait_all();  // no copy of this thread outlives it
}

// B2's id-fed stream kernel: B3's ring and consumer, the rows gathered
// by id.  Shared memory: S "full" and S "empty" mbarriers, S stages, the
// running α of the last S·T positions.  64 threads: warp 0 consumes,
// warp 1 produces.  X holds n_x rows; S·T is a power of two and S at
// most RING_MAX_STAGES.
template <int K, int W>
__global__ void dcd_dense_stream_kernel(
    const int* __restrict__ idx, int m, long long n_loc,
    const float* __restrict__ X, long long n_x, int d, float* alpha,
    const float* __restrict__ q, const float* __restrict__ act,
    const float* __restrict__ y, float* w, DcdLoss L, long long idx_ts,
    long long row_ts, long long act_ts, int T, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* empty = full + S;
  float* ring = reinterpret_cast<float*>(empty + S);
  const long long sw = dense_stream_stage_words(T, d);
  float* arun = ring + S * sw;  // α after position t, at t & stm
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int dw = row_slot(d);
  // data shard blockIdx.x of task blockIdx.y: its ids, its rows, its α, y
  // and act, its replica of w
  const long long task = blockIdx.y;
  const long long row0 = (long long)blockIdx.x * n_loc;
  idx += task * idx_ts + (long long)blockIdx.x * m;
  alpha += task * row_ts;
  if (y) y += task * row_ts;
  if (act) act += task * act_ts;
  w += (task * gridDim.x + blockIdx.x) * (long long)d;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      // the producer's lanes, twice each: once with their row's window
      // (its bytes), once their cp.async copies land
      mbar_init(full + s, 64);
      mbar_init(empty + s, 32);  // the consumer's lanes
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n_st = (m + T - 1) / T, stm = S * T - 1;
  const long long rd = (long long)T * dw;

  if (warp == 1) {
    dense_stream_produce(idx, m, row0, X, n_x, d, alpha, q, act, y, ring, sw,
                         full, empty, T, S, lane);
  } else {
    // consumer: w in registers; the next row's words and scalars load a
    // step ahead, with its current α_i: the staged one, or the running
    // one of its last occurrence in the lookahead (the update just taken:
    // a register)
    const DcdLoss Lk{K, L.C, L.inv_two_c, L.eps_c, L.newton_steps};
    float wr[W], x[W], xn[W];
#pragma unroll
    for (int u = 0; u < W; ++u) {
      const int j = lane + 32 * u;
      wr[u] = j < d ? w[j] : 0.0f;
      xn[u] = 0.0f;
    }
    float a_last = 0.0f;
    for (int kk = 0, s = 0, ph = 0; kk < n_st; ++kk) {
      mbar_wait(full + s, ph);
      const float* xs = ring + s * sw;
      const int* sid = reinterpret_cast<const int*>(xs + rd);
      const int* sprev = sid + T;
      const int* soff = sprev + T;
      const float* sa = reinterpret_cast<const float*>(soff + T);
      const float* sq = sa + T;
      const float* sy = sq + T;
      const float* sact = sy + T;
      const int t0 = kk * T, rows = min(T, m - t0);
      const float* xr = xs + soff[0] + lane;  // this lane's words of row 0
#pragma unroll
      for (int u = 0; u < W; ++u) x[u] = lane + 32 * u < d ? xr[32 * u] : 0.0f;
      int i_c = sid[0], pt_n = sprev[0];
      float q_c = sq[0], y_c = sy[0], act_c = sact[0];
      float a_c = pt_n < 0 ? sa[0]
                           : (pt_n == t0 - 1 ? a_last : arun[pt_n & stm]);
      // unrolled by two, so that the copies of the next row's words and
      // scalars become register renames, as in B3's consumer
#pragma unroll 2
      for (int r = 0; r < rows; ++r) {
        const int t = t0 + r;
        int i_n = 0;
        float q_n = 1.0f, y_n = 1.0f, act_n = 1.0f, a_pre = 0.0f;
        pt_n = -1;
        if (r + 1 < rows) {
          xr = xs + (long long)(r + 1) * dw + soff[r + 1] + lane;
#pragma unroll
          for (int u = 0; u < W; ++u)
            xn[u] = lane + 32 * u < d ? xr[32 * u] : 0.0f;
          i_n = sid[r + 1];
          pt_n = sprev[r + 1];
          q_n = sq[r + 1];
          y_n = sy[r + 1];
          act_n = sact[r + 1];
          a_pre = pt_n >= 0 && pt_n != t ? arun[pt_n & stm] : sa[r + 1];
        }
        a_last = stream_update<W, true>(Lk, lane, alpha + i_c, a_c, q_c, x,
                                        wr, y_c, act_c);
        if (lane == 0) arun[t & stm] = a_last;
        __syncwarp();
#pragma unroll
        for (int u = 0; u < W; ++u) x[u] = xn[u];
        i_c = i_n;
        q_c = q_n;
        y_c = y_n;
        act_c = act_n;
        a_c = pt_n == t ? a_last : a_pre;
      }
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

// The most consumer warps of the split kernel (w split over them).
#define SPLIT_MAX_WARPS 16

// The sum of p[O .. O + N) as a fixed tree of halves, straight-line code
// on a register array (a loop over the levels can leave p in local
// memory).
template <int N, int O = 0>
struct TreeSum {
  static __device__ __forceinline__ float of(const float* p) {
    return TreeSum<N / 2, O>::of(p) + TreeSum<N / 2, O + N / 2>::of(p);
  }
};
template <int O>
struct TreeSum<1, O> {
  static __device__ __forceinline__ float of(const float* p) { return p[O]; }
};

// Shared memory of the split kernel: S "full" and S "empty" mbarriers,
// S stages (B2 stream's: T rows in windows, then their id, previous
// occurrence, window offset, α, q, y and act), each consumer warp's
// running α of the last S·T positions (padded to 16 bytes), and two slots
// of SPLIT_MAX_WARPS partial dots (those past C stay 0), read as float4.
__host__ __device__ inline long long dense_split_bytes(int T, int S, int d,
                                                       int C) {
  return 16LL * S + 4LL * S * dense_stream_stage_words(T, d) +
         4LL * ((C * S * T + 3) / 4 * 4) + 8LL * SPLIT_MAX_WARPS;
}

// B2's and B3's split kernel (the note at the top).  C consumer warps
// (warps 0..C-1) and a producer (warp C); idx null is B3's in-order epoch
// over rows 0..m-1 (one CTA, no labels, no mask).  X holds n_x rows; S·T
// is a power of two, S at most RING_MAX_STAGES, T at most 32.
template <int K, int W>
__global__ void __launch_bounds__(32 * (SPLIT_MAX_WARPS + 1))
    dcd_dense_split_kernel(const int* __restrict__ idx, int m,
                           long long n_loc, const float* __restrict__ X,
                           long long n_x, int d, float* alpha,
                           const float* __restrict__ q,
                           const float* __restrict__ act,
                           const float* __restrict__ y, float* w, DcdLoss L,
                           long long idx_ts, long long row_ts,
                           long long act_ts, int T, int S, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* empty = full + S;
  float* ring = reinterpret_cast<float*>(empty + S);
  const long long sw = dense_stream_stage_words(T, d);
  const int stm = S * T - 1;
  float* arun_all = ring + S * sw;  // warp c's at c·S·T + (t & stm)
  // slot t & 1 of the partial dots, warp c's at (t & 1)·16 + c
  float* part = arun_all + (C * (stm + 1) + 3) / 4 * 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int dw = row_slot(d);
  // data shard blockIdx.x of task blockIdx.y: its ids, its rows, its α, y
  // and act, its replica of w
  const long long task = blockIdx.y;
  const long long row0 = (long long)blockIdx.x * n_loc;
  if (idx) idx += task * idx_ts + (long long)blockIdx.x * m;
  alpha += task * row_ts;
  if (y) y += task * row_ts;
  if (act) act += task * act_ts;
  w += (task * gridDim.x + blockIdx.x) * (long long)d;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      // the producer's lanes, twice each (a row's window, its cp.async)
      mbar_init(full + s, 64);
      mbar_init(empty + s, C);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x < 2 * SPLIT_MAX_WARPS) part[threadIdx.x] = 0.0f;
  __syncthreads();
  const int n_st = (m + T - 1) / T;
  const long long rd = (long long)T * dw;

  if (warp == C) {
    dense_stream_produce(idx, m, row0, X, n_x, d, alpha, q, act, y, ring, sw,
                         full, empty, T, S, lane);
  } else if (warp < C) {
    // consumer warp c = warp: its slice of w in registers
    const DcdLoss Lk{K, L.C, L.inv_two_c, L.eps_c, L.newton_steps};
    const int j0 = warp * 32 * W + lane;  // this lane's words j0 + 32u
    float* arun = arun_all + warp * (stm + 1);
    float wr[W], x[W], xn[W];
#pragma unroll
    for (int u = 0; u < W; ++u) {
      const int j = j0 + 32 * u;
      wr[u] = j < d ? w[j] : 0.0f;
      xn[u] = 0.0f;
    }
    float a_last = 0.0f;
    for (int kk = 0, s = 0, ph = 0; kk < n_st; ++kk) {
      mbar_wait(full + s, ph);
      const float* xs = ring + s * sw;
      const int* sid = reinterpret_cast<const int*>(xs + rd);
      const int* sprev = sid + T;
      const int* soff = sprev + T;
      const float* sa = reinterpret_cast<const float*>(soff + T);
      const float* sq = sa + T;
      const float* sy = sq + T;
      const float* sact = sy + T;
      const int t0 = kk * T, rows = min(T, m - t0);
      const float* xr = xs + soff[0] + j0;
#pragma unroll
      for (int u = 0; u < W; ++u) x[u] = j0 + 32 * u < d ? xr[32 * u] : 0.0f;
      int i_c = sid[0], pt_n = sprev[0];
      float q_c = sq[0], y_c = sy[0], act_c = sact[0];
      float a_c =
          pt_n < 0 ? sa[0] : (pt_n == t0 - 1 ? a_last : arun[pt_n & stm]);
      for (int r = 0; r < rows; ++r) {
        const int t = t0 + r;
        int i_n = 0;
        float q_n = 1.0f, y_n = 1.0f, act_n = 1.0f, a_pre = 0.0f;
        pt_n = -1;
        if (r + 1 < rows) {
          xr = xs + (long long)(r + 1) * dw + soff[r + 1] + j0;
#pragma unroll
          for (int u = 0; u < W; ++u)
            xn[u] = j0 + 32 * u < d ? xr[32 * u] : 0.0f;
          i_n = sid[r + 1];
          pt_n = sprev[r + 1];
          q_n = sq[r + 1];
          y_n = sy[r + 1];
          act_n = sact[r + 1];
          a_pre = pt_n >= 0 && pt_n != t ? arun[pt_n & stm] : sa[r + 1];
        }
        // 1. the warp's partial dot: a tree over its words, the butterfly
        float p[W];
#pragma unroll
        for (int u = 0; u < W; ++u) p[u] = wr[u] * x[u];
        float pw = TreeSum<W>::of(p);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          pw += __shfl_xor_sync(0xffffffffu, pw, o);
        // 2.–4. the C partials through shared memory, one named barrier,
        // the same fixed tree in every warp
        float* slot = part + (t & 1) * SPLIT_MAX_WARPS;
        if (lane == 0) slot[warp] = pw;
        asm volatile("bar.sync 1, %0;\n" ::"r"(32 * C) : "memory");
        float v[SPLIT_MAX_WARPS];
#pragma unroll
        for (int c = 0; c < SPLIT_MAX_WARPS; c += 4) {
          const float4 f = *reinterpret_cast<const float4*>(slot + c);
          v[c] = f.x;
          v[c + 1] = f.y;
          v[c + 2] = f.z;
          v[c + 3] = f.w;
        }
        const float dot = TreeSum<SPLIT_MAX_WARPS>::of(v);
        // 5. δ, α, the axpy
        float dl = dcd_delta(Lk, a_c, y_c * dot, q_c);
        if (!(act_c > 0.0f)) dl = 0.0f;
        a_last = a_c + dl;
        if (lane == 0) {
          arun[t & stm] = a_last;
          if (warp == 0) alpha[i_c] = a_last;
        }
        __syncwarp();
        const float sc = dl * y_c;
        if (sc != 0.0f) {
#pragma unroll
          for (int u = 0; u < W; ++u) wr[u] = wr[u] + sc * x[u];
        }
#pragma unroll
        for (int u = 0; u < W; ++u) x[u] = xn[u];
        i_c = i_n;
        q_c = q_n;
        y_c = y_n;
        act_c = act_n;
        a_c = pt_n == t ? a_last : a_pre;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);  // the producer may refill it
      if (++s == S) {
        s = 0;
        ph ^= 1;
      }
    }
#pragma unroll
    for (int u = 0; u < W; ++u) {
      const int j = j0 + 32 * u;
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
                               long long w_ts, int pod_shards,
                               cudaStream_t st) {
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
      row_ts, act_ts, w_ts, pod_shards);
  return (int)cudaGetLastError();
}

extern "C" int dcd_block_staged_launch(
    const int* idx, int m, int shards, long long n_loc, const float* X,
    int d, float* alpha, const float* q, const float* act, const float* y,
    float* w, long long w_stride, float* dw, int kind, float C,
    float inv_two_c, float eps_c, int newton_steps, int per_lane,
    int threads, int smem_bytes, int tasks, long long idx_ts,
    long long row_ts, long long act_ts, long long w_ts, int pod_shards,
    void* stream) {
  // the bytes the kernel carves (repro_torch/dist/mesh.py:
  // dcd_dense_staged_bytes): the block's rows, eight m-word arrays.  More
  // than one (shard, task) pair writes Δw slices, never w in place.
  const long long need = 4LL * m * d + 32LL * m;
  if (m < 1 || d < 1 || d > 32 * per_lane || threads < 32 ||
      threads % 32 != 0 || threads > 1024 || smem_bytes < need ||
      shards < 1 || shards > 65535 || tasks < 1 || tasks > 65535 ||
      ((shards > 1 || tasks > 1) && !dw) || pod_shards < 1 ||
      shards % pod_shards != 0)
    return (int)cudaErrorInvalidValue;
  const DcdLoss L{kind, C, inv_two_c, eps_c, newton_steps};
  cudaStream_t st = (cudaStream_t)stream;
#define B2_LAUNCH(W)                                                       \
  return dense_staged_launch<W>(idx, m, shards, n_loc, X, d, alpha, q, act, \
                                y, w, w_stride, dw, L, threads, smem_bytes, \
                                tasks, idx_ts, row_ts, act_ts, w_ts,      \
                                pod_shards, st)
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

template <int K, int W>
static int dense_stream_launch(const int* idx, int m, int shards,
                               long long n_loc, const float* X,
                               long long n_x, int d,
                               float* alpha, const float* q, const float* act,
                               const float* y, float* w, const DcdLoss& L,
                               int T, int S, int smem_bytes, int tasks,
                               long long idx_ts, long long row_ts,
                               long long act_ts, cudaStream_t st) {
  static int smem_set = 0;  // the limit raised so far (this process)
  if (smem_bytes > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dcd_dense_stream_kernel<K, W>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem_bytes;
  }
  dcd_dense_stream_kernel<K, W><<<dim3(shards, tasks), 64, smem_bytes, st>>>(
      idx, m, n_loc, X, n_x, d, alpha, q, act, y, w, L, idx_ts, row_ts,
      act_ts, T, S);
  return (int)cudaGetLastError();
}

template <int K>
static int dense_stream_per_lane(const int* idx, int m, int shards,
                                 long long n_loc, const float* X,
                                 long long n_x, int d,
                                 float* alpha, const float* q,
                                 const float* act, const float* y, float* w,
                                 const DcdLoss& L, int per_lane, int T,
                                 int S, int smem_bytes, int tasks,
                                 long long idx_ts, long long row_ts,
                                 long long act_ts, cudaStream_t st) {
#define B2_STREAM(W)                                                       \
  return dense_stream_launch<K, W>(idx, m, shards, n_loc, X, n_x, d, alpha, \
                                   q, act, y, w, L, T, S, smem_bytes, tasks, \
                                   idx_ts, row_ts, act_ts, st)
  switch (per_lane) {
    case 1: B2_STREAM(1);
    case 2: B2_STREAM(2);
    case 4: B2_STREAM(4);
    case 8: B2_STREAM(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef B2_STREAM
}

template <int K, int W>
static int dense_split_launch(const int* idx, int m, int shards,
                              long long n_loc, const float* X, long long n_x,
                              int d, float* alpha, const float* q,
                              const float* act, const float* y, float* w,
                              const DcdLoss& L, int warps, int T, int S,
                              int smem_bytes, int tasks, long long idx_ts,
                              long long row_ts, long long act_ts,
                              cudaStream_t st) {
  static int smem_set = 0;  // the limit raised so far (this process)
  if (smem_bytes > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dcd_dense_split_kernel<K, W>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem_bytes;
  }
  dcd_dense_split_kernel<K, W>
      <<<dim3(shards, tasks), 32 * (warps + 1), smem_bytes, st>>>(
          idx, m, n_loc, X, n_x, d, alpha, q, act, y, w, L, idx_ts, row_ts,
          act_ts, T, S, warps);
  return (int)cudaGetLastError();
}

// B2 and B3 over rows of more than 256 floats.  idx null is B3's in-order
// epoch over rows 0..m-1: one CTA, no labels, no mask.
extern "C" int dcd_block_split_launch(
    const int* idx, int m, int shards, long long n_loc, const float* X,
    long long n_x, int d, float* alpha, const float* q, const float* act,
    const float* y, float* w, int kind, float C, float inv_two_c, float eps_c,
    int newton_steps, int per_lane, int warps, int tile_rows, int stages,
    int smem_bytes, int tasks, long long idx_ts, long long row_ts,
    long long act_ts, void* stream) {
  // the bytes the kernel carves (repro_torch/dist/mesh.py:
  // dcd_dense_split_bytes)
  const long long S = stages, T = tile_rows;
  if (m < 1 || d < 1 || warps < 1 || warps > SPLIT_MAX_WARPS ||
      d > 32LL * per_lane * warps || T < 1 || T > 32 || S < 2 ||
      S > RING_MAX_STAGES || ((S * T) & (S * T - 1)) != 0 ||
      smem_bytes < dense_split_bytes(tile_rows, stages, d, warps) ||
      shards < 1 || shards > 65535 || tasks < 1 || tasks > 65535 ||
      (!idx && (shards > 1 || tasks > 1 || act || y)))
    return (int)cudaErrorInvalidValue;
  const DcdLoss L{kind, C, inv_two_c, eps_c, newton_steps};
  cudaStream_t st = (cudaStream_t)stream;
#define B2_SPLIT(K, W)                                                      \
  return dense_split_launch<K, W>(idx, m, shards, n_loc, X, n_x, d, alpha,  \
                                  q, act, y, w, L, warps, tile_rows, stages, \
                                  smem_bytes, tasks, idx_ts, row_ts, act_ts, \
                                  st)
#define B2_SPLIT_LOSS(K)      \
  switch (per_lane) {         \
    case 8: B2_SPLIT(K, 8);   \
    case 16: B2_SPLIT(K, 16); \
    default: break;           \
  }                           \
  break
  switch (kind) {  // the loss is a template: no dispatch on the chain
    case DCD_HINGE: B2_SPLIT_LOSS(DCD_HINGE);
    case DCD_SQUARED_HINGE: B2_SPLIT_LOSS(DCD_SQUARED_HINGE);
    case DCD_LOGISTIC: B2_SPLIT_LOSS(DCD_LOGISTIC);
    default: break;
  }
#undef B2_SPLIT_LOSS
#undef B2_SPLIT
  return (int)cudaErrorInvalidValue;
}

extern "C" int dcd_block_stream_launch(
    const int* idx, int m, int shards, long long n_loc, const float* X,
    long long n_x, int d, float* alpha, const float* q, const float* act,
    const float* y, float* w, int kind, float C, float inv_two_c, float eps_c,
    int newton_steps, int per_lane, int tile_rows, int stages,
    int smem_bytes, int tasks, long long idx_ts, long long row_ts,
    long long act_ts, void* stream) {
  // the bytes the kernel carves (repro_torch/dist/mesh.py:
  // dcd_dense_stream_bytes): two mbarriers a stage, the stages (each row
  // in a 16-byte-aligned window), and the running α of S·T positions
  const long long S = stages, T = tile_rows;
  const long long need = 16 * S +
                         4 * S * dense_stream_stage_words(tile_rows, d) +
                         4 * S * T;
  if (m < 1 || d < 1 || d > 32 * per_lane || T < 1 || T > 32 || S < 2 ||
      S > RING_MAX_STAGES || ((S * T) & (S * T - 1)) != 0 ||
      smem_bytes < need || shards < 1 || shards > 65535 || tasks < 1 ||
      tasks > 65535)
    return (int)cudaErrorInvalidValue;
  const DcdLoss L{kind, C, inv_two_c, eps_c, newton_steps};
  cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {  // the loss is a template: no dispatch on the chain
    case DCD_HINGE:
      return dense_stream_per_lane<DCD_HINGE>(
          idx, m, shards, n_loc, X, n_x, d, alpha, q, act, y, w, L, per_lane,
          tile_rows, stages, smem_bytes, tasks, idx_ts, row_ts, act_ts, st);
    case DCD_SQUARED_HINGE:
      return dense_stream_per_lane<DCD_SQUARED_HINGE>(
          idx, m, shards, n_loc, X, n_x, d, alpha, q, act, y, w, L, per_lane,
          tile_rows, stages, smem_bytes, tasks, idx_ts, row_ts, act_ts, st);
    case DCD_LOGISTIC:
      return dense_stream_per_lane<DCD_LOGISTIC>(
          idx, m, shards, n_loc, X, n_x, d, alpha, q, act, y, w, L, per_lane,
          tile_rows, stages, smem_bytes, tasks, idx_ts, row_ts, act_ts, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
