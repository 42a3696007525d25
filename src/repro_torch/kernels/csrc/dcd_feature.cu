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
// B4 replaces the Pallas TPU kernel repro/kernels/dcd_feature.py
// (_gram_kernel, reached through dcd_feature_gram_pallas_call): every
// shard's partial base (m, B) and Gram (m, B, B); the caller sums them over
// shards (the reference's psum over "model").  The TPU kernel scatters row
// t into a d1-word VMEM scratch and gathers every row against it; d1
// (4.15M words for webspam at m = 4) is far beyond shared memory, and a
// scratch in device memory makes every gather a scattered HBM sector.  So
// B4 splits each shard's columns into R classes (column c → class c mod R,
// local column c div R, so the zipf-hot low ids spread over all classes),
// sized by repro_torch/dist/mesh.py: gram_plan, in three kernels of one
// launch:
//   dcd_feature_bucket_kernel, grid (m, B): row t of shard j stages its k
//     slots in shared memory (batches of independent loads) and reads each
//     real entry once: base_t = Σ w·v (a fixed reduction tree), and a
//     stable counting sort of the real entries by class (per-warp counts,
//     a scan, ranks from __match_any_sync) into the workspace, with each
//     class's offset in the row.  Within a class, a row's entries keep
//     their slot order.
//   dcd_feature_gram_kernel, grid (R, m, tiles): CTA (r, j) stages class r
//     of shard j (every row's segment, in chunks of at most `chunk`
//     entries) in shared memory, counts each local column's entries in an
//     open-addressing table, and sorts the chunk into one contiguous run
//     per column (a scan over the table, then a place).  The walker
//     threads of column t of G then take row t's entries of the class in
//     slot order and walk each entry's run: G[s, t] += v_t·v_s.  The work
//     is Σ L² over the runs' lengths L, not B·k; a run's entries are
//     contiguous, so a walk issues independent loads.  Each walker owns
//     its cells of G in shared memory (two interleaved walkers per column,
//     summed in order at the end), so no cell is added to by two threads;
//     the order inside a run (the race of its placement) only orders adds
//     into different cells, unless row s repeats a column.
//   dcd_feature_gram_reduce_kernel: G = Σ_r partial_r in class order
//     (skipped when there is one class).
// The CTAs of a shard's classes are adjacent in the grid, so the widest
// shard's (shard 0 holds 87% of webspam's entries) start first.  Padding
// lanes (id d_loc, or any id outside [0, d_loc)) are skipped.  Two launches
// give the same bits unless a row repeats a column.  What bounds it: the
// widest shard's CTAs, each a chain of staging, table and walk phases
// separated by barriers, latency-bound at 8 warps an SM; in bytes, the
// block's rows are read once and the bucketed entries about twice.
//
// B5, dcd_feature_update_kernel, replaces repro/kernels/dcd_feature.py
// (_update_kernel, reached through dcd_feature_update_pallas_call): the
// B-step δ recursion against the summed (base, G), the α update, and the
// scatter of δ̃_t·vals_t into this shard's slice only.  It runs on a grid
// of R × m CTAs, R being B4's column classes: CTA (r, j) owns the columns
// of class r in shard j, so no two CTAs touch one word of w.
//   1. Prologue, all threads: the block's ids and base, each row's class-r
//      segment bounds from B4's roff, and G by cp.async when it fits
//      (repro_torch/dist/mesh.py: feature_update_plan; 16 KB at B = 64)
//      issue together; then each id's seed α, q, y and act are gathered in
//      parallel (one latency, not B), and each id's previous and last
//      occurrence in the block found from the ids in shared memory.
//   2. The recursion, on warp 0, right-looking: lane l holds accumulators
//      acc[u] = Σ_{s<t} δ̃_s·G[s, u] for its columns u = l + 32c.  At step
//      t the lane that owns t gives acc[t] to every lane with one shuffle;
//      every lane takes δ (dcd_delta, the running α of a repeated id from
//      prev[]) and adds δ̃_t·G[t, u].  G's row t and the step's scalars
//      load a step ahead (G from shared memory, or from device memory past
//      the staging limit).  Row t of G is the reference's cell G[s = t, u]:
//      no symmetry is assumed.  No reduction and no global load is on the
//      chain.  Every CTA runs the same recursion on the same inputs (a
//      single recursion kernel ahead of the scatter measured slower),
//      while its other warps stage the class's entries from B4's buckets
//      (bk_lc, bk_v: each row's real entries grouped by class, in slot
//      order) in shared memory, with an L2 prefetch of each entry's word
//      of w.
//   3. The scatter, on warp 0: the staged entries in row order, column
//      lc·R + r += δ̃_t·v (atomicAdd, so the adds issue without waiting; a
//      __syncwarp between rows keeps the reference's per-row order, and
//      no other CTA touches the column).  CTA (0, 0) alone writes α, each
//      id's at its last update in the block.
// Called without B4's workspace, the C entry runs B4's bucket pass first
// (without its base) into a workspace of the wrapper's: the same buckets,
// so the same bits.  Two launches give the same bits unless a row repeats
// a column (two atomic adds into one word within a row, in no fixed
// order), the case B4 also excludes.  What bounds it: the wrapper's copy
// of w (m·d1 words in and out) in bytes; in the kernel, the recursion's
// chain of B shuffles and δs, then the widest shard's CTAs issuing their
// scattered adds (1,000–2,000 a CTA at webspam).
//
// Data shards.  The reference's 2-D mesh is (data, model): each of p data
// shards runs its own block against its own view of the feature-sharded
// w.  Here shard s of a launch takes ids idx[s·B .. s·B + B) of its rows
// [s·n_loc, (s+1)·n_loc) (row s·n_loc + id).  B4's bucket pass runs on a
// grid (m, B, p) and reads w + s·w_stride (w_stride 0: one w for every
// data shard); its Gram and reduce kernels, and B5, index the p·m
// (data, model) pairs as one grid dimension, js = s·m + j, whose
// workspace rows, partial Grams and outputs are js's own: the workspace,
// base_p (p·m, B) and gram_p (p·m, B, B) are per data shard.  B5 runs
// R × p·m CTAs; CTA (r, js) reads its data shard's summed (base, G) at
// base + s·B and gram + s·B², and scatters into w + js·d1, its data
// shard's own replica of the (m, d1) slices (the wrapper fills the
// replicas and takes each shard's Δw = replica − w).  No CTA reads what
// another data shard writes, so the result does not depend on which CTAs
// run together.
//
// Tasks.  The multi-task (one-vs-rest) solver's K binary problems on one
// unfolded X (the reference vmaps the round over a leading task axis) join
// the data shards: pair z = k·p + s is data shard s of task k, and the
// (task, data, model) triples are js = z·m + j.  B4's bucket grid is
// (m, B, K·p); pair z reads its ids at idx + k·idx_ts + s·B (idx_ts 0:
// every task draws the same block) and its view of w at w + k·w_ts +
// s·w_stride, and writes its own workspace rows, base and partial Grams:
// G is computed for every task, as the reference's vmapped kernel does,
// though it depends on the ids alone.  B5 runs R × K·p·m CTAs; CTA
// (r, js) reads task k's α, y and act at + k·row_ts, + k·row_ts and
// + k·act_ts (act_ts 0: one mask for every task), pair z's (base, G), and
// scatters into w + js·d1, the pair's own replica of the slices.  No CTA's
// arithmetic changes with the task dimension: K = 1 gives the bits of the
// task-free grid.
//
// Pods.  The pod solver's P pods of p data shards join the data shards:
// data = P·p, data shard s is shard s mod p of pod s / p, and pod k's
// shards read pod k's own w — B4's bucket pass at w + k·w_ts +
// (s / pod_shards)·w_stride, pod_shards = p (1: a w a data shard).  B5
// scatters into its pair's own replica, which the wrapper fills from its
// pod's w.  The (task, pod·data, model) triples stay one grid dimension;
// P = 1 gives the bits of the pod-free grid.
//
// Blocks past 1,024 ids (the shim's one block of B = n rows; repro_torch/
// dist/mesh.py: GRAM_SHARED_MAX_IDS) take the "rows" layout: one column
// class; B4's bucket pass as above (its rows stepping over a grid of at most
// 65,535 in y), then dcd_feature_gram_rows_kernel, G in tiles of 64 columns
// straight to device memory; B5 as dcd_feature_recursion_panel_kernel (a
// cluster of CTAs a pair, a blocked recursion in panels of 32 steps, δ̃
// to device memory; the note before it) and
// dcd_feature_scatter_rows_kernel.  Below it every launch keeps the layout
// above and its bits.
//
// Both build with --fmad=false, as B1–B3, so δ̃·v and the adds round as
// the plain version's do.

#include "dcd_delta.cuh"
#include "dcd_stage.cuh"

#define DCD_FEATURE_MAX_B 1024  // the shared layout's ids a block

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

// The CTA's exclusive prefix sum of one int per thread (in thread order);
// `tmp` is DCD_MAX_WARPS ints of shared memory, *total gets the sum.
// Every thread must call it.
__device__ __forceinline__ int block_excl_scan(int v, int* tmp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nw ? tmp[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nw) tmp[lane] = s;
  }
  __syncthreads();
  const int excl = x - v + (warp > 0 ? tmp[warp - 1] : 0);
  *total = tmp[nw - 1];
  __syncthreads();
  return excl;
}

__device__ __forceinline__ unsigned gram_hash(int c, int slots) {
  unsigned h = (unsigned)c * 0x9E3779B1u;
  return (h ^ (h >> 16)) & (unsigned)(slots - 1);
}

// Row (j, t) of the workspace: bk_lc / bk_v hold k slots, roff R + 1
// offsets (class r's entries are [roff[r], roff[r + 1])).  base_p may be
// null (B5's own bucket pass): then w is not read.  The row's k
// slots are staged in shared memory, loaded GRAM_LANE_BATCH a lane at a
// time so that the loads, and the gathers of w behind them, overlap.
#define GRAM_LANE_BATCH 8
__device__ __forceinline__ void bucket_row(
    const int* __restrict__ idx, int B, long long n_loc,
    const int* __restrict__ cols, const float* __restrict__ vals, int m,
    int k, int d_loc, const float* __restrict__ w, long long w_stride,
    int d1, int R, int* __restrict__ bk_lc, float* __restrict__ bk_v,
    int* __restrict__ roff, float* __restrict__ base_p, int data,
    long long idx_ts, long long w_ts, int pod_shards, int j, int t, int z,
    int* cur, float* red, int* tmp) {
  const int sd = z % data;
  const long long task = z / data;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  int* sc = cur + nw * R;  // the row's k column ids
  float* sv = reinterpret_cast<float*>(sc + k);
  const long long gid =
      sd * n_loc + idx[task * idx_ts + (long long)sd * B + t];
  const long long rt = (gid * m + j) * k;
  const int* ct = cols + rt;
  const float* vt = vals + rt;
  const float* wj =
      w + task * w_ts + (sd / pod_shards) * w_stride + (long long)j * d1;
  const long long row = ((long long)z * m + j) * B + t;
  for (int i = tid; i < nw * R; i += blockDim.x) cur[i] = 0;
  __syncthreads();
  // each warp owns a contiguous run of slots, so warp order is slot order
  const int per = ((k + nw - 1) / nw + 31) & ~31;
  const int e0 = min(k, warp * per), e1 = min(k, e0 + per);
  float part = 0.0f;
  for (int b0 = e0; b0 < e1; b0 += 32 * GRAM_LANE_BATCH) {
    int c[GRAM_LANE_BATCH];
    float v[GRAM_LANE_BATCH], wv[GRAM_LANE_BATCH];
#pragma unroll
    for (int u = 0; u < GRAM_LANE_BATCH; ++u) {
      const int e = b0 + lane + 32 * u;
      c[u] = e < e1 ? ct[e] : -1;
      v[u] = e < e1 ? vt[e] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < GRAM_LANE_BATCH; ++u)
      wv[u] = base_p && (unsigned)c[u] < (unsigned)d_loc ? wj[c[u]] : 0.0f;
#pragma unroll
    for (int u = 0; u < GRAM_LANE_BATCH; ++u) {
      const int e = b0 + lane + 32 * u;
      if (e < e1) {
        sc[e] = c[u];
        sv[e] = v[u];
      }
      if ((unsigned)c[u] < (unsigned)d_loc) {
        part += wv[u] * v[u];
        atomicAdd(cur + warp * R + c[u] % R, 1);
      }
    }
  }
  const float base = block_sum(part, red);
  if (tid == 0 && base_p) base_p[row] = base;
  const int per_r = (R + blockDim.x - 1) / blockDim.x;
  const int r0 = min(R, tid * per_r), r1 = min(R, r0 + per_r);
  int tot = 0;
  for (int r = r0; r < r1; ++r)
    for (int u = 0; u < nw; ++u) tot += cur[u * R + r];
  int total;
  int run = block_excl_scan(tot, tmp, &total);
  int* ro = roff + row * (R + 1);
  for (int r = r0; r < r1; ++r) {
    ro[r] = run;
    for (int u = 0; u < nw; ++u) {
      const int n = cur[u * R + r];
      cur[u * R + r] = run;
      run += n;
    }
  }
  if (tid == 0) ro[R] = total;
  __syncthreads();
  int* olc = bk_lc + row * k;
  float* ov = bk_v + row * k;
  for (int eb = e0; eb < e1; eb += 32) {
    const int e = eb + lane;
    const int c = e < e1 ? sc[e] : -1;
    const bool real = (unsigned)c < (unsigned)d_loc;
    const int r = real ? c % R : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, r);
    if (real) {
      const int pos = cur[warp * R + r] + __popc(peers & ((1u << lane) - 1u));
      olc[pos] = c / R;
      ov[pos] = sv[e];
    }
    __syncwarp();
    if (real && lane == 31 - __clz(peers))
      cur[warp * R + r] += __popc(peers);
    __syncwarp();
  }
}

__global__ void dcd_feature_bucket_kernel(
    const int* __restrict__ idx, int B, long long n_loc,
    const int* __restrict__ cols, const float* __restrict__ vals, int m,
    int k, int d_loc, const float* __restrict__ w, long long w_stride,
    int d1, int R, int* __restrict__ bk_lc, float* __restrict__ bk_v,
    int* __restrict__ roff, float* __restrict__ base_p, int data,
    long long idx_ts, long long w_ts, int pod_shards) {
  extern __shared__ __align__(16) int cur[];  // [warps][R]: counts, cursors
  __shared__ float red[DCD_MAX_WARPS];
  __shared__ int tmp[DCD_MAX_WARPS];
  // pair z = blockIdx.z: data shard sd of task `task`; the rows t step by
  // gridDim.y, which holds at most 65,535 (one row a CTA up to there)
  for (int t = blockIdx.y; t < B; t += gridDim.y) {
    bucket_row(idx, B, n_loc, cols, vals, m, k, d_loc, w, w_stride, d1, R,
               bk_lc, bk_v, roff, base_p, data, idx_ts, w_ts, pod_shards,
               blockIdx.x, t, blockIdx.z, cur, red, tmp);
    __syncthreads();  // the row's cursors are read before the next zeroes
  }
}


// G[s, t] += v·v_s over the run [i, end) of one column (rows s_row, values
// s_v); Gp points at column t of the caller's accumulator (row stride
// `tile`).  Four entries at a time: their rows are distinct unless a row
// repeats the column, and then they go one by one.
__device__ __forceinline__ void gram_run(float* Gp, int tile,
                                         const int* s_row, const float* s_v,
                                         int i, int end, float v) {
  for (; i + 4 <= end; i += 4) {
    const int r0 = s_row[i], r1 = s_row[i + 1], r2 = s_row[i + 2],
              r3 = s_row[i + 3];
    const float v0 = s_v[i], v1 = s_v[i + 1], v2 = s_v[i + 2],
                v3 = s_v[i + 3];
    if (r0 != r1 && r0 != r2 && r0 != r3 && r1 != r2 && r1 != r3 &&
        r2 != r3) {
      const float g0 = Gp[r0 * tile], g1 = Gp[r1 * tile], g2 = Gp[r2 * tile],
                  g3 = Gp[r3 * tile];
      Gp[r0 * tile] = g0 + v * v0;
      Gp[r1 * tile] = g1 + v * v1;
      Gp[r2 * tile] = g2 + v * v2;
      Gp[r3 * tile] = g3 + v * v3;
    } else {
      Gp[r0 * tile] = Gp[r0 * tile] + v * v0;
      Gp[r1 * tile] = Gp[r1 * tile] + v * v1;
      Gp[r2 * tile] = Gp[r2 * tile] + v * v2;
      Gp[r3 * tile] = Gp[r3 * tile] + v * v3;
    }
  }
  for (; i < end; ++i) Gp[s_row[i] * tile] = Gp[s_row[i] * tile] + v * s_v[i];
}

// Class r of shard j: its partial Gram, for the columns t of tile
// blockIdx.z; blockDim is 64 × walkers.  Shared memory: a table of `slots`
// local columns (key, entry count, end of its run), `chunk` staged
// entries (local column, row, value, table slot) and the same entries
// sorted into column runs (row, value), the rows' segment offsets and
// starts, and each walker's (B, tile) accumulator.
__global__ void dcd_feature_gram_kernel(int B, int k, int R, int tile,
                                        int chunk, int slots,
                                        const int* __restrict__ bk_lc,
                                        const float* __restrict__ bk_v,
                                        const int* __restrict__ roff,
                                        float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* key = reinterpret_cast<int*>(smem);
  int* cnt = key + slots;
  int* runend = cnt + slots;
  int* u_lc = runend + slots;
  int* u_row = u_lc + chunk;
  float* u_v = reinterpret_cast<float*>(u_row + chunk);
  int* u_slot = reinterpret_cast<int*>(u_v + chunk);
  int* s_row = u_slot + chunk;
  float* s_v = reinterpret_cast<float*>(s_row + chunk);
  int* segoff = reinterpret_cast<int*>(s_v + chunk);  // B + 1
  int* rstart = segoff + B + 1;                       // B
  float* G = reinterpret_cast<float*>(rstart + B);
  __shared__ int tmp[DCD_MAX_WARPS];
  const int r = blockIdx.x, j = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x, walkers = nt >> 6;
  const int tl = tid & 63, p = tid >> 6;
  const int t = blockIdx.z * tile + tl;
  const bool walker = tl < tile && t < B;
  const long long row0 = (long long)j * B;
  for (int i = tid; i < slots; i += nt) {
    key[i] = -1;
    cnt[i] = 0;
  }
  for (int i = tid; i < walkers * B * tile; i += nt) G[i] = 0.0f;
  // every row's segment of class r: its start in the row, and its offset
  // in the class's entries (row order)
  const int per_s = (B + nt - 1) / nt;
  const int s0 = min(B, tid * per_s), s1 = min(B, s0 + per_s);
  int len = 0;
  for (int s = s0; s < s1; ++s) {
    const int* ro = roff + (row0 + s) * (R + 1) + r;
    const int a = ro[0], b = ro[1];
    rstart[s] = a;
    segoff[s] = b - a;
    len += b - a;
  }
  int total;
  int run = block_excl_scan(len, tmp, &total);
  for (int s = s0; s < s1; ++s) {
    const int n = segoff[s];
    segoff[s] = run;
    run += n;
  }
  if (tid == 0) segoff[B] = total;
  __syncthreads();
  int my0 = 0, my1 = 0, mys = 0;
  if (walker) {
    my0 = segoff[t];
    my1 = segoff[t + 1];
    mys = rstart[t];
  }
  const int* tlc = bk_lc + (row0 + (walker ? t : 0)) * k;
  const float* tv = bk_v + (row0 + (walker ? t : 0)) * k;
  for (int c0 = 0; c0 < total; c0 += chunk) {
    const int n = min(chunk, total - c0);
    // stage the chunk, GRAM_LANE_BATCH entries a thread at a time: find
    // each entry's row, then issue all the loads, then store
    for (int e0 = tid; e0 < n; e0 += nt * GRAM_LANE_BATCH) {
      int rw[GRAM_LANE_BATCH], lcv[GRAM_LANE_BATCH];
      long long src[GRAM_LANE_BATCH];
      float vv[GRAM_LANE_BATCH];
#pragma unroll
      for (int u = 0; u < GRAM_LANE_BATCH; ++u) {
        const int q = c0 + e0 + u * nt;
        rw[u] = -1;
        src[u] = 0;
        if (e0 + u * nt < n) {
          int lo = 0, hi = B - 1;  // the row whose segment holds entry q
          while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (segoff[mid] <= q)
              lo = mid;
            else
              hi = mid - 1;
          }
          rw[u] = lo;
          src[u] = (row0 + lo) * k + rstart[lo] + (q - segoff[lo]);
        }
      }
#pragma unroll
      for (int u = 0; u < GRAM_LANE_BATCH; ++u) {
        lcv[u] = rw[u] >= 0 ? bk_lc[src[u]] : 0;
        vv[u] = rw[u] >= 0 ? bk_v[src[u]] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < GRAM_LANE_BATCH; ++u) {
        if (rw[u] >= 0) {
          const int e = e0 + u * nt;
          u_lc[e] = lcv[u];
          u_v[e] = vv[u];
          u_row[e] = rw[u];
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < n; e += nt) {
      const int lc = u_lc[e];
      unsigned h = gram_hash(lc, slots);
      for (;;) {
        const int got = atomicCAS(key + h, -1, lc);
        if (got == -1 || got == lc) break;
        h = (h + 1) & (unsigned)(slots - 1);
      }
      u_slot[e] = (int)h;
      atomicAdd(cnt + h, 1);
    }
    __syncthreads();
    // runs: an exclusive scan of the counts over the table
    const int per_h = (slots + nt - 1) / nt;
    const int h0 = min(slots, tid * per_h), h1 = min(slots, h0 + per_h);
    int hs = 0;
    for (int h = h0; h < h1; ++h) hs += cnt[h];
    int tot2;
    int at = block_excl_scan(hs, tmp, &tot2);
    for (int h = h0; h < h1; ++h) {
      runend[h] = at;
      at += cnt[h];
    }
    __syncthreads();
    for (int e = tid; e < n; e += nt) {
      const int pos = atomicAdd(runend + u_slot[e], 1);
      s_row[pos] = u_row[e];
      s_v[pos] = u_v[e];
    }
    __syncthreads();
    if (walker) {
      float* Gp = G + (long long)p * B * tile + tl;
      for (int q = my0 + p; q < my1; q += walkers) {
        const bool in = q >= c0 && q < c0 + n;
        const int lc = in ? u_lc[q - c0] : tlc[mys + q - my0];
        const float v = in ? u_v[q - c0] : tv[mys + q - my0];
        unsigned h = gram_hash(lc, slots);
        int kh = key[h];
        while (kh != -1 && kh != lc) {
          h = (h + 1) & (unsigned)(slots - 1);
          kh = key[h];
        }
        if (kh == lc)
          gram_run(Gp, tile, s_row, s_v, runend[h] - cnt[h], runend[h], v);
      }
    }
    __syncthreads();
    for (int i = tid; i < slots; i += nt) {
      key[i] = -1;
      cnt[i] = 0;
    }
    __syncthreads();
  }
  float* out = part + ((long long)j * R + r) * B * B;
  for (int i = tid; i < B * tile; i += nt) {
    const int s = i / tile, c = i - s * tile, tc = blockIdx.z * tile + c;
    if (tc < B) {
      float acc = 0.0f;
      for (int q = 0; q < walkers; ++q) acc += G[(q * B + s) * tile + c];
      out[(long long)s * B + tc] = acc;
    }
  }
}

__global__ void dcd_feature_gram_reduce_kernel(int B, int R,
                                               const float* __restrict__ part,
                                               float* __restrict__ gram_p) {
  const int j = blockIdx.y;
  const long long bb = (long long)B * B;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < bb;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = 0.0f;
    for (int r = 0; r < R; ++r)
      acc += part[((long long)j * R + r) * bb + i];
    gram_p[j * bb + i] = acc;
  }
}

// B4's rows layout (B > 1,024 ids, one column class: a row's bucketed
// entries are its real entries in slot order, roff[row] = (0, count)).
// CTA (x, y, js) computes G[s, t] of triple js for the tile of columns
// t ∈ [x·tile, x·tile + tile) and the rows s ∈ [y·nt, y·nt + nt), one row
// a thread, and writes them straight to G in device memory: the walkers'
// (B, tile) accumulators of the shared layout would not fit.  The tile
// rows' entries are staged in chunks, counted by local column in an
// open-addressing table and sorted into one run a column; each thread then
// walks its row s's entries in slot order and, for each, its column's run:
// acc[t] += v_s·v_t, into its own column of the [tile][nt] accumulators in
// shared memory (no cell is added to by two threads).  Within a run the
// order is the placement's race, which orders adds into one cell only
// where row t repeats a column, as in the shared layout.  Work Σ L² over
// the runs, and every CTA of a tile stages the tile's rows once.
__global__ void dcd_feature_gram_rows_kernel(int B, int k, int tile,
                                             int chunk, int slots,
                                             const int* __restrict__ bk_lc,
                                             const float* __restrict__ bk_v,
                                             const int* __restrict__ roff,
                                             float* __restrict__ gram_p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* key = reinterpret_cast<int*>(smem);
  int* cnt = key + slots;
  int* runend = cnt + slots;
  int* u_lc = runend + slots;
  int* u_t = u_lc + chunk;
  float* u_v = reinterpret_cast<float*>(u_t + chunk);
  int* u_slot = reinterpret_cast<int*>(u_v + chunk);
  int* s_t = u_slot + chunk;
  float* s_v = reinterpret_cast<float*>(s_t + chunk);
  int* segoff = reinterpret_cast<int*>(s_v + chunk);  // tile + 1
  float* acc = reinterpret_cast<float*>(segoff + tile + 1);  // [tile][nt]
  __shared__ int tmp[DCD_MAX_WARPS];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int t0 = blockIdx.x * tile, tn = min(tile, B - t0);
  const int s = blockIdx.y * nt + tid;
  const long long row0 = (long long)blockIdx.z * B;
  for (int i = tid; i < slots; i += nt) {
    key[i] = -1;
    cnt[i] = 0;
  }
  for (int c = 0; c < tile; ++c) acc[c * nt + tid] = 0.0f;
  if (tid == 0) {  // the tile rows' offsets in the staged entries
    int run = 0;
    for (int c = 0; c < tn; ++c) {
      segoff[c] = run;
      run += roff[(row0 + t0 + c) * 2 + 1];
    }
    segoff[tn] = run;
  }
  __syncthreads();
  const int total = segoff[tn];
  const bool mine = s < B;
  const int ns = mine ? roff[(row0 + s) * 2 + 1] : 0;
  const int* slc = bk_lc + (row0 + (mine ? s : 0)) * k;
  const float* sv = bk_v + (row0 + (mine ? s : 0)) * k;
  for (int c0 = 0; c0 < total; c0 += chunk) {
    const int n = min(chunk, total - c0);
    for (int e = tid; e < n; e += nt) {
      const int q = c0 + e;
      int lo = 0, hi = tn - 1;  // the tile row whose entries hold q
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (segoff[mid] <= q)
          lo = mid;
        else
          hi = mid - 1;
      }
      const long long src = (row0 + t0 + lo) * k + (q - segoff[lo]);
      u_lc[e] = bk_lc[src];
      u_v[e] = bk_v[src];
      u_t[e] = lo;
    }
    __syncthreads();
    for (int e = tid; e < n; e += nt) {
      const int lc = u_lc[e];
      unsigned h = gram_hash(lc, slots);
      for (;;) {
        const int got = atomicCAS(key + h, -1, lc);
        if (got == -1 || got == lc) break;
        h = (h + 1) & (unsigned)(slots - 1);
      }
      u_slot[e] = (int)h;
      atomicAdd(cnt + h, 1);
    }
    __syncthreads();
    const int per_h = (slots + nt - 1) / nt;
    const int h0 = min(slots, tid * per_h), h1 = min(slots, h0 + per_h);
    int hs = 0;
    for (int h = h0; h < h1; ++h) hs += cnt[h];
    int tot2;
    int at = block_excl_scan(hs, tmp, &tot2);
    for (int h = h0; h < h1; ++h) {
      runend[h] = at;
      at += cnt[h];
    }
    __syncthreads();
    for (int e = tid; e < n; e += nt) {
      const int pos = atomicAdd(runend + u_slot[e], 1);
      s_t[pos] = u_t[e];
      s_v[pos] = u_v[e];
    }
    __syncthreads();
    for (int e = 0; e < ns; ++e) {
      const int lc = slc[e];
      const float v = sv[e];
      unsigned h = gram_hash(lc, slots);
      int kh = key[h];
      while (kh != -1 && kh != lc) {
        h = (h + 1) & (unsigned)(slots - 1);
        kh = key[h];
      }
      if (kh == lc)
        for (int q = runend[h] - cnt[h]; q < runend[h]; ++q)
          acc[s_t[q] * nt + tid] = acc[s_t[q] * nt + tid] + v * s_v[q];
    }
    __syncthreads();
    for (int i = tid; i < slots; i += nt) {
      key[i] = -1;
      cnt[i] = 0;
    }
    __syncthreads();
  }
  if (mine) {
    float* out = gram_p + row0 * B + (long long)s * B + t0;
    for (int c = 0; c < tn; ++c) out[c] = acc[c * nt + tid];
  }
}

// B5's shared memory (repro_torch/dist/mesh.py: feature_update_bytes): G
// when staged (B² floats, first, so 16-byte copies land aligned), a chunk
// of entries (column, value), ten B-word id arrays, the rows' segment
// offsets (B + 1) and starts (B).
struct B5Smem {
  float* G;
  int* c_lc;
  float* c_v;
  int* ids;
  float *a0, *qs, *ys, *acts, *bs, *arun, *dtil;
  int *prev, *last, *segoff, *rstart;
};

__device__ __forceinline__ B5Smem b5_carve(unsigned char* smem, int B,
                                           int stage_gram, int chunk) {
  B5Smem S;
  S.G = reinterpret_cast<float*>(smem);
  S.c_lc = reinterpret_cast<int*>(S.G + (stage_gram ? (long long)B * B : 0));
  S.c_v = reinterpret_cast<float*>(S.c_lc + chunk);
  S.ids = reinterpret_cast<int*>(S.c_v + chunk);
  S.a0 = reinterpret_cast<float*>(S.ids + B);
  S.qs = S.a0 + B;
  S.ys = S.qs + B;
  S.acts = S.ys + B;
  S.bs = S.acts + B;
  S.arun = S.bs + B;  // α of idx[t] after update t
  S.dtil = S.arun + B;  // δ̃_t = δ_t·y_t
  S.prev = reinterpret_cast<int*>(S.dtil + B);  // last s < t, same id
  S.last = S.prev + B;  // no s > t has the same id
  S.segoff = S.last + B;
  S.rstart = S.segoff + B + 1;
  return S;
}

// All threads: the ids, each id's seed α, q, y, act and base, prev[] and
// last[], G when staged (cp.async, 16 bytes a copy where it can; the
// caller waits), and where each row's class-r segment of shard j starts
// in its workspace row (rstart) and in the class's entries (segoff, row
// order).  The loads that do not depend on the ids issue first.  Returns
// the class's entry count.
__device__ __forceinline__ int b5_prologue(
    const B5Smem& S, const int* __restrict__ idx, long long grow0, int B,
    int R, int r, long long row0, const int* __restrict__ roff,
    const float* __restrict__ alpha_in, const float* __restrict__ q,
    const float* __restrict__ act, const float* __restrict__ y,
    const float* __restrict__ base, const float* __restrict__ gram,
    int stage_gram, int* tmp) {
  const int tid = threadIdx.x, nt = blockDim.x;
  int e0 = 0;
  if (stage_gram &&
      (reinterpret_cast<unsigned long long>(gram) & 15ULL) == 0) {
    e0 = (B * B) & ~3;
    for (int e = 4 * tid; e < e0; e += 4 * nt) cp_async16(S.G + e, gram + e);
  }
  if (stage_gram)
    for (int e = e0 + tid; e < B * B; e += nt) cp_async4(S.G + e, gram + e);
  for (int t = tid; t < B; t += nt) {
    S.ids[t] = (int)(grow0 + idx[t]);
    S.bs[t] = base[t];
  }
  const int per = (B + nt - 1) / nt;
  const int s0 = min(B, tid * per), s1 = min(B, s0 + per);
  int len = 0;
  for (int s = s0; s < s1; ++s) {
    const int* ro = roff + (row0 + s) * (R + 1) + r;
    const int a = ro[0], b = ro[1];
    S.rstart[s] = a;
    S.segoff[s] = b - a;
    len += b - a;
  }
  int total;
  int run = block_excl_scan(len, tmp, &total);  // publishes the ids too
  for (int s = s0; s < s1; ++s) {
    const int n = S.segoff[s];
    S.segoff[s] = run;
    run += n;
  }
  if (tid == 0) S.segoff[B] = total;
  for (int t = tid; t < B; t += nt) {
    const int i = S.ids[t];
    S.a0[t] = alpha_in[i];
    S.qs[t] = q[i];
    S.ys[t] = y ? y[i] : 1.0f;
    S.acts[t] = act ? act[i] : 1.0f;
  }
  dcd_repeats(S.ids, B, S.prev, S.last);
  __syncthreads();
  return total;
}

// Warp 0: the B steps of the recursion (see the note at the top), G's
// rows from Gsrc (shared or device memory), δ̃ and the running α into
// shared memory; the next step's row of G and scalars load a step ahead.
// NC accumulators a lane: NC·32 ≥ B.
template <int NC>
__device__ __forceinline__ void b5_recursion(const B5Smem& S, int B,
                                             const float* Gsrc,
                                             const DcdLoss& L) {
  const int lane = threadIdx.x & 31;
  // acc[c], g[c] and gn[c] are column u = lane + 32·(c + c0); at every
  // 32nd step the finished group c0 shifts out, so the owner of step t
  // always holds acc_t in acc[0] (static indices keep them in registers)
  float acc[NC], g[NC], gn[NC];
  int c0 = 0;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int u = lane + 32 * c;
    acc[c] = 0.0f;
    g[c] = u < B ? Gsrc[u] : 0.0f;
    gn[c] = 0.0f;
  }
  int pt = S.prev[0];
  float yi = S.ys[0], qi = S.qs[0], ai = S.acts[0], a0t = S.a0[0];
  float bt = S.bs[0], a_last = 0.0f;
  for (int t = 0; t < B; ++t) {
    if (t > 0 && (t & 31) == 0) {
#pragma unroll
      for (int c = 0; c + 1 < NC; ++c) {
        acc[c] = acc[c + 1];
        g[c] = g[c + 1];
      }
      acc[NC - 1] = 0.0f;
      g[NC - 1] = 0.0f;
      ++c0;
    }
    int pt_n = -1;
    float y_n = 1.0f, q_n = 1.0f, act_n = 1.0f, a0_n = 0.0f, b_n = 0.0f;
    if (t + 1 < B) {
      const float* gr = Gsrc + (long long)(t + 1) * B;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int u = lane + 32 * (c + c0);
        gn[c] = u < B ? gr[u] : 0.0f;
      }
      pt_n = S.prev[t + 1];
      y_n = S.ys[t + 1];
      q_n = S.qs[t + 1];
      act_n = S.acts[t + 1];
      a0_n = S.a0[t + 1];
      b_n = S.bs[t + 1];
    }
    const float at = __shfl_sync(0xffffffffu, acc[0], t & 31);
    // a repeated id reads its running α (the last step's from registers)
    const float a = pt < 0 ? a0t : (pt == t - 1 ? a_last : S.arun[pt]);
    float dl = dcd_delta(L, a, yi * (bt + at), qi);
    if (!(ai > 0.0f)) dl = 0.0f;
    const float dt = dl * yi;
    a_last = a + dl;
    if (lane == 0) {
      S.arun[t] = a_last;
      S.dtil[t] = dt;
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc[c] = acc[c] + dt * g[c];
      g[c] = gn[c];
    }
    pt = pt_n;
    yi = y_n;
    qi = q_n;
    ai = act_n;
    a0t = a0_n;
    bt = b_n;
    __syncwarp();
  }
}

// Threads [first, first + count): stage the class's entries [c0, c0 + n)
// in the chunk — the values by cp.async (the caller waits), the columns
// through registers, B5_STAGE a thread at a time — each with an L2
// prefetch of its word of w, so that the scatter's adds find it in L2.
#define B5_STAGE 8
__device__ __forceinline__ void b5_stage_chunk(
    const B5Smem& S, int B, int k, int R, int r, long long row0,
    const int* __restrict__ bk_lc, const float* __restrict__ bk_v,
    const float* wj, int c0, int n, int first, int count) {
  for (int e0 = (int)threadIdx.x - first; e0 < n; e0 += B5_STAGE * count) {
    long long src[B5_STAGE];
    int lc[B5_STAGE];
#pragma unroll
    for (int u = 0; u < B5_STAGE; ++u) {
      const int e = e0 + u * count;
      src[u] = -1;
      if (e < n) {
        const int q = c0 + e;
        int lo = 0, hi = B - 1;  // the row whose segment holds entry q
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (S.segoff[mid] <= q)
            lo = mid;
          else
            hi = mid - 1;
        }
        src[u] = (row0 + lo) * k + S.rstart[lo] + (q - S.segoff[lo]);
      }
    }
#pragma unroll
    for (int u = 0; u < B5_STAGE; ++u)
      lc[u] = src[u] >= 0 ? bk_lc[src[u]] : 0;
#pragma unroll
    for (int u = 0; u < B5_STAGE; ++u) {
      if (src[u] >= 0) {
        const int e = e0 + u * count;
        S.c_lc[e] = lc[u];
        cp_async4(S.c_v + e, bk_v + src[u]);
        asm volatile("prefetch.global.L2 [%0];" ::"l"(
            wj + (long long)lc[u] * R + r));
      }
    }
  }
}

// Warp 0: the chunk's entries in row order, w[lc·R + r] += δ̃_t·v; each
// row's bounds and δ̃ load a row ahead, and a __syncwarp follows each row
// that adds.
__device__ __forceinline__ void b5_apply_chunk(const B5Smem& S, int B, int R,
                                               int r, float* wj, int c0,
                                               int n) {
  const int lane = threadIdx.x & 31;
  int lo = max(S.segoff[0], c0), hi = min(S.segoff[1], c0 + n);
  float s = S.dtil[0];
  for (int t = 0; t < B; ++t) {
    int lo_n = 0, hi_n = 0;
    float s_n = 0.0f;
    if (t + 1 < B) {
      lo_n = max(S.segoff[t + 1], c0);
      hi_n = min(S.segoff[t + 2], c0 + n);
      s_n = S.dtil[t + 1];
    }
    if (lo < hi && s != 0.0f) {
      for (int e = lo + lane; e < hi; e += 32)
        atomicAdd(wj + (long long)S.c_lc[e - c0] * R + r,
                  s * S.c_v[e - c0]);
      __syncwarp();
    }
    lo = lo_n;
    hi = hi_n;
    s = s_n;
  }
}

// α of each id at its last update in the block.
__device__ __forceinline__ void b5_alpha_out(const B5Smem& S, int B,
                                             float* alpha_out) {
  for (int t = threadIdx.x; t < B; t += blockDim.x)
    if (S.last[t]) alpha_out[S.ids[t]] = S.arun[t];
}

// CTA (r = blockIdx.x, j = blockIdx.y): warp 0 runs the recursion while
// the other warps stage the first chunk of the class's entries; then warp
// 0 scatters the chunk (and any later one, staged by all).
template <int NC>
__global__ void dcd_feature_update_kernel(
    const int* __restrict__ idx, int B, long long n_loc, int m, int k, int R,
    const int* __restrict__ bk_lc, const float* __restrict__ bk_v,
    const int* __restrict__ roff, const float* __restrict__ alpha_in,
    float* __restrict__ alpha_out, const float* __restrict__ q,
    const float* __restrict__ act, const float* __restrict__ y, float* w,
    int d1, const float* __restrict__ base, const float* __restrict__ gram,
    int stage_gram, int chunk, DcdLoss L, int data, long long idx_ts,
    long long row_ts, long long act_ts) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int tmp[DCD_MAX_WARPS];
  const B5Smem S = b5_carve(smem, B, stage_gram, chunk);
  // CTA (r, js): class r of feature shard j = js mod m of pair z = js div
  // m, data shard sd = z mod data of task z div data
  const int r = blockIdx.x, js = blockIdx.y;
  const int z = js / m, j = js - z * m;
  const int sd = z % data;
  const long long task = z / data;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long row0 = (long long)js * B;
  float* wj = w + (long long)js * d1;
  idx += task * idx_ts + (long long)sd * B;
  base += (long long)z * B;
  gram += (long long)z * B * B;
  alpha_in += task * row_ts;
  alpha_out += task * row_ts;
  if (y) y += task * row_ts;
  if (act) act += task * act_ts;
  const int total =
      b5_prologue(S, idx, sd * n_loc, B, R, r, row0, roff, alpha_in, q, act,
                  y, base, gram, stage_gram, tmp);
  cp_async_wait_all();  // G
  __syncthreads();
  int n = min(chunk, total);
  if (tid < 32)
    b5_recursion<NC>(S, B, stage_gram ? S.G : gram, L);
  else
    b5_stage_chunk(S, B, k, R, r, row0, bk_lc, bk_v, wj, 0, n, 32, nt - 32);
  cp_async_wait_all();
  __syncthreads();
  for (int c0 = 0; c0 < total; c0 += chunk) {
    n = min(chunk, total - c0);
    if (c0 > 0) {
      b5_stage_chunk(S, B, k, R, r, row0, bk_lc, bk_v, wj, c0, n, 0, nt);
      cp_async_wait_all();
      __syncthreads();
    }
    if (tid < 32) b5_apply_chunk(S, B, R, r, wj, c0, n);
    __syncthreads();
  }
  // CTA (0, j = 0) of each pair writes that pair's α
  if (r == 0 && j == 0) b5_alpha_out(S, B, alpha_out);
}

// B5's rows layout (B > 1,024 ids), the recursion: a blocked (panel)
// recursion on a thread-block cluster of NC CTAs a (task, data shard)
// pair z.  acc[u] = Σ_{s<u} δ̃_s·G[s, u] is what step u needs besides
// base_u; the B steps are cut into panels of 32, panel k the steps t0 =
// 32k … t0 + 31, and G's columns into tiles of TC = 32·NW·B5R_CPL, tile
// x being rank x mod NC's (its accumulators in that CTA's shared memory).
//   - Warp 0 of rank 0, the serial warp, lane l step t0 + l (alone on its
//     SM sub-partition: warps 4, 8, … idle), holds its step's id, label,
//     q, mask, base and α (gathered a panel ahead, ids two ahead), and
//     acc of its column, and runs the panel's 32 steps with shuffles
//     only: at step s every lane takes δ (lane s from its own scalars,
//     the others of a benign point, so no lane's division takes its slow
//     path), the step's δ̃ and new α go to every lane (two shuffles), and
//     each lane adds δ̃_s·G[t0 + s, t0 + l] to its acc.  A repeated id
//     takes the running α: within the panel from masks of
//     __match_any_sync, for the next panel's α (loaded before this
//     panel's stores) from a mask of the ids it shares with this one.
//     The panel's block of G (its rows, the columns of this panel and the
//     next) comes by bulk copies of each row's 16-byte window into a ring
//     of three blocks, issued two panels ahead.  After the panel, warp 0
//     stores δ̃ (to dtil_g for the scatter) and α (the last occurrence in
//     the panel), writes the panel's δ̃ into every CTA's ring of panels
//     through distributed shared memory and arrives on each CTA's
//     "ready" mbarrier (once every CTA's workers have released the panel
//     that held the slot before), then adds the panel's δ̃ to the next
//     panel's acc (its block's second half), once that group's owner has
//     sent its columns as of panel k − 1.
//   - In every CTA, the NW workers (warps 2, 3, 5, 6, 7, 9, …) apply panel
//     k's δ̃ to the CTA's columns of panel k + 2 onward, row by row
//     (acc[u] += δ̃_s·G[t0 + s, u], s in order); worker w owns the
//     32-column groups c ≡ w mod NW of the CTA's tiles, so a column is
//     always added to by one warp, panel after panel, and each lane takes
//     B5R_CPL columns of a tile.  The owner of group k + 2 sends its 32
//     columns to rank 0 (distributed shared memory and a remote
//     mbarrier) as soon as it is done: the look-ahead, one panel of slack
//     for the round trip.
//   - In every CTA, warp 1, the producer, streams the CTA's tiles of panel
//     k's rows of G, columns 32(k + 2) onward, through a ring of S
//     stages: a bulk copy of each row's 16-byte window (row_window), G
//     being independent of δ.  One SM's copy engine takes a few tens of
//     ns a request whatever its size, so the rows go in 2 KB copies
//     (B5R_CPL columns a lane), and the cluster splits G's bytes over NC
//     SMs (one SM's 132 KB ring streamed 30 GB/s).
// So nothing on the serial chain reads device memory; its steps are δ,
// two shuffles, a multiply-add and a few selects.  Every column gets its
// adds in step order, ((0 + δ̃_0·G[0, u]) + δ̃_1·G[1, u]) + …, the order
// of the one-step-at-a-time recursion, so the δ's keep its bits.  acc
// lives in shared memory (acc_g null) or, past what fits, device memory.
// What bounds it: the serial chain of B steps and the cluster's round
// trips a panel, with the trailing update's B²/2 multiply-adds and G's
// B²/2 words (32 MB at the shim's 4,096 ids) streaming beside it.
#define B5R_PANEL 32
#define B5R_LOOK 64     // the serial block's columns: this panel's and the next's
#define B5R_BLOCKS 3    // the serial warp's ring of blocks
#define B5R_SIGNALS 8   // δ̃ panels and look-ahead barriers in flight
#define B5R_MAX_WARPS 12
// The CTA's warps: the serial warp 0 alone on its SM sub-partition (warp
// w issues on sub-partition w mod 4): warps 4, 8, … idle, warp 1 the
// producer, the rest the workers.  b5r_workers(W) of W warps work.
__host__ __device__ inline int b5r_workers(int warps) {
  return warps - 2 - (warps - 1) / 4;
}
#define B5R_CPL 2       // a worker lane's columns a tile (2 KB row copies)

// Words of one ring stage (32 rows of a tile of `tc` columns in windows,
// then each row's window offset), and of one serial block.
__host__ __device__ inline int b5r_stage_words(int tc) {
  return B5R_PANEL * row_slot(tc) + B5R_PANEL;
}
__host__ __device__ inline int b5r_block_words() {
  return B5R_PANEL * row_slot(B5R_LOOK) + B5R_PANEL;
}

// Floats of a CTA's accumulators: its share of the tiles of TC columns
// (tile x is CTA x mod NC's).
__host__ __device__ inline long long b5r_acc_words(int B, int TC, int NC) {
  const long long tiles = (B + TC - 1) / TC;
  return (tiles + NC - 1) / NC * TC;
}

// The rows recursion's shared memory, a CTA of the cluster: the mbarriers
// (the ring's full and empty, the blocks' full, and a δ̃ panel's ready,
// look-ahead and release in flight), the ring, the serial warp's blocks,
// the δ̃ panels, the look-ahead columns, and its accumulators (when
// shared).
__host__ __device__ inline long long b5r_bytes(int B, int S, int NW, int NC,
                                               bool acc_shared) {
  const long long bars = 8LL * (2 * S + B5R_BLOCKS + 3 * B5R_SIGNALS);
  const int TC = 32 * NW * B5R_CPL;
  return (bars + 15) / 16 * 16 + 4LL * S * b5r_stage_words(TC) +
         4LL * B5R_BLOCKS * b5r_block_words() +
         8LL * B5R_SIGNALS * B5R_PANEL +
         (acc_shared ? 4LL * b5r_acc_words(B, TC, NC) : 0);
}

// Thread-block clusters: this CTA's rank, a shared::cluster address of
// `p` in CTA `rank`, a store and an mbarrier arrival there (release at
// cluster scope), a wait on a local mbarrier that remote threads arrive
// on (acquire at cluster scope), and the cluster's barrier.
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_addr(const void* p,
                                                 unsigned rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_addr(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ void st_cluster(unsigned addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_cluster(unsigned addr) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          addr)
      : "memory");
}

__device__ __forceinline__ void mbar_wait_cluster(unsigned long long* bar,
                                                  unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// Pair z's recursion on the NC CTAs of cluster z (rank 0 runs the serial
// warp; every rank streams and applies its tiles of G: the note above).
template <int K>
__global__ void __launch_bounds__(32 * B5R_MAX_WARPS)
    dcd_feature_recursion_panel_kernel(
        const int* __restrict__ idx, int B, long long n_loc,
        float* __restrict__ alpha_out, const float* __restrict__ q,
        const float* __restrict__ act, const float* __restrict__ y,
        const float* __restrict__ base, const float* __restrict__ gram,
        float* __restrict__ acc_g, float* __restrict__ dtil_g, DcdLoss L,
        int data, long long idx_ts, long long row_ts, long long act_ts,
        int S, int NW, int NC) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* empty = full + S;
  unsigned long long* bfull = empty + S;
  unsigned long long* dready = bfull + B5R_BLOCKS;
  unsigned long long* ready = dready + B5R_SIGNALS;   // rank 0's
  unsigned long long* dempty = ready + B5R_SIGNALS;   // rank 0's
  const long long bars = 8LL * (2 * S + B5R_BLOCKS + 3 * B5R_SIGNALS);
  const int TC = 32 * NW * B5R_CPL, STW = b5r_stage_words(TC);
  const int slot = row_slot(TC);
  float* ring = reinterpret_cast<float*>(smem + (bars + 15) / 16 * 16);
  float* blocks = ring + (long long)S * STW;
  float* dring = blocks + B5R_BLOCKS * b5r_block_words();
  float* look = dring + B5R_SIGNALS * B5R_PANEL;  // rank 0's
  float* acc_s = look + B5R_SIGNALS * B5R_PANEL;
  const unsigned rank = cluster_rank();
  const int z = blockIdx.x / NC, sd = z % data;
  const long long task = z / data;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  idx += task * idx_ts + (long long)sd * B;
  base += (long long)z * B;
  gram += (long long)z * B * B;
  const float* g_end = gram + (long long)B * B;
  alpha_out += task * row_ts;
  if (y) y += task * row_ts;
  if (act) act += task * act_ts;
  float* dtil = dtil_g + (long long)z * B;
  const long long g0 = sd * n_loc;
  const int nP = (B + B5R_PANEL - 1) / B5R_PANEL;
  const int tiles = (B + TC - 1) / TC;
  // column u of this CTA's tile x: acc_s[(x / NC)·TC + u − x·TC], or the
  // pair's row of acc_g
  auto acc_of = [&](int x, int u) -> float* {
    return acc_g ? acc_g + (long long)z * B + u
                 : acc_s + (x / NC) * TC + (u - x * TC);
  };
  for (int x = rank; x < tiles; x += NC)
    for (int u = x * TC + tid; u < min((x + 1) * TC, B); u += nt)
      *acc_of(x, u) = 0.0f;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 64);        // the producer's lanes, twice each
      mbar_init(empty + s, 32 * NW);  // every worker lane
    }
    for (int b = 0; b < B5R_BLOCKS; ++b) mbar_init(bfull + b, 64);
    for (int b = 0; b < B5R_SIGNALS; ++b) {
      mbar_init(dready + b, 32);       // the serial warp's lanes
      mbar_init(ready + b, 32);        // the lanes of one worker warp
      mbar_init(dempty + b, NC * NW);  // every rank's worker warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every CTA's barriers before any remote arrival
  // the panels whose δ̃ the workers apply (to columns past the next panel)
  auto worked = [&](int k) { return B5R_PANEL * (k + 2) < B; };
  // this CTA's first tile of panel k's trailing columns
  auto first_tile = [&](int k) {
    const int x0 = (k + 2) / (NW * B5R_CPL);
    return x0 + ((int)rank - x0 % NC + NC) % NC;
  };

  if (warp == 0 && rank == 0) {
    // ---- the serial warp
    const DcdLoss Lk{K, L.C, L.inv_two_c, L.eps_c, L.newton_steps};
    const int BW = b5r_block_words(), bslot = row_slot(B5R_LOOK);
    // panel k's block: its rows, columns [t0, t0 + 64) ∩ [0, B)
    auto issue_block = [&](int k) {
      const int t0 = B5R_PANEL * k, rows = min(B5R_PANEL, B - t0);
      float* blk = blocks + (k % B5R_BLOCKS) * BW;
      unsigned long long* bar = bfull + k % B5R_BLOCKS;
      if (lane < rows) {
        const float* src = gram + (long long)(t0 + lane) * B + t0;
        reinterpret_cast<int*>(blk + B5R_PANEL * bslot)[lane] = row_off(src);
        row_window(blk + lane * bslot, src, min(B5R_LOOK, B - t0), gram,
                   g_end, bar);
      } else {
        mbar_arrive(bar);
      }
      mbar_arrive_cp_async(bar);
    };
    // the id of step 32k + lane (-1 past B), its shard's offset g0 added
    // where the id is used (a warp that adds it at once waits for the load)
    auto step_id = [&](int k) {
      const int t = B5R_PANEL * k + lane;
      return t < B ? idx[t] : -1;
    };
    issue_block(0);
    if (nP > 1) issue_block(1);
    // this panel's scalars (lane l: step t0 + l), and the next's
    int i_c = step_id(0), i_n = nP > 1 ? step_id(1) : -1;
    float y_c = 1.0f, q_c = 1.0f, act_c = 0.0f, b_c = 0.0f, a_c = 0.0f;
    if (i_c >= 0) {
      y_c = y ? y[g0 + i_c] : 1.0f;
      q_c = q[g0 + i_c];
      act_c = act ? act[g0 + i_c] : 1.0f;
      b_c = base[lane];
      a_c = alpha_out[g0 + i_c];
    }
    float acc_c = 0.0f;
    for (int k = 0; k < nP; ++k) {
      const int t0 = B5R_PANEL * k, rows = min(B5R_PANEL, B - t0);
      if (k + 2 < nP) issue_block(k + 2);
      // the next panel's scalars; its α as the last panel's stores left
      // it, patched below with this panel's steps
      float y_n = 1.0f, q_n = 1.0f, act_n = 0.0f, b_n = 0.0f, a_n = 0.0f;
      if (i_n >= 0) {
        y_n = y ? y[g0 + i_n] : 1.0f;
        q_n = q[g0 + i_n];
        act_n = act ? act[g0 + i_n] : 1.0f;
        b_n = base[t0 + B5R_PANEL + lane];
        a_n = alpha_out[g0 + i_n];
      }
      const int i_nn = k + 2 < nP ? step_id(k + 2) : -1;
      const unsigned valid = rows == 32 ? 0xffffffffu : (1u << rows) - 1u;
      const unsigned same = __match_any_sync(0xffffffffu, i_c) & valid;
      const unsigned rep = same & ((1u << lane) - 1u);  // earlier steps
      const bool last = !(same & ~(((1u << lane) << 1) - 1u));
      unsigned nxt = 0;  // this panel's steps with the id of my next one
      for (int s = 0; s < rows; ++s)
        nxt |= (unsigned)(__shfl_sync(0xffffffffu, i_c, s) == i_n) << s;
      if (i_n < 0) nxt = 0;
      mbar_wait(bfull + k % B5R_BLOCKS, (k / B5R_BLOCKS) & 1);
      const float* blk = blocks + (k % B5R_BLOCKS) * BW;
      const int* boff = reinterpret_cast<const int*>(blk + B5R_PANEL * bslot);
      // this lane's column of the panel's block, into registers before the
      // steps: no load on the chain
      float g[B5R_PANEL];
#pragma unroll
      for (int s = 0; s < B5R_PANEL; ++s)
        g[s] = s < rows ? blk[s * bslot + boff[s] + lane] : 0.0f;
      float own_dt = 0.0f, own_a = a_c, a_np = 0.0f;
      bool patched = false;  // a_np, not the loaded a_n, is the next α
#pragma unroll
      for (int s = 0; s < B5R_PANEL; ++s) {
        if (s < rows) {
          // lane s's δ is the step's; the other lanes take δ of a benign
          // point instead of their own partial sums, whose divisions would
          // now and then take the slow path and hold up the warp
          const bool mine = lane == s;
          float dl = dcd_delta(Lk, mine ? a_c : 0.5f * Lk.C,
                               mine ? y_c * (b_c + acc_c) : 0.0f,
                               mine ? q_c : 1.0f);
          if (!(act_c > 0.0f)) dl = 0.0f;
          const float an = a_c + dl, dt = dl * y_c;
          const float dt_s = __shfl_sync(0xffffffffu, dt, s);
          const float as = __shfl_sync(0xffffffffu, an, s);
          if (lane == s) {
            own_dt = dt;
            own_a = an;
          }
          acc_c = acc_c + dt_s * g[s];
          if ((rep >> s) & 1u) a_c = as;
          if ((nxt >> s) & 1u) {
            a_np = as;
            patched = true;
          }
        }
      }
      if (patched) a_n = a_np;
      // the panel's δ̃ and α out; its δ̃ to every CTA's workers, once all
      // of them have released the panel that held its slot before
      const int ks = k % B5R_SIGNALS;
      if (lane < rows) {
        dtil[t0 + lane] = own_dt;
        if (last) alpha_out[g0 + i_c] = own_a;
      }
      if (k >= B5R_SIGNALS && worked(k - B5R_SIGNALS))
        mbar_wait_cluster(dempty + ks, ((k / B5R_SIGNALS) - 1) & 1);
      float* dts = dring + ks * B5R_PANEL;
      dts[lane] = own_dt;
      if (worked(k))
        for (int r = 0; r < NC; ++r) {
          if (r > 0) st_cluster(cluster_addr(dts + lane, r), own_dt);
          mbar_arrive_cluster(cluster_addr(dready + ks, r));
        }
      __syncwarp();  // the panel's stores before the next one's loads
      // the look-ahead: the next panel's acc, the workers' adds through
      // panel k − 1 (sent by the group's owner) then this panel's
      if (k + 1 < nP) {
        const int c1 = k + 1;
        float an_acc = 0.0f;
        if (c1 >= 2) {
          const int cs = (c1 - 2) % B5R_SIGNALS;
          mbar_wait_cluster(ready + cs, ((c1 - 2) / B5R_SIGNALS) & 1);
          an_acc = look[cs * B5R_PANEL + lane];
        }
#pragma unroll 8
        for (int s = 0; s < rows; ++s)
          an_acc = an_acc + dts[s] * blk[s * bslot + boff[s] + 32 + lane];
        acc_c = an_acc;
      }
      __syncwarp();
      i_c = i_n;
      y_c = y_n;
      q_c = q_n;
      act_c = act_n;
      b_c = b_n;
      a_c = a_n;
      i_n = i_nn;
    }
  } else if (warp == 1) {
    // ---- the producer: this CTA's tiles of panel k's rows, columns
    // 32(k + 2) onward
    for (int k = 0, s = 0, ph = 0; worked(k); ++k) {
      const int c_lo = k + 2;
      const int t0 = B5R_PANEL * k, rows = min(B5R_PANEL, B - t0);
      for (int x = first_tile(k); x < tiles; x += NC) {
        mbar_wait(empty + s, ph ^ 1);
        const int cs = max(x * TC, B5R_PANEL * c_lo);
        const int ce = min((x + 1) * TC, B);
        float* st = ring + (long long)s * STW;
        if (lane < rows) {
          const float* src = gram + (long long)(t0 + lane) * B + cs;
          reinterpret_cast<int*>(st + B5R_PANEL * slot)[lane] = row_off(src);
          row_window(st + lane * slot, src, ce - cs, gram, g_end, full + s);
        } else {
          mbar_arrive(full + s);
        }
        mbar_arrive_cp_async(full + s);
        if (++s == S) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    cp_async_wait_all();  // no copy of this thread outlives it
  } else if (warp > 1 && warp % 4 != 0) {
    // ---- worker wk: column groups c ≡ wk mod NW of this CTA's tiles,
    // panel after panel
    const int wk = warp - 2 - warp / 4;
    for (int k = 0, s = 0, ph = 0; worked(k); ++k) {
      const int c_lo = k + 2;
      const int rows = min(B5R_PANEL, B - B5R_PANEL * k);
      mbar_wait_cluster(dready + k % B5R_SIGNALS, (k / B5R_SIGNALS) & 1);
      const float* dt = dring + (k % B5R_SIGNALS) * B5R_PANEL;
      for (int x = first_tile(k); x < tiles; x += NC) {
        mbar_wait(full + s, ph);
        const int cs = max(x * TC, B5R_PANEL * c_lo);
        const float* st = ring + (long long)s * STW;
        const int* soff = reinterpret_cast<const int*>(st + B5R_PANEL * slot);
        // each row's start in the stage and δ̃, once a tile
        int ro[B5R_PANEL];
        float dv[B5R_PANEL];
#pragma unroll
        for (int r = 0; r < B5R_PANEL; ++r) {
          ro[r] = r * slot + soff[r];
          dv[r] = r < rows ? dt[r] : 0.0f;
        }
        // the tile's groups x·NW·CPL + wk + j·NW, j < CPL: a group's
        // owner is the same warp of the same CTA in every panel
        bool signal = false;
#pragma unroll
        for (int j = 0; j < B5R_CPL; ++j) {
          const int cg = (x * B5R_CPL + j) * NW + wk;
          const int u = B5R_PANEL * cg + lane;
          if (cg >= c_lo && u < B) {
            // the panel's 32 words of this column into registers first,
            // so the loads overlap; then the adds in row order
            const float* gu = st + (u - cs);
            float g[B5R_PANEL];
#pragma unroll
            for (int r = 0; r < B5R_PANEL; ++r)
              g[r] = r < rows ? gu[ro[r]] : 0.0f;
            float* au = acc_of(x, u);
            float a = *au;
#pragma unroll
            for (int r = 0; r < B5R_PANEL; ++r)
              if (r < rows) a = a + dv[r] * g[r];
            *au = a;
            if (cg == c_lo) {  // the serial warp's next look-ahead
              st_cluster(cluster_addr(look + ((c_lo - 2) % B5R_SIGNALS) *
                                                 B5R_PANEL + lane, 0), a);
              signal = true;
            }
          }
        }
        if (__any_sync(0xffffffffu, signal))
          mbar_arrive_cluster(
              cluster_addr(ready + (c_lo - 2) % B5R_SIGNALS, 0));
        mbar_arrive(empty + s);
        if (++s == S) {
          s = 0;
          ph ^= 1;
        }
      }
      __syncwarp();  // the warp's reads of the panel's δ̃ are done
      if (lane == 0)
        mbar_arrive_cluster(cluster_addr(dempty + k % B5R_SIGNALS, 0));
    }
  }
  cluster_sync();  // no CTA leaves while another may write to it
}

// B5's rows layout, the scatter: CTA (r, js), one warp, adds δ̃_t·v of its
// class-r entries of each row t into its triple's replica of the slices,
// rows in order (a __syncwarp after each row that adds, as the shared
// layout's).  Rows go B5S_ROWS at a time: lane c loads row t0 + c's δ̃
// and bounds (a group ahead), then every lane loads its entries of each
// of the rows (the first 32·B5S_ENTRIES of a row: a zipf-heavy shard's
// rows run to 60 and more) into registers before any add, so the group's
// loads overlap instead of waiting a row at a time; a longer row's rest
// loads as it is added.
#define B5S_ROWS 16
#define B5S_ENTRIES 2
__global__ void dcd_feature_scatter_rows_kernel(
    int B, int m, int k, int R, const int* __restrict__ bk_lc,
    const float* __restrict__ bk_v, const int* __restrict__ roff,
    const float* __restrict__ dtil_g, float* w, int d1) {
  const int r = blockIdx.x, js = blockIdx.y, z = js / m;
  const int lane = threadIdx.x & 31;
  const long long row0 = (long long)js * B;
  const float* dtil = dtil_g + (long long)z * B;
  float* wj = w + (long long)js * d1;
  // lane c: row t0 + c's δ̃ and segment bounds, a group ahead
  float s_n = 0.0f;
  int a_n = 0, b_n = 0;
  auto bounds = [&](int t0) {
    const int tl = t0 + lane;
    s_n = 0.0f;
    a_n = b_n = 0;
    if (lane < B5S_ROWS && tl < B) {
      s_n = dtil[tl];
      a_n = roff[(row0 + tl) * (R + 1) + r];
      b_n = roff[(row0 + tl) * (R + 1) + r + 1];
    }
  };
  bounds(0);
  for (int t0 = 0; t0 < B; t0 += B5S_ROWS) {
    const float s_l = s_n;
    const int a_l = a_n, b_l = b_n;
    const int nrow = min(B5S_ROWS, B - t0);
    int lc[B5S_ROWS][B5S_ENTRIES];
    float v[B5S_ROWS][B5S_ENTRIES];
#pragma unroll
    for (int c = 0; c < B5S_ROWS; ++c) {
      const float sc = __shfl_sync(0xffffffffu, s_l, c);
      const int a = __shfl_sync(0xffffffffu, a_l, c);
      const int b = __shfl_sync(0xffffffffu, b_l, c);
#pragma unroll
      for (int j = 0; j < B5S_ENTRIES; ++j) {
        const int e = a + lane + 32 * j;
        const long long src = (row0 + t0 + c) * k + e;
        const bool live = c < nrow && sc != 0.0f && e < b;
        lc[c][j] = live ? bk_lc[src] : 0;
        v[c][j] = live ? bk_v[src] : 0.0f;
      }
    }
    bounds(t0 + B5S_ROWS);
#pragma unroll
    for (int c = 0; c < B5S_ROWS; ++c) {
      const float sc = __shfl_sync(0xffffffffu, s_l, c);
      const int a = __shfl_sync(0xffffffffu, a_l, c);
      const int b = __shfl_sync(0xffffffffu, b_l, c);
      if (c < nrow && sc != 0.0f && a < b) {
#pragma unroll
        for (int j = 0; j < B5S_ENTRIES; ++j)
          if (a + lane + 32 * j < b)
            atomicAdd(wj + (long long)lc[c][j] * R + r, sc * v[c][j]);
        const long long rt = (row0 + t0 + c) * k;
        for (int e = a + 32 * B5S_ENTRIES + lane; e < b; e += 32)
          atomicAdd(wj + (long long)bk_lc[rt + e] * R + r, sc * bk_v[rt + e]);
        __syncwarp();
      }
    }
  }
}

// The dynamic shared memory limit of `kernel`, raised to `bytes` when
// `*set` (the limit raised so far in this process) is below it.
template <typename K>
static cudaError_t smem_limit(K kernel, int bytes, int* set) {
  if (bytes <= *set) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *set = bytes;
  return err;
}

static int bucket_smem_set = 0;

// Plain C entries for ctypes.  Each returns cudaGetLastError() after its
// launch (0 = launched), or cudaErrorInvalidValue for a layout the
// kernels cannot take.  act and y may be null.
extern "C" int dcd_feature_gram_launch(
    const int* idx, int B, int data, long long n_loc, const int* cols,
    const float* vals, int m, int k, int d_loc, const float* w,
    long long w_stride, int d1, int R, int tile, int tiles, int chunk,
    int slots, int bucket_threads, int bucket_smem, int gram_threads,
    int gram_smem, int* bk_lc, float* bk_v, int* roff, float* part,
    float* base_p, float* gram_p, int tasks, long long idx_ts,
    long long w_ts, int pod_shards, int rows, void* stream) {
  // the bytes each kernel carves (repro_torch/dist/mesh.py: gram_plan,
  // gram_rows_bytes): the bucket pass's per-warp class counts and the
  // staged row; the Gram kernel's table (key, count, run end), the
  // chunk's entries staged and sorted (6 words each), and in the shared
  // layout the rows' offsets and starts and each walker's (B, tile)
  // accumulator, in the rows layout the tile rows' offsets and each
  // thread's tile of accumulators
  const int walkers = rows ? 1 : gram_threads / 64;
  const long long bucket_need = 4LL * (bucket_threads / 32) * R + 8LL * k;
  const long long gram_need =
      12LL * slots + 24LL * chunk +
      (rows ? 4LL * (tile + 1) + 4LL * gram_threads * tile
            : 4LL * (2 * B + 1) + 4LL * walkers * B * tile);
  if (B < 1 || R < 1 || walkers < 1 ||
      gram_threads % (rows ? 32 : 64) != 0 || (rows && R != 1) ||
      gram_threads > 1024 || tile < 1 || tile > 64 ||
      (long long)tile * tiles < B || bucket_threads < 32 ||
      bucket_threads % 32 != 0 || bucket_threads > 1024 ||
      (slots & (slots - 1)) != 0 || slots < chunk ||
      bucket_smem < bucket_need || gram_smem < gram_need || data < 1 ||
      tasks < 1 || (long long)tasks * data * m > 65535 || pod_shards < 1 ||
      data % pod_shards != 0)
    return (int)cudaErrorInvalidValue;
  const int pairs = tasks * data;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  static int gram_set = 0;
  err = smem_limit(dcd_feature_bucket_kernel, bucket_smem, &bucket_smem_set);
  if (err != cudaSuccess) return (int)err;
  dcd_feature_bucket_kernel<<<dim3(m, B < 65535 ? B : 65535, pairs),
                              bucket_threads, bucket_smem, st>>>(
      idx, B, n_loc, cols, vals, m, k, d_loc, w, w_stride, d1, R, bk_lc, bk_v,
      roff, base_p, data, idx_ts, w_ts, pod_shards);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (rows) {
    static int rows_set = 0;
    err = smem_limit(dcd_feature_gram_rows_kernel, gram_smem, &rows_set);
    if (err != cudaSuccess) return (int)err;
    dcd_feature_gram_rows_kernel<<<
        dim3(tiles, (B + gram_threads - 1) / gram_threads, pairs * m),
        gram_threads, gram_smem, st>>>(B, k, tile, chunk, slots, bk_lc, bk_v,
                                       roff, gram_p);
    return (int)cudaGetLastError();
  }
  err = smem_limit(dcd_feature_gram_kernel, gram_smem, &gram_set);
  if (err != cudaSuccess) return (int)err;
  // the classes of a shard in x, so the widest shard's CTAs start first;
  // the (task, data, model) triples in y
  dcd_feature_gram_kernel<<<dim3(R, pairs * m, tiles), gram_threads,
                            gram_smem, st>>>(B, k, R, tile, chunk, slots,
                                             bk_lc, bk_v, roff,
                                             R > 1 ? part : gram_p);
  err = cudaGetLastError();
  if (err != cudaSuccess || R == 1) return (int)err;
  const long long bb = (long long)B * B;
  const int blocks = (int)((bb + 255) / 256 < 1024 ? (bb + 255) / 256 : 1024);
  dcd_feature_gram_reduce_kernel<<<dim3(blocks, pairs * m), 256, 0, st>>>(
      B, R, part, gram_p);
  return (int)cudaGetLastError();
}

template <int NC>
static int update_launch(const int* idx, int B, int data, long long n_loc,
                         int m, int k, int R,
                         const int* bk_lc, const float* bk_v, const int* roff,
                         const float* alpha_in, float* alpha_out,
                         const float* q, const float* act, const float* y,
                         float* w, int d1, const float* base,
                         const float* gram, int stage_gram, int chunk,
                         const DcdLoss& L, int threads, int smem, int tasks,
                         long long idx_ts, long long row_ts,
                         long long act_ts, cudaStream_t st) {
  static int set = 0;
  const cudaError_t err =
      smem_limit(dcd_feature_update_kernel<NC>, smem, &set);
  if (err != cudaSuccess) return (int)err;
  dcd_feature_update_kernel<NC><<<dim3(R, tasks * data * m), threads, smem,
                                  st>>>(
      idx, B, n_loc, m, k, R, bk_lc, bk_v, roff, alpha_in, alpha_out, q, act,
      y, w, d1, base, gram, stage_gram, chunk, L, data, idx_ts, row_ts,
      act_ts);
  return (int)cudaGetLastError();
}

// B5's rows-layout recursion, a cluster of NC CTAs a (task, data shard)
// pair.
template <int K>
static cudaError_t panel_launch(const int* idx, int B, long long n_loc,
                                float* alpha_out, const float* q,
                                const float* act, const float* y,
                                const float* base, const float* gram,
                                float* acc_g, float* dtil_g, const DcdLoss& L,
                                int data, long long idx_ts, long long row_ts,
                                long long act_ts, int S, int NW, int NC,
                                int tasks, int threads, int smem,
                                cudaStream_t st) {
  static int set = 0;
  const cudaError_t err =
      smem_limit(dcd_feature_recursion_panel_kernel<K>, smem, &set);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tasks * data * NC);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, dcd_feature_recursion_panel_kernel<K>, idx,
                            B, n_loc, alpha_out, q, act, y, base, gram, acc_g,
                            dtil_g, L, data, idx_ts, row_ts, act_ts, S, NW,
                            NC);
}

// B5.  With `bucket`, B4's bucket pass (no base) first fills bk_lc, bk_v
// and roff for this block.
extern "C" int dcd_feature_update_launch(
    const int* idx, int B, int data, long long n_loc, const int* cols,
    const float* vals, int m, int k, int d_loc, const float* alpha_in,
    float* alpha_out, const float* q,
    const float* act, const float* y, float* w, int d1, const float* base,
    const float* gram, int kind, float C, float inv_two_c, float eps_c,
    int newton_steps, int R, int per_lane, int stage_gram, int chunk,
    int threads, int smem, int bucket, int bucket_threads, int bucket_smem,
    int* bk_lc, float* bk_v, int* roff, int tasks, long long idx_ts,
    long long row_ts, long long act_ts, int rows, float* acc_g,
    float* dtil_g, int stages, int cluster, void* stream) {
  // the bytes each kernel carves (repro_torch/dist/mesh.py:
  // feature_update_bytes, gram_plan; in the rows layout
  // feature_rows_bytes: its ring of `stages` stages for the workers of
  // threads / 32 warps, and the B accumulators unless they are in device
  // memory)
  const int workers = b5r_workers(threads / 32);
  const long long need =
      rows ? b5r_bytes(B, stages, workers, cluster, !acc_g)
           : 4LL * (12LL * B + 1) + (stage_gram ? 4LL * B * B : 0) +
                 8LL * chunk;
  const long long bucket_need = 4LL * (bucket_threads / 32) * R + 8LL * k;
  const bool lanes_ok = rows || (B <= DCD_FEATURE_MAX_B && per_lane >= 1 &&
                                 per_lane <= 32 &&
                                 (per_lane & (per_lane - 1)) == 0 &&
                                 32LL * per_lane >= B && chunk >= 1);
  if (B < 1 || R < 1 || !lanes_ok ||
      (rows && (!dtil_g || workers < 1 || threads > 32 * B5R_MAX_WARPS ||
                cluster < 1 || cluster > 8 ||
                stages < 2 || stages > B5R_SIGNALS - 2)) ||
      threads < (rows ? 32 : 64) || threads % 32 != 0 || threads > 1024 ||
      smem < need || data < 1 || tasks < 1 ||
      (long long)tasks * data * m > 65535 ||
      (bucket && (bucket_threads < 32 || bucket_threads % 32 != 0 ||
                  bucket_threads > 1024 || bucket_smem < bucket_need)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bucket) {
    cudaError_t err =
        smem_limit(dcd_feature_bucket_kernel, bucket_smem, &bucket_smem_set);
    if (err != cudaSuccess) return (int)err;
    // w is not read without base_p: its strides are of no matter
    dcd_feature_bucket_kernel<<<dim3(m, B < 65535 ? B : 65535, tasks * data),
                                 bucket_threads, bucket_smem, st>>>(
        idx, B, n_loc, cols, vals, m, k, d_loc, w, 0, d1, R, bk_lc, bk_v,
        roff, nullptr, data, idx_ts, 0, 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const DcdLoss L{kind, C, inv_two_c, eps_c, newton_steps};
  if (rows) {
    cudaError_t err;
    switch (kind) {  // the loss is a template: no dispatch on the chain
      case DCD_HINGE:
        err = panel_launch<DCD_HINGE>(idx, B, n_loc, alpha_out, q, act, y,
                                      base, gram, acc_g, dtil_g, L, data,
                                      idx_ts, row_ts, act_ts, stages,
                                      workers, cluster, tasks, threads, smem,
                                      st);
        break;
      case DCD_SQUARED_HINGE:
        err = panel_launch<DCD_SQUARED_HINGE>(
            idx, B, n_loc, alpha_out, q, act, y, base, gram, acc_g, dtil_g,
            L, data, idx_ts, row_ts, act_ts, stages, workers, cluster, tasks,
            threads, smem, st);
        break;
      case DCD_LOGISTIC:
        err = panel_launch<DCD_LOGISTIC>(
            idx, B, n_loc, alpha_out, q, act, y, base, gram, acc_g, dtil_g,
            L, data, idx_ts, row_ts, act_ts, stages, workers, cluster, tasks,
            threads, smem, st);
        break;
      default: return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
    dcd_feature_scatter_rows_kernel<<<dim3(R, tasks * data * m), 32, 0, st>>>(
        B, m, k, R, bk_lc, bk_v, roff, dtil_g, w, d1);
    return (int)cudaGetLastError();
  }
#define B5_LAUNCH(NC)                                                         \
  return update_launch<NC>(idx, B, data, n_loc, m, k, R, bk_lc, bk_v, roff, \
                           alpha_in, alpha_out, q, act, y, w, d1, base,      \
                           gram, stage_gram, chunk, L, threads, smem, tasks, \
                           idx_ts, row_ts, act_ts, st)
  switch (per_lane) {
    case 1: B5_LAUNCH(1);
    case 2: B5_LAUNCH(2);
    case 4: B5_LAUNCH(4);
    case 8: B5_LAUNCH(8);
    case 16: B5_LAUNCH(16);
    default: B5_LAUNCH(32);
  }
#undef B5_LAUNCH
}
