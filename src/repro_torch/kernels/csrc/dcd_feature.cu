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
// offsets (class r's entries are [roff[r], roff[r + 1])).  The row's k
// slots are staged in shared memory, loaded GRAM_LANE_BATCH a lane at a
// time so that the loads, and the gathers of w behind them, overlap.
#define GRAM_LANE_BATCH 8
__global__ void dcd_feature_bucket_kernel(
    const int* __restrict__ idx, int B, const int* __restrict__ cols,
    const float* __restrict__ vals, int m, int k, int d_loc,
    const float* __restrict__ w, int d1, int R, int* __restrict__ bk_lc,
    float* __restrict__ bk_v, int* __restrict__ roff,
    float* __restrict__ base_p) {
  extern __shared__ __align__(16) int cur[];  // [warps][R]: counts, cursors
  __shared__ float red[DCD_MAX_WARPS];
  __shared__ int tmp[DCD_MAX_WARPS];
  const int j = blockIdx.x, t = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  int* sc = cur + nw * R;  // the row's k column ids
  float* sv = reinterpret_cast<float*>(sc + k);
  const long long rt = ((long long)idx[t] * m + j) * k;
  const int* ct = cols + rt;
  const float* vt = vals + rt;
  const float* wj = w + (long long)j * d1;
  const long long row = (long long)j * B + t;
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
      wv[u] = (unsigned)c[u] < (unsigned)d_loc ? wj[c[u]] : 0.0f;
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
  if (tid == 0) base_p[row] = base;
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
// launch (0 = launched), or cudaErrorInvalidValue for a layout the
// kernels cannot take.  act and y may be null.
extern "C" int dcd_feature_gram_launch(
    const int* idx, int B, const int* cols, const float* vals, int m, int k,
    int d_loc, const float* w, int d1, int R, int tile, int tiles, int chunk,
    int slots, int bucket_threads, int bucket_smem, int gram_threads,
    int gram_smem, int* bk_lc, float* bk_v, int* roff, float* part,
    float* base_p, float* gram_p, void* stream) {
  // the bytes each kernel carves (repro_torch/dist/mesh.py: gram_plan):
  // the bucket pass's per-warp class counts and the staged row; the Gram
  // kernel's table (key, count, run end), the chunk's entries staged and
  // sorted (6 words each), the rows' offsets and starts, and each
  // walker's (B, tile) accumulator
  const int walkers = gram_threads / 64;
  const long long bucket_need = 4LL * (bucket_threads / 32) * R + 8LL * k;
  const long long gram_need = 12LL * slots + 24LL * chunk +
                              4LL * (2 * B + 1) +
                              4LL * walkers * B * tile;
  if (B < 1 || R < 1 || walkers < 1 || gram_threads % 64 != 0 ||
      gram_threads > 1024 || tile < 1 || tile > 64 ||
      (long long)tile * tiles < B || bucket_threads < 32 ||
      bucket_threads % 32 != 0 || bucket_threads > 1024 ||
      (slots & (slots - 1)) != 0 || slots < chunk ||
      bucket_smem < bucket_need || gram_smem < gram_need)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  static int bucket_set = 0, gram_set = 0;  // limits raised so far
  if (bucket_smem > bucket_set) {
    err = cudaFuncSetAttribute(dcd_feature_bucket_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bucket_smem);
    if (err != cudaSuccess) return (int)err;
    bucket_set = bucket_smem;
  }
  if (gram_smem > gram_set) {
    err = cudaFuncSetAttribute(dcd_feature_gram_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               gram_smem);
    if (err != cudaSuccess) return (int)err;
    gram_set = gram_smem;
  }
  dcd_feature_bucket_kernel<<<dim3(m, B), bucket_threads, bucket_smem, st>>>(
      idx, B, cols, vals, m, k, d_loc, w, d1, R, bk_lc, bk_v, roff, base_p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the classes of a shard in x, so the widest shard's CTAs start first
  dcd_feature_gram_kernel<<<dim3(R, m, tiles), gram_threads, gram_smem, st>>>(
      B, k, R, tile, chunk, slots, bk_lc, bk_v, roff, R > 1 ? part : gram_p);
  err = cudaGetLastError();
  if (err != cudaSuccess || R == 1) return (int)err;
  const long long bb = (long long)B * B;
  const int blocks = (int)((bb + 255) / 256 < 1024 ? (bb + 255) / 256 : 1024);
  dcd_feature_gram_reduce_kernel<<<dim3(blocks, m), 256, 0, st>>>(B, R, part,
                                                                  gram_p);
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
