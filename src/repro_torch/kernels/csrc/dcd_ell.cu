// B1: indexed DCD over an ELL row shard, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/dcd_ell.py
// (_dcd_ell_indexed_kernel, reached through dcd_ell_epoch_pallas_call).
// For each row id i = idx[t], t = 0..m-1, in order:
//   wx = y_i · Σ_j w[cols_ij]·vals_ij,  δ = loss.delta(α_i, wx, q_i)
//   (0 where act_i = 0),  α_i += δ,  w[cols_ij] += δ·y_i·vals_ij.
// α and w carry across all m ids: each update reads the previous one's
// writes (serial-DCD semantics).  The TPU kernel leans on its grid running
// in order; Hopper runs blocks in parallel and in no order, so ONE CTA
// runs the whole id sequence in a loop.  The wrapper copies α into its
// output buffer first, and the kernels allocate nothing.
//
// Data shards.  The reference's p devices along "data" each run their own
// block against their replica of w, and psum their Δw.  Here they are a
// grid of p CTAs, CTA s one shard: its ids are idx[s·m .. s·m + m) of the
// shard's rows [s·n_loc, (s+1)·n_loc) (row s·n_loc + id), it reads
// w + s·w_stride (w_stride 0: one w for every shard), and it writes its
// own Δw slice (the staged kernel: dw[s] = w_new − w at the columns it
// touched, into a slice the wrapper zeroed) or updates its own replica of
// w in place (the wide kernel: w + s·(d + 1), which the wrapper filled;
// the wrapper takes Δw = replica − w).  No CTA reads what another writes
// (the shards' rows are disjoint), so the result does not depend on which
// CTAs run together; the wrapper sums the p slices in shard order.  A
// launch with p = 1, n_loc = 0 and no dw is the single block of the
// serial solvers, updating w in place.
//
// Tasks.  The multi-task (one-vs-rest) solver runs K binary problems on
// one unfolded X: the reference vmaps the whole round over a leading task
// axis.  Here the tasks are the grid's y dimension: CTA (s, k) runs data
// shard s of task k.  It reads the shared rows (cols, vals, q), its ids at
// idx + k·idx_ts (idx_ts 0: every task draws the same blocks), its α and y
// at α + k·row_ts and y + k·row_ts, its act at act + k·act_ts (0: one mask
// for every task), its view of w at w + k·w_ts + s·w_stride, and writes
// its Δw slice dw[k·p + s] (staged) or its replica w + (k·p + s)·(d + 1)
// (wide).  Nothing is shared between CTAs, so a task dimension changes no
// CTA's arithmetic: K = 1 gives the bits of the task-free grid.  Padding slots (col == d, value 0) and any column outside
// [0, d) are skipped, so the dummy slot w[d] stays exactly 0.  A δ of
// exactly 0 (a row at its box, or frozen) scatters nothing.  Two variants,
// chosen by shape (repro_torch/dist/mesh.py: dcd_ell_plan):
//
// dcd_ell_staged_kernel, for a block whose rows fit in shared memory (the
// main path: 64 ids of rcv1's 73 slots).  What bounds B1 is the chain of m
// dependent updates, not bytes; the design keeps every link of that chain
// in shared memory.
//   1. Prologue, all threads: cp.async copies the block's rows (cols and
//      vals) into shared memory, independent 4-byte copies waited for
//      once; the ids' α, q, y and act load beside them.  Each real column
//      is inserted into an open-addressing table (linear probing,
//      atomicCAS on the key), and its slot replaces the column in the
//      staged row.  Rows that repeat a column are found with a bit per
//      row in each table slot (atomicOr, 32 rows a pass); then w is
//      gathered into the table once (batches of independent loads).  A
//      repeated id finds its previous occurrence in the block and reads
//      its running α from shared memory, as B5 does.
//   2. Updates, on one warp (rows of at most 128 slots; about 3 entries
//      a lane at rcv1): each lane keeps its entries of the row in
//      registers and loads the next row's while this one runs; the dot is
//      a butterfly of shuffles, so every lane holds the same sum and
//      takes the same δ.  The scatter is plain read-modify-write: a float
//      atomicAdd on shared memory is a compare-and-swap loop on this card,
//      and it cost more than half of each update.  Its adds reuse the w
//      values the dot loaded, as no other lane writes a slot of the row.
//      A row that repeats a column (two entries on one slot, marked by the
//      prologue) scatters from one lane instead, in slot order.
//      __syncwarp orders one update's adds before the next gather, so the
//      adds into each w entry stay in update order.
//   3. Epilogue, all threads: α of each id at its last update in the
//      block, and every table entry back to its column of w.
// Which table slot a column lands in depends on the race of the inserts,
// but no arithmetic does: two launches give the same bits.
//
// dcd_ell_kernel, the wide variant, for blocks too large to stage (a 1-D
// solve on webspam's 3,728-slot rows): one thread per ELL slot (whole
// warps), w gathered from and scattered into device memory (atomicAdd), a
// CTA reduction and a __syncthreads between updates.  It is latency-bound
// on the dependent global round trips of each update.

#include "dcd_delta.cuh"

// row entries a lane of the staged kernel's update warp holds (the plan
// gives a block the staged kernel only if k ≤ 4 · 32)
#define ELL_LANE_ENTRIES 4
#define ELL_GATHER 16  // table slots a thread gathers from w at once

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ unsigned col_hash(int c, int slots) {
  unsigned h = (unsigned)c * 0x9E3779B1u;
  return (h ^ (h >> 16)) & (unsigned)(slots - 1);
}

__global__ void dcd_ell_staged_kernel(const int* __restrict__ idx, int m,
                                      long long n_loc,
                                      const int* __restrict__ cols,
                                      const float* __restrict__ vals, int k,
                                      int d, float* alpha,
                                      const float* __restrict__ q,
                                      const float* __restrict__ act,
                                      const float* __restrict__ y, float* w,
                                      long long w_stride, float* dw,
                                      DcdLoss L, int slots, long long idx_ts,
                                      long long row_ts, long long act_ts,
                                      long long w_ts) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* key = reinterpret_cast<int*>(smem);        // column, or -1: empty
  float* wt = reinterpret_cast<float*>(key + slots);  // w at that column
  const int E = m * k;
  int* slot = reinterpret_cast<int*>(wt + slots);  // col, then table slot
  float* val = reinterpret_cast<float*>(slot + E);
  int* ids = reinterpret_cast<int*>(val + E);
  float* a0 = reinterpret_cast<float*>(ids + m);  // α_i at block entry
  float* qs = a0 + m;
  float* ys = qs + m;
  float* acts = ys + m;
  float* arun = acts + m;  // α_i after update t
  int* prev = reinterpret_cast<int*>(arun + m);  // last s < t, same id
  int* dup = prev + m;  // row t repeats a column
  const int tid = threadIdx.x, nt = blockDim.x;
  // data shard blockIdx.x of task blockIdx.y: its ids, its rows, its α,
  // y and act, its view of w
  const long long task = blockIdx.y;
  const long long row0 = (long long)blockIdx.x * n_loc;
  idx += task * idx_ts + (long long)blockIdx.x * m;
  alpha += task * row_ts;
  if (y) y += task * row_ts;
  if (act) act += task * act_ts;
  w += task * w_ts + (long long)blockIdx.x * w_stride;

  // 1. prologue
  for (int t = tid; t < m; t += nt) ids[t] = (int)(row0 + idx[t]);
  for (int s = tid; s < slots; s += nt) key[s] = -1;
  __syncthreads();
  for (int e = tid; e < E; e += nt) {
    const int t = e / k;
    const long long off = (long long)ids[t] * k + (e - t * k);
    cp_async4(slot + e, cols + off);
    cp_async4(val + e, vals + off);
  }
  for (int t = tid; t < m; t += nt) {
    const int i = ids[t];
    a0[t] = alpha[i];
    qs[t] = q[i];
    ys[t] = y ? y[i] : 1.0f;
    acts[t] = act ? act[i] : 1.0f;
  }
  // each id's previous occurrence in the block, a warp an id (ballots)
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  for (int t = warp; t < m; t += nwarps) {
    int p = -1;
    for (int s0 = 0; s0 < t; s0 += 32) {
      const int s = s0 + lane;
      const unsigned b = __ballot_sync(0xffffffffu, s < t && ids[s] == ids[t]);
      if (b) p = s0 + 31 - __clz(b);
    }
    if (lane == 0) prev[t] = p;
  }
  cp_async_wait_all();
  __syncthreads();
  for (int e = tid; e < E; e += nt) {
    const int c = slot[e];
    int sl = -1;
    if ((unsigned)c < (unsigned)d) {
      unsigned h = col_hash(c, slots);
      for (;;) {  // a plain read first: hot columns are mostly in already
        int got = reinterpret_cast<volatile int*>(key)[h];
        if (got == -1) got = atomicCAS(key + h, -1, c);
        if (got == -1 || got == c) break;
        h = (h + 1) & (unsigned)(slots - 1);
      }
      sl = (int)h;
    }
    slot[e] = sl;
  }
  __syncthreads();
  // the scatter is plain adds, which a row that repeats a column (two of
  // its entries on one slot) must not take: find those rows, 32 rows at a
  // time, with a bit per row in each slot of the table (the w words,
  // before w is gathered into them)
  {
    unsigned* bits = reinterpret_cast<unsigned*>(wt);
    for (int t = tid; t < m; t += nt) dup[t] = 0;
    for (int g0 = 0; g0 < m; g0 += 32) {
      for (int s = tid; s < slots; s += nt) bits[s] = 0u;
      __syncthreads();
      const int e1 = min(m, g0 + 32) * k;
      for (int e = g0 * k + tid; e < e1; e += nt) {
        const int h = slot[e];
        const int t = e / k;
        const unsigned bit = 1u << (t - g0);
        if (h >= 0 && (atomicOr(bits + h, bit) & bit)) dup[t] = 1;
      }
      __syncthreads();
    }
  }
  // w into the table, ELL_GATHER slots a thread at a time so the loads
  // overlap
  for (int s0 = tid; s0 < slots; s0 += nt * ELL_GATHER) {
    int c[ELL_GATHER];
    float wv[ELL_GATHER];
#pragma unroll
    for (int u = 0; u < ELL_GATHER; ++u) {
      const int s = s0 + u * nt;
      c[u] = s < slots ? key[s] : -1;
    }
#pragma unroll
    for (int u = 0; u < ELL_GATHER; ++u) wv[u] = c[u] >= 0 ? w[c[u]] : 0.0f;
#pragma unroll
    for (int u = 0; u < ELL_GATHER; ++u)
      if (c[u] >= 0) wt[s0 + u * nt] = wv[u];
  }
  __syncthreads();

  // 2. the m updates, on warp 0, in shared memory only.  Each lane holds
  // up to ELL_LANE_ENTRIES of a row's entries (e = lane + 32·j) and loads
  // the next row's (slot, value) pairs and its id's scalars while this
  // row's update runs.
  if (warp == 0) {
    int sl[ELL_LANE_ENTRIES], nsl[ELL_LANE_ENTRIES];
    float v[ELL_LANE_ENTRIES], nv[ELL_LANE_ENTRIES];
#pragma unroll
    for (int j = 0; j < ELL_LANE_ENTRIES; ++j) {
      const int e = lane + j * 32;
      sl[j] = e < k ? slot[e] : -1;
      v[j] = e < k ? val[e] : 0.0f;
    }
    int pt = prev[0], rep_t = dup[0];
    float yi = ys[0], qi = qs[0], ai = acts[0], a0t = a0[0];
    for (int t = 0; t < m; ++t) {
      const float a = pt >= 0 ? arun[pt] : a0t;
      float g[ELL_LANE_ENTRIES];  // w at the lane's slots, before update t
#pragma unroll
      for (int j = 0; j < ELL_LANE_ENTRIES; ++j)
        g[j] = sl[j] >= 0 ? wt[sl[j]] : 0.0f;
      float part = 0.0f;
#pragma unroll
      for (int j = 0; j < ELL_LANE_ENTRIES; ++j)
        if (sl[j] >= 0) part += g[j] * v[j];
      int pt_n = -1, rep_n = 0;
      float y_n = 1.0f, q_n = 1.0f, act_n = 1.0f, a0_n = 0.0f;
      if (t + 1 < m) {
        const int* sn = slot + (t + 1) * k;
        const float* vn = val + (t + 1) * k;
#pragma unroll
        for (int j = 0; j < ELL_LANE_ENTRIES; ++j) {
          const int e = lane + j * 32;
          nsl[j] = e < k ? sn[e] : -1;
          nv[j] = e < k ? vn[e] : 0.0f;
        }
        pt_n = prev[t + 1];
        rep_n = dup[t + 1];
        y_n = ys[t + 1];
        q_n = qs[t + 1];
        act_n = acts[t + 1];
        a0_n = a0[t + 1];
      }
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      float dl = dcd_delta(L, a, yi * part, qi);
      if (!(ai > 0.0f)) dl = 0.0f;
      if (lane == 0) arun[t] = a + dl;
      const float sc = dl * yi;
      if (sc != 0.0f) {
        if (!rep_t) {  // distinct slots: no lane wrote ours
#pragma unroll
          for (int j = 0; j < ELL_LANE_ENTRIES; ++j)
            if (sl[j] >= 0) wt[sl[j]] = g[j] + sc * v[j];
        } else if (lane == 0) {  // a repeated column: one lane, slot order
          const int* st = slot + t * k;
          const float* vt = val + t * k;
          for (int e = 0; e < k; ++e)
            if (st[e] >= 0) wt[st[e]] = wt[st[e]] + sc * vt[e];
        }
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < ELL_LANE_ENTRIES; ++j) {
        sl[j] = nsl[j];
        v[j] = nv[j];
      }
      pt = pt_n;
      rep_t = rep_n;
      yi = y_n;
      qi = q_n;
      ai = act_n;
      a0t = a0_n;
    }
  }
  __syncthreads();

  // 3. epilogue: α at each id's last update (a warp an id), the touched
  // w back
  for (int t = warp; t < m; t += nwarps) {
    bool later = false;
    for (int s0 = t + 1; s0 < m; s0 += 32) {
      const int s = s0 + lane;
      later |= __any_sync(0xffffffffu, s < m && ids[s] == ids[t]);
    }
    if (lane == 0 && !later) alpha[ids[t]] = arun[t];
  }
  // the pair's Δw slice (its touched columns), or w in place
  float* dws =
      dw ? dw + (task * gridDim.x + blockIdx.x) * (long long)(d + 1) : nullptr;
  for (int s = tid; s < slots; s += nt) {
    const int c = key[s];
    if (c >= 0) {
      if (dws)
        dws[c] = wt[s] - w[c];
      else
        w[c] = wt[s];
    }
  }
}

__global__ void dcd_ell_kernel(const int* __restrict__ idx, int m,
                               long long n_loc, const int* __restrict__ cols,
                               const float* __restrict__ vals, int k, int d,
                               float* alpha, const float* __restrict__ q,
                               const float* __restrict__ act,
                               const float* __restrict__ y, float* w,
                               DcdLoss L, long long idx_ts, long long row_ts,
                               long long act_ts) {
  // data shard blockIdx.x of task blockIdx.y: its ids, its rows, its α, y
  // and act, its replica of w
  const long long task = blockIdx.y;
  const long long row0 = (long long)blockIdx.x * n_loc;
  idx += task * idx_ts + (long long)blockIdx.x * m;
  alpha += task * row_ts;
  if (y) y += task * row_ts;
  if (act) act += task * act_ts;
  w += (task * gridDim.x + blockIdx.x) * (long long)(d + 1);
  for (int t = 0; t < m; ++t) {
    const long long i = row0 + idx[t];
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

// Plain C entries for ctypes.  act, y and dw may be null.  `shards` ×
// `tasks` CTAs run one (data shard, task) pair each (see the notes at the
// top).  Each returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a layout the kernel cannot take.
extern "C" int dcd_ell_launch(const int* idx, int m, int shards,
                              long long n_loc, const int* cols,
                              const float* vals, int k, int d, float* alpha,
                              const float* q, const float* act,
                              const float* y, float* w, int kind, float C,
                              float inv_two_c, float eps_c, int newton_steps,
                              int threads, int tasks, long long idx_ts,
                              long long row_ts, long long act_ts,
                              void* stream) {
  if (shards < 1 || shards > 65535 || tasks < 1 || tasks > 65535)
    return (int)cudaErrorInvalidValue;
  const DcdLoss L{kind, C, inv_two_c, eps_c, newton_steps};
  dcd_ell_kernel<<<dim3(shards, tasks), threads, 0, (cudaStream_t)stream>>>(
      idx, m, n_loc, cols, vals, k, d, alpha, q, act, y, w, L, idx_ts, row_ts,
      act_ts);
  return (int)cudaGetLastError();
}

extern "C" int dcd_ell_staged_launch(
    const int* idx, int m, int shards, long long n_loc, const int* cols,
    const float* vals, int k, int d, float* alpha, const float* q,
    const float* act, const float* y, float* w, long long w_stride,
    float* dw, int kind, float C, float inv_two_c, float eps_c,
    int newton_steps, int slots, int threads, int smem_bytes, int tasks,
    long long idx_ts, long long row_ts, long long act_ts, long long w_ts,
    void* stream) {
  // the bytes the kernel carves (repro_torch/dist/mesh.py:
  // dcd_ell_staged_bytes): the table's keys and w, the block's slots and
  // values, eight m-word arrays; a table with room for every entry.  More
  // than one (shard, task) pair writes Δw slices, never w in place.
  const long long entries = (long long)m * k;
  const long long need = 8LL * slots + 8LL * entries + 32LL * m;
  if (slots < 32 || (slots & (slots - 1)) != 0 || slots < entries ||
      k > ELL_LANE_ENTRIES * 32 || threads < 32 || threads % 32 != 0 ||
      threads > 1024 || smem_bytes < need || shards < 1 || shards > 65535 ||
      tasks < 1 || tasks > 65535 || ((shards > 1 || tasks > 1) && !dw))
    return (int)cudaErrorInvalidValue;
  static int smem_set = 0;  // the limit raised so far (this process)
  if (smem_bytes > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dcd_ell_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem_bytes;
  }
  const DcdLoss L{kind, C, inv_two_c, eps_c, newton_steps};
  dcd_ell_staged_kernel<<<dim3(shards, tasks), threads, smem_bytes,
                          (cudaStream_t)stream>>>(
      idx, m, n_loc, cols, vals, k, d, alpha, q, act, y, w, w_stride, dw, L,
      slots, idx_ts, row_ts, act_ts, w_ts);
  return (int)cudaGetLastError();
}
