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
// CTA's arithmetic: K = 1 gives the bits of the task-free grid.
//
// Pods.  The pod solver (Hybrid-DCA) runs P pods of p data shards, pod
// k's shards reading and updating pod k's own w within an epoch.  They
// are the grid's x dimension, P·p CTAs, CTA s data shard s mod p of pod
// s / p (the fleet index); the staged kernel reads its view of w at
// w + k·w_ts + (s / pod_shards)·w_stride, pod_shards = p shards a w
// (pod_shards 1: a w a shard, as above), and the wrapper sums each pod's
// p Δw slices in shard order.  The wide kernel's replicas are a pair's
// own already (the stream kernel's too).  Integer index math only: P = 1
// gives the bits of the pod-free grid.  Padding slots (col == d, value 0)
// and any column outside [0, d) are skipped, so the dummy slot w[d] stays
// exactly 0.  A δ of exactly 0 (a row at its box, or frozen) scatters
// nothing.  Three variants, chosen by shape (repro_torch/dist/mesh.py:
// dcd_ell_plan):
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
// dcd_ell_stream_kernel, for every other block: a whole epoch's order
// (serial DCD, Lock: all n ids), CoCoA's and the pod oracle's rounds, and
// webspam's 3,728-slot rows.  What bounds it is again the chain of m
// dependent updates; the wide kernel below put two dependent device-memory
// round trips, a CTA reduction, atomics and a __syncthreads on each link.
// Here, as in B3's stream kernel (dcd_block.cu):
//   - A producer warp gathers the rows by id into a ring of S stages of T
//     rows in shared memory: each row's columns and values as one bulk
//     copy (the TMA) each of the 16-byte-aligned window around them
//     (row_window: rcv1's 292-byte rows sit at any 4-byte offset; a
//     thread's cp.async copies of rows at random ids capped its rows in
//     flight), with its α, q, y and act (cp.async), all completing on the
//     stage's "full" mbarrier; the consumers release a stage on "empty".
//     So a row's loads cost the chain nothing.
//   - α is the hazard: a stage's α is copied once the stage S before it
//     is released, so an id that recurs within the last S·T positions
//     (any order of ids is allowed) finds a stale α there.  The producer
//     records each row's latest earlier position in that lookahead (off
//     the chain: ring_prev, from the last stages' ids in its registers),
//     and the consumers read the running α of that position (kept for
//     S·T positions; the last one in registers).  Every update stores
//     α_i, so the last occurrence's value stands.
//   - w in shared memory when (d + 1) floats fit beside the ring (rcv1's
//     188,948 bytes beside two stages of 32 rows): copied in once and
//     written back once, to w or the pair's replica.  Otherwise it stays
//     in device memory (webspam's 66 MB), read and written through L2
//     (ld/st.cg), never through L1, which other threads' writes do not
//     reach.
//   - Rows of at most 128 slots: one consumer warp, as in the staged
//     kernel's update loop (its entries in registers, the next row's and
//     its scalars loaded while this one runs, a butterfly, δ in every
//     lane, a plain scatter).
//   - Longer rows: up to 16 consumer warps.  Each thread issues all its
//     gathers of w (at most ELL_STREAM_LANE entries) before it uses any,
//     so one device-memory round trip serves the row.  A warp butterfly,
//     the warps' sums in warp order after a named barrier, δ in every
//     thread; the scatter (plain stores of the gathered value plus
//     δ·y·v: one write an address), and a barrier orders it before the
//     next gather.
//   - A repeated column: the wrapper flags the rows that repeat a
//     column (kernels/dcd_ell.py: row_repeats, a sort of the matrix's
//     rows, once a matrix); the producer stages a row's flag with it, and
//     a flagged row scatters from one thread in slot order, as the plain
//     version's index_add_ does.  (Finding them in the kernel cost the
//     chain: a shared-memory atomic is tens of ns on Hopper,
//     serialised, and tags written to w and read back cost two more
//     memory operations an entry.)
//   No arithmetic depends on timing: two launches give the same bits.
//
// dcd_ell_kernel, the wide variant (the first design, kept to be held
// against the others; launched when asked for, or where a row is too long
// for the stream kernel's ring): one thread per ELL slot (whole
// warps), w gathered from and scattered into device memory (atomicAdd), a
// CTA reduction and a __syncthreads between updates.  It is latency-bound
// on the dependent global round trips of each update.

#include "dcd_delta.cuh"
#include "dcd_stage.cuh"

// row entries a lane of the staged kernel's update warp holds (the plan
// gives a block the staged kernel only if k ≤ 4 · 32)
#define ELL_LANE_ENTRIES 4
#define ELL_GATHER 16  // table slots a thread gathers from w at once

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
                                      long long w_ts, int pod_shards) {
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
  w += task * w_ts + (long long)(blockIdx.x / pod_shards) * w_stride;

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

// ---- dcd_ell_stream_kernel (see the notes at the top) ----

#define ELL_STREAM_LANE 16  // row entries a lane of a long-row consumer
                            // gathers at once

// w at column c, and w[c] = v: shared memory, or device memory through
// L2 (ld/st.cg), where every other lane's scatter lands
template <bool SMEM_W>
__device__ __forceinline__ float w_load(const float* w, int c) {
  return SMEM_W ? w[c] : __ldcg(w + c);
}

template <bool SMEM_W>
__device__ __forceinline__ void w_store(float* w, int c, float v) {
  if (SMEM_W)
    w[c] = v;
  else
    __stcg(w + c, v);
}

// words of one stage of T rows of k slots: the rows' column and value
// windows (row_slot(k) words each), then the rows' id, prev,
// repeated-column flag, offsets into the two windows (2 bits each), α, q,
// y and act (T each), padded to 16 bytes
__host__ __device__ inline long long ell_stream_stage_words(int T, int k) {
  return (2LL * T * row_slot(k) + 8LL * T + 3) / 4 * 4;
}

// Shared memory: S "full" and S "empty" mbarriers, S stages, the running
// α of the last S·T positions, a partial dot a consumer warp, then w
// (d + 1 floats) when SMEM_W.  blockDim.x = 32·(consumer warps +
// 1); the last warp produces.  S·T is a power of two, S at most
// RING_MAX_STAGES, and a long row one gather a thread (k ≤ consumer
// threads · ELL_STREAM_LANE).  cols and vals hold n_x rows; rep, one int
// a row, flags the rows that repeat a column.
template <bool SMEM_W>
__global__ void dcd_ell_stream_kernel(
    const int* __restrict__ idx, const int* __restrict__ rep, int m,
    long long n_loc,
    const int* __restrict__ cols, const float* __restrict__ vals,
    long long n_x, int k, int d, float* alpha, const float* __restrict__ q,
    const float* __restrict__ act, const float* __restrict__ y, float* w,
    DcdLoss L, long long idx_ts, long long row_ts, long long act_ts, int T,
    int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int NC = (blockDim.x >> 5) - 1;
  const int nct = NC * 32;
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* empty = full + S;
  float* ring = reinterpret_cast<float*>(empty + S);
  const long long sw = ell_stream_stage_words(T, k);
  float* arun = ring + S * sw;  // α after position t, at t & stm
  float* red = arun + S * T;  // the consumer warps' partial dots
  float* wsm = red + NC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // data shard blockIdx.x of task blockIdx.y: its ids, its rows, its α, y
  // and act, its replica of w
  const long long task = blockIdx.y;
  const long long row0 = (long long)blockIdx.x * n_loc;
  idx += task * idx_ts + (long long)blockIdx.x * m;
  alpha += task * row_ts;
  if (y) y += task * row_ts;
  if (act) act += task * act_ts;
  w += (task * gridDim.x + blockIdx.x) * (long long)(d + 1);
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      // the producer's lanes, three times each: with its row's column and
      // value windows (their bytes), and once its cp.async copies land
      mbar_init(full + s, 96);
      mbar_init(empty + s, nct);  // the consumers' threads
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (SMEM_W) {
    for (int j = tid; j <= d; j += blockDim.x) cp_async4(wsm + j, w + j);
    cp_async_wait_all();
  }
  __syncthreads();
  float* wv = SMEM_W ? wsm : w;
  const int n_st = (m + T - 1) / T, stm = S * T - 1;
  const int kw = row_slot(k);
  const long long rk = (long long)T * kw;

  if (warp == NC) {
    // producer: stage kk into slot kk mod S once the consumers have
    // released the stage S before it: the ids (loaded a stage ahead),
    // each row's previous occurrence in the lookahead (ring_prev), lane
    // r's row as bulk copies of the 16-byte-aligned windows around its
    // columns and values (row_window), and cp.async copies of the rows'
    // repeated-column flags, α, q, y and act, all landing on the stage's
    // "full" mbarrier
    const int* c_end = cols + n_x * k;
    const float* v_end = vals + n_x * k;
    int id_n = lane < T && lane < m ? (int)(row0 + idx[lane]) : 0;
    int hist[RING_MAX_STAGES - 1] = {0, 0, 0};
    for (int kk = 0, s = 0, ph = 0; kk < n_st; ++kk) {
      mbar_wait(empty + s, ph ^ 1);
      const int t0 = kk * T, rows = min(T, m - t0);
      float* st = ring + s * sw;
      int* scol = reinterpret_cast<int*>(st);
      float* sval = st + rk;
      int* sid = reinterpret_cast<int*>(sval + rk);
      int* sprev = sid + T;
      int* sdup = sprev + T;
      int* soff = sdup + T;
      float* sa = reinterpret_cast<float*>(soff + T);
      float* sq = sa + T;
      float* sy = sq + T;
      float* sact = sy + T;
      const int id = id_n;
      if (kk + 1 < n_st) {
        const int tn = t0 + T + lane;
        id_n = lane < T && tn < m ? (int)(row0 + idx[tn]) : 0;
      }
      const int prev = ring_prev(id, hist, lane, rows, kk, T, S);
      if (lane < rows) {
        sid[lane] = id;
        sprev[lane] = prev;
        cp_async4(sdup + lane, rep + id);
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
        const long long src = (long long)id * k;
        // the windows' offsets, stored before the lane arrives
        soff[lane] = row_off(cols + src) | row_off(vals + src) << 2;
        row_window(scol + (long long)lane * kw, cols + src, k, cols,
                   c_end, full + s);
        row_window(sval + (long long)lane * kw, vals + src, k, vals,
                   v_end, full + s);
      } else {
        mbar_arrive(full + s);
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
  } else if (k <= ELL_LANE_ENTRIES * 32) {
    // one consumer warp, rows of at most 128 slots: each lane holds its
    // ≤ 4 entries of the row, and the next row's entries and scalars load
    // a step ahead; the gather, the dot as a butterfly, δ in every lane,
    // lane 0 storing α_i, and the scatter as plain writes of the gathered
    // values plus δ·y·v (one lane, in slot order, for a row that repeats
    // a column)
    int sl[ELL_LANE_ENTRIES], nsl[ELL_LANE_ENTRIES];
    float v[ELL_LANE_ENTRIES], nv[ELL_LANE_ENTRIES];
    float a_last = 0.0f;
    for (int kk = 0, s = 0, ph = 0; kk < n_st; ++kk) {
      mbar_wait(full + s, ph);
      const float* st = ring + s * sw;
      const int* scol = reinterpret_cast<const int*>(st);
      const float* sval = st + rk;
      const int* sid = reinterpret_cast<const int*>(sval + rk);
      const int* sprev = sid + T;
      const int* sdup = sprev + T;
      const int* soff = sdup + T;
      const float* sa = reinterpret_cast<const float*>(soff + T);
      const float* sq = sa + T;
      const float* sy = sq + T;
      const float* sact = sy + T;
      const int t0 = kk * T, rows = min(T, m - t0);
      const int* crow = scol + (soff[0] & 3);  // row 0's columns, values
      const float* vrow = sval + (soff[0] >> 2);
#pragma unroll
      for (int u = 0; u < ELL_LANE_ENTRIES; ++u) {
        const int e = lane + 32 * u;
        const int c = e < k ? crow[e] : -1;
        sl[u] = (unsigned)c < (unsigned)d ? c : -1;
        v[u] = e < k ? vrow[e] : 0.0f;
        nsl[u] = -1;
        nv[u] = 0.0f;
      }
      int i_c = sid[0], dup_c = sdup[0], pt_n = sprev[0];
      float q_c = sq[0], y_c = sy[0], act_c = sact[0];
      float a_c = pt_n < 0 ? sa[0]
                           : (pt_n == t0 - 1 ? a_last : arun[pt_n & stm]);
#pragma unroll 2
      for (int r = 0; r < rows; ++r) {
        const int t = t0 + r;
        float g[ELL_LANE_ENTRIES];  // w at the lane's columns, before t
#pragma unroll
        for (int u = 0; u < ELL_LANE_ENTRIES; ++u)
          g[u] = sl[u] >= 0 ? w_load<SMEM_W>(wv, sl[u]) : 0.0f;
        float part = 0.0f;
#pragma unroll
        for (int u = 0; u < ELL_LANE_ENTRIES; ++u)
          if (sl[u] >= 0) part += g[u] * v[u];
        const int* cnow = crow;
        const float* vnow = vrow;
        int i_n = 0, dup_n = 0;
        float q_n = 1.0f, y_n = 1.0f, act_n = 1.0f, a_pre = 0.0f;
        pt_n = -1;
        if (r + 1 < rows) {
          const int o = soff[r + 1];
          crow = scol + (r + 1) * kw + (o & 3);
          vrow = sval + (r + 1) * kw + (o >> 2);
#pragma unroll
          for (int u = 0; u < ELL_LANE_ENTRIES; ++u) {
            const int e = lane + 32 * u;
            const int c = e < k ? crow[e] : -1;
            nsl[u] = (unsigned)c < (unsigned)d ? c : -1;
            nv[u] = e < k ? vrow[e] : 0.0f;
          }
          i_n = sid[r + 1];
          dup_n = sdup[r + 1];
          pt_n = sprev[r + 1];
          q_n = sq[r + 1];
          y_n = sy[r + 1];
          act_n = sact[r + 1];
          a_pre = pt_n >= 0 && pt_n != t ? arun[pt_n & stm] : sa[r + 1];
        }
        for (int o = 16; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        float dl = dcd_delta(L, a_c, y_c * part, q_c);
        if (!(act_c > 0.0f)) dl = 0.0f;
        a_last = a_c + dl;
        if (lane == 0) {
          arun[t & stm] = a_last;
          alpha[i_c] = a_last;
        }
        const float sc = dl * y_c;
        if (sc != 0.0f) {
          if (!dup_c) {  // distinct columns: no lane wrote ours
#pragma unroll
            for (int u = 0; u < ELL_LANE_ENTRIES; ++u)
              if (sl[u] >= 0) w_store<SMEM_W>(wv, sl[u], g[u] + sc * v[u]);
          } else if (lane == 0) {  // a repeated column: one lane, slot order
            for (int e = 0; e < k; ++e) {
              const int c = cnow[e];
              if ((unsigned)c < (unsigned)d)
                w_store<SMEM_W>(wv, c, w_load<SMEM_W>(wv, c) + sc * vnow[e]);
            }
          }
        }
        __syncwarp();
#pragma unroll
        for (int u = 0; u < ELL_LANE_ENTRIES; ++u) {
          sl[u] = nsl[u];
          v[u] = nv[u];
        }
        i_c = i_n;
        dup_c = dup_n;
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
  } else {
    // NC consumer warps, rows of more than 128 slots: each thread issues
    // its gathers of w (≤ ELL_STREAM_LANE entries) before it uses any,
    // so one round trip serves the row; a warp butterfly, the warps' sums
    // in warp order after a named barrier, δ in every thread, the scatter
    // as plain writes (one thread, in slot order, for a row that repeats
    // a column), and a second barrier before the next row's gather
    float a_last = 0.0f;
    for (int kk = 0, s = 0, ph = 0; kk < n_st; ++kk) {
      mbar_wait(full + s, ph);
      const float* st = ring + s * sw;
      const int* scol = reinterpret_cast<const int*>(st);
      const float* sval = st + rk;
      const int* sid = reinterpret_cast<const int*>(sval + rk);
      const int* sprev = sid + T;
      const int* sdup = sprev + T;
      const int* soff = sdup + T;
      const float* sa = reinterpret_cast<const float*>(soff + T);
      const float* sq = sa + T;
      const float* sy = sq + T;
      const float* sact = sy + T;
      const int t0 = kk * T, rows = min(T, m - t0);
      for (int r = 0; r < rows; ++r) {
        const int t = t0 + r;
        const int* cr = scol + r * kw + (soff[r] & 3);
        const float* vr = sval + r * kw + (soff[r] >> 2);
        int c[ELL_STREAM_LANE];
        float v[ELL_STREAM_LANE], g[ELL_STREAM_LANE];
#pragma unroll
        for (int u = 0; u < ELL_STREAM_LANE; ++u) {
          const int e = tid + nct * u;
          const int cc = e < k ? cr[e] : -1;
          c[u] = (unsigned)cc < (unsigned)d ? cc : -1;
          v[u] = e < k ? vr[e] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < ELL_STREAM_LANE; ++u)
          g[u] = c[u] >= 0 ? w_load<SMEM_W>(wv, c[u]) : 0.0f;
        const int pt = sprev[r];
        const float a =
            pt < 0 ? sa[r] : (pt == t - 1 ? a_last : arun[pt & stm]);
        const float yi = sy[r], qi = sq[r], ai = sact[r];
        const int i = sid[r], dup = sdup[r];
        float part = 0.0f;
#pragma unroll
        for (int u = 0; u < ELL_STREAM_LANE; ++u)
          if (c[u] >= 0) part += g[u] * v[u];
        for (int o = 16; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        if (lane == 0) red[warp] = part;
        asm volatile("bar.sync 1, %0;\n" ::"r"(nct) : "memory");
        float dot = 0.0f;
        for (int j = 0; j < NC; ++j) dot += red[j];
        float dl = dcd_delta(L, a, yi * dot, qi);
        if (!(ai > 0.0f)) dl = 0.0f;
        a_last = a + dl;
        if (tid == 0) {
          arun[t & stm] = a_last;
          alpha[i] = a_last;
        }
        const float sc = dl * yi;
        if (sc != 0.0f) {
          if (!dup) {  // distinct columns: one write an address
#pragma unroll
            for (int u = 0; u < ELL_STREAM_LANE; ++u)
              if (c[u] >= 0) w_store<SMEM_W>(wv, c[u], g[u] + sc * v[u]);
          } else if (tid == 0) {  // a repeated column: one thread, in order
            for (int e = 0; e < k; ++e) {
              const int cc = cr[e];
              if ((unsigned)cc < (unsigned)d)
                w_store<SMEM_W>(wv, cc, w_load<SMEM_W>(wv, cc) + sc * vr[e]);
            }
          }
        }
        asm volatile("bar.sync 1, %0;\n" ::"r"(nct) : "memory");
      }
      mbar_arrive(empty + s);
      if (++s == S) {
        s = 0;
        ph ^= 1;
      }
    }
  }
  if (SMEM_W) {  // w back, to w or the pair's replica
    __syncthreads();
    for (int j = tid; j <= d; j += blockDim.x) w[j] = wsm[j];
  }
}

// Plain C entries for ctypes.  act, y and dw may be null.  `shards` ×
// `tasks` CTAs run one (data shard, task) pair each (see the notes at the
// top); the wide and stream kernels update w in place, a replica a pair.
// Each returns cudaGetLastError() after the launch (0 = launched), or
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
    int pod_shards, void* stream) {
  // the bytes the kernel carves (repro_torch/dist/mesh.py:
  // dcd_ell_staged_bytes): the table's keys and w, the block's slots and
  // values, eight m-word arrays; a table with room for every entry.  More
  // than one (shard, task) pair writes Δw slices, never w in place.
  const long long entries = (long long)m * k;
  const long long need = 8LL * slots + 8LL * entries + 32LL * m;
  if (slots < 32 || (slots & (slots - 1)) != 0 || slots < entries ||
      k > ELL_LANE_ENTRIES * 32 || threads < 32 || threads % 32 != 0 ||
      threads > 1024 || smem_bytes < need || shards < 1 || shards > 65535 ||
      tasks < 1 || tasks > 65535 || ((shards > 1 || tasks > 1) && !dw) ||
      pod_shards < 1 || shards % pod_shards != 0)
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
      slots, idx_ts, row_ts, act_ts, w_ts, pod_shards);
  return (int)cudaGetLastError();
}

template <bool SMEM_W>
static int ell_stream_launch(const int* idx, const int* rep, int m,
                             int shards,
                             long long n_loc, const int* cols,
                             const float* vals, long long n_x, int k, int d,
                             float* alpha,
                             const float* q, const float* act,
                             const float* y, float* w, const DcdLoss& L,
                             int warps, int T, int S, int smem_bytes,
                             int tasks, long long idx_ts,
                             long long row_ts, long long act_ts,
                             cudaStream_t st) {
  static int smem_set = 0;  // the limit raised so far (this process)
  if (smem_bytes > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dcd_ell_stream_kernel<SMEM_W>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem_bytes;
  }
  dcd_ell_stream_kernel<SMEM_W><<<dim3(shards, tasks), 32 * (warps + 1),
                                  smem_bytes, st>>>(
      idx, rep, m, n_loc, cols, vals, n_x, k, d, alpha, q, act, y, w, L,
      idx_ts, row_ts, act_ts, T, S);
  return (int)cudaGetLastError();
}

extern "C" int dcd_ell_stream_launch(
    const int* idx, const int* rep, int m, int shards, long long n_loc,
    const int* cols,
    const float* vals, long long n_x, int k, int d, float* alpha,
    const float* q,
    const float* act, const float* y, float* w, int kind, float C,
    float inv_two_c, float eps_c, int newton_steps, int warps,
    int tile_rows, int stages, int w_shared, int smem_bytes,
    int tasks, long long idx_ts, long long row_ts, long long act_ts,
    void* stream) {
  // the bytes the kernel carves (repro_torch/dist/mesh.py:
  // dcd_ell_stream_bytes): two mbarriers a stage, the stages, the running
  // α of S·T positions, a partial dot a consumer warp, and w when it is
  // staged.  Rows of at most 128 slots take one consumer warp;
  // a longer row is one gather a consumer thread.
  const long long S = stages, T = tile_rows;
  const long long need = 16 * S +
                         4 * S * ell_stream_stage_words(tile_rows, k) +
                         4 * S * T + 4LL * warps +
                         (w_shared ? 4LL * (d + 1) : 0);
  if (m < 1 || k < 1 || d < 0 || warps < 1 || warps > 31 ||
      (k <= ELL_LANE_ENTRIES * 32 && warps != 1) ||
      (k > ELL_LANE_ENTRIES * 32 && k > 32LL * warps * ELL_STREAM_LANE) ||
      T < 1 || T > 32 || S < 2 || S > RING_MAX_STAGES ||
      ((S * T) & (S * T - 1)) != 0 || smem_bytes < need || shards < 1 ||
      shards > 65535 || tasks < 1 || tasks > 65535)
    return (int)cudaErrorInvalidValue;
  const DcdLoss L{kind, C, inv_two_c, eps_c, newton_steps};
  cudaStream_t st = (cudaStream_t)stream;
  return w_shared
             ? ell_stream_launch<true>(idx, rep, m, shards, n_loc, cols, vals,
                                       n_x, k, d, alpha, q, act, y, w, L,
                                       warps, tile_rows, stages, smem_bytes,
                                       tasks, idx_ts, row_ts, act_ts, st)
             : ell_stream_launch<false>(idx, rep, m, shards, n_loc, cols,
                                        vals,
                                        n_x, k, d, alpha, q, act, y, w, L,
                                        warps, tile_rows, stages, smem_bytes,
                                        tasks, idx_ts, row_ts, act_ts, st);
}
