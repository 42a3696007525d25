#!/usr/bin/env python3
"""The floor of one update's dependent chain on the card, for B3's and
B2's stream kernels, for B1's stream kernel at rcv1's and webspam's rows,
for B2's and B3's split kernel at the LM probe's 5,120 floats and for a
step of B5's rows-layout recursion, from the latencies of the
instructions on it, measured alone.

    python3 scripts/b3_chain_floor.py

An update of B3's stream kernel at covtype's width (W = 2 words of w a
lane, ``csrc/dcd_block.cu``: ``stream_update``) is one dependent chain:
the dot (a multiply and an add), a 5-step xor-shuffle butterfly (a
shuffle and an add a step), δ (``csrc/dcd_delta.cuh``: ``dcd_delta``, as
compiled, IEEE division included) and the axpy (a multiply and an add).
B2's stream kernel (the same consumer, fed by id) adds the label: y·dot
before δ and δ·y after it.  A probe kernel, built here with the port's
nvcc flags, times each piece as a chain of ``ITERS`` dependent copies in
one warp with ``clock64``:

  fadd      v = v + c
  fmul      v = v * c
  shfl_fadd v = v + shfl_xor(v, 1)        one butterfly step
  delta_*   v = dcd_delta(L, a, v, q_i)   hinge and logistic δ (α = 0.03,
                                          C = 0.0625, q_i = 0.5 formed
                                          anew each step, as a row's q
                                          is; the loss a compile-time
                                          constant, as in the kernel)
  smem_rt   a lane stores v to shared memory, __syncwarp, v = another
            lane's word + c (a scatter, the update's barrier, the next
            gather of the same word, the scatter's add)

and, in a second probe of eight warps (the stream kernel's consumers at
webspam's 3,728-slot rows, ``csrc/dcd_ell.cu``), from thread 0:

  bar       v = v + c, then a named barrier of the 256 threads
  cross     lane 0 of each warp stores its sum, a named barrier, every
            thread sums the eight in order (the warps' dot)
  hbm       one thread's dependent loads (ld.global.cg) over a random
            cycle through 256 MB (a gather of w that misses L2, as
            webspam's 66 MB w does)

The floors: B3's, fmul + fadd + 5·shfl_fadd + delta_hinge + fmul + fadd
cycles; B2 stream's, B3's + 2·fmul; B1 stream's at rcv1's rows (w in
shared memory, ≤ 3 entries a lane), smem_rt + fmul + 3·fadd + 5·shfl_fadd
+ fmul + delta_hinge + 2·fmul (the scatter's add and store, the
warp's barrier and the next gather are smem_rt; the tags' round trip runs
beside the butterfly); at webspam's rows (w in device memory, 15 entries
a thread), hbm + fmul + 15·fadd + 5·shfl_fadd + cross + fmul +
delta_hinge + 2·fmul + fmul + fadd + bar (the gather, the dot, the
warps' sum, δ, the scatter and the barrier before the next gather; the
stores' acknowledgements are not counted).  A third probe of
``SPLIT_WARPS`` warps times the split kernel's exchange, ``xchg_split``
(a store to a slot of 16 partials, a named barrier of the warps, four
float4 loads and a 15-add tree; the loop's multiply subtracted): the
split floor at 5,120 floats is fmul + 4·fadd + 5·shfl_fadd + xchg_split
+ fmul + delta_hinge + 3·fmul + fadd, a B5 rows step 2·fadd + 2·fmul +
delta_hinge + shfl_fadd + fmul.  The SM clock is read from
the first probe's cycles over its CUDA-event time.  Prints the card's name
and power limit, each latency, the floors in cycles and ns, and a JSON
object of them.  Needs one CUDA card and nvcc.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ITERS = 1 << 16
HBM_ITERS = 1 << 12
HBM_WORDS = 1 << 26  # 256 MB of int32: past the 50 MB L2
SPLIT_WARPS = 10  # the split kernel's consumer warps at 5,120 floats

PROBE = r"""
#include "dcd_delta.cuh"

__device__ __forceinline__ float shfl_fadd(float v) {
  return v + __shfl_xor_sync(0xffffffffu, v, 1);
}

// the loss as a compile-time constant, as the stream kernel has it
__device__ __forceinline__ DcdLoss with_kind(int kind, const DcdLoss& L) {
  return DcdLoss{kind, L.C, L.inv_two_c, L.eps_c, L.newton_steps};
}

// cycles[k] = clock64 cycles of ITERS dependent copies of piece k
extern "C" __global__ void chain_probe(int iters, const float* in,
                                       float* out, long long* cycles,
                                       DcdLoss h, DcdLoss l) {
  const DcdLoss hinge = with_kind(DCD_HINGE, h);
  const DcdLoss logistic = with_kind(DCD_LOGISTIC, l);
  const int lane = threadIdx.x;
  const float c = in[0], a = in[1], q = in[2];
  float v = in[3 + lane], sink = 0.0f;
  long long t;
#define PROBE_CHAIN(k, body)                 \
  v = in[3 + lane];                          \
  t = clock64();                             \
  for (int i = 0; i < iters; ++i) { body; }  \
  cycles[k] = clock64() - t;                 \
  sink += v;
  PROBE_CHAIN(0, v = v + c)
  PROBE_CHAIN(1, v = v * c)
  PROBE_CHAIN(2, v = shfl_fadd(v))
  // q changes every step, as a row's does (c = 0: the value stays q, but
  // its reciprocal cannot leave the loop)
  PROBE_CHAIN(3, v = dcd_delta(hinge, a, v, q + c * (float)(i & 7)))
  PROBE_CHAIN(4, v = dcd_delta(logistic, a, v, q + c * (float)(i & 7)))
  __shared__ float sm[32];
  PROBE_CHAIN(5, sm[lane] = v; __syncwarp(); v = sm[(lane + 1) & 31] + c)
  out[lane] = sink;
}

// eight warps, thread 0's cycles: cycles[k] for piece k of the long rows'
// chain; chase is a random cycle of int32 offsets through 256 MB
extern "C" __global__ void chain_probe_wide(int iters, int hbm_iters,
                                            const int* chase, float* out,
                                            long long* cycles, float c) {
  __shared__ float red[8];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float v = 1.0f;
  long long t = clock64();
  for (int i = 0; i < iters; ++i) {
    v = v + c;
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
  }
  if (tid == 0) cycles[0] = clock64() - t;
  t = clock64();
  for (int i = 0; i < iters; ++i) {
    if (lane == 0) red[warp] = v;
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    float s = 0.0f;
    for (int j = 0; j < 8; ++j) s += red[j];
    v = s;
  }
  if (tid == 0) cycles[1] = clock64() - t;
  if (tid == 0) {
    int j = 0;
    t = clock64();
    for (int i = 0; i < hbm_iters; ++i) j = __ldcg(chase + j);
    cycles[2] = clock64() - t;
    v += (float)j;
  }
  out[tid] = v;
}

// the sum of p[O .. O + N) as the split kernel sums its partials
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

// the split kernel's exchange (csrc/dcd_block.cu: dcd_dense_split_kernel)
// over `warps` consumer warps, thread 0's cycles: lane 0 of each warp
// stores its partial to the update's slot of 16, a named barrier of the
// warps, every lane reads the slot as four float4 and sums it in a fixed
// tree (the warps' dot)
extern "C" __global__ void chain_probe_split(int iters, float* out,
                                             long long* cycles, float c) {
  __shared__ __align__(16) float part[2][16];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  if (tid < 32) part[tid >> 4][tid & 15] = 0.0f;
  __syncthreads();
  float v = c;
  long long t = clock64();
  for (int i = 0; i < iters; ++i) {
    float* slot = part[i & 1];
    if (lane == 0) slot[warp] = v;
    asm volatile("bar.sync 1, %0;\n" ::"r"(nthreads) : "memory");
    float p[16];
#pragma unroll
    for (int k = 0; k < 16; k += 4) {
      const float4 f = *reinterpret_cast<const float4*>(slot + k);
      p[k] = f.x;
      p[k + 1] = f.y;
      p[k + 2] = f.z;
      p[k + 3] = f.w;
    }
    v = TreeSum<16>::of(p) * 1e-3f;
  }
  if (tid == 0) cycles[0] = clock64() - t;
  out[tid] = v;
}

extern "C" int chain_probe_split_launch(int iters, int warps, float* out,
                                        long long* cycles, float c) {
  chain_probe_split<<<1, 32 * warps>>>(iters, out, cycles, c);
  return (int)cudaGetLastError();
}

extern "C" int chain_probe_wide_launch(int iters, int hbm_iters,
                                       const int* chase, float* out,
                                       long long* cycles, float c) {
  chain_probe_wide<<<1, 256>>>(iters, hbm_iters, chase, out, cycles, c);
  return (int)cudaGetLastError();
}

extern "C" int chain_probe_launch(int iters, const float* in, float* out,
                                  long long* cycles, DcdLoss* hinge,
                                  DcdLoss* logistic) {
  chain_probe<<<1, 32>>>(iters, in, out, cycles, *hinge, *logistic);
  return (int)cudaGetLastError();
}
"""


class DcdLoss(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int), ("C", ctypes.c_float),
                ("inv_two_c", ctypes.c_float), ("eps_c", ctypes.c_float),
                ("newton_steps", ctypes.c_int)]


def main():
    import torch

    if not torch.cuda.is_available():
        print("b3_chain_floor: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import card_line
    from repro_torch.core import duals
    from repro_torch.core.duals import kernel_params
    from repro_torch.kernels import build

    card = card_line()
    print(card)
    out_dir = build.build_dir() / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "b3_chain_probe.cu", out_dir / "libb3_chain_probe.so"
    src.write_text(PROBE)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(lib), str(src)], check=True)
    so = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    so.chain_probe_launch.argtypes = [I, P, P, P, ctypes.POINTER(DcdLoss),
                                      ctypes.POINTER(DcdLoss)]
    so.chain_probe_launch.restype = I
    so.chain_probe_wide_launch.argtypes = [I, I, P, P, P, ctypes.c_float]
    so.chain_probe_wide_launch.restype = I
    so.chain_probe_split_launch.argtypes = [I, I, P, P, ctypes.c_float]
    so.chain_probe_split_launch.restype = I

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    inp = torch.rand(131, generator=gen) * 0.2
    inp[0], inp[1], inp[2] = 0.0, 0.03, 0.5  # c, α, q (covtype-like)
    inp = inp.to(dev)
    out = torch.zeros(32, device=dev)
    cyc = torch.zeros(6, dtype=torch.int64, device=dev)
    hinge = DcdLoss(*kernel_params(duals.Hinge(0.0625)))
    logistic = DcdLoss(*kernel_params(duals.Logistic(0.0625)))
    names = ["fadd", "fmul", "shfl_fadd", "delta_hinge", "delta_logistic",
             "smem_rt"]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(2):  # the second run is kept (the first warms up)
        start.record()
        build.check(so.chain_probe_launch(ITERS, inp.data_ptr(),
                                          out.data_ptr(), cyc.data_ptr(),
                                          ctypes.byref(hinge),
                                          ctypes.byref(logistic)),
                    "chain_probe")
        end.record()
        torch.cuda.synchronize()
    lat = {k: v / ITERS for k, v in zip(names, cyc.tolist())}
    mhz = sum(cyc.tolist()) / (start.elapsed_time(end) * 1e3)
    # the long rows' probe: a random cycle through HBM_WORDS offsets
    perm = torch.randperm(HBM_WORDS, generator=gen).to(dev)
    chase = torch.empty(HBM_WORDS, dtype=torch.int32, device=dev)
    chase[perm] = torch.roll(perm, -1).int()
    del perm
    out = torch.zeros(256, device=dev)
    cw = torch.zeros(3, dtype=torch.int64, device=dev)
    for _ in range(2):
        build.check(so.chain_probe_wide_launch(
            ITERS, HBM_ITERS, chase.data_ptr(), out.data_ptr(),
            cw.data_ptr(), 0.0), "chain_probe_wide")
        torch.cuda.synchronize()
    wide = cw.tolist()
    lat.update(bar=wide[0] / ITERS - lat["fadd"], cross=wide[1] / ITERS,
               hbm=wide[2] / HBM_ITERS)
    # the split kernel's exchange at the probe's 10 consumer warps
    cs = torch.zeros(1, dtype=torch.int64, device=dev)
    out = torch.zeros(32 * SPLIT_WARPS, device=dev)
    for _ in range(2):
        build.check(so.chain_probe_split_launch(
            ITERS, SPLIT_WARPS, out.data_ptr(), cs.data_ptr(), 0.5),
            "chain_probe_split")
        torch.cuda.synchronize()
    lat["xchg_split"] = cs.item() / ITERS - lat["fmul"]
    L = lat
    floors = {
        "b3": 2 * L["fmul"] + 2 * L["fadd"] + 5 * L["shfl_fadd"]
        + L["delta_hinge"]}
    floors["b2_stream"] = floors["b3"] + 2 * L["fmul"]
    floors["b1_stream_rcv1"] = (L["smem_rt"] + L["fmul"] + 3 * L["fadd"]
                                + 5 * L["shfl_fadd"] + L["fmul"]
                                + L["delta_hinge"] + 2 * L["fmul"])
    floors["b1_stream_webspam"] = (
        L["hbm"] + L["fmul"] + 15 * L["fadd"] + 5 * L["shfl_fadd"]
        + L["cross"] + L["fmul"] + L["delta_hinge"] + 3 * L["fmul"]
        + L["fadd"] + L["bar"])
    # B2's and B3's split kernel at the probe's 5,120 floats (16 words a
    # lane over 10 warps): the products and a 4-level tree, the butterfly,
    # the exchange, y·dot, δ, δ·y and the axpy
    floors["split_5120"] = (
        L["fmul"] + 4 * L["fadd"] + 5 * L["shfl_fadd"] + L["xchg_split"]
        + L["fmul"] + L["delta_hinge"] + L["fmul"] + L["fmul"] + L["fadd"])
    # B5's rows-layout serial step (csrc/dcd_feature.cu:
    # dcd_feature_recursion_panel_kernel): base + acc, y·(…), δ, δ·y, the
    # shuffle of δ̃ to every lane, δ̃·G and the add into acc
    floors["b5_rows_step"] = (
        2 * L["fadd"] + 2 * L["fmul"] + L["delta_hinge"]
        + L["shfl_fadd"] + L["fmul"])
    for k, v in lat.items():
        print(f"  {k}: {v:.2f} cycles")
    print(f"  SM clock over the probe: {mhz:.0f} MHz")
    print(f"  floor of one hinge update (B3): fmul + fadd + 5 shfl_fadd + "
          f"delta_hinge + fmul + fadd = {floors['b3']:.2f} cycles, "
          f"{floors['b3'] / mhz * 1e3:.2f} ns")
    for k in ("b2_stream", "b1_stream_rcv1", "b1_stream_webspam",
              "split_5120", "b5_rows_step"):
        print(f"  floor of one hinge update ({k}): {floors[k]:.2f} cycles, "
              f"{floors[k] / mhz * 1e3:.2f} ns")
    print(json.dumps({"card": card, "cycles": lat, "sm_mhz": mhz,
                      "floor_cycles": floors["b3"],
                      "floor_ns": floors["b3"] / mhz * 1e3,
                      "floors_ns": {k: v / mhz * 1e3
                                    for k, v in floors.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
