#!/usr/bin/env python3
"""The floor of one B3 update's dependent chain on the card, from the
latencies of the instructions on it, measured one warp alone.

    python3 scripts/b3_chain_floor.py

An update of B3's stream kernel at covtype's width (W = 2 words of w a
lane, ``csrc/dcd_block.cu``: ``stream_update``) is one dependent chain:
the dot (a multiply and an add), a 5-step xor-shuffle butterfly (a
shuffle and an add a step), δ (``csrc/dcd_delta.cuh``: ``dcd_delta``, as
compiled, IEEE division included) and the axpy (a multiply and an add).
A probe kernel, built here with the port's nvcc flags, times each piece
as a chain of ``ITERS`` dependent copies in one warp with ``clock64``:

  fadd      v = v + c
  fmul      v = v * c
  shfl_fadd v = v + shfl_xor(v, 1)        one butterfly step
  delta_*   v = dcd_delta(L, a, v, q_i)   hinge and logistic δ (α = 0.03,
                                          C = 0.0625, q_i = 0.5 formed
                                          anew each step, as a row's q
                                          is; the loss a compile-time
                                          constant, as in the kernel)

The floor is fmul + fadd + 5·shfl_fadd + delta_hinge + fmul + fadd
cycles.  The SM clock is read from the probe's cycles over its CUDA-event
time.  Prints the card's name and power limit, each latency,
the floor in cycles and ns, and a JSON object of them.  Needs one CUDA
card and nvcc.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ITERS = 1 << 16

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
  out[lane] = sink;
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

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    inp = torch.rand(131, generator=gen) * 0.2
    inp[0], inp[1], inp[2] = 0.0, 0.03, 0.5  # c, α, q (covtype-like)
    inp = inp.to(dev)
    out = torch.zeros(32, device=dev)
    cyc = torch.zeros(5, dtype=torch.int64, device=dev)
    hinge = DcdLoss(*kernel_params(duals.Hinge(0.0625)))
    logistic = DcdLoss(*kernel_params(duals.Logistic(0.0625)))
    names = ["fadd", "fmul", "shfl_fadd", "delta_hinge", "delta_logistic"]
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
    floor = (2 * lat["fmul"] + 2 * lat["fadd"] + 5 * lat["shfl_fadd"]
             + lat["delta_hinge"])
    for k, v in lat.items():
        print(f"  {k}: {v:.2f} cycles")
    print(f"  SM clock over the probe: {mhz:.0f} MHz")
    print(f"  floor of one hinge update: fmul + fadd + 5 shfl_fadd + "
          f"delta_hinge + fmul + fadd = {floor:.2f} cycles, "
          f"{floor / mhz * 1e3:.2f} ns")
    print(json.dumps({"card": card, "cycles": lat, "sm_mhz": mhz,
                      "floor_cycles": floor,
                      "floor_ns": floor / mhz * 1e3}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
