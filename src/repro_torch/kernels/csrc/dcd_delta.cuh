// Device side of one DCD coordinate update, shared by the DCD kernels
// (dcd_ell.cu, dcd_block.cu, and B5 in dcd_feature.cu): the exact 1-D dual step δ for the
// hinge, squared-hinge and logistic losses, and the CTA-wide middle of an
// update (reduce the dot, take δ, write α_i, broadcast δ·y_i).
//
// δ is the one definition the kernels share, as the Pallas kernels share
// repro/core/duals.py's loss.delta; it is held to
// repro_torch/core/duals.py operation for operation: the same clamp
// order, the same float32 constants (the host forms 1/(2C) and 1e-12·C in
// double and rounds once, as a Python-float constant rounds into a
// float32 expression), logf for jnp.log / torch.log.  The kernels build
// with --fmad=false so no a + b·c is contracted into an FMA that the
// plain version does not take.
#pragma once

#include <cuda_runtime.h>

#define DCD_HINGE 0
#define DCD_SQUARED_HINGE 1
#define DCD_LOGISTIC 2

#define DCD_EPS 1e-12f
#define DCD_MAX_WARPS 32

struct DcdLoss {
  int kind;          // DCD_HINGE, DCD_SQUARED_HINGE or DCD_LOGISTIC
  float C;           // the box / loss scale
  float inv_two_c;   // 1/(2C)
  float eps_c;       // 1e-12·C, the logistic domain margin
  int newton_steps;  // logistic Newton iterations (20)
};

// jnp.clip: min(max(x, lo), hi)
__device__ __forceinline__ float dcd_clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// The exact minimiser δ of the one-variable dual subproblem at α, given
// wx = wᵀx_i and q = ‖x_i‖² (repro_torch/core/duals.py: *.delta).
__device__ __forceinline__ float dcd_delta(const DcdLoss& L, float alpha,
                                           float wx, float q) {
  q = fmaxf(q, DCD_EPS);
  if (L.kind == DCD_HINGE) {
    const float nw = dcd_clip(alpha + (1.0f - wx) / q, 0.0f, L.C);
    return nw - alpha;
  }
  if (L.kind == DCD_SQUARED_HINGE) {
    const float denom = q + L.inv_two_c;
    const float nw =
        fmaxf(alpha + (1.0f - wx - alpha / (2.0f * L.C)) / denom, 0.0f);
    return nw - alpha;
  }
  // logistic: safeguarded Newton on
  //   g'(δ) = wx + δ·q + log(α+δ) − log(C−α−δ),  g'' = q + C/((α+δ)(C−α−δ))
  const float C = L.C;
  const float lo = -alpha + L.eps_c;
  const float hi = (C - alpha) - L.eps_c;
  float delta = 0.0f;
  for (int s = 0; s < L.newton_steps; ++s) {
    const float a = alpha + delta;
    const float g1 = wx + delta * q + logf(a) - logf(C - a);
    const float g2 = q + C / fmaxf(a * (C - a), DCD_EPS);
    delta = dcd_clip(delta - g1 / g2, lo, hi);
  }
  return delta;
}

// The middle of update i, run by every thread of the CTA (blockDim.x a
// multiple of 32, at most 1024): sum the threads' partial dots `part`,
// let thread 0 fold the label (wx = y_i·dot), take δ (exactly 0 for a
// frozen row, act_i = 0), write α_i += δ, and broadcast δ·y_i — the scale
// of the rank-1 scatter — which every thread returns.  act and y may be
// null (all-ones: no shrinking, pre-folded rows).
__device__ __forceinline__ float dcd_update_scale(
    float part, long long i, float* alpha, const float* q, const float* act,
    const float* y, const DcdLoss& L) {
  __shared__ float red[DCD_MAX_WARPS];
  __shared__ float scale;
  for (int o = 16; o > 0; o >>= 1)
    part += __shfl_down_sync(0xffffffffu, part, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    float dot = 0.0f;
    for (int k = 0; k < (int)(blockDim.x >> 5); ++k) dot += red[k];
    const float yi = y ? y[i] : 1.0f;
    const float a = alpha[i];
    float dl = dcd_delta(L, a, yi * dot, q[i]);
    if (act && !(act[i] > 0.0f)) dl = 0.0f;
    alpha[i] = a + dl;
    scale = dl * yi;
  }
  __syncthreads();
  return scale;
}
