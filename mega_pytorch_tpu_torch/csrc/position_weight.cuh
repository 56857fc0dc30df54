// Relation-attention position weight, device side: what the standalone bias
// kernel (position_bias.cu) and the flash attention kernel's mode "compute"
// (relation_attention.cu) share, so the two cannot fork the convention (the
// JAX package keeps its single bias_freq_scales for the same reason):
//
//   - the box geometry: +1 widths, the 1e-3 w/h clamp (geometry);
//   - the parameter block: Wg (E, G) row-major, its bias (G,), then the F
//     sinusoid frequencies 100 / 1000^(f/F) (ops/kernels/position_bias.py
//     packs it; bias_of and FREQ);
//   - the Wg row order (channel, sin|cos, freq) over the channels
//     pos = (log(|dcx| / w + 1e-3), log(|dcy| / h + 1e-3), log(w / w'), log(h / h'))
//     (wg_row);
//
//   sums[g] = sum over channel c and frequency f of
//             sin(pos[c] * fr[f]) * Wg[c*2F + f, g] + cos(pos[c] * fr[f]) * Wg[c*2F + F + f, g]
//
// Where they differ: the bias kernel evaluates all four channels pairwise
// in f32 with the range-reduced sincosf and contracts them with f32 Wg
// (weight_sums). Mode "compute" evaluates only dx/dy pairwise, with the
// reduction of sincos_reduced and the hardware sine, contracts those
// features with Wg as bf16 hi/lo pairs on the tensor cores, and takes dw/dh
// through separable row and column factors (its source note).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace posw {

constexpr int G = 16;  // attention groups
constexpr int E = 64;  // position embedding width (4 channels x 2 x F)
constexpr int F = 8;   // sinusoid frequencies
constexpr int FREQ = E * G + G;        // offset of the frequencies
constexpr int PARAMS = E * G + G + F;  // floats in the parameter block

// Wg row of channel c (0 dx, 1 dy, 2 dw, 3 dh), sine (0) or cosine (1), freq f
__host__ __device__ constexpr int wg_row(int c, int cosine, int f) {
  return c * 2 * F + cosine * F + f;
}

__device__ __forceinline__ float4 geometry(const float* box) {
  // (w, h, cx, cy) with the reference's 1e-3 clamp and +1 widths
  const float w = fmaxf(box[2] - box[0] + 1.0f, 1e-3f);
  const float h = fmaxf(box[3] - box[1] + 1.0f, 1e-3f);
  return make_float4(w, h, 0.5f * (box[0] + box[2]), 0.5f * (box[1] + box[3]));
}

// Wg . sinusoid(pos(a, c)) for all G groups, without the bias; a is the
// query box's geometry, c the ref box's, params the parameter block.
__device__ __forceinline__ void weight_sums(float4 a, float4 c,
                                            const float* params,
                                            float sums[G]) {
  const float* wg = params;             // (E, G)
  const float* fr = params + E * G + G;  // (F,)
  float pos[4];
  pos[0] = logf(fabsf((a.z - c.z) / a.x) + 1e-3f);
  pos[1] = logf(fabsf((a.w - c.w) / a.y) + 1e-3f);
  pos[2] = logf(a.x / c.x);
  pos[3] = logf(a.y / c.y);
#pragma unroll
  for (int g = 0; g < G; ++g) sums[g] = 0.0f;
  // the channel loop stays rolled: unrolled, the 32 inlined sincosf left
  // position_bias.cu with a 3.5 KB stack of spills and 14x slower
#pragma unroll 1
  for (int ch = 0; ch < 4; ++ch) {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      float s, co;
      sincosf(pos[ch] * fr[f], &s, &co);
      const float* ws = wg + (ch * 2 * F + f) * G;
      const float* wc = wg + (ch * 2 * F + F + f) * G;
#pragma unroll
      for (int g = 0; g < G; ++g) sums[g] += s * ws[g] + co * wc[g];
    }
  }
}

__device__ __forceinline__ const float* bias_of(const float* params) {
  return params + E * G;  // (G,)
}

// sin and cos of x (|x| up to ~800 rad here) by an f32 reduction to
// [-pi, pi], r = x - round(x / 2pi) * 2pi with each step rounded as written
// (no contraction; round half to even by adding and subtracting 1.5 * 2^23,
// which equals rintf for |x / 2pi| < 2^22 and keeps the conversion unit
// free), then the hardware approximations, whose absolute error on
// [-pi, pi] is below 2^-21. No slow path, so no stack frame. The plain
// version (ops/kernels/relation_attention.py, _sincos_reduced) repeats the
// reduction step for step.
__device__ __forceinline__ void sincos_reduced(float x, float& s, float& c) {
  const float t = __fmul_rn(x, 0.15915494309189535f);
  const float k = __fsub_rn(__fadd_rn(t, 12582912.0f), 12582912.0f);
  const float r = __fsub_rn(x, __fmul_rn(k, 6.283185307179586f));
  __sincosf(r, &s, &c);
}

}  // namespace posw
