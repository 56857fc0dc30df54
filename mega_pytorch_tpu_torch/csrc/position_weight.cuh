// Relation-attention position weight, device side: the one definition of the
// geometry -> sinusoid -> Wg contraction that both the flash attention
// kernel (mode "compute", relation_attention.cu) and the standalone bias
// kernel (position_bias.cu) use, so the two cannot fork the convention
// (the JAX package keeps its single bias_freq_scales for the same reason).
//
//   pos  = (log(|dcx| / w + 1e-3), log(|dcy| / h + 1e-3), log(w / w'), log(h / h'))
//   sums[g] = sum over channel c and frequency f of
//             sin(pos[c] * fr[f]) * Wg[c*2F + f, g] + cos(pos[c] * fr[f]) * Wg[c*2F + F + f, g]
//
// with +1 box widths and the 1e-3 w/h clamp; the caller adds the Wg bias.
// Parameters arrive as one f32 block: Wg (E, G) row-major, its bias (G,),
// then the F sinusoid frequencies (ops/kernels/position_bias.py packs it).
// Sinusoids use the range-reduced sincosf: the arguments reach |x| ~ 800
// rad, where __sinf/__cosf lose accuracy.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace posw {

constexpr int G = 16;  // attention groups
constexpr int E = 64;  // position embedding width (4 channels x 2 x F)
constexpr int F = 8;   // sinusoid frequencies
constexpr int PARAMS = E * G + G + F;  // floats in the parameter block

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

}  // namespace posw
