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
// Both evaluate dx/dy pairwise with sincos_reduced (dxy_of, the range
// reduction, then the hardware sine), contract those features with Wg's
// dx/dy rows as bf16 hi/lo pairs on the tensor cores (split_bf16, mma_bf16)
// and take dw/dh through separable factors of the angle f (log w_n -
// log w_m) as one fp16 contraction (mma_f16, feature tiles in tsw rows).
// Where they differ: mode "compute" folds Wg's dw/dh rows into the ref side
// (T) and contracts per group with query rows as the mma rows; the bias
// kernel folds them into the query side and contracts a row's refs against
// all 16 groups at once, as it does for dx/dy (their source notes).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// ---------------------------------------------------------------------------
// Tensor-core pieces of the two kernels' contractions (mma.sync m16n8k16;
// fragment layout in relation_attention.cu)

constexpr int J = 4 * F;  // features of the dx/dy or the dw/dh pair of channels

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16, row) . b (16x8, col), bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16x16, row) . b (16x8, col), fp16 operands, f32 sums
__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// element offset of 16-byte chunk `chunk` (of 4) of row `row` of a tile of
// J fp16 features a row (64-byte rows): chunks XOR-swizzled by row / 2, so
// ldmatrix's 8 rows hit 8 distinct 16-byte bank groups
__device__ __forceinline__ int tsw(int row, int chunk) {
  return row * J + ((chunk ^ ((row >> 1) & 3)) << 3);
}

// (a, b) as a bf16 pair hi plus the bf16 pair lo of the remainders, both
// truncated (a byte permute, no conversion instruction): hi + lo carries 15
// bits of each (x - hi is exact in f32); three mma.sync (lo.hi, hi.lo,
// hi.hi) then give a product to ~2^-15
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const uint32_t ua = __float_as_uint(a), ub = __float_as_uint(b);
  hi = __byte_perm(ua, ub, 0x7632);
  const float la = a - __uint_as_float(ua & 0xffff0000u);
  const float lb = b - __uint_as_float(ub & 0xffff0000u);
  lo = __byte_perm(__float_as_uint(la), __float_as_uint(lb), 0x7632);
}

// dx (or dy) of the tensor-core kernels: log(|q_c - r_c| / w + 1e-3) from
// the query box's centre q_c and reciprocal width (height) inv and the ref
// box's centre r_c, by the reciprocal and __logf
__device__ __forceinline__ float dxy_of(float q_c, float inv, float r_c) {
  return __logf(fabsf(__fmul_rn(q_c - r_c, inv)) + 1e-3f);
}

}  // namespace posw
