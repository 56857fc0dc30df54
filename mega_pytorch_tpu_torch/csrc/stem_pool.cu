// Stem epilogue: frozen-BN affine + relu + exact 3x3/2 pad-1 maxpool on the
// s2d(4) phase-packed stem conv output.
//
// Replaces: mega_pytorch_tpu/ops/pallas/stem_pool.py, stem_pool_packed /
// _kernel (Pallas TPU).
//
// Input y is (N, T, U, 4*O) with phase block p = a'*2 + b' holding stem-conv
// output position (2t+a', 2u+b'); output is (N, T, U, O):
//   z(t, u, p)  = relu(y * scale + shift)                     (f32)
//   r_b'(t, u)  = max(z(t,u,(0,b')), z(t,u,(1,b')), z(t-1,u,(1,b')))
//   out(t, u)   = max(r_0(t,u), r_1(t,u), r_1(t,u-1))
// with -inf beyond the top and left borders, rounded once to the output type.
//
// Bound: device-memory bandwidth. One read of y and a quarter-size write
// (~40 MB in, ~10 MB out per flagship step in bf16); no arithmetic to speak of.
// Design: one thread per 8 output channels of one (n, t, u) cell, 16-byte
// loads of each phase block; the halo cells (t-1, u-1) are re-read straight
// from global memory, where L2 serves them. The affine uses __fmul_rn /
// __fadd_rn so nvcc cannot contract it into an FMA: the result is bit-exact
// with the plain PyTorch version (separate multiply and add, f32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  }
  *reinterpret_cast<uint4*>(p) = raw;
}

template <typename T>
__device__ __forceinline__ void affine_relu(const T* y, const float* scale,
                                            const float* shift, float* z) {
  load8(y, z);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    z[k] = fmaxf(__fadd_rn(__fmul_rn(z[k], scale[k]), shift[k]), 0.0f);
  }
}

template <typename T>
__global__ void stem_pool_kernel(const T* __restrict__ y,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ shift,
                                 T* __restrict__ out, int n_img, int rows,
                                 int cols, int out_ch) {
  const int groups = out_ch / 8;
  const long long total = (long long)n_img * rows * cols * groups;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int g = (int)(idx % groups);
  long long rest = idx / groups;
  const int u = (int)(rest % cols);
  rest /= cols;
  const int t = (int)(rest % rows);
  const int n = (int)(rest / rows);
  const int o0 = g * 8;
  const long long cell = 4LL * out_ch;  // elements per (t, u) cell of y

  auto at = [&](int tt, int uu, int phase) {
    return y + (((long long)n * rows + tt) * cols + uu) * cell +
           (long long)phase * out_ch + o0;
  };
  auto sc = [&](int phase) { return scale + phase * out_ch + o0; };
  auto sh = [&](int phase) { return shift + phase * out_ch + o0; };

  float res[8], r1[8], z[8];
  // r_0(t, u) and r_1(t, u)
  float r0[8];
  affine_relu(at(t, u, 0), sc(0), sh(0), r0);
  affine_relu(at(t, u, 2), sc(2), sh(2), z);
#pragma unroll
  for (int k = 0; k < 8; ++k) r0[k] = fmaxf(r0[k], z[k]);
  affine_relu(at(t, u, 1), sc(1), sh(1), r1);
  affine_relu(at(t, u, 3), sc(3), sh(3), z);
#pragma unroll
  for (int k = 0; k < 8; ++k) r1[k] = fmaxf(r1[k], z[k]);
  if (t > 0) {
    affine_relu(at(t - 1, u, 2), sc(2), sh(2), z);
#pragma unroll
    for (int k = 0; k < 8; ++k) r0[k] = fmaxf(r0[k], z[k]);
    affine_relu(at(t - 1, u, 3), sc(3), sh(3), z);
#pragma unroll
    for (int k = 0; k < 8; ++k) r1[k] = fmaxf(r1[k], z[k]);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) res[k] = fmaxf(r0[k], r1[k]);
  // r_1(t, u-1): the left halo column
  if (u > 0) {
    float c[8];
    affine_relu(at(t, u - 1, 1), sc(1), sh(1), c);
    affine_relu(at(t, u - 1, 3), sc(3), sh(3), z);
#pragma unroll
    for (int k = 0; k < 8; ++k) c[k] = fmaxf(c[k], z[k]);
    if (t > 0) {
      affine_relu(at(t - 1, u - 1, 3), sc(3), sh(3), z);
#pragma unroll
      for (int k = 0; k < 8; ++k) c[k] = fmaxf(c[k], z[k]);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) res[k] = fmaxf(res[k], c[k]);
  }
  store8(out + (((long long)n * rows + t) * cols + u) * out_ch + o0, res);
}

}  // namespace

extern "C" int stem_pool_packed_launch(const void* y, const void* scale,
                                       const void* shift, void* out, int n_img,
                                       int rows, int cols, int out_ch,
                                       int is_bf16, void* stream) {
  const long long total = (long long)n_img * rows * cols * (out_ch / 8);
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (blocks == 0) return (int)cudaGetLastError();
  if (is_bf16) {
    stem_pool_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(y), static_cast<const float*>(scale),
        static_cast<const float*>(shift), static_cast<__nv_bfloat16*>(out),
        n_img, rows, cols, out_ch);
  } else {
    stem_pool_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(y), static_cast<const float*>(scale),
        static_cast<const float*>(shift), static_cast<float*>(out), n_img,
        rows, cols, out_ch);
  }
  return (int)cudaGetLastError();
}
