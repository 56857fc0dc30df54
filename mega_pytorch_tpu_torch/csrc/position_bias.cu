// Standalone relation-attention log position bias:
//   out[g, n, m] = log(relu(Wg . sinusoid(pos(rois[n], refs[m])) + b)[g] + 1e-6)
// in f32 throughout, with the geometry, sinusoids and Wg contraction of
// position_weight.cuh (shared with the flash attention kernel).
//
// Replaces: mega_pytorch_tpu/ops/pallas/position_bias.py, fused_position_bias
// (_kernel: the per-tile FMA unroll against SMEM weights).
//
// Operands: rois (N, 4), refs (M, 4) f32; params = Wg (64, 16) row-major,
// its bias (16,), the 8 sinusoid frequencies, all f32. Out (16, N, M) f32.
//
// Bound: arithmetic (the special functions). Per (n, m) pair 32 sin/cos
// pairs, 4 logs, 16 logs of the result and 16x64 multiply-adds, for 64
// bytes of output; at N=675, M=3750 that is 2.5 M pairs and 162 MB written.
// Design: one thread per (n, m) pair, consecutive threads on consecutive m,
// so each group's store is coalesced along M. A block takes 128 refs and
// walks ROWS query rows, so the parameter block (4.2 KB) is staged in shared
// memory once per ROWS * 128 pairs and each thread's ref geometry is
// computed once.

#include <cuda_runtime.h>
#include <math.h>

#include "position_weight.cuh"

namespace {

constexpr int NT = 128;   // threads per block, one ref each
constexpr int ROWS = 8;   // query rows per block

__global__ void __launch_bounds__(NT)
position_bias_kernel(const float* __restrict__ rois,
                     const float* __restrict__ refs,
                     const float* __restrict__ params,
                     float* __restrict__ out, int N, int M) {
  __shared__ float par_s[posw::PARAMS];
  __shared__ float4 rgeo_s[ROWS];
  const int tid = threadIdx.x;
  const int m = blockIdx.x * NT + tid;
  const int n0 = blockIdx.y * ROWS;
  for (int i = tid; i < posw::PARAMS; i += NT) par_s[i] = params[i];
  if (tid < ROWS) {
    rgeo_s[tid] = posw::geometry(rois + (long long)min(n0 + tid, N - 1) * 4);
  }
  __syncthreads();
  if (m >= M) return;
  const float4 c = posw::geometry(refs + (long long)m * 4);
  const float* wb = posw::bias_of(par_s);
  const long long plane = (long long)N * M;
#pragma unroll 1
  for (int rr = 0; rr < ROWS && n0 + rr < N; ++rr) {
    float sums[posw::G];
    posw::weight_sums(rgeo_s[rr], c, par_s, sums);
    float* dst = out + (long long)(n0 + rr) * M + m;
#pragma unroll
    for (int g = 0; g < posw::G; ++g) {
      dst[g * plane] = logf(fmaxf(sums[g] + wb[g], 0.0f) + 1e-6f);
    }
  }
}

}  // namespace

extern "C" int position_bias_launch(const void* rois, const void* refs,
                                    const void* params, void* out, int N,
                                    int M, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (N == 0 || M == 0) return (int)cudaGetLastError();
  const dim3 grid((M + NT - 1) / NT, (N + ROWS - 1) / ROWS);
  position_bias_kernel<<<grid, NT, 0, s>>>(
      static_cast<const float*>(rois), static_cast<const float*>(refs),
      static_cast<const float*>(params), static_cast<float*>(out), N, M);
  return (int)cudaGetLastError();
}
