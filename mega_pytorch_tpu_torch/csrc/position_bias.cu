// Standalone relation-attention log position bias:
//   out[g, n, m] = log(relu(Wg . sinusoid(pos(rois[n], refs[m])) + b)[g] + 1e-6)
// with the geometry, the sinusoids and the tensor-core contraction of
// position_weight.cuh (shared with the flash attention kernel's mode
// "compute").
//
// Replaces: mega_pytorch_tpu/ops/pallas/position_bias.py, fused_position_bias
// (_kernel: the per-tile FMA unroll against SMEM weights).
//
// Operands: rois (N, 4), refs (M, 4) f32; params = Wg (64, 16) row-major,
// its bias (16,), the 8 sinusoid frequencies, all f32. Out (16, N, M) f32.
//
// Bound: the output bytes. Per (n, m) pair 64 bytes are written, against 2
// logs, 16 sin/cos pairs of dx/dy, 16 output logs on the special function
// units and 2 x 64 x 16 FLOPs of the Wg contraction on the tensor cores: at
// N=675, M=3750 that is 162 MB (0.048 ms at 3.35 TB/s) against 0.030 ms of
// special functions.
// Design: a block of 8 warps owns 16 query rows x 128 refs, a warp one row
// at a time, 32 refs (two mma row tiles, interleaved) at a time; one mma
// accumulator tile is (16 refs, 8 groups), two of them hold a pair's 16
// groups.
//   - dx/dy: a thread evaluates 2 pairs x 2 frequencies x (dx, dy) with
//     sincos_reduced, exactly its A fragment in Wg's (channel, sin|cos,
//     freq) order (the quad's 4 threads compute the 4 logs of its 2 pairs
//     once and exchange them by shuffles); features and Wg's dx/dy rows are
//     split into bf16 hi + lo, three mma.sync per k-step and group tile.
//   - dw/dh through separable factors: the angle f (log w_n - log w_m)
//     expands by angle addition into per-ref sinusoids cos / sin(f log w_m)
//     (the A operand: a (128, 32) fp16 tile per block, evaluated once per
//     ref and read by ldmatrix) times per-row coefficients with Wg's dw/dh
//     rows folded in (the B operand: ws sin a + wc cos a and wc sin a - ws
//     cos a of a = f log w_n, fp16, built in registers once per row from
//     the row's 16 sinusoids): one fp16 mma.sync per k-step and group tile,
//     O(N + M) sinusoids instead of O(N M).
//   - Out: + b, relu, + 1e-6 and __logf in the accumulator registers, then
//     into a padded per-warp shared-memory stage of the row's 16 groups x
//     128 refs (conflict-free both ways), stored when the row is done:
//     each group's 128 refs as a 512-byte run of 4 coalesced 128-byte
//     stores. The fragment layout alone would scatter every store over 4
//     planes in 32-byte pieces. What still holds the stores back: with
//     M = 3750 three plane rows of four start off the 32-byte sector grid,
//     so most stores leave sectors partial, which the L2 fetches from
//     device memory first (tools/write_probe.py measures the patterns).
//     The 67 KB of stages leave 2 blocks (16 warps) an SM.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "position_weight.cuh"

namespace {

using posw::F;
using posw::G;
using posw::J;
constexpr int WARPS = 8;
constexpr int NT = 32 * WARPS;  // threads per block
constexpr int TN = 16;          // query rows per block, TN / WARPS per warp
constexpr int TM = 128;         // refs per block, 8 mma row tiles of 16
constexpr int STAGE_STRIDE = TM + 4;  // f32 row stride of a warp's (16, TM) output stage

struct Smem {
  float params[posw::PARAMS];
  float4 rgeo[TN];       // (cx, cy, 1 / w, 1 / h) of the block's rows
  float2 rsc[TN][2][F];  // (sin, cos) of f log w and f log h of each row
  float2 fgeo[TM];       // (cx, cy) of the block's refs
  __half feat[TM * J];   // cos, sin of f log w, then of f log h (tsw rows)
  float out[WARPS][G * STAGE_STRIDE];  // each warp's (group, ref) output stage of a row
};

__global__ void __launch_bounds__(NT, 2)
position_bias_kernel(const float* __restrict__ rois,
                     const float* __restrict__ refs,
                     const float* __restrict__ params,
                     float* __restrict__ out, int N, int M) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem& sm = *reinterpret_cast<Smem*>(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  const float* par = sm.params;
  const float* fr = par + posw::FREQ;

  for (int i = tid; i < posw::PARAMS; i += NT) sm.params[i] = params[i];
  __syncthreads();  // the frequencies
  for (int i = tid; i < TN * 2 * F; i += NT) {  // the rows' sinusoids: (row, w|h, frequency)
    const int r = i / (2 * F), c = i / F % 2, f = i % F;
    const float4 geo = posw::geometry(rois + (long long)min(n0 + r, N - 1) * 4);
    if (c == 0 && f == 0) sm.rgeo[r] = make_float4(geo.z, geo.w, 1.0f / geo.x, 1.0f / geo.y);
    float s, co;
    posw::sincos_reduced(__fmul_rn(logf(c == 0 ? geo.x : geo.y), fr[f]), s, co);
    sm.rsc[r][c][f] = make_float2(s, co);
  }
  for (int i = tid; i < TM * F; i += NT) {  // the refs' sinusoids: (ref, frequency)
    const int mm = i / F, f = i % F;
    const float4 geo = posw::geometry(refs + (long long)min(m0 + mm, M - 1) * 4);
    if (f == 0) sm.fgeo[mm] = make_float2(geo.z, geo.w);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float s, co;
      posw::sincos_reduced(__fmul_rn(logf(c == 0 ? geo.x : geo.y), fr[f]), s, co);
      sm.feat[posw::tsw(mm, 2 * c) + f] = __float2half_rn(co);
      sm.feat[posw::tsw(mm, 2 * c + 1) + f] = __float2half_rn(s);
    }
  }
  // Wg's dx (k-step 0) and dy (k-step 1) rows as split B fragments of the
  // two group tiles: [k-step][tile][b0 sines | b1 cosines], column gid
  uint32_t wh[2][2][2], wl[2][2][2];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int cosine = 0; cosine < 2; ++cosine) {
        const float* w = par + posw::wg_row(kk, cosine, 2 * tig) * G + 8 * nt + gid;
        posw::split_bf16(w[0], w[G], wh[kk][nt][cosine], wl[kk][nt][cosine]);
      }
    }
  }
  __syncthreads();  // the rows' and refs' sinusoids and geometry

  const float fr0 = fr[2 * tig], fr1 = fr[2 * tig + 1];
  const long long plane = (long long)N * M;
#pragma unroll 1
  for (int r = warp; r < TN && n0 + r < N; r += WARPS) {
    const int n = n0 + r;
    const float4 rg = sm.rgeo[r];
    // the row's dw/dh coefficients as fp16 B fragments: [w|h][tile][b0 of
    // cos(f b) | b1 of sin(f b)], frequencies 2 tig and 2 tig + 1, column gid
    uint32_t bn[2][2][2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float2 a0 = sm.rsc[r][c][2 * tig], a1 = sm.rsc[r][c][2 * tig + 1];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float* ws = par + posw::wg_row(2 + c, 0, 2 * tig) * G + 8 * nt + gid;
        const float* wc = par + posw::wg_row(2 + c, 1, 2 * tig) * G + 8 * nt + gid;
        const __half2 cos_coef = __floats2half2_rn(ws[0] * a0.x + wc[0] * a0.y,
                                                   ws[G] * a1.x + wc[G] * a1.y);
        const __half2 sin_coef = __floats2half2_rn(wc[0] * a0.x - ws[0] * a0.y,
                                                   wc[G] * a1.x - ws[G] * a1.y);
        bn[c][nt][0] = *reinterpret_cast<const uint32_t*>(&cos_coef);
        bn[c][nt][1] = *reinterpret_cast<const uint32_t*>(&sin_coef);
      }
    }
    float wb[2][2];  // the bias of groups 8 nt + 2 tig (+1)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      wb[nt][0] = posw::bias_of(par)[8 * nt + 2 * tig];
      wb[nt][1] = posw::bias_of(par)[8 * nt + 2 * tig + 1];
    }
    float* orow = out + (long long)n * M;
    float* stage = sm.out[warp];

#pragma unroll 1
    for (int m32 = 0; m32 < TM && m0 + m32 < M; m32 += 32) {
      // the chunk's two 16-ref tiles unrolled and without a branch, so that
      // their chains interleave (refs past M have clamped geometry and are
      // not stored)
#pragma unroll
      for (int m16 = m32; m16 < m32 + 32; m16 += 16) {
        // the quad's 4 logs: thread tig takes (pair gid + 8 (tig & 1), dx or dy)
        float d[2][2];  // [dx|dy][pair gid | gid + 8]
        {
          const float2 c = sm.fgeo[m16 + gid + 8 * (tig & 1)];
          const float own = tig < 2 ? posw::dxy_of(rg.x, rg.z, c.x)
                                    : posw::dxy_of(rg.y, rg.w, c.y);
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              d[kk][h] = __shfl_sync(0xffffffffu, own, (lane & ~3) | (2 * kk + h));
            }
          }
        }
        float acc[2][4] = {};  // [group tile]: (ref gid | gid + 8) x 2 groups
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {  // dx, dy
          uint32_t ah[4], al[4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float s0, c0, s1, c1;
            posw::sincos_reduced(__fmul_rn(d[kk][h], fr0), s0, c0);
            posw::sincos_reduced(__fmul_rn(d[kk][h], fr1), s1, c1);
            posw::split_bf16(s0, s1, ah[h], al[h]);
            posw::split_bf16(c0, c1, ah[2 + h], al[2 + h]);
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {  // the small cross terms first
            posw::mma_bf16(acc[nt], al, wh[kk][nt][0], wh[kk][nt][1]);
            posw::mma_bf16(acc[nt], ah, wl[kk][nt][0], wl[kk][nt][1]);
            posw::mma_bf16(acc[nt], ah, wh[kk][nt][0], wh[kk][nt][1]);
          }
        }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {  // dw, dh
          uint32_t fa[4];
          posw::ldmatrix_x4(fa, sm.feat + posw::tsw(m16 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            posw::mma_f16(acc[nt], fa, bn[kk][nt][0], bn[kk][nt][1]);
          }
        }
        // + b, relu, + 1e-6, log, into the warp's stage: (group, ref)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int g = 8 * nt + 2 * tig + (i & 1), ref = m16 + gid + 8 * (i >> 1);
            stage[g * STAGE_STRIDE + ref] =
                __logf(fmaxf(acc[nt][i] + wb[nt][i & 1], 0.0f) + 1e-6f);
          }
        }
      }
    }
    __syncwarp();
    // each group's row of TM refs as 4 contiguous 128-byte stores
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int c = 0; c < TM; c += 32) {
        const int m = m0 + c + lane;
        if (m < M) orow[g * plane + m] = stage[g * STAGE_STRIDE + c + lane];
      }
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int position_bias_launch(const void* rois, const void* refs,
                                    const void* params, void* out, int N,
                                    int M, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (N == 0 || M == 0) return (int)cudaGetLastError();
  const cudaError_t err = cudaFuncSetAttribute(
      position_bias_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + TM - 1) / TM, (N + TN - 1) / TN);
  position_bias_kernel<<<grid, NT, sizeof(Smem), s>>>(
      static_cast<const float*>(rois), static_cast<const float*>(refs),
      static_cast<const float*>(params), static_cast<float*>(out), N, M);
  return (int)cudaGetLastError();
}
