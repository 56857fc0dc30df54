// Flash relation attention, forward only, in three modes:
//   mode 0 ("none"):    out = softmax_m(mask((q.k + u.k) / sqrt(d))) . v
//   mode 1 ("compute"): the same with the position weight
//                       pw = relu(Wg . sinusoid(dx, dy, dw, dh)) + 1e-6
//                       multiplied into the exponentials, which equals adding
//                       log pw to the logits.
//   mode 2 ("input"):   the same with a precomputed (B, 16, N, M) f32 log
//                       bias added to the scaled logits before masking and
//                       the running max.
//
// Replaces: mega_pytorch_tpu/ops/pallas/relation_attention.py,
// _fused_fwd_batched / _kernel with bias_mode "none" (fused_relation_attention),
// "compute" (fused_relation_attention_pos, _tile_bias_weight, _sincos) and
// "input" (a bias operand, relation_attention.py:519-530 and :347-348).
//
// Operands: q (B, 16, N, 64), k and v (B, 16, M, 64) bf16; uk (B, 16, M) f32;
// valid (B, M) bool; rois (B, N, 4), refs (B, M, 4) f32 and params (the
// position_weight.cuh block) in mode 1; bias (B, 16, N, M) f32 in mode 2.
// Out (B, 16, N, 64) f32. QK and PV take bf16 operands with f32 sums, p is
// rounded to bf16 before PV, the softmax recurrence is f32, invalid refs are
// masked, and a lane with no valid ref gives exact zeros.
//
// Bound: arithmetic. Per flagship detect ~21 GFLOP of QK + PV, plus in
// "compute" mode 32 sin/cos pairs and 16x64 multiply-adds per (n, m) pair
// (2.5 M pairs at stage 0). Design: one block per (lane, 16 query rows); the
// block walks the refs in tiles of 64 because blocks have no sequential grid
// axis. Per tile the position weight of all 16 groups is computed once into
// shared memory (it is shared by the groups and never reaches device
// memory), then the groups run one after another through QK, the online
// softmax and PV, with each group's running max, sum and accumulator kept in
// shared memory. In mode "input" each thread reads its four bias values of
// the tile straight from device memory (16 threads of a row read 256
// consecutive bytes); the bias is read once, so staging it in shared memory
// would save nothing. The products run on the CUDA cores; tensor cores
// (wgmma) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "position_weight.cuh"

namespace {

using posw::G;           // attention groups
constexpr int D = 64;    // per-group width
constexpr int TN = 16;   // query rows per block
constexpr int TM = 64;   // refs per tile
constexpr int NT = 256;  // threads per block: 16 per query row
constexpr int KT_STRIDE = TM + 8;  // bf16 row stride of the transposed K tile
constexpr float NEG_INF = -1e30f;
constexpr int MODE_NONE = 0, MODE_COMPUTE = 1, MODE_INPUT = 2;

struct Layout {
  // byte offsets into dynamic shared memory
  static constexpr int q = 0;                                   // G*TN*D bf16
  static constexpr int kt = q + G * TN * D * 2;                 // D*KT_STRIDE bf16
  static constexpr int v = kt + D * KT_STRIDE * 2;              // TM*D bf16
  static constexpr int acc = v + TM * D * 2;                    // G*TN*D f32
  static constexpr int p = acc + G * TN * D * 4;                // TN*TM f32
  static constexpr int mrun = p + TN * TM * 4;                  // G*TN f32
  static constexpr int lrun = mrun + G * TN * 4;                // G*TN f32
  static constexpr int uk = lrun + G * TN * 4;                  // TM f32
  static constexpr int valid = uk + TM * 4;                     // TM f32
  static constexpr int base_bytes = valid + TM * 4;
  // "compute" mode only
  static constexpr int params = base_bytes;                     // posw::PARAMS f32
  static constexpr int rgeo = params + posw::PARAMS * 4;        // TN*4 f32
  static constexpr int fgeo = rgeo + TN * 4 * 4;                // TM*4 f32
  static constexpr int pw = fgeo + TM * 4 * 4;                  // G*TN*TM f32
  static constexpr int pos_bytes = pw + G * TN * TM * 4;
};

template <int MODE>
__global__ void __launch_bounds__(NT)
relation_attention_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const float* __restrict__ uk,
                          const uint8_t* __restrict__ valid,
                          const float* __restrict__ rois,
                          const float* __restrict__ refs,
                          const float* __restrict__ params,
                          const float* __restrict__ bias,
                          float* __restrict__ out, int N, int M) {
  constexpr bool POS = MODE == MODE_COMPUTE;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + Layout::q);
  __nv_bfloat16* kt_s = reinterpret_cast<__nv_bfloat16*>(smem + Layout::kt);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + Layout::v);
  float* acc_s = reinterpret_cast<float*>(smem + Layout::acc);
  float* p_s = reinterpret_cast<float*>(smem + Layout::p);
  float* m_s = reinterpret_cast<float*>(smem + Layout::mrun);
  float* l_s = reinterpret_cast<float*>(smem + Layout::lrun);
  float* uk_s = reinterpret_cast<float*>(smem + Layout::uk);
  float* valid_s = reinterpret_cast<float*>(smem + Layout::valid);
  float* par_s = reinterpret_cast<float*>(smem + Layout::params);
  float* rgeo_s = reinterpret_cast<float*>(smem + Layout::rgeo);
  float* fgeo_s = reinterpret_cast<float*>(smem + Layout::fgeo);
  float* pw_s = reinterpret_cast<float*>(smem + Layout::pw);

  const int tid = threadIdx.x;
  const int r = tid / 16;  // query row of this thread within the tile
  const int j = tid % 16;  // its slot among the row's 16 threads
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * TN;
  const float scale = 0.125f;  // 1 / sqrt(D)

  // q tile of all groups: G*TN rows of 64 bf16 = 8 uint4 each
  for (int i = tid; i < G * TN * 8; i += NT) {
    const int row = i / 8, part = i % 8;
    const int g = row / TN, rr = row % TN, n = n0 + rr;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (n < N) {
      val = reinterpret_cast<const uint4*>(
          q + (((long long)b * G + g) * N + n) * D)[part];
    }
    reinterpret_cast<uint4*>(q_s + (g * TN + rr) * D)[part] = val;
  }
  for (int i = tid; i < G * TN * D; i += NT) acc_s[i] = 0.0f;
  for (int i = tid; i < G * TN; i += NT) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.0f;
  }
  if (POS) {
    for (int i = tid; i < posw::PARAMS; i += NT) par_s[i] = params[i];
    if (tid < TN) {
      const int n = min(n0 + tid, N - 1);
      const float4 gq = posw::geometry(rois + ((long long)b * N + n) * 4);
      reinterpret_cast<float4*>(rgeo_s)[tid] = gq;
    }
  }

  for (int m0 = 0; m0 < M; m0 += TM) {
    __syncthreads();  // previous tile's readers are done
    if (tid < TM) {
      const int m = m0 + tid;
      valid_s[tid] = (m < M && valid[(long long)b * M + m]) ? 1.0f : 0.0f;
      if (POS) {
        const int mc = min(m, M - 1);
        reinterpret_cast<float4*>(fgeo_s)[tid] =
            posw::geometry(refs + ((long long)b * M + mc) * 4);
      }
    }
    if (POS) {
      __syncthreads();
      // position weight of every (row, ref) pair of the tile, all groups
      const float* wb = posw::bias_of(par_s);
      for (int pair = tid; pair < TN * TM; pair += NT) {
        const int rr = pair / TM, mm = pair % TM;
        float wsum[G];
        posw::weight_sums(reinterpret_cast<const float4*>(rgeo_s)[rr],
                          reinterpret_cast<const float4*>(fgeo_s)[mm], par_s, wsum);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          pw_s[(g * TN + rr) * TM + mm] = fmaxf(wsum[g] + wb[g], 0.0f) + 1e-6f;
        }
      }
    }

    for (int g = 0; g < G; ++g) {
      __syncthreads();  // K/V/uk of the previous group are no longer read
      const long long kv_base = ((long long)b * G + g) * M;
      for (int i = tid; i < TM * 8; i += NT) {
        const int mm = i / 8, part = i % 8, m = m0 + mm;
        uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
        if (m < M) {
          kv = reinterpret_cast<const uint4*>(k + (kv_base + m) * D)[part];
          vv = reinterpret_cast<const uint4*>(v + (kv_base + m) * D)[part];
        }
        reinterpret_cast<uint4*>(v_s + mm * D)[part] = vv;
        const __nv_bfloat16* kh = reinterpret_cast<const __nv_bfloat16*>(&kv);
#pragma unroll
        for (int e = 0; e < 8; ++e) kt_s[(part * 8 + e) * KT_STRIDE + mm] = kh[e];
      }
      if (tid < TM) {
        const int m = m0 + tid;
        uk_s[tid] = m < M ? uk[kv_base + m] : 0.0f;
      }
      __syncthreads();

      // logits for row r, refs 4j .. 4j+3
      float bias_in[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (MODE == MODE_INPUT && n0 + r < N) {
        const float* brow = bias + (((long long)b * G + g) * N + n0 + r) * M;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = m0 + 4 * j + i;
          if (m < M) bias_in[i] = brow[m];
        }
      }
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const __nv_bfloat162* qrow =
          reinterpret_cast<const __nv_bfloat162*>(q_s + (g * TN + r) * D);
#pragma unroll 8
      for (int dd = 0; dd < D; dd += 2) {
        const float2 qv = __bfloat1622float2(qrow[dd / 2]);
        const __nv_bfloat162* k0 =
            reinterpret_cast<const __nv_bfloat162*>(kt_s + dd * KT_STRIDE + 4 * j);
        const __nv_bfloat162* k1 = reinterpret_cast<const __nv_bfloat162*>(
            kt_s + (dd + 1) * KT_STRIDE + 4 * j);
        const float2 a0 = __bfloat1622float2(k0[0]), a1 = __bfloat1622float2(k0[1]);
        const float2 c0 = __bfloat1622float2(k1[0]), c1 = __bfloat1622float2(k1[1]);
        s[0] += qv.x * a0.x + qv.y * c0.x;
        s[1] += qv.x * a0.y + qv.y * c0.y;
        s[2] += qv.x * a1.x + qv.y * c1.x;
        s[3] += qv.x * a1.y + qv.y * c1.y;
      }
      float tile_max = NEG_INF;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int mm = 4 * j + i;
        s[i] = (s[i] + uk_s[mm]) * scale;
        if (MODE == MODE_INPUT) s[i] += bias_in[i];
        if (valid_s[mm] < 0.5f) s[i] = NEG_INF;
        tile_max = fmaxf(tile_max, s[i]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
      }
      const float m_prev = m_s[g * TN + r];
      const float l_prev = l_s[g * TN + r];
      const float new_max = fmaxf(m_prev, tile_max);
      const float alpha = expf(m_prev - new_max);
      float psum = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int mm = 4 * j + i;
        float p = expf(s[i] - new_max);
        if (POS) p *= pw_s[(g * TN + r) * TM + mm];
        if (valid_s[mm] < 0.5f) p = 0.0f;
        psum += p;
        p_s[r * TM + mm] = __bfloat162float(__float2bfloat16_rn(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      }
      __syncwarp();  // the row's p values are written by its own half-warp
      if (j == 0) {
        m_s[g * TN + r] = new_max;
        l_s[g * TN + r] = l_prev * alpha + psum;
      }

      // accumulator columns 4j .. 4j+3 of row r
      float* acc = acc_s + (g * TN + r) * D + 4 * j;
      float o[4] = {acc[0] * alpha, acc[1] * alpha, acc[2] * alpha, acc[3] * alpha};
      const float* prow = p_s + r * TM;
#pragma unroll 8
      for (int mm = 0; mm < TM; ++mm) {
        const float p = prow[mm];
        const __nv_bfloat162* vr =
            reinterpret_cast<const __nv_bfloat162*>(v_s + mm * D + 4 * j);
        const float2 v0 = __bfloat1622float2(vr[0]), v1 = __bfloat1622float2(vr[1]);
        o[0] += p * v0.x;
        o[1] += p * v0.y;
        o[2] += p * v1.x;
        o[3] += p * v1.y;
      }
      acc[0] = o[0];
      acc[1] = o[1];
      acc[2] = o[2];
      acc[3] = o[3];
    }
  }
  __syncthreads();

  const int n = n0 + r;
  if (n < N) {
    for (int g = 0; g < G; ++g) {
      const float l = l_s[g * TN + r];
      const float* acc = acc_s + (g * TN + r) * D + 4 * j;
      float4 res = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (l > 0.0f) {
        res = make_float4(acc[0] / l, acc[1] / l, acc[2] / l, acc[3] / l);
      }
      reinterpret_cast<float4*>(out + (((long long)b * G + g) * N + n) * D)[j] = res;
    }
  }
}

template <int MODE>
cudaError_t launch_mode(dim3 grid, int smem, cudaStream_t s,
                        const __nv_bfloat16* q, const __nv_bfloat16* k,
                        const __nv_bfloat16* v, const float* uk,
                        const uint8_t* valid, const float* rois,
                        const float* refs, const float* params,
                        const float* bias, float* out, int N, int M) {
  const cudaError_t err = cudaFuncSetAttribute(
      relation_attention_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  relation_attention_kernel<MODE><<<grid, NT, smem, s>>>(
      q, k, v, uk, valid, rois, refs, params, bias, out, N, M);
  return cudaGetLastError();
}

}  // namespace

extern "C" int relation_attention_launch(const void* q, const void* k,
                                         const void* v, const void* uk,
                                         const void* valid, const void* rois,
                                         const void* refs, const void* params,
                                         const void* bias, void* out, int B,
                                         int N, int M, int mode, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((N + TN - 1) / TN, B);
  if (grid.x == 0 || B == 0) return (int)cudaGetLastError();
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* ukf = static_cast<const float*>(uk);
  const auto* vd = static_cast<const uint8_t*>(valid);
  const auto* rf = static_cast<const float*>(rois);
  const auto* ff = static_cast<const float*>(refs);
  const auto* pf = static_cast<const float*>(params);
  const auto* bf = static_cast<const float*>(bias);
  auto* o = static_cast<float*>(out);
  switch (mode) {
    case MODE_NONE:
      return (int)launch_mode<MODE_NONE>(grid, Layout::base_bytes, s, qb, kb, vb,
                                         ukf, vd, rf, ff, pf, bf, o, N, M);
    case MODE_COMPUTE:
      return (int)launch_mode<MODE_COMPUTE>(grid, Layout::pos_bytes, s, qb, kb, vb,
                                            ukf, vd, rf, ff, pf, bf, o, N, M);
    case MODE_INPUT:
      return (int)launch_mode<MODE_INPUT>(grid, Layout::base_bytes, s, qb, kb, vb,
                                          ukf, vd, rf, ff, pf, bf, o, N, M);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
