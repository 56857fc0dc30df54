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
// Operands: q (B, 16, N, 64), k and v (B, 16, M, 64) bf16, 16-byte aligned;
// uk (B, 16, M) f32; valid (B, M) bool; rois (B, N, 4), refs (B, M, 4) f32
// and params (the position_weight.cuh block) in mode 1; bias (B, 16, N, M)
// f32, 8-byte aligned, in mode 2. Out (B, 16, N, 64) f32. QK and PV take
// bf16 operands with f32 sums, p is rounded to bf16 (nearest) before PV
// while l sums the f32 p, the softmax recurrence is f32 with expf, invalid
// refs are masked before the running max (to -1e30, or to -inf where that
// gives the same maxima) and get p = 0 exactly, and a row whose l is 0 (a
// lane with no valid ref) gives exact zeros. The refs are walked in tiles of
// 64 in every mode, and the order of operations of a row depends on neither
// B nor N, so each lane of a batched call equals its one-lane call bit for
// bit.
//
// Modes "none" and "input": relation_attention_tc_kernel.
//   Replaces mega_pytorch_tpu/ops/pallas/relation_attention.py
//   _fused_fwd_batched / _kernel with bias_mode "none" (fused_relation_attention
//   :712) and "input" (the bias operand, :519-530, body :347-348).
//   Bound: "none" does ~7 us of tensor-core work at the flagship's largest
//   call (N=2175, M=750: 6.7 GFLOP, 16.5 MB), so latency and grid fill bound
//   it; "input" must read its bias once (162 MB at stage 0 and one lane,
//   48 us at 3.35 TB/s), so it is bound by the bias bytes.
//   Design: the 16 groups are independent here, so a block owns one (lane,
//   group, 64 query rows): a grid of (ceil(N/64), 16, B) blocks of 4 warps
//   (560 blocks at N=2175 and B=1), each warp 16 rows, FlashAttention-2
//   style with the running max, the sum and the 16x64 f32 accumulator in
//   registers. QK and PV run on the tensor cores as
//   mma.sync.m16n8k16 bf16 with f32 accumulators: the FLOPs are so few that
//   wgmma's last share of the tensor-core rate would buy nothing, and
//   mma.sync keeps the softmax in the accumulator fragments. Q sits in
//   registers as A fragments for the whole walk; K tiles are read by ldmatrix
//   as the "col" B operand of QK, V tiles by ldmatrix.trans for PV; p goes
//   from the S fragments straight into PV's A fragments, two m16n8 tiles per
//   m16k16, without touching shared memory. An invalid ref's uk is stored
//   as -inf, so the mask costs no instruction per logit. K and V tiles
//   (128-byte rows, 16-byte chunks XOR-swizzled by row so that ldmatrix is
//   free of bank conflicts) are copied with cp.async.cg into a ring of
//   stages with one barrier per tile: "none" keeps tiles t+1 and t+2 in
//   flight while tile t computes (3 stages, 49 KB); the ragged tail is
//   zero-filled and masked. In mode "input" the bias tile of the block's 64
//   rows is copied the same way, into a padded f32 stage (two wavefronts per
//   warp read, the least for 256 bytes), from which each thread reads its S
//   fragment's values; its 18 KB stages leave room for 2 (70 KB, tile t+1 in
//   flight). A bias row is M*4 bytes, 8 mod 16 at M=750 or 3750, so the
//   copies are 8 bytes (4 when M is odd), never 16. About 160-170 registers
//   a thread give 3 blocks (12 warps) per SM; capping them at 128 for a
//   fourth block spills and was slower on the card.
//
// Mode "compute": relation_attention_pos_kernel.
//   Replaces the same _kernel with bias_mode "compute"
//   (fused_relation_attention_pos :749, _tile_bias_weight, _sincos).
//   Bound: arithmetic: 32 sin/cos pairs and 16x64 multiply-adds per (n, m)
//   pair (2.5 M pairs at stage 0) on top of the products. Design: one block
//   per (lane, 16 query rows) walks the refs in tiles of 64. Per tile the
//   position weight of all 16 groups is computed once into shared memory (it
//   is shared by the groups and never reaches device memory), then the groups
//   run one after another through QK, the online softmax and PV, with each
//   group's running max, sum and accumulator kept in shared memory. The
//   products run on the CUDA cores; tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "position_weight.cuh"

namespace {

using posw::G;           // attention groups
constexpr int D = 64;    // per-group width
constexpr int TM = 64;   // refs per tile
constexpr float NEG_INF = -1e30f;
constexpr float SCALE = 0.125f;  // 1 / sqrt(D)
constexpr int MODE_NONE = 0, MODE_COMPUTE = 1, MODE_INPUT = 2;

// ---------------------------------------------------------------------------
// Modes "none" and "input": tensor cores, one block per (lane, group, 64 rows)

namespace tc {

constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;       // threads per block
constexpr int TN = 16 * WARPS;       // query rows per block
constexpr int BIAS_STRIDE = TM + 8;  // f32 row stride of a bias stage

// ref tiles in the ring: "none" keeps two tiles in flight, "input" one, as
// its bias stages are large
template <bool BIAS>
constexpr int STAGES = BIAS ? 2 : 3;

template <int S>
struct Ring {
  __nv_bfloat16 k[S][TM * D];  // swizzled 128-byte rows
  __nv_bfloat16 v[S][TM * D];
  float uk[S][TM];  // uk / 8 of a valid ref; -inf of an invalid one or past M
};
// mode "input" appends float bias[S][TN * BIAS_STRIDE]
template <bool BIAS>
constexpr int SMEM_BYTES =
    sizeof(Ring<STAGES<BIAS>>) + (BIAS ? STAGES<BIAS> * TN * BIAS_STRIDE * 4 : 0);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of `size` bytes; only `src_bytes` (0 or size) are read, the rest
// of the destination is zero-filled
template <int SIZE>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  if constexpr (SIZE == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(SIZE), "r"(src_bytes) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>  // wait until at most PENDING groups are in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x: the lower column
  return *reinterpret_cast<const uint32_t*>(&h);
}

// element offset of 16-byte chunk `chunk` of row `row` in a swizzled tile
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}

// Fragment layout of mma.m16n8k16 (lane = 4 * gid + tig): an S or O tile
// holds (row gid, cols 2 tig, 2 tig + 1) in c[0..1] and (row gid + 8, same
// cols) in c[2..3]; an A tile holds rows gid / gid + 8 and cols 2 tig (+1),
// then 2 tig + 8 (+1), packed in pairs.
template <bool BIAS>
__global__ void __launch_bounds__(NT)
relation_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const float* __restrict__ uk,
                             const uint8_t* __restrict__ valid,
                             const float* __restrict__ bias,
                             float* __restrict__ out, int N, int M) {
  constexpr int S = STAGES<BIAS>;
  extern __shared__ __align__(128) unsigned char smem[];
  Ring<S>& sm = *reinterpret_cast<Ring<S>*>(smem);
  float* bias_s = reinterpret_cast<float*>(smem + sizeof(Ring<S>));

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int n0 = blockIdx.x * TN;
  const long long bg = (long long)blockIdx.z * G + blockIdx.y;
  const __nv_bfloat16* kg = k + bg * M * D;
  const __nv_bfloat16* vg = v + bg * M * D;
  const float* ukg = uk + bg * M;
  const uint8_t* validg = valid + (long long)blockIdx.z * M;
  const float* biasg = BIAS ? bias + bg * N * M : nullptr;
  const int tiles = (M + TM - 1) / TM;

  // K, V (and the bias) of tile t into stage st, as one cp.async group
  auto load_tile = [&](int t, int st) {
    const int m0 = t * TM;
#pragma unroll
    for (int it = 0; it < TM * 8 / NT; ++it) {  // 64 rows x 8 chunks of 16 B
      const int i = tid + it * NT;
      const int row = i / 8, chunk = i % 8, m = m0 + row;
      const long long src = (long long)(m < M ? m : 0) * D + chunk * 8;
      const int bytes = m < M ? 16 : 0;
      cp_async<16>(&sm.k[st][swz(row, chunk)], kg + src, bytes);
      cp_async<16>(&sm.v[st][swz(row, chunk)], vg + src, bytes);
    }
    if constexpr (BIAS) {
      float* stage = bias_s + st * TN * BIAS_STRIDE;
#pragma unroll 4
      for (int it = 0; it < TN * TM / 2 / NT; ++it) {  // 64 rows x 32 pairs
        const int i = tid + it * NT;
        const int row = i / (TM / 2), m = m0 + 2 * (i % (TM / 2)), n = n0 + row;
        const float* src = biasg + (long long)(n < N ? n : 0) * M;
        float* dst = stage + row * BIAS_STRIDE + (m - m0);
        if ((M & 1) == 0) {  // rows start 8-byte aligned; m < M implies m + 1 < M
          const bool in = n < N && m < M;
          cp_async<8>(dst, src + (in ? m : 0), in ? 8 : 0);
        } else {  // every other row starts 4 bytes off an 8-byte boundary
          const bool in0 = n < N && m < M, in1 = n < N && m + 1 < M;
          cp_async<4>(dst, src + (in0 ? m : 0), in0 ? 4 : 0);
          cp_async<4>(dst + 1, src + (in1 ? m + 1 : 0), in1 ? 4 : 0);
        }
      }
    }
  };
  // The scaled uk of ref t * 64 + tid, or -inf where the ref is invalid:
  // (q.k + uk) / 8 == fma(q.k, 1/8, uk / 8) exactly (1/8 is a power of two),
  // and a -inf logit gives exactly the -1e30 mask's maxima and p = 0.
  auto ref_term = [&](int t) {
    const int m = t * TM + tid;
    return (m < M && validg[m]) ? ukg[m] * SCALE : -INFINITY;
  };

  for (int t = 0; t < S - 1; ++t) {  // the ring's first tiles in flight
    if (t < tiles) {
      load_tile(t, t);
      if (tid < TM) sm.uk[t][tid] = ref_term(t);
    }
    cp_async_commit();
  }

  // Q of this warp's 16 rows as the A fragments of 4 k-steps (rows past N: 0)
  uint32_t qa[4][4];
  {
    const int r0 = n0 + warp * 16 + gid, r1 = r0 + 8;
    const uint32_t* q0 =
        reinterpret_cast<const uint32_t*>(q + (bg * N + (r0 < N ? r0 : 0)) * D);
    const uint32_t* q1 =
        reinterpret_cast<const uint32_t*>(q + (bg * N + (r1 < N ? r1 : 0)) * D);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      qa[kk][0] = r0 < N ? q0[kk * 8 + tig] : 0u;
      qa[kk][1] = r1 < N ? q1[kk * 8 + tig] : 0u;
      qa[kk][2] = r0 < N ? q0[kk * 8 + 4 + tig] : 0u;
      qa[kk][3] = r1 < N ? q1[kk * 8 + 4 + tig] : 0u;
    }
  }

  float acc[8][4];  // O: 8 column tiles of 8
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  float mrun[2] = {NEG_INF, NEG_INF};  // rows gid and gid + 8
  float lrun[2] = {0.0f, 0.0f};        // this thread's share of the row sums

  for (int t = 0; t < tiles; ++t) {
    const int st = t % S;
    cp_async_wait<S - 2>();  // this thread's copies of tile t have landed
    __syncthreads();  // everyone's have, and every warp is done with tile t - 1
    const int ahead = t + S - 1;  // into the stage of tile t - 1
    const bool more = ahead < tiles;
    if (more) load_tile(ahead, ahead % S);
    cp_async_commit();
    const float u_next = more && tid < TM ? ref_term(ahead) : 0.0f;

    // S = Q K^T over the tile's 64 refs: 8 column tiles of 8 refs
    const __nv_bfloat16* ks = sm.k[st];
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {  // d in two halves of 32
        uint32_t kb[4];
        ldmatrix_x4(kb, ks + swz(j * 8 + (lane & 7), kp * 4 + (lane >> 3)));
        mma_bf16(s[j], qa[2 * kp], kb[0], kb[1]);
        mma_bf16(s[j], qa[2 * kp + 1], kb[2], kb[3]);
      }
    }

    // logits (invalid refs -inf), running max
    const float* uks = sm.uk[st];
    const float* brow = bias_s + st * TN * BIAS_STRIDE + (warp * 16 + gid) * BIAS_STRIDE;
    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j * 8 + 2 * tig;
      const float2 u = *reinterpret_cast<const float2*>(uks + c);
      s[j][0] = fmaf(s[j][0], SCALE, u.x);
      s[j][1] = fmaf(s[j][1], SCALE, u.y);
      s[j][2] = fmaf(s[j][2], SCALE, u.x);
      s[j][3] = fmaf(s[j][3], SCALE, u.y);
      if constexpr (BIAS) {
        const float2 b0 = *reinterpret_cast<const float2*>(brow + c);
        const float2 b1 = *reinterpret_cast<const float2*>(brow + 8 * BIAS_STRIDE + c);
        s[j][0] += b0.x;
        s[j][1] += b0.y;
        s[j][2] += b1.x;
        s[j][3] += b1.y;
      }
      tmax[0] = fmaxf(tmax[0], fmaxf(s[j][0], s[j][1]));
      tmax[1] = fmaxf(tmax[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the row's 4 threads are one quad
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
      const float new_max = fmaxf(mrun[h], tmax[h]);
      alpha[h] = expf(mrun[h] - new_max);
      mrun[h] = new_max;
    }

    // p = exp(s - max), exactly 0 on invalid refs; P as PV's A fragments
    float psum[2] = {0.0f, 0.0f};
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = expf(s[j][0] - mrun[0]), p1 = expf(s[j][1] - mrun[0]);
      const float p2 = expf(s[j][2] - mrun[1]), p3 = expf(s[j][3] - mrun[1]);
      psum[0] += p0 + p1;
      psum[1] += p2 + p3;
      pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) lrun[h] = lrun[h] * alpha[h] + psum[h];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V: V tiles through ldmatrix.trans, two column tiles per load
    const __nv_bfloat16* vs = sm.v[st];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // refs in steps of 16
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(
            vb, vs + swz(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, jp * 2 + (lane >> 4)));
        mma_bf16(acc[2 * jp], pa[kk], vb[0], vb[1]);
        mma_bf16(acc[2 * jp + 1], pa[kk], vb[2], vb[3]);
      }
    }

    if (more && tid < TM) sm.uk[ahead % S][tid] = u_next;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = lrun[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int n = n0 + warp * 16 + gid + 8 * h;
    if (n >= N) continue;
    float* orow = out + (bg * N + n) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float2 res = make_float2(0.0f, 0.0f);
      if (l > 0.0f) res = make_float2(acc[j][2 * h] / l, acc[j][2 * h + 1] / l);
      *reinterpret_cast<float2*>(orow + j * 8 + 2 * tig) = res;
    }
  }
}

template <bool BIAS>
cudaError_t launch_tc(int B, int N, int M, cudaStream_t s, const __nv_bfloat16* q,
                      const __nv_bfloat16* k, const __nv_bfloat16* v, const float* uk,
                      const uint8_t* valid, const float* bias, float* out) {
  constexpr int smem = SMEM_BYTES<BIAS>;
  const cudaError_t err = cudaFuncSetAttribute(
      relation_attention_tc_kernel<BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TN - 1) / TN, G, B);
  relation_attention_tc_kernel<BIAS><<<grid, NT, smem, s>>>(q, k, v, uk, valid, bias, out,
                                                             N, M);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// Mode "compute": CUDA cores, one block per (lane, 16 rows), groups in turn

constexpr int TN = 16;   // query rows per block
constexpr int NT = 256;  // threads per block: 16 per query row
constexpr int KT_STRIDE = TM + 8;  // bf16 row stride of the transposed K tile

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
  static constexpr int params = valid + TM * 4;                 // posw::PARAMS f32
  static constexpr int rgeo = params + posw::PARAMS * 4;        // TN*4 f32
  static constexpr int fgeo = rgeo + TN * 4 * 4;                // TM*4 f32
  static constexpr int pw = fgeo + TM * 4 * 4;                  // G*TN*TM f32
  static constexpr int bytes = pw + G * TN * TM * 4;
};

__global__ void __launch_bounds__(NT)
relation_attention_pos_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const float* __restrict__ uk,
                              const uint8_t* __restrict__ valid,
                              const float* __restrict__ rois,
                              const float* __restrict__ refs,
                              const float* __restrict__ params,
                              float* __restrict__ out, int N, int M) {
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
  for (int i = tid; i < posw::PARAMS; i += NT) par_s[i] = params[i];
  if (tid < TN) {
    const int n = min(n0 + tid, N - 1);
    const float4 gq = posw::geometry(rois + ((long long)b * N + n) * 4);
    reinterpret_cast<float4*>(rgeo_s)[tid] = gq;
  }

  for (int m0 = 0; m0 < M; m0 += TM) {
    __syncthreads();  // previous tile's readers are done
    if (tid < TM) {
      const int m = m0 + tid;
      valid_s[tid] = (m < M && valid[(long long)b * M + m]) ? 1.0f : 0.0f;
      const int mc = min(m, M - 1);
      reinterpret_cast<float4*>(fgeo_s)[tid] =
          posw::geometry(refs + ((long long)b * M + mc) * 4);
    }
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
        s[i] = (s[i] + uk_s[mm]) * SCALE;
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
        p *= pw_s[(g * TN + r) * TM + mm];
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

cudaError_t launch_pos(int B, int N, int M, cudaStream_t s, const __nv_bfloat16* q,
                       const __nv_bfloat16* k, const __nv_bfloat16* v, const float* uk,
                       const uint8_t* valid, const float* rois, const float* refs,
                       const float* params, float* out) {
  const cudaError_t err = cudaFuncSetAttribute(
      relation_attention_pos_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TN - 1) / TN, B);
  relation_attention_pos_kernel<<<grid, NT, Layout::bytes, s>>>(
      q, k, v, uk, valid, rois, refs, params, out, N, M);
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
  if (N == 0 || B == 0) return (int)cudaGetLastError();
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* ukf = static_cast<const float*>(uk);
  const auto* vd = static_cast<const uint8_t*>(valid);
  auto* o = static_cast<float*>(out);
  switch (mode) {
    case MODE_NONE:
      return (int)tc::launch_tc<false>(B, N, M, s, qb, kb, vb, ukf, vd, nullptr, o);
    case MODE_COMPUTE:
      return (int)launch_pos(B, N, M, s, qb, kb, vb, ukf, vd,
                             static_cast<const float*>(rois),
                             static_cast<const float*>(refs),
                             static_cast<const float*>(params), o);
    case MODE_INPUT:
      return (int)tc::launch_tc<true>(B, N, M, s, qb, kb, vb, ukf, vd,
                                      static_cast<const float*>(bias), o);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
