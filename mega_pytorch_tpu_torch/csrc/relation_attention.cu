// Flash relation attention, forward only, in three modes:
//   mode 0 ("none"):    out = softmax_m(mask((q.k + u.k) / sqrt(d))) . v
//   mode 1 ("compute"): the same with the position weight
//                       pw = relu(Wg . sinusoid(dx, dy, dw, dh) + b) + 1e-6
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
// bf16 operands with f32 sums, p (times pw in mode 1) is rounded to bf16
// (nearest) before PV while l sums the f32 p, the softmax recurrence is f32
// with expf, invalid refs are masked before the running max (to -1e30, or
// to -inf where that gives the same maxima) and get p = 0 exactly, and a
// row whose l is 0 (a lane with no valid ref) gives exact zeros. The refs
// are walked in tiles of 64 in every mode, and the order of operations of a
// row depends on neither B nor N, so each lane of a batched call equals its
// one-lane call bit for bit.
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
// Mode "compute": relation_attention_pos_tc_kernel.
//   Replaces the same _kernel with bias_mode "compute"
//   (fused_relation_attention_pos :749, _tile_bias_weight :159, _wh_factors
//   :90, _sincos :61), and computes the Pallas kernel's function:
//   pw[g, n, m] = relu(Wg[dx/dy rows, g] . feat(n, m) + S[n] . T[g][:, m]
//   + b[g]) + 1e-6, with feat the 32 pairwise dx/dy sinusoids and S (N, 32),
//   T (g, 32, M) the separable dw/dh factors (angle addition: sin(a - b) and
//   cos(a - b) of a = f log w_n, b = f log w_m, with Wg's dw/dh rows folded
//   into T), and p = exp(s - running max of the qk logits) * pw.
//   Bound: per (query, ref) pair 4096 tensor-core FLOPs for QK and PV over
//   the 16 groups and 2048 for the two Wg contractions: 187 GFLOP at stage
//   0 with 12 lanes (N=675, M=3750), 0.19 ms at 989 TFLOP/s, against 237 MB
//   of operands (0.07 ms). The special function units take per pair the 32
//   dx/dy sinusoids, the 2 logs and the 16 exps (one a group): 1.52 G at 16
//   a clock per SM (4.18 T/s at 1.98 GHz), 0.36 ms, which sets the bound
//   (chip_smoke.py computes it from the call's inputs).
//   Design: the sinusoids are shared by the 16 groups; the accumulators, K
//   and V are per group, and one block holds neither 16 groups' K/V tiles
//   nor their accumulators. A block owns (lane, 2 groups, 64 query rows):
//   8 warps, warp w one (group w / 4, 16 rows), grid (ceil(N/64), 8, B);
//   the 8 blocks of one (lane, 64 rows) form a thread block cluster, and
//   each evaluates the dx/dy features of 8 of the 64 rows for all 16 groups
//   and stores each group's share into the owning block's shared memory, so
//   every (lane, query, ref) pair's sinusoids are evaluated once. Per
//   64-ref tile:
//   1. features: the block's 8 x 64 pairs as 32 mma row tiles of 16 pairs
//      (one query row, 16 refs), 4 per warp. A thread evaluates 2 pairs x
//      2 frequencies x (dx, dy) with sincos_reduced, which is exactly its A
//      fragment of the features in Wg's (channel, sin|cos, freq) order;
//      features and Wg's dx/dy rows (B fragments of 2 column tiles of 8
//      groups, staged once per block) are split into truncated bf16 hi + lo
//      pairs, and three mma.sync per k-step and column tile (hi.hi, hi.lo,
//      lo.hi) give the dx/dy part to ~2^-15, stored as f32 through
//      distributed shared memory into the padded (2, 64, 72) pw stage of the
//      group's block;
//   2. T: one thread per (ref, frequency) folds sin/cos of f log w_m and
//      f log h_m with the f32 Wg dw/dh rows into the tile's (2, 64, 32)
//      fp16 T, stored with swizzled 64-byte rows for ldmatrix;
//   3. per warp, its (group, 16 rows) of pw finished in place in the stage:
//      per 8-ref column tile the dw/dh part S.T by two fp16 mma.sync (S,
//      fp16 and computed once per block, and T by ldmatrix), which lands in
//      the logits' fragment layout, plus the staged dx/dy part and b, relu,
//      + 1e-6;
//   4. per warp, as in modes "none"/"input": S = QK by mma.sync, the online
//      max over the qk logits, p = exp(s - max) * pw into PV's A
//      fragments, PV by mma.sync.
//   S is computed once per block and T once per tile inside the kernel, not
//   in a prologue launch: T costs 64 x 16 sinusoids per tile against 4096
//   pairs x 16 pairwise ones, and no (g, 32, M) operand goes through memory.
//   K and V of the block's groups go by cp.async into one stage issued after
//   the tile's last read, so the copy of tile t+1 overlaps the feature pass
//   of tile t+1; ref geometry and uk are double-buffered; two cluster
//   barriers per tile (the pw stage is complete; every block is done with
//   it). Q, S and each thread's running max and sums stay in shared memory
//   (~110 KB a block), so two blocks (16 warps) share an SM at the 128
//   registers that allows: held in registers they spilled.
//   Numerics: sincos_reduced (an f32 reduction to [-pi, pi], then the
//   hardware sine, |error| < 2^-21) for every sinusoid, where the Pallas
//   kernel uses a 12-FMA polynomial (|error| < 2e-4); the dx/dy contraction
//   as f32-grade hi/lo bf16 products, and S and T in fp16, where the Pallas
//   kernel feeds its MXU bf16: on the card bf16 features put the output
//   2.2e-2, and bf16 S and T 3.5e-2, from the f32 plain version (12 lanes,
//   stage 1), against the 2e-2 it is held to, because near pw's relu floor
//   an absolute error of 2e-3 in pw scales a ref's weight by a large
//   factor; f32 sums; the pairwise log by __logf and the dx/dy quotient by
//   the row's reciprocal width. reference_relation_attention_pos_tiled
//   repeats this arithmetic.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
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
// Tensor-core helpers of both kernels

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

// c += a (16x16, row) . b (16x8, col), fp16 operands, f32 sums
__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
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
// then 2 tig + 8 (+1), packed in pairs; a B tile holds (rows 2 tig (+1),
// col gid) in b0 and rows 2 tig + 8 (+1) in b1.

// K and V rows [m0, m0 + 64) of one (lane, group) into swizzled tiles by
// cp.async, NTH threads; rows past M are zero-filled
template <int NTH>
__device__ __forceinline__ void load_kv_tile(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                             const __nv_bfloat16* kg,
                                             const __nv_bfloat16* vg, int m0, int M,
                                             int tid) {
#pragma unroll
  for (int it = 0; it < TM * 8 / NTH; ++it) {  // 64 rows x 8 chunks of 16 B
    const int i = tid + it * NTH;
    const int row = i / 8, chunk = i % 8, m = m0 + row;
    const long long src = (long long)(m < M ? m : 0) * D + chunk * 8;
    const int bytes = m < M ? 16 : 0;
    cp_async<16>(&ks[swz(row, chunk)], kg + src, bytes);
    cp_async<16>(&vs[swz(row, chunk)], vg + src, bytes);
  }
}

// the A fragments of 16 rows of a swizzled (64, 64) tile, from row r0
__device__ __forceinline__ void ldmatrix_a(uint32_t (&a)[4][4], const __nv_bfloat16* tile,
                                           int r0, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    ldmatrix_x4(a[kk], tile + swz(r0 + (lane & 15), 2 * kk + (lane >> 4)));
  }
}

// s = Q K^T over a tile's 64 refs: 8 column tiles of 8 refs
__device__ __forceinline__ void qk_tile(float (&s)[8][4], const uint32_t (&qa)[4][4],
                                        const __nv_bfloat16* ks, int lane) {
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
}

// acc += P V: V tiles through ldmatrix.trans, two column tiles per load
__device__ __forceinline__ void pv_tile(float (&acc)[8][4], const uint32_t (&pa)[4][4],
                                        const __nv_bfloat16* vs, int lane) {
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
}

// running max of rows gid / gid + 8 from this thread's tile maxima; alpha
// rescales the sums and the accumulator
__device__ __forceinline__ void update_max(float (&tmax)[2], float (&mrun)[2],
                                           float (&alpha)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the row's 4 threads are one quad
    tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
    tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
    const float new_max = fmaxf(mrun[h], tmax[h]);
    alpha[h] = expf(mrun[h] - new_max);
    mrun[h] = new_max;
  }
}

// out rows r0 and r0 + 8 of one (lane, group): acc / l, exact zeros where
// l is 0
__device__ __forceinline__ void store_rows(float* outg, const float (&acc)[8][4],
                                           const float (&lrun)[2], int r0, int N,
                                           int tig) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = lrun[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int n = r0 + 8 * h;
    if (n >= N) continue;
    float* orow = outg + (long long)n * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float2 res = make_float2(0.0f, 0.0f);
      if (l > 0.0f) res = make_float2(acc[j][2 * h] / l, acc[j][2 * h + 1] / l);
      *reinterpret_cast<float2*>(orow + j * 8 + 2 * tig) = res;
    }
  }
}

// ---------------------------------------------------------------------------
// Modes "none" and "input": one block per (lane, group, 64 rows)

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
    load_kv_tile<NT>(sm.k[st], sm.v[st], kg, vg, m0, M, tid);
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

    float s[8][4];
    qk_tile(s, qa, sm.k[st], lane);

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
    update_max(tmax, mrun, alpha);

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
    pv_tile(acc, pa, sm.v[st], lane);

    if (more && tid < TM) sm.uk[ahead % S][tid] = u_next;
  }

  store_rows(out + bg * N * D, acc, lrun, n0 + warp * 16 + gid, N, tig);
}

template <bool BIAS>
cudaError_t launch(int B, int N, int M, cudaStream_t s, const __nv_bfloat16* q,
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
// Mode "compute": one block per (lane, 2 groups, 64 rows), a cluster of 8 per
// (lane, 64 rows)

namespace pos {

constexpr int GB = 2;                     // groups per block (two blocks an SM)
constexpr int WARPS = 4 * GB;             // 4 warps of 16 rows per group
constexpr int NT = 32 * WARPS;            // 256 threads
constexpr int TN = 64;                    // query rows per block
constexpr int F = posw::F;                // sinusoid frequencies
constexpr int J = 4 * F;                  // features of the dx/dy or the dw/dh pair
constexpr int PW_STRIDE = TM + 8;         // f32 row stride of the pw stage
constexpr int PW_PLANE = TN * PW_STRIDE + 8;  // per group; +8 staggers the banks
constexpr int CLUSTER = G / GB;           // the 8 group pairs of one (lane, 64 rows)
constexpr int ROW_TILES = TN / CLUSTER * TM / 16 / WARPS;  // feature tiles per warp (4)
constexpr int MIN_BLOCKS = 65536 / 128 / NT;  // blocks per SM at 128 registers

struct Smem {
  __nv_bfloat16 k[GB][TM * D];  // swizzled 128-byte rows
  __nv_bfloat16 v[GB][TM * D];
  __nv_bfloat16 q[GB][TN * D];
  float pw[GB * PW_PLANE];       // the dx/dy part of the tile's position weight
  __half t[GB][TM * J];          // T: (ref, feature) fp16, swizzled 64-byte rows
  __half s[TN * J];              // S: (row, feature) fp16, the same layout
  float params[posw::PARAMS];
  uint4 wf[2][2][32];            // Wg's dx/dy B fragments: [k-step][hi|lo][lane]
  float4 rgeo[TN];               // (cx, cy, 1/w, 1/h) of the block's rows
  float4 fgeo[2][TM];            // (cx, cy, log w, log h) of a tile's refs
  float uk[2][GB][TM];           // uk / 8, or -inf for an invalid ref or past M
  float4 ml[NT];                 // a thread's running max and sums (rows gid, gid + 8)
};

// element offset of 16-byte chunk `chunk` (of 4) of row `row` of an S or T
// tile: chunks XOR-swizzled by row / 2, so ldmatrix's 8 rows hit 8 distinct
// 16-byte bank groups
__device__ __forceinline__ int tsw(int row, int chunk) {
  return row * J + ((chunk ^ ((row >> 1) & 3)) << 3);
}

// the thread index, read afresh: the addresses derived from it are
// recomputed where they are used instead of being hoisted out of the tile
// loop, where they outlived the feature pass and spilled
__device__ __forceinline__ int tid_now() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

// (a, b) as a bf16 pair hi plus the bf16 pair lo of the remainders, both
// truncated (a byte permute, no conversion instruction): hi + lo carries 15
// bits of each (x - hi is exact in f32)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const uint32_t ua = __float_as_uint(a), ub = __float_as_uint(b);
  hi = __byte_perm(ua, ub, 0x7632);
  const float la = a - __uint_as_float(ua & 0xffff0000u);
  const float lb = b - __uint_as_float(ub & 0xffff0000u);
  lo = __byte_perm(__float_as_uint(la), __float_as_uint(lb), 0x7632);
}

__global__ void __cluster_dims__(1, CLUSTER, 1) __launch_bounds__(NT, MIN_BLOCKS)
relation_attention_pos_tc_kernel(const __nv_bfloat16* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ k,
                                 const __nv_bfloat16* __restrict__ v,
                                 const float* __restrict__ uk,
                                 const uint8_t* __restrict__ valid,
                                 const float* __restrict__ rois,
                                 const float* __restrict__ refs,
                                 const float* __restrict__ params,
                                 float* __restrict__ out, int N, int M) {
  extern __shared__ __align__(128) unsigned char smem[];
  Smem& sm = *reinterpret_cast<Smem*>(smem);
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int b = blockIdx.z, g0 = blockIdx.y * GB;  // the block's first group
  const int rank = cluster.block_rank();           // == blockIdx.y
  const int gl = warp / 4;                         // the warp's group in the block
  const int n0 = blockIdx.x * TN, rw = (warp % 4) * 16;  // the warp's first row
  const long long bg = (long long)b * G + g0 + gl;
  const int tiles = (M + TM - 1) / TM;
  const float* par = sm.params;
  const float* fr = par + posw::FREQ;

  // K and V of the block's groups for tile t, as one cp.async group
  auto load_tile = [&](int t) {
    const int tid = tid_now();
#pragma unroll
    for (int gg = 0; gg < GB; ++gg) {
      const long long kv = ((long long)b * G + g0 + gg) * M * D;
      load_kv_tile<NT>(sm.k[gg], sm.v[gg], k + kv, v + kv, t * TM, M, tid);
    }
    cp_async_commit();
  };
  // uk and ref geometry of tile t into buffer t % 2 (see tc's ref_term)
  auto stage_refs = [&](int t) {
    const int buf = t & 1, tid = tid_now();
    if (tid < GB * TM) {
      const int gg = tid / TM, mm = tid % TM, m = t * TM + mm;
      sm.uk[buf][gg][mm] = (m < M && valid[(long long)b * M + m])
                               ? uk[((long long)b * G + g0 + gg) * M + m] * SCALE
                               : -INFINITY;
    } else if (tid < GB * TM + TM) {
      const int mm = tid - GB * TM, m = min(t * TM + mm, M - 1);
      const float4 geo = posw::geometry(refs + ((long long)b * M + m) * 4);
      sm.fgeo[buf][mm] = make_float4(geo.z, geo.w, logf(geo.x), logf(geo.y));
    }
  };
  // sin and cos of f log w and f log h, [w|h][sin|cos], for one S or T row:
  // thread (row tid / F, frequency f = tid % F) writes the row's 4 values of f
  auto row_sincos = [&](float lw, float lh, float (&sc)[2][2], int f) {
    posw::sincos_reduced(__fmul_rn(lw, fr[f]), sc[0][0], sc[0][1]);
    posw::sincos_reduced(__fmul_rn(lh, fr[f]), sc[1][0], sc[1][1]);
  };

  // Q of the block's groups (its own cp.async group), parameters, row
  // geometry, S
  for (int i = tid; i < GB * TN * 8; i += NT) {  // 64 rows x 8 chunks per group
    const int gg = i / (TN * 8), row = i / 8 % TN, chunk = i % 8, n = n0 + row;
    cp_async<16>(&sm.q[gg][swz(row, chunk)],
                 q + (((long long)b * G + g0 + gg) * N + (n < N ? n : 0)) * D + chunk * 8,
                 n < N ? 16 : 0);
  }
  cp_async_commit();
  for (int i = tid; i < posw::PARAMS; i += NT) sm.params[i] = params[i];
  __syncthreads();  // the frequencies and Wg
  if (tid < 64) {
    // Wg's dx (k-step 0) and dy (k-step 1) rows as split B fragments of two
    // column tiles for lane l: column l / 4 of tile nt is group 8 nt + l / 4
    const int kk = tid / 32, l = tid % 32;
    uint32_t hi[4], lo[4];  // [column tile][b0 | b1]
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int cosine = 0; cosine < 2; ++cosine) {
        auto w = [&](int f) { return par[posw::wg_row(kk, cosine, f) * G + 8 * nt + l / 4]; };
        split_bf16(w(2 * (l % 4)), w(2 * (l % 4) + 1), hi[2 * nt + cosine], lo[2 * nt + cosine]);
      }
    }
    sm.wf[kk][0][l] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    sm.wf[kk][1][l] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  for (int i = tid; i < TN * F; i += NT) {  // S: thread (row i / F, frequency i % F)
    const int r = i / F, f = i % F;
    const float4 geo = posw::geometry(rois + ((long long)b * N + min(n0 + r, N - 1)) * 4);
    if (f == 0) sm.rgeo[r] = make_float4(geo.z, geo.w, 1.0f / geo.x, 1.0f / geo.y);
    float sc[2][2];
    row_sincos(logf(geo.x), logf(geo.y), sc, f);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      sm.s[tsw(r, 2 * c) + f] = __float2half_rn(sc[c][0]);
      sm.s[tsw(r, 2 * c + 1) + f] = __float2half_rn(sc[c][1]);
    }
  }
  if (tiles > 0) {
    load_tile(0);
    stage_refs(0);
  }

  // 1. the dx/dy part of pw: this block's quarter of the 64 rows, all 16
  // groups, stored into the pw stages of the cluster's 4 blocks
  auto features = [&](int t) {
    const float4* fg = sm.fgeo[t & 1];
    // this thread's two frequencies, 2 tig and 2 tig + 1: its A fragment
    // columns hold their sines (2 tig, 2 tig + 1) and cosines (+8)
    const float fr0 = fr[2 * tig], fr1 = fr[2 * tig + 1];
#pragma unroll 1
    for (int i = 0; i < ROW_TILES; ++i) {
      const int tile = warp * ROW_TILES + i;
      const int row = rank * (TN / CLUSTER) + tile / (TM / 16), m16 = (tile % (TM / 16)) * 16;
      float dxy[2][4] = {};  // [column tile]
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {  // dx, dy
        uint32_t ah[4], al[4];            // the split A fragment
#pragma unroll
        for (int h = 0; h < 2; ++h) {     // pairs gid, gid + 8
          const float4 rg = sm.rgeo[row];
          const float4 c = fg[m16 + gid + 8 * h];
          const float d = kk == 0 ? __logf(fabsf(__fmul_rn(rg.x - c.x, rg.z)) + 1e-3f)
                                  : __logf(fabsf(__fmul_rn(rg.y - c.y, rg.w)) + 1e-3f);
          float s0, c0, s1, c1;
          posw::sincos_reduced(__fmul_rn(d, fr0), s0, c0);
          posw::sincos_reduced(__fmul_rn(d, fr1), s1, c1);
          split_bf16(s0, s1, ah[h], al[h]);
          split_bf16(c0, c1, ah[2 + h], al[2 + h]);
        }
        // feat . Wg to ~2^-15: the small cross terms first, lo . lo dropped
        const uint4 wh = sm.wf[kk][0][lane], wl = sm.wf[kk][1][lane];
        mma_bf16(dxy[0], al, wh.x, wh.y);
        mma_bf16(dxy[0], ah, wl.x, wl.y);
        mma_bf16(dxy[0], ah, wh.x, wh.y);
        mma_bf16(dxy[1], al, wh.z, wh.w);
        mma_bf16(dxy[1], ah, wl.z, wl.w);
        mma_bf16(dxy[1], ah, wh.z, wh.w);
      }
      // columns 2 tig and 2 tig + 1 of tile nt: groups 8 nt + 2 tig (+1),
      // of one block of the cluster
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int g = 8 * nt + 2 * tig;
        float* p0 = cluster.map_shared_rank(sm.pw, g / GB) + g % GB * PW_PLANE +
                    row * PW_STRIDE + m16 + gid;
        p0[0] = dxy[nt][0];
        p0[PW_PLANE] = dxy[nt][1];
        p0[8] = dxy[nt][2];
        p0[PW_PLANE + 8] = dxy[nt][3];
      }
    }
  };
  // 2. T of the tile: Wg's dw/dh rows folded with sin/cos of f log w_m and
  // f log h_m into alpha = ws cos b + wc sin b, beta = wc cos b - ws sin b
  auto build_t = [&](int t) {
    for (int i = tid_now(); i < TM * F; i += NT) {  // thread (ref i / F, frequency i % F)
      const int mm = i / F, f = i % F;
      const float4 rg = sm.fgeo[t & 1][mm];
      float sc[2][2];  // [w|h][sin|cos]
      row_sincos(rg.z, rg.w, sc, f);
#pragma unroll
      for (int gg = 0; gg < GB; ++gg) {
        __half* tt = sm.t[gg];
#pragma unroll
        for (int c = 0; c < 2; ++c) {  // dw, dh
          const float ws = par[posw::wg_row(2 + c, 0, f) * G + g0 + gg];
          const float wc = par[posw::wg_row(2 + c, 1, f) * G + g0 + gg];
          const float sb = sc[c][0], cb = sc[c][1];
          tt[tsw(mm, 2 * c) + f] =
              __float2half_rn(__fadd_rn(__fmul_rn(ws, cb), __fmul_rn(wc, sb)));
          tt[tsw(mm, 2 * c + 1) + f] =
              __float2half_rn(__fsub_rn(__fmul_rn(wc, cb), __fmul_rn(ws, sb)));
        }
      }
    }
  };

  float acc[8][4];  // O: 8 column tiles of 8
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  // the running max and this thread's share of the row sums live in shared
  // memory between tiles: held in registers through the feature pass they
  // spilled
  sm.ml[tid] = make_float4(NEG_INF, NEG_INF, 0.0f, 0.0f);

  // S, the row geometry and tile 0's refs are staged, and every block of the
  // cluster runs, so its shared memory takes the others' stores
  cluster.sync();
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    features(t);
    build_t(t);
    cp_async_wait<0>();  // this thread's copies of K/V tile t (and Q) have landed
    cluster.sync();      // everyone's, T, and the pw stage from all 4 blocks
    if (t + 1 < tiles) stage_refs(t + 1);  // the buffer tile t - 1 read

    // 3. this warp's (group, 16 rows) of pw, finished in place: the dw/dh
    // part S . T per 8-ref column tile (two mma.sync, landing in the
    // logits' fragment layout), plus the staged dx/dy part and b, relu, 1e-6
    const int ln = tid_now() % 32, lg = ln / 4, lt = ln % 4;
    float* pwg = sm.pw + gl * PW_PLANE + (rw + lg) * PW_STRIDE;
    {
      uint32_t sa[2][4];  // S of the warp's rows: f log w (k-step 0), f log h
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        ldmatrix_x4(sa[kk], sm.s + tsw(rw + (ln & 15), 2 * kk + (ln >> 4)));
      }
      const __half* ts = sm.t[gl];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t tb[4];
        ldmatrix_x4(tb, ts + tsw(j * 8 + (ln & 7), ln >> 3));
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_f16(c, sa[0], tb[0], tb[1]);
        mma_f16(c, sa[1], tb[2], tb[3]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* x = reinterpret_cast<float2*>(pwg + 8 * h * PW_STRIDE + j * 8 + 2 * lt);
          const float2 xv = *x;
          const float wb = posw::bias_of(par)[g0 + gl];
          *x = make_float2(fmaxf(xv.x + c[2 * h] + wb, 0.0f) + 1e-6f,
                           fmaxf(xv.y + c[2 * h + 1] + wb, 0.0f) + 1e-6f);
        }
      }
    }

    // 4. QK, online max, p = exp(s - max) * pw, PV
    float s[8][4];
    {
      uint32_t qa[4][4];
      ldmatrix_a(qa, sm.q[gl], rw, ln);
      qk_tile(s, qa, sm.k[gl], ln);
    }
    const float* uks = sm.uk[buf][gl];
    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 u = *reinterpret_cast<const float2*>(uks + j * 8 + 2 * lt);
      s[j][0] = fmaf(s[j][0], SCALE, u.x);
      s[j][1] = fmaf(s[j][1], SCALE, u.y);
      s[j][2] = fmaf(s[j][2], SCALE, u.x);
      s[j][3] = fmaf(s[j][3], SCALE, u.y);
      tmax[0] = fmaxf(tmax[0], fmaxf(s[j][0], s[j][1]));
      tmax[1] = fmaxf(tmax[1], fmaxf(s[j][2], s[j][3]));
    }
    const int me = tid_now();
    const float4 ml = sm.ml[me];
    float mrun[2] = {ml.x, ml.y}, alpha[2];
    update_max(tmax, mrun, alpha);

    float psum[2] = {0.0f, 0.0f};
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 w0 = *reinterpret_cast<const float2*>(pwg + j * 8 + 2 * lt);
      const float2 w1 = *reinterpret_cast<const float2*>(pwg + 8 * PW_STRIDE + j * 8 + 2 * lt);
      const float p0 = __fmul_rn(expf(s[j][0] - mrun[0]), w0.x);
      const float p1 = __fmul_rn(expf(s[j][1] - mrun[0]), w0.y);
      const float p2 = __fmul_rn(expf(s[j][2] - mrun[1]), w1.x);
      const float p3 = __fmul_rn(expf(s[j][3] - mrun[1]), w1.y);
      psum[0] += p0 + p1;
      psum[1] += p2 + p3;
      pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    sm.ml[me] = make_float4(mrun[0], mrun[1], ml.z * alpha[0] + psum[0],
                            ml.w * alpha[1] + psum[1]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    pv_tile(acc, pa, sm.v[gl], ln);

    // every warp of the cluster is done with K/V, T and its pw stage of tile t
    cluster.sync();
    if (t + 1 < tiles) load_tile(t + 1);
  }

  const float lrun[2] = {sm.ml[tid].z, sm.ml[tid].w};
  store_rows(out + bg * N * D, acc, lrun, n0 + rw + gid, N, tig);
}

cudaError_t launch(int B, int N, int M, cudaStream_t s, const __nv_bfloat16* q,
                   const __nv_bfloat16* k, const __nv_bfloat16* v, const float* uk,
                   const uint8_t* valid, const float* rois, const float* refs,
                   const float* params, float* out) {
  constexpr int smem = sizeof(Smem);
  const cudaError_t err = cudaFuncSetAttribute(
      relation_attention_pos_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TN - 1) / TN, G / GB, B);
  relation_attention_pos_tc_kernel<<<grid, NT, smem, s>>>(q, k, v, uk, valid, rois, refs,
                                                          params, out, N, M);
  return cudaGetLastError();
}

}  // namespace pos

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
      return (int)tc::launch<false>(B, N, M, s, qb, kb, vb, ukf, vd, nullptr, o);
    case MODE_COMPUTE:
      return (int)pos::launch(B, N, M, s, qb, kb, vb, ukf, vd,
                              static_cast<const float*>(rois),
                              static_cast<const float*>(refs),
                              static_cast<const float*>(params), o);
    case MODE_INPUT:
      return (int)tc::launch<true>(B, N, M, s, qb, kb, vb, ukf, vd,
                                   static_cast<const float*>(bias), o);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
