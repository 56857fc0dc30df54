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
// Folded layout (frame_rows = s): frames stacked along T at stride s; a row
// t with t % s == 0 starts a frame and takes -inf as its row above, as row 0
// does (JAX's frame_rows). The unfolded layout is s = T.
//
// Bound: device-memory bandwidth. One read of y and a quarter-size write
// (MEGA's 24 frames: 478 MB in, 120 MB out in bf16, 0.178 ms at 3.35 TB/s);
// no arithmetic to speak of.
// Design: one warp walks a strip of one frame: a run of packed rows and a
// tile of W consecutive columns (8 in bf16, 4 in f32), each lane 2 of the
// 64 channels, so every load and store of a warp is one contiguous 128-byte
// (bf16) piece of a cell. Per row a lane issues all its loads at once (the
// tile's 4 W phase words and the left halo column's 2 b'=1 words, no
// branch between them), then walks the tile's columns left to right: r_1 of
// the column to the left is the previous step's (the halo column's for the
// first), and the a'=1 half of the row above (the row halo) and the corner
// stay in registers from the previous row. So y is read from device memory
// once per strip, plus the row above the strip and 1 / (2 W) of halo
// columns, with no shared memory and no barrier. In the folded layout a
// strip that starts at a frame's first row skips the row above, and the
// walk resets the row-above registers to -inf at each frame's first row;
// strips are cut without regard to frames. Scale and shift of the
// lane's channels live in registers. The grid is sized from the occupancy
// so that all blocks are on the card at once: 24 frames take 4 strips of
// 38 rows per (frame, 64 columns), 2 frames 38 strips of 4 rows.
// Arithmetic, bit-exact with the plain version: the affine u = y * scale +
// shift in f32 with __fmul_rn / __fadd_rn (no FMA contraction), each u
// rounded to the output type, the maxima over the rounded values (bf16x2
// in bf16), and relu once on the maximum. Rounding to nearest is monotonic
// and maps 0 to 0, so max(round(u_i)) = round(max u_i), and relu commutes
// with max: the result equals rounding once the f32 maximum of the relu'd
// values, as the plain version does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int O = 64;             // channels: 32 lanes x 2
constexpr int CELL = 4 * O;       // elements of one (t, u) cell of y
constexpr int WARPS = 8;          // warps a block, on consecutive column tiles
constexpr int MIN_ROWS = 4;       // rows of a strip, at the least

// per dtype: 2 channels as loaded (Raw), as u rounded to the type (Z), and
// the columns a warp walks (W)
template <typename T> struct Lane;
template <> struct Lane<__nv_bfloat16> {
  using Raw = uint32_t;
  using Z = __nv_bfloat162;
  static constexpr int W = 8;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  static __device__ __forceinline__ float lo(Raw r) { return __uint_as_float(r << 16); }
  static __device__ __forceinline__ float hi(Raw r) { return __uint_as_float(r & 0xffff0000u); }
  static __device__ __forceinline__ Z pack(float a, float b) { return __floats2bfloat162_rn(a, b); }
  static __device__ __forceinline__ Z max(Z a, Z b) { return __hmax2(a, b); }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, Z z) {
    *reinterpret_cast<__nv_bfloat162*>(p) = z;
  }
};
template <> struct Lane<float> {
  using Raw = float2;
  using Z = float2;
  static constexpr int W = 4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
  static __device__ __forceinline__ float lo(Raw r) { return r.x; }
  static __device__ __forceinline__ float hi(Raw r) { return r.y; }
  static __device__ __forceinline__ Z pack(float a, float b) { return make_float2(a, b); }
  static __device__ __forceinline__ Z max(Z a, Z b) {
    return make_float2(fmaxf(a.x, b.x), fmaxf(a.y, b.y));
  }
  static __device__ __forceinline__ void store(float* p, Z z) {
    *reinterpret_cast<float2*>(p) = z;
  }
};

// grid (strips, column tiles of WARPS * W, N), block 32 * WARPS threads;
// lane l takes channels 2 l and 2 l + 1
template <typename T>
__global__ void __launch_bounds__(32 * WARPS, 3)
stem_pool_kernel(const T* __restrict__ y, const float* __restrict__ scale,
                 const float* __restrict__ shift, T* __restrict__ out, int rows,
                 int cols, int strip_rows, int frame_rows) {
  using L = Lane<T>;
  using Z = typename L::Z;
  constexpr int W = L::W;
  const int lane = threadIdx.x % 32, c2 = 2 * lane;
  const int u0 = (blockIdx.y * WARPS + threadIdx.x / 32) * W;  // first column
  if (u0 >= cols) return;
  const int n = blockIdx.z, t0 = blockIdx.x * strip_rows;
  const int t_end = min(t0 + strip_rows, rows);
  const T* yn = y + (long long)n * rows * cols * CELL + c2;

  float sc[4][2], sh[4][2];  // this lane's channels, per phase
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(scale + p * O + c2));
    const float2 b = __ldg(reinterpret_cast<const float2*>(shift + p * O + c2));
    sc[p][0] = a.x; sc[p][1] = a.y; sh[p][0] = b.x; sh[p][1] = b.y;
  }
  // column j of the walk is u0 - 1 + j: j = 0 the left halo, 1..W the tile;
  // loads read clamped columns, whose results are never stored
  int col[W + 1];
#pragma unroll
  for (int j = 0; j <= W; ++j) col[j] = min(max(u0 - 1 + j, 0), cols - 1);
  auto at = [&](int t, int j, int p) { return yn + ((long long)t * cols + col[j]) * CELL + p * O; };
  auto z_of = [&](typename L::Raw r, int p) {
    return L::pack(__fadd_rn(__fmul_rn(L::lo(r), sc[p][0]), sh[p][0]),
                   __fadd_rn(__fmul_rn(L::hi(r), sc[p][1]), sh[p][1]));
  };
  const Z neg = L::pack(-INFINITY, -INFINITY), zero = L::pack(0.0f, 0.0f);

  Z p2[W + 1], p3[W + 1];  // u of the row above, phases 2 and 3 (-inf above a frame)
#pragma unroll
  for (int j = 0; j <= W; ++j) p2[j] = p3[j] = neg;
  int in_frame = t0 % frame_rows;  // row t's index within its frame
  if (in_frame != 0) {
    typename L::Raw r2[W + 1], r3[W + 1];
#pragma unroll
    for (int j = 0; j <= W; ++j) {
      r2[j] = L::load(at(t0 - 1, j, 2));
      r3[j] = L::load(at(t0 - 1, j, 3));
    }
#pragma unroll
    for (int j = 0; j <= W; ++j) {
      p2[j] = z_of(r2[j], 2);
      p3[j] = z_of(r3[j], 3);
    }
  }

#pragma unroll 1
  for (int t = t0; t < t_end; ++t) {
    if (in_frame == 0) {  // a frame's first row: nothing above it
#pragma unroll
      for (int j = 0; j <= W; ++j) p2[j] = p3[j] = neg;
    }
    if (++in_frame == frame_rows) in_frame = 0;
    typename L::Raw r[W + 1][4];
    r[0][1] = L::load(at(t, 0, 1));
    r[0][3] = L::load(at(t, 0, 3));
#pragma unroll
    for (int j = 1; j <= W; ++j) {
#pragma unroll
      for (int p = 0; p < 4; ++p) r[j][p] = L::load(at(t, j, p));
    }
    // r_1(t, u0 - 1), -inf left of column 0
    const Z h3 = z_of(r[0][3], 3);
    Z left = L::max(L::max(z_of(r[0][1], 1), h3), p3[0]);
    p3[0] = h3;
    if (u0 == 0) left = neg;
    T* orow = out + (((long long)n * rows + t) * cols) * O + c2;
#pragma unroll
    for (int j = 1; j <= W; ++j) {
      const Z z2 = z_of(r[j][2], 2), z3 = z_of(r[j][3], 3);
      const Z r0 = L::max(L::max(z_of(r[j][0], 0), z2), p2[j]);
      const Z r1 = L::max(L::max(z_of(r[j][1], 1), z3), p3[j]);
      p2[j] = z2;
      p3[j] = z3;
      const Z o = L::max(L::max(L::max(r0, r1), left), zero);  // relu, once
      left = r1;
      if (u0 - 1 + j < cols) L::store(orow + (long long)(u0 - 1 + j) * O, o);
    }
  }
}

template <typename T>
cudaError_t launch(const T* y, const float* scale, const float* shift, T* out,
                   int n_img, int rows, int cols, int frame_rows, cudaStream_t s) {
  constexpr int threads = 32 * WARPS, tile = WARPS * Lane<T>::W;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_pool_kernel<T>,
                                                           threads, 0)) != cudaSuccess)
    return err;
  // as many row strips per (frame, column tile) as fit on the card at once,
  // none shorter than MIN_ROWS
  const int tiles = (cols + tile - 1) / tile;
  const long long pairs = (long long)n_img * tiles;
  const long long most = (rows + MIN_ROWS - 1) / MIN_ROWS;
  const long long strips = std::max(1LL, std::min((long long)per_sm * sms / pairs, most));
  const int strip_rows = (int)((rows + strips - 1) / strips);
  const dim3 grid((rows + strip_rows - 1) / strip_rows, tiles, n_img);
  stem_pool_kernel<T><<<grid, threads, 0, s>>>(y, scale, shift, out, rows, cols, strip_rows,
                                               frame_rows);
  return cudaGetLastError();
}

int dispatch(const void* y, const void* scale, const void* shift, void* out, int n_img,
             int rows, int cols, int out_ch, int is_bf16, void* stream, int frame_rows) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (out_ch != O || frame_rows < 0) return (int)cudaErrorInvalidValue;
  if (n_img == 0 || rows == 0 || cols == 0) return (int)cudaGetLastError();
  if (frame_rows == 0) frame_rows = rows;
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  if (is_bf16) {
    return (int)launch(static_cast<const __nv_bfloat16*>(y), sc, sh,
                       static_cast<__nv_bfloat16*>(out), n_img, rows, cols, frame_rows, s);
  }
  return (int)launch(static_cast<const float*>(y), sc, sh, static_cast<float*>(out), n_img,
                     rows, cols, frame_rows, s);
}

}  // namespace

// unfolded layout: one frame per image of the batch
extern "C" int stem_pool_packed_launch(const void* y, const void* scale,
                                       const void* shift, void* out, int n_img,
                                       int rows, int cols, int out_ch,
                                       int is_bf16, void* stream) {
  return dispatch(y, scale, shift, out, n_img, rows, cols, out_ch, is_bf16, stream, 0);
}

// folded layout: frames stacked along the rows at stride frame_rows (0: rows)
extern "C" int stem_pool_packed_folded_launch(const void* y, const void* scale,
                                              const void* shift, void* out, int n_img,
                                              int rows, int cols, int out_ch,
                                              int is_bf16, void* stream, int frame_rows) {
  return dispatch(y, scale, shift, out, n_img, rows, cols, out_ch, is_bf16, stream,
                  frame_rows);
}
