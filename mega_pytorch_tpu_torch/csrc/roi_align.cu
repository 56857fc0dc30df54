// ROIAlign as one gather: maskrcnn-benchmark semantics (no half-pixel
// shift, ROI extents floored at 1, sampling_ratio 0 = an adaptive
// ceil(extent / pooled) grid a bin capped at max_grid, taps outside
// [-1, size] adding zero, coordinates clamped at the edges), over lanes
// that each hold their own map and ROIs:
//   out[l, r, ph, pw, c] = sum_h sum_w Wy[l, r, ph, h] Wx[l, r, pw, w] feat[l, h, w, c]
// where Wy (Wx) sums the bin's bilinear tap weights over its samples
// divided by the grid: exactly ops/roi_align.py:_axis_weights, whose
// coordinate arithmetic is repeated here operation for operation in f32
// (__fmul_rn / __fadd_rn / __fdiv_rn, no contraction), so that every tap
// and the [-1, size] test fall where the plain version puts them.
//
// Replaces: no TPU kernel. The JAX package's ROIAlign
// (mega_pytorch_tpu/ops/roi_align.py) is plain JAX; this kernel takes the
// place of the plain version's dense one-hot weights and two f32 einsums on
// the card, which read whole map rows for each ROI.
//
// Operands: feat (L, H, W, C) with channel stride 1 and any lane, row and
// column strides, f32 or bf16, read as stored; rois (L, R, 4) f32 xyxy in
// image coordinates; out (L, R, PH, PW, C) f32 or bf16, contiguous,
// accumulated in f32 and rounded once at the store.
//
// Bound: the output bytes. MEGA's 12 lanes x (300 + 75) ROIs x 49 bins x
// 2048 channels are 0.90 GB in bf16 (0.27 ms at 3.35 TB/s) against 0.24 GB
// of bf16 maps read once. What the kernel cannot avoid beyond that: each
// ROI reads its own stretch of the map, from L2 (a lane's bf16 map, 10 MB
// at 38x64x2048, stays resident while its ROIs run), so an ROI that covers
// the map reads 10 MB for its 0.2 MB of output; the arithmetic is a few
// FMAs a tap.
// Design: one block per (lane, ROI, group of bin rows): all PH rows where
// lanes x ROIs fill the card, one row a block where they do not. Lanes are
// the grid's slowest index, so a lane's ROIs run together over its map.
// The block first computes the ROI's taps into shared memory from its four
// numbers (a thread a bin row or column: its samples' (row, weight) or
// (column, weight) pairs, merged where samples share a row), then merges
// the columns of each chunk of PWC bins into one table of (column, PWC
// weights). The weights never reach device memory. Threads run along the
// channels, V of them a thread (16-byte loads: 8 bf16 or 4 f32; one channel
// where C or a stride is not a multiple of V), so every tap is a coalesced
// run of the NHWC map. For each bin row and each column of the table, a
// thread interpolates the column over the row's taps and adds the value
// into the bins' accumulators whose x weight there is not zero: O(span x
// taps) loads and about O(2 span) accumulations per channel, not 4 gh gw
// taps per bin. The loads wait on L2, so a thread interpolates NC = 3
// columns at once with their loads issued together (1 to 4 columns timed
// at MEGA's shapes: 2 ran 1.2-1.3x as fast as 1, 3 another 5-7 %; 4, at 128
// registers, slower than 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int PWC = 7;         // bins of one column chunk: a thread's accumulators
constexpr int NC = 3;          // columns a pass
constexpr int ROW_UNROLL = 2;  // row taps a pass, unrolled
constexpr int THREADS = 256;   // threads of a block, at most

// the (index, weight) taps of bin p along one axis, as _axis_weights sums
// them: ascending, one entry per index, zero weights left out; returns the
// count (at most 2 g)
__device__ int axis_taps(float start, float bin, int g, int p, int len, int* idx, float* w) {
  const float gf = (float)g;
  const float wm = __fdiv_rn(1.f, gf);
  const float base = __fadd_rn(start, __fmul_rn((float)p, bin));
  int n = 0;
  auto add = [&](int i, float v) {
    if (v == 0.f) return;
    int j = n;
    while (j > 0 && idx[j - 1] > i) --j;
    if (j > 0 && idx[j - 1] == i) {
      w[j - 1] = __fadd_rn(w[j - 1], v);
      return;
    }
    for (int k = n; k > j; --k) {
      idx[k] = idx[k - 1];
      w[k] = w[k - 1];
    }
    idx[j] = i;
    w[j] = v;
    ++n;
  };
  for (int s = 0; s < g; ++s) {
    const float coord = __fadd_rn(base, __fdiv_rn(__fmul_rn((float)s + 0.5f, bin), gf));
    if (!(coord >= -1.f && coord <= (float)len)) continue;
    const float c = fmaxf(coord, 0.f);
    const float low = floorf(c);
    if (low >= (float)(len - 1)) {
      add(len - 1, wm);  // both taps at the edge: (1 + 0) x the sample's weight
    } else {
      const float lf = __fsub_rn(c, low);
      add((int)low, __fmul_rn(__fsub_rn(1.f, lf), wm));
      add((int)low + 1, __fmul_rn(lf, wm));
    }
  }
  return n;
}

// W channels at p as f32
template <typename T, int W>
__device__ __forceinline__ void load_f32(const T* p, float (&f)[W]) {
  if constexpr (W == 1) {
    if constexpr (std::is_same<T, float>::value) {
      f[0] = __ldg(p);
    } else {
      f[0] = __bfloat162float(__ldg(p));
    }
  } else if constexpr (std::is_same<T, float>::value) {
    static_assert(W == 4, "f32 vectors are 4 channels");
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  } else {
    static_assert(W == 8, "bf16 vectors are 8 channels");
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
}

// W f32 sums at p, rounded once to O
template <typename O, int W>
__device__ __forceinline__ void store(O* p, const float (&a)[W]) {
  if constexpr (std::is_same<O, float>::value) {
    if constexpr (W % 4 == 0) {
#pragma unroll
      for (int i = 0; i < W; i += 4) {
        reinterpret_cast<float4*>(p)[i / 4] = make_float4(a[i], a[i + 1], a[i + 2], a[i + 3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < W; ++i) p[i] = a[i];
    }
  } else if constexpr (W == 1) {
    p[0] = __float2bfloat16_rn(a[0]);
  } else {
    uint32_t u[W / 2];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(a[2 * i], a[2 * i + 1]);
      u[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    if constexpr (W == 8) {
      *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
    } else {
      static_assert(W == 4, "bf16 stores of 4 or 8 channels");
      *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
    }
  }
}

struct Taps {
  const int* rrow;  // [nph][G2] rows of each bin row
  const float* rw;
  const int* rn;    // [nph] row counts
  const int* tcol;  // [chunks][PWC * G2] columns of each chunk's table
  const float* tw;  // [chunks][PWC * G2][PWC] their weights, bin by bin
  const int* tn;    // [chunks] table lengths
};

// one channel group (W channels at base / out_roi) through every bin row of
// the block and every column chunk
template <typename T, typename O, int W>
__device__ __forceinline__ void pool_channels(const T* __restrict__ base, O* __restrict__ out_roi,
                                              const Taps& t, int C, long long s_row,
                                              long long s_col, int ph0, int nph, int PW,
                                              int G2) {
  const int chunks = (PW + PWC - 1) / PWC;
  for (int i = 0; i < nph; ++i) {
    const int nr = t.rn[i];
    const int* rows = t.rrow + i * G2;
    const float* rws = t.rw + i * G2;
    for (int ch = 0; ch < chunks; ++ch) {
      const int p0 = ch * PWC;
      const int nk = min(PWC, PW - p0);
      float acc[PWC][W];
#pragma unroll
      for (int k = 0; k < PWC; ++k) {
#pragma unroll
        for (int q = 0; q < W; ++q) acc[k][q] = 0.f;
      }
      // NC columns a pass, their row taps' loads issued together; a short
      // last pass repeats its last column with no weight
      const int e0 = ch * PWC * G2, e1 = e0 + t.tn[ch];
      for (int e = e0; e < e1; e += NC) {
        const T* col[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) col[c] = base + (long long)t.tcol[min(e + c, e1 - 1)] * s_col;
        float v[NC][W];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
#pragma unroll
          for (int q = 0; q < W; ++q) v[c][q] = 0.f;
        }
#pragma unroll (ROW_UNROLL)
        for (int j = 0; j < nr; ++j) {
          const long long ro = (long long)rows[j] * s_row;
          float f[NC][W];
#pragma unroll
          for (int c = 0; c < NC; ++c) load_f32<T, W>(col[c] + ro, f[c]);
          const float wj = rws[j];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
#pragma unroll
            for (int q = 0; q < W; ++q) v[c][q] = fmaf(wj, f[c][q], v[c][q]);
          }
        }
        // most columns reach one or two bins: the zero weights are skipped
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (e + c >= e1) break;
          const float* we = t.tw + (long long)(e + c) * PWC;
#pragma unroll
          for (int k = 0; k < PWC; ++k) {
            const float wk = we[k];
            if (wk != 0.f) {
#pragma unroll
              for (int q = 0; q < W; ++q) acc[k][q] = fmaf(wk, v[c][q], acc[k][q]);
            }
          }
        }
      }
      O* o = out_roi + ((long long)(ph0 + i) * PW + p0) * C;
#pragma unroll
      for (int k = 0; k < PWC; ++k) {
        if (k < nk) store<O, W>(o + (long long)k * C, acc[k]);
      }
    }
  }
}

template <typename T, typename O, int V>
__global__ void __launch_bounds__(THREADS)
roi_align_kernel(const T* __restrict__ feat, const float* __restrict__ rois,
                 O* __restrict__ out, int R, int H, int Wd, int C, long long s_lane,
                 long long s_row, long long s_col, int PH, int PW, int phb, float scale,
                 int sampling_ratio, int max_grid) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G2 = 2 * (sampling_ratio > 0 ? sampling_ratio : max_grid);
  const int chunks = (PW + PWC - 1) / PWC;
  const int entries = chunks * PWC * G2;
  float* tw = reinterpret_cast<float*>(smem);  // [entries][PWC]
  float* rw = tw + entries * PWC;              // [phb][G2]
  float* xw = rw + phb * G2;                   // [PW][G2]
  int* tcol = reinterpret_cast<int*>(xw + PW * G2);  // [entries]
  int* rrow = tcol + entries;                  // [phb][G2]
  int* xcol = rrow + phb * G2;                 // [PW][G2]
  int* rn = xcol + PW * G2;                    // [phb]
  int* xn = rn + phb;                          // [PW]
  int* tn = xn + PW;                           // [chunks]

  const int r = blockIdx.x, lane = blockIdx.z;
  const int ph0 = blockIdx.y * phb, nph = min(phb, PH - ph0);
  const float* roi = rois + ((long long)lane * R + r) * 4;
  const float x1 = __fmul_rn(roi[0], scale), y1 = __fmul_rn(roi[1], scale);
  const float roi_w = fmaxf(__fsub_rn(__fmul_rn(roi[2], scale), x1), 1.f);
  const float roi_h = fmaxf(__fsub_rn(__fmul_rn(roi[3], scale), y1), 1.f);
  const float bin_w = __fdiv_rn(roi_w, (float)PW), bin_h = __fdiv_rn(roi_h, (float)PH);
  int gh = sampling_ratio, gw = sampling_ratio;
  if (sampling_ratio <= 0) {
    gh = min(max((int)ceilf(bin_h), 1), max_grid);
    gw = min(max((int)ceilf(bin_w), 1), max_grid);
  }

  for (int i = threadIdx.x; i < nph + PW; i += blockDim.x) {
    if (i < nph) {
      rn[i] = axis_taps(y1, bin_h, gh, ph0 + i, H, rrow + i * G2, rw + i * G2);
    } else {
      const int p = i - nph;
      xn[p] = axis_taps(x1, bin_w, gw, p, Wd, xcol + p * G2, xw + p * G2);
    }
  }
  __syncthreads();
  // each chunk's table: the union of its bins' columns, ascending, with
  // each bin's weight (0 where the bin has no tap there)
  for (int ch = threadIdx.x; ch < chunks; ch += blockDim.x) {
    const int p0 = ch * PWC, nk = min(PWC, PW - p0);
    int at[PWC];
    for (int k = 0; k < PWC; ++k) at[k] = 0;
    int e = ch * PWC * G2;
    while (true) {
      int m = INT_MAX;
      for (int k = 0; k < nk; ++k) {
        if (at[k] < xn[p0 + k]) m = min(m, xcol[(p0 + k) * G2 + at[k]]);
      }
      if (m == INT_MAX) break;
      tcol[e] = m;
      for (int k = 0; k < PWC; ++k) {
        float w = 0.f;
        if (k < nk && at[k] < xn[p0 + k] && xcol[(p0 + k) * G2 + at[k]] == m) {
          w = xw[(p0 + k) * G2 + at[k]];
          ++at[k];
        }
        tw[e * PWC + k] = w;
      }
      ++e;
    }
    tn[ch] = e - ch * PWC * G2;
  }
  __syncthreads();

  const Taps t{rrow, rw, rn, tcol, tw, tn};
  const T* base = feat + (long long)lane * s_lane;
  O* out_roi = out + ((long long)lane * R + r) * PH * PW * (long long)C;
  for (int u = threadIdx.x; u < C / V; u += blockDim.x) {
    pool_channels<T, O, V>(base + u * V, out_roi + u * V, t, C, s_row, s_col, ph0, nph, PW,
                           G2);
  }
}

size_t smem_bytes(int PW, int phb, int G2) {
  const size_t entries = (size_t)((PW + PWC - 1) / PWC) * PWC * G2;
  return entries * (PWC + 1) * 4 + (size_t)(phb + PW) * G2 * 8 + (size_t)(phb + PW) * 4 +
         (size_t)((PW + PWC - 1) / PWC) * 4;
}

int multiprocessors() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      sms = 132;
    }
  }
  return sms;
}

template <typename T, typename O, int V>
cudaError_t launch(const void* feat, const float* rois, void* out, int lanes, int R, int H,
                   int W, int C, long long s_lane, long long s_row, long long s_col, int PH,
                   int PW, float scale, int sampling_ratio, int max_grid, cudaStream_t s) {
  // a block per (lane, ROI) where they fill the card, else per bin row too
  const int phb = (long long)lanes * R >= 4LL * multiprocessors() ? PH : 1;
  const int G2 = 2 * (sampling_ratio > 0 ? sampling_ratio : max_grid);
  const size_t smem = smem_bytes(PW, phb, G2);
  auto kernel = roi_align_kernel<T, O, V>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int units = C / V;
  const int threads = std::min(THREADS, (units + 31) / 32 * 32);
  const dim3 grid(R, (PH + phb - 1) / phb, lanes);
  kernel<<<grid, threads, smem, s>>>(static_cast<const T*>(feat), rois, static_cast<O*>(out),
                                     R, H, W, C, s_lane, s_row, s_col, PH, PW, phb, scale,
                                     sampling_ratio, max_grid);
  return cudaGetLastError();
}

template <typename T, typename O>
cudaError_t launch_vec(bool vector, const void* feat, const float* rois, void* out, int lanes,
                       int R, int H, int W, int C, long long s_lane, long long s_row,
                       long long s_col, int PH, int PW, float scale, int sampling_ratio,
                       int max_grid, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (vector) {
    return launch<T, O, V>(feat, rois, out, lanes, R, H, W, C, s_lane, s_row, s_col, PH, PW,
                           scale, sampling_ratio, max_grid, s);
  }
  return launch<T, O, 1>(feat, rois, out, lanes, R, H, W, C, s_lane, s_row, s_col, PH, PW,
                         scale, sampling_ratio, max_grid, s);
}

}  // namespace

// feat (lanes, H, W, C) at element strides (s_lane, s_row, s_col, 1); rois
// (lanes, R, 4) f32 contiguous; out (lanes, R, PH, PW, C) contiguous
extern "C" int roi_align_launch(const void* feat, const void* rois, void* out, int lanes,
                                int R, int H, int W, int C, long long s_lane, long long s_row,
                                long long s_col, int PH, int PW, float scale,
                                int sampling_ratio, int max_grid, int in_bf16, int out_bf16,
                                void* stream) {
  if (lanes < 0 || R < 0 || H < 1 || W < 1 || C < 1 || PH < 1 || PW < 1 || lanes > 65535 ||
      PH > 65535 || (sampling_ratio <= 0 && max_grid < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (lanes == 0 || R == 0) return (int)cudaSuccess;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int v = in_bf16 ? 8 : 4;
  const bool vector = C % v == 0 && s_lane % v == 0 && s_row % v == 0 && s_col % v == 0 &&
                      reinterpret_cast<uintptr_t>(feat) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto* r = static_cast<const float*>(rois);
  cudaError_t e;
  if (in_bf16 && out_bf16) {
    e = launch_vec<__nv_bfloat16, __nv_bfloat16>(vector, feat, r, out, lanes, R, H, W, C,
                                                 s_lane, s_row, s_col, PH, PW, scale,
                                                 sampling_ratio, max_grid, s);
  } else if (in_bf16) {
    e = launch_vec<__nv_bfloat16, float>(vector, feat, r, out, lanes, R, H, W, C, s_lane,
                                         s_row, s_col, PH, PW, scale, sampling_ratio,
                                         max_grid, s);
  } else if (out_bf16) {
    e = launch_vec<float, __nv_bfloat16>(vector, feat, r, out, lanes, R, H, W, C, s_lane,
                                         s_row, s_col, PH, PW, scale, sampling_ratio,
                                         max_grid, s);
  } else {
    e = launch_vec<float, float>(vector, feat, r, out, lanes, R, H, W, C, s_lane, s_row,
                                 s_col, PH, PW, scale, sampling_ratio, max_grid, s);
  }
  return (int)e;
}
