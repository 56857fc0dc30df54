// Bottleneck epilogue: the elementwise tail of a ResNet bottleneck's
// convolution under frozen BN, with the BN scale already folded into the
// convolution's weights (models/backbone/resnet.py:Bottleneck):
//   y[p, c] = relu(a[p, c] + shift[c] (+ r[p, c]))
// over NHWC maps, the sums in f32 (__fadd_rn, a + shift first, then r) and
// rounded once to the map's type: bit for bit the plain version
// (ops/kernels/bottleneck_epilogue.py:bottleneck_epilogue_reference).
//
// Replaces: no TPU kernel. The JAX package's FrozenBN, relu and residual
// add are plain JAX that XLA fuses into the convolutions; on the card the
// plain PyTorch forward ran them as 3-4 passes a convolution (BN's product
// and sum over broadcast channels_last operands, relu, the residual add).
//
// Operands: a and r (N, H, W, C) contiguous (an NCHW tensor in channels_last
// memory), bf16 or f32, y likewise and distinct from both; shift (C,) f32.
// C times the element size must be a multiple of 16 bytes (8 bf16 or 4 f32
// channels), and a, r and y 16-byte aligned.
//
// Bound: the bytes, a and r read once and y written once. At layer3's map
// of 24 frames (24, 38, 64, 1024) in bf16 with the residual: 0.359 GB,
// 0.107 ms at 3.35 TB/s.
// Design: a thread owns one 16-byte vector of channels (8 bf16 or 4 f32)
// at a time and walks the map with a grid-stride loop. The block holds a
// whole number of channel rows' vectors and so does the grid, so a thread's
// channels never change: its V shifts are loaded once into registers. Each
// pass of the loop issues UNROLL vectors' loads (a and r, streaming) before
// any arithmetic, to keep enough bytes in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;  // block size aimed at (a multiple of the row's vectors)
constexpr int UNROLL = 4;     // vectors a thread has in flight

template <typename T>
struct Pack;

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ static void unpack(const uint4& u, float (&f)[V]) {
    const auto* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < V / 2; ++k) {
      const float2 t = __bfloat1622float2(h[k]);
      f[2 * k] = t.x;
      f[2 * k + 1] = t.y;
    }
  }
  __device__ static uint4 pack(const float (&f)[V]) {
    uint4 u;
    auto* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < V / 2; ++k) h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    return u;
  }
};

template <>
struct Pack<float> {
  static constexpr int V = 4;
  __device__ static void unpack(const uint4& u, float (&f)[V]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float (&f)[V]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

// blockDim.x and gridDim.x * blockDim.x are multiples of row_vecs
template <typename T, bool RES>
__global__ void __launch_bounds__(1024)
    bottleneck_epilogue_kernel(const uint4* __restrict__ a, const uint4* __restrict__ r,
                               const float* __restrict__ shift, uint4* __restrict__ y,
                               long long vecs, int row_vecs) {
  constexpr int V = Pack<T>::V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int c0 = (int)(threadIdx.x % row_vecs) * V;
  float s[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = __ldg(shift + c0 + k);
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < vecs;
       v += UNROLL * stride) {
    uint4 av[UNROLL], rv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long w = v + u * stride;
      if (w < vecs) {
        av[u] = __ldcs(a + w);
        if (RES) rv[u] = __ldcs(r + w);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long w = v + u * stride;
      if (w < vecs) {
        float f[V], g[V];
        Pack<T>::unpack(av[u], f);
        if (RES) Pack<T>::unpack(rv[u], g);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          float t = __fadd_rn(f[k], s[k]);
          if (RES) t = __fadd_rn(t, g[k]);
          f[k] = t < 0.f ? 0.f : t;  // a NaN stays NaN, as torch.relu keeps it
        }
        y[w] = Pack<T>::pack(f);
      }
    }
  }
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

template <typename T, bool RES>
cudaError_t launch(const void* a, const void* r, const float* shift, void* y,
                   long long elements, int channels, cudaStream_t s) {
  constexpr int V = Pack<T>::V;
  const auto kernel = bottleneck_epilogue_kernel<T, RES>;
  const int row_vecs = channels / V;
  const long long vecs = elements / V;
  const int threads = row_vecs * std::max(1, THREADS / row_vecs);
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                      threads, 0);
  if (e != cudaSuccess) return e;
  // one wave: every block resident at once, none without a vector
  const long long needed = (vecs + threads - 1) / threads;
  const long long resident = (long long)multiprocessors() * std::max(1, per_sm);
  const int grid = (int)std::max(1LL, std::min(needed, resident));
  kernel<<<grid, threads, 0, s>>>(static_cast<const uint4*>(a), static_cast<const uint4*>(r),
                                  shift, static_cast<uint4*>(y), vecs, row_vecs);
  return cudaGetLastError();
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// a, r (r may be null: no residual) and y hold `elements` values of
// `channels` channels each, channel fastest; shift (channels,) f32
extern "C" int bottleneck_epilogue_launch(const void* a, const void* r, const void* shift,
                                          void* y, long long elements, int channels,
                                          int is_bf16, void* stream) {
  const int v = is_bf16 ? 8 : 4;
  if (channels < v || channels % v != 0 || channels / v > 1024 || elements < 0 ||
      elements % channels != 0 || !aligned(a) || !aligned(y) ||
      (r != nullptr && !aligned(r))) {
    return (int)cudaErrorInvalidValue;
  }
  if (elements == 0) return (int)cudaSuccess;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* sh = static_cast<const float*>(shift);
  if (is_bf16) {
    return (int)(r != nullptr ? launch<__nv_bfloat16, true>(a, r, sh, y, elements, channels, s)
                              : launch<__nv_bfloat16, false>(a, r, sh, y, elements, channels, s));
  }
  return (int)(r != nullptr ? launch<float, true>(a, r, sh, y, elements, channels, s)
                            : launch<float, false>(a, r, sh, y, elements, channels, s));
}
