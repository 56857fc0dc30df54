"""How fast the card writes the standalone position bias's (16, N, M) f32
output in the store patterns a kernel can give it, against the
``fused_position_bias`` kernel itself.

    python -m mega_pytorch_tpu_torch.tools.write_probe [--n 675] [--m 3750]

Five store-only kernels write the same constant output: "pieces" (each
warp store 32 refs of one plane, a warp walking 32-ref chunks of its rows),
"runs" (each warp a row's 128 refs of one plane in a row, 4 stores of 128
bytes from the tile's first ref), "aligned runs" (the same with each store
starting on a 32-byte sector: the kernel's pattern), "block rows" (a
block's 8 warps on 256 consecutive refs of one row) and "flat" (the output
as one flat array); ``torch.Tensor.fill_`` is the card's own. With M = 3750
three plane rows of four start off the 32-byte sector grid. Times: CUDA
events, median of alternating turns (``tools/kernel_bench``). Prints one
line per pattern with its rate and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from ..ops.kernels import position_bias as pb
from ..ops.kernels.build import BUILD_DIR, NVCC_FLAGS, _nvcc
from .kernel_bench import attention_inputs, time_alternating

SOURCE = r"""
#include <cuda_runtime.h>
__global__ void pieces(float* out, int N, int M) {  // block (128 refs, 16 rows)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * 128, n0 = blockIdx.y * 16;
  const long long plane = (long long)N * M;
  for (int r = warp; r < 16 && n0 + r < N; r += 8) {
    float* row = out + (long long)(n0 + r) * M;
    for (int c = 0; c < 128; c += 32) {
      const int m = m0 + c + lane;
      if (m < M) for (int g = 0; g < 16; ++g) row[g * plane + m] = 1.0f;
    }
  }
}
__global__ void runs(float* out, int N, int M) {  // block (128 refs, 16 rows)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * 128, n0 = blockIdx.y * 16;
  const long long plane = (long long)N * M;
  for (int r = warp; r < 16 && n0 + r < N; r += 8) {
    float* row = out + (long long)(n0 + r) * M;
    for (int g = 0; g < 16; ++g)
      for (int c = 0; c < 128; c += 32) {
        const int m = m0 + c + lane;
        if (m < M) row[g * plane + m] = 1.0f;
      }
  }
}
__global__ void aligned_runs(float* out, int N, int M) {  // as runs, sector-aligned
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * 128, n0 = blockIdx.y * 16;
  const long long plane = (long long)N * M;
  for (int r = warp; r < 16 && n0 + r < N; r += 8) {
    float* row = out + (long long)(n0 + r) * M;
    for (int g = 0; g < 16; ++g) {
      const int a = (int)((g * plane + (long long)(n0 + r) * M + m0) & 7);
      for (int c = -a; c < 128; c += 32) {
        const int mm = c + lane;
        if (mm >= 0 && mm < 128 && m0 + mm < M) row[g * plane + m0 + mm] = 1.0f;
      }
    }
  }
}
__global__ void block_rows(float* out, int N, int M) {  // block (256 refs, 16 rows)
  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * 256 + threadIdx.x / 32 * 32 + lane, n0 = blockIdx.y * 16;
  const long long plane = (long long)N * M;
  for (int r = 0; r < 16 && n0 + r < N; ++r)
    if (m < M) for (int g = 0; g < 16; ++g) out[g * plane + (long long)(n0 + r) * M + m] = 1.0f;
}
__global__ void flat(float* out, long long total) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) out[i] = 1.0f;
}
extern "C" int write_probe(int which, float* out, int N, int M, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 g128((M + 127) / 128, (N + 15) / 16), g256((M + 255) / 256, (N + 15) / 16);
  if (which == 0) pieces<<<g128, 256, 0, s>>>(out, N, M);
  if (which == 1) runs<<<g128, 256, 0, s>>>(out, N, M);
  if (which == 2) aligned_runs<<<g128, 256, 0, s>>>(out, N, M);
  if (which == 3) block_rows<<<g256, 256, 0, s>>>(out, N, M);
  if (which == 4) flat<<<132 * 8, 256, 0, s>>>(out, 16LL * N * M);
  return (int)cudaGetLastError();
}
"""
PATTERNS = ("pieces", "runs", "aligned runs", "block rows", "flat")


def _library():
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, lib = BUILD_DIR / "write_probe.cu", BUILD_DIR / "libwrite_probe.so"
    src.write_text(SOURCE)
    subprocess.run([_nvcc(), *NVCC_FLAGS[:6], "-shared", "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).write_probe
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=675)
    ap.add_argument("--m", type=int, default=3750)
    ap.add_argument("--turns", type=int, default=9)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("write_probe: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    probe = _library()
    dev = torch.device("cuda")
    n, m = args.n, args.m
    out = torch.empty((16, n, m), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    x = attention_inputs(torch.Generator(dev).manual_seed(0), 1, n, m, dev)
    pargs = (x["rois"][0].contiguous(), x["refs"][0].contiguous(), x["wk"], x["wb"])

    def store(which):
        if probe(which, out.data_ptr(), n, m, stream):
            raise SystemExit("write_probe: launch failed")

    fns = [lambda w=w: store(w) for w in range(len(PATTERNS))]
    fns += [lambda: out.fill_(1.0), lambda: pb.fused_position_bias(*pargs)]
    names = (*PATTERNS, "fill_", "fused_position_bias")
    for name, ms in zip(names, time_alternating(fns, args.turns)):
        print(f"[write_probe] {name} ({n}, {m}): {ms:.4f} ms, "
              f"{out.numel() * 4 / ms / 1e9:.2f} TB/s; {smi}")


if __name__ == "__main__":
    main()
