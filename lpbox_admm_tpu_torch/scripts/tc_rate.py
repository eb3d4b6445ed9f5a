"""The card's rate for ``mma.sync.m16n8k8`` TF32 with f32 sums, the
instruction that K2 (``csrc/policy.cu``) and P2 run their three-pass
products on.

    python -m lpbox_admm_tpu_torch.scripts.tc_rate

compiles a throughput kernel with ``nvcc`` into the build directory
(each warp keeps 8 independent fragments; operands stay in registers,
so no memory traffic), times it with CUDA events at three grid shapes
and prints TFLOP/s (2 x 16 x 8 x 8 flop an mma) with the card's name.
The data-sheet TF32 peak, 495 TFLOP/s on an H100 SXM, is reached only
by ``wgmma``.  Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import sys
from typing import Dict

import torch

from ..kernels import build

SRC = r"""
#include <cuda_runtime.h>
__global__ void tc_rate_kernel(float* out, int iters) {
  unsigned a[4];
  for (int i = 0; i < 4; ++i)
    a[i] = __float_as_uint(1.0f + (threadIdx.x + i) * 1e-3f) & 0xffffe000u;
  const unsigned b0 = a[0] ^ 0x100000u, b1 = a[1] ^ 0x200000u;
  float c[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j)
    for (int q = 0; q < 4; ++q) s += c[j][q];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int tc_rate_run(float* out, int blocks, int threads, int iters,
                           void* stream) {
  tc_rate_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""
ITERS = 4000
MMAS_A_WARP = 8          # independent fragments a warp
FLOP_AN_MMA = 2 * 16 * 8 * 8


def _library() -> ctypes.CDLL:
    tag = hashlib.sha256((SRC + " ".join(build.ARCH_FLAGS)).encode()
                         ).hexdigest()[:16]
    lib = build.BUILD_DIR / f"tc_rate_{tag}.so"
    if not lib.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = build.BUILD_DIR / f"tc_rate_{tag}.cu"
        src.write_text(SRC)
        res = subprocess.run([build.nvcc_path(), *build.ARCH_FLAGS, "-O3",
                              "-shared", "-Xcompiler", "-fPIC", "-o",
                              str(lib), str(src)], capture_output=True,
                             text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{res.stderr}")
    so = ctypes.CDLL(str(lib))
    so.tc_rate_run.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    so.tc_rate_run.restype = ctypes.c_int
    return so


def rate() -> Dict[str, float]:
    """TFLOP/s of mma.sync m16n8k8 TF32 at 'blocks x threads' grids."""
    if not torch.cuda.is_available():
        raise RuntimeError("tc_rate needs a CUDA device")
    so = _library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for blocks, threads in ((4 * sms, 256), (sms, 512), (2 * sms, 512)):
        buf = torch.empty(blocks * threads, device="cuda")
        run = lambda: so.tc_rate_run(buf.data_ptr(), blocks, threads, ITERS,
                                     stream)
        if run() != 0:
            raise RuntimeError("tc_rate kernel launch failed")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            run()
        stop.record()
        stop.synchronize()
        s = start.elapsed_time(stop) / 3 / 1e3
        flop = FLOP_AN_MMA * MMAS_A_WARP * ITERS * blocks * threads / 32
        out[f"{blocks}x{threads}"] = flop / s / 1e12
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("tc_rate: no CUDA device", file=sys.stderr)
        return 2
    for grid, tf in rate().items():
        print(f"mma.sync m16n8k8 tf32, grid {grid}: {tf:.1f} TFLOP/s "
              f"({torch.cuda.get_device_name(0)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
