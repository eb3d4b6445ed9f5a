// Shared helpers of the port's CUDA kernels (plain C interface, no
// PyTorch headers: the library builds with one nvcc call in seconds).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define LPBOX_API extern "C" __attribute__((visibility("default")))

namespace lpbox {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Four consecutive matrix entries as float (16-byte f32 or 8-byte bf16
// load; callers keep rows 4-aligned).
__device__ __forceinline__ void load4(const float* p, float (&e)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  e[0] = t.x; e[1] = t.y; e[2] = t.z; e[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&e)[4]) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  e[0] = a.x; e[1] = a.y; e[2] = b.x; e[3] = b.y;
}

// c += A (16 x 8, row) B (8 x 8, col) on the tensor cores in TF32 with
// f32 sums (P2, K2); fragments as in the PTX ISA's m16n8k8 .tf32 layout
// (lane = 4g + t: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4);
// b0 (t, g), b1 (t+4, g); c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Sum of K values over the whole block, returned to EVERY thread (so a
// decision taken on the result is uniform across the block).  Every
// thread of the block must call it; it ends with a barrier, so `red`
// (K * NT/32 + K floats of shared memory) can be reused right after.
template <int K, int NT>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[k * NW + warp] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float s = lane < NW ? red[k * NW + lane] : 0.f;
      s = warp_sum(s);
      if (lane == 0) red[K * NW + k] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = red[K * NW + k];
  __syncthreads();
}

}  // namespace lpbox
