// K4: y = G v for a symmetric G from its packed lower-triangle blocks.
//
// Replaces the TPU kernel lpbox_admm_tpu/ops/pallas_symm.py::_symm_kernel
// (called by symm_matvec, pallas_symm.py:107).  G is packed once per
// window by ops/symm.py::pack_tril into (B, L, 128, 128) f32 blocks,
// L = T(T+1)/2, block l = r(r+1)/2 + c holding rows r, columns c <= r.
//
// Bound: bytes.  Each packed element is read once and used twice
// (y_r += G_rc v_c and, off the diagonal, y_c += G_rc^T v_r), 2 flops per
// use; at the large CA rung (B, m) = (8, 1664) that is 47.7 MB, 0.54x the
// dense G^{-1}, against ~0.2 GFLOP.
//
// Design.  One thread block per (packed block, instance), 256 threads:
// warp w holds rows 16w..16w+15 of the block and lane q the column quad
// 4q..4q+3 (one 16-byte load per row and thread, a warp reading a whole
// 512-byte row).  Row sums are finished by a warp butterfly; column sums
// are combined over the 8 warps in shared memory in warp order.  The
// two 128-vectors go to a workspace; a second launch adds, for each
// output block r, the row parts of blocks (r, 0..r) and then the column
// parts of blocks (r+1..T-1, r) in that order.  No atomics: a repeat
// launch gives the same bits.
#include "common.cuh"

namespace {

constexpr int BM = 128;
constexpr int NTS = 256;

struct SymmArgs {
  const float* Gp;  // (B, L, 128, 128)
  const float* v;   // (B, m)
  float* y;         // (B, m)
  float* part;      // (B, L, 2, 128) workspace: row part, column part
  int B, m, T, L;
};

__device__ __forceinline__ void block_coords(int l, int& r, int& c) {
  r = (int)((sqrtf(8.f * (float)l + 1.f) - 1.f) * 0.5f);
  while ((r + 1) * (r + 2) / 2 <= l) ++r;
  while (r * (r + 1) / 2 > l) --r;
  c = l - r * (r + 1) / 2;
}

__global__ void __launch_bounds__(NTS) symm_blocks_kernel(const SymmArgs a) {
  __shared__ float colp[NTS / 32][BM];
  const int l = blockIdx.x, b = blockIdx.y;
  int r, c;
  block_coords(l, r, c);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* G = a.Gp + ((size_t)b * a.L + l) * BM * BM;
  const float* v = a.v + (size_t)b * a.m;
  const float4 vc = *reinterpret_cast<const float4*>(v + c * BM + 4 * lane);
  float* part = a.part + ((size_t)b * a.L + l) * 2 * BM;
  float cs[4] = {0.f, 0.f, 0.f, 0.f};
  float g[16][4];
#pragma unroll
  for (int k = 0; k < 16; ++k)
    lpbox::load4(G + (size_t)(16 * warp + k) * BM + 4 * lane, g[k]);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int row = 16 * warp + k;
    float s = g[k][0] * vc.x;
    s = fmaf(g[k][1], vc.y, s);
    s = fmaf(g[k][2], vc.z, s);
    s = fmaf(g[k][3], vc.w, s);
    s = lpbox::warp_sum(s);
    if (lane == 0) part[row] = s;
    const float vr = v[r * BM + row];
#pragma unroll
    for (int q = 0; q < 4; ++q) cs[q] = fmaf(g[k][q], vr, cs[q]);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) colp[warp][4 * lane + q] = cs[q];
  __syncthreads();
  if (threadIdx.x < BM) {
    float s = 0.f;
    if (r != c) {
#pragma unroll
      for (int w = 0; w < NTS / 32; ++w) s += colp[w][threadIdx.x];
    }
    part[BM + threadIdx.x] = s;
  }
}

__global__ void __launch_bounds__(BM) symm_finish_kernel(const SymmArgs a) {
  const int r = blockIdx.x, b = blockIdx.y, k = threadIdx.x;
  const float* part = a.part + (size_t)b * a.L * 2 * BM;
  float s = 0.f;
  for (int c = 0; c <= r; ++c) s += part[(size_t)(r * (r + 1) / 2 + c) * 2 * BM + k];
  for (int i = r + 1; i < a.T; ++i)
    s += part[(size_t)(i * (i + 1) / 2 + r) * 2 * BM + BM + k];
  a.y[(size_t)b * a.m + r * BM + k] = s;
}

}  // namespace

LPBOX_API int lpbox_symm_args_size() { return (int)sizeof(SymmArgs); }

LPBOX_API int lpbox_symm_matvec(const void* args, void* stream) {
  const SymmArgs& a = *static_cast<const SymmArgs*>(args);
  if (a.m != a.T * BM || a.L != a.T * (a.T + 1) / 2 || a.B < 1 ||
      a.B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  symm_blocks_kernel<<<dim3(a.L, a.B), NTS, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  symm_finish_kernel<<<dim3(a.T, a.B), BM, 0, s>>>(a);
  return (int)cudaGetLastError();
}
