// P1-P3: three formulations of the batched matvec y[b] = E[b] v[b],
// E (bt, m, n) f32, v (bt, n) f32 -> y (bt, m) f32.
//
// Replace the TPU kernels of scripts/probe_dot.py, which probed which
// formulations lower in Mosaic and which is fastest per call (`run`, :30,
// and `timeit`, :74, call them through pl.pallas_call):
//   P1 k_batched (:43)  one batched dot_general;
//   P2 k_pairs   (:50)  one 2-D product (bt*m, n) @ (n, bt) -> (bt, m, bt),
//                       the diagonal b = b' selected and summed;
//   P3 k_vpu     (:61)  a broadcast multiply E * v[:, None, :] and row sum.
// Each keeps its formulation's own work, so the three stay three kernels:
// P2 does bt times the flops of P1 and P3, as the TPU probe did.
//
// Bound: bytes.  At the probe's shape (8, 256, 256) every kernel must read
// E (2.10 MB) and v and write y, 0.63 us at 3.35 TB/s, against 1.05 MFLOP
// (P1, P3) or 8.39 MFLOP (P2) of f32 FMA work, 0.02 and 0.13 us at 67
// TFLOP/s; one launch's latency (a few us) is larger than either.
//
// Design, simple first.  P1: one warp per output row, each lane reading
// 16-byte quads of E's row (a warp reads 512 contiguous bytes), v of the
// instance in shared memory, a butterfly shuffle sum.  P2: one block per
// tile of 16 flattened rows holds the 16 x bt partial sums over the whole
// n in registers, staging 64-column chunks of the E tile and of all bt
// vectors in shared memory (rows padded by one word against bank
// conflicts); the epilogue selects and sums the diagonal in shared memory.
// Plain f32 FMA: TF32 mma.sync would miss the 1e-5 tolerance.  P3: one
// block per (instance, 8-row tile) writes the elementwise products of a
// 128-column chunk to shared memory and sums each row by a tree there,
// adding the chunk sums in order.  No atomics: every sum runs in a fixed
// order, so a repeat launch gives the same bits.
#include "common.cuh"

namespace {

struct ProbeArgs {
  const float* E;  // (bt, m, n)
  const float* v;  // (bt, n)
  float* y;        // (bt, m)
  int bt, m, n;
};

constexpr int P1_WARPS = 8;
constexpr int P1_NMAX = 12288;  // v in 48 KB of dynamic shared memory
// P1_NMAX, P2_BTMAX and the grid.y limit 65535 are copied in the
// package's scripts/probe_dot.py, which refuses the same shapes before a
// launch.

__global__ void __launch_bounds__(P1_WARPS * 32)
    probe_batched_kernel(const ProbeArgs a) {
  extern __shared__ __align__(16) float vs[];  // (n,)
  const int b = blockIdx.y, n = a.n;
  const float* v = a.v + (size_t)b * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) vs[j] = v[j];
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * P1_WARPS + warp;
  if (row >= a.m) return;  // no barrier follows
  const float* e = a.E + ((size_t)b * a.m + row) * n;
  float s = 0.f;
  for (int j = 4 * lane; j < n; j += 128) {
    float q[4];
    lpbox::load4(e + j, q);
    const float4 w = *reinterpret_cast<const float4*>(vs + j);
    s = fmaf(q[0], w.x, s);
    s = fmaf(q[1], w.y, s);
    s = fmaf(q[2], w.z, s);
    s = fmaf(q[3], w.w, s);
  }
  s = lpbox::warp_sum(s);
  if (lane == 0) a.y[(size_t)b * a.m + row] = s;
}

constexpr int P2_ROWS = 16;   // flattened rows of E per block
constexpr int P2_KC = 64;     // columns per staged chunk
constexpr int P2_NT = 128;
constexpr int P2_BTMAX = 64;  // vectors held: 16 * 64 sums in registers
constexpr int P2_OUT = P2_ROWS * P2_BTMAX / P2_NT;

__global__ void __launch_bounds__(P2_NT) probe_pairs_kernel(const ProbeArgs a) {
  __shared__ float es[P2_ROWS][P2_KC + 1];
  __shared__ float vsh[P2_BTMAX][P2_KC + 1];
  __shared__ float ps[P2_ROWS][P2_BTMAX + 1];
  const int bt = a.bt, n = a.n;
  const long long rows = (long long)bt * a.m;
  const long long r0 = (long long)blockIdx.x * P2_ROWS;
  const int nout = P2_ROWS * bt;  // output o: row o / bt, vector o % bt
  float acc[P2_OUT];
#pragma unroll
  for (int q = 0; q < P2_OUT; ++q) acc[q] = 0.f;
  for (int k0 = 0; k0 < n; k0 += P2_KC) {
    for (int i = threadIdx.x; i < P2_ROWS * P2_KC; i += P2_NT) {
      const int r = i / P2_KC, c = i % P2_KC, k = k0 + c;
      const long long g = r0 + r;
      es[r][c] = (g < rows && k < n) ? a.E[g * n + k] : 0.f;
    }
    for (int i = threadIdx.x; i < bt * P2_KC; i += P2_NT) {
      const int bb = i / P2_KC, c = i % P2_KC, k = k0 + c;
      vsh[bb][c] = k < n ? a.v[(size_t)bb * n + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < P2_OUT; ++q) {
      const int o = threadIdx.x + q * P2_NT;
      if (o < nout) {
        const int r = o / bt, bb = o % bt;
        float s = acc[q];
#pragma unroll 16
        for (int c = 0; c < P2_KC; ++c) s = fmaf(es[r][c], vsh[bb][c], s);
        acc[q] = s;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < P2_OUT; ++q) {
    const int o = threadIdx.x + q * P2_NT;
    if (o < nout) ps[o / bt][o % bt] = acc[q];
  }
  __syncthreads();
  // y[b, i] = sum_b' where(b' == b, P[b*m + i, b'], 0)
  for (int r = threadIdx.x; r < P2_ROWS; r += P2_NT) {
    const long long g = r0 + r;
    if (g < rows) {
      const int b = (int)(g / a.m);
      float s = 0.f;
      for (int bb = 0; bb < bt; ++bb) s += bb == b ? ps[r][bb] : 0.f;
      a.y[g] = s;
    }
  }
}

constexpr int P3_ROWS = 8;
constexpr int P3_NC = 128;  // columns per chunk (a power of two: tree sum)
constexpr int P3_NT = 256;

__global__ void __launch_bounds__(P3_NT) probe_vpu_kernel(const ProbeArgs a) {
  __shared__ float prod[P3_ROWS][P3_NC];
  __shared__ float vs[P3_NC];
  const int b = blockIdx.y, i0 = blockIdx.x * P3_ROWS, m = a.m, n = a.n;
  const float* E = a.E + (size_t)b * m * n;
  const float* v = a.v + (size_t)b * n;
  float acc = 0.f;  // row threadIdx.x's sum (threads < P3_ROWS)
  for (int j0 = 0; j0 < n; j0 += P3_NC) {
    if (threadIdx.x < P3_NC) {
      const int j = j0 + threadIdx.x;
      vs[threadIdx.x] = j < n ? v[j] : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < P3_ROWS * P3_NC; i += P3_NT) {
      const int r = i / P3_NC, c = i % P3_NC, row = i0 + r, j = j0 + c;
      prod[r][c] = (row < m && j < n) ? E[(size_t)row * n + j] * vs[c] : 0.f;
    }
    __syncthreads();
    for (int s = P3_NC / 2; s > 0; s >>= 1) {
      for (int i = threadIdx.x; i < P3_ROWS * s; i += P3_NT) {
        const int r = i / s, c = i % s;
        prod[r][c] += prod[r][c + s];
      }
      __syncthreads();
    }
    if (threadIdx.x < P3_ROWS) acc += prod[threadIdx.x][0];
    __syncthreads();  // the next chunk overwrites vs and prod
  }
  if (threadIdx.x < P3_ROWS && i0 + threadIdx.x < m)
    a.y[(size_t)b * m + i0 + threadIdx.x] = acc;
}

bool valid(const ProbeArgs& a) {
  return a.E && a.v && a.y && a.bt >= 1 && a.m >= 1 && a.n >= 1;
}

}  // namespace

LPBOX_API int lpbox_probe_args_size() { return (int)sizeof(ProbeArgs); }

LPBOX_API int lpbox_probe_batched(const void* args, void* stream) {
  const ProbeArgs& a = *static_cast<const ProbeArgs*>(args);
  if (!valid(a) || a.n % 4 || a.n > P1_NMAX || a.bt > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.m + P1_WARPS - 1) / P1_WARPS, a.bt);
  probe_batched_kernel<<<grid, P1_WARPS * 32, a.n * sizeof(float),
                         static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

LPBOX_API int lpbox_probe_pairs(const void* args, void* stream) {
  const ProbeArgs& a = *static_cast<const ProbeArgs*>(args);
  const long long tiles =
      ((long long)a.bt * a.m + P2_ROWS - 1) / P2_ROWS;
  if (!valid(a) || a.bt > P2_BTMAX || tiles > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  probe_pairs_kernel<<<(unsigned)tiles, P2_NT, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

LPBOX_API int lpbox_probe_vpu(const void* args, void* stream) {
  const ProbeArgs& a = *static_cast<const ProbeArgs*>(args);
  if (!valid(a) || a.bt > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.m + P3_ROWS - 1) / P3_ROWS, a.bt);
  probe_vpu_kernel<<<grid, P3_NT, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
