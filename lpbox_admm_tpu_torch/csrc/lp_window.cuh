// K1: a whole window of Woodbury-mode LP ADMM iterations in one launch:
// the kernel, shared by its one-block launch (lp_window.cu) and its
// cluster launch (lp_window_cluster.cu).
//
// Replaces the TPU kernel lpbox_admm_tpu/ops/pallas_lp.py::_window_kernel
// (called by lp_window_fused, pallas_lp.py:476).  Same arithmetic in the
// same order as its `body` (pallas_lp.py:163-306): box and shifted-sphere
// projections, y3 slack, rhs with the E^T w term, the exact x-update
// (m side: E, G^{-1}, E^T; n side: H^{-1} and E^T E), the PCG warm-start
// keep test, dual ascent, the y1/y2 and objective-std stops, the
// feasible incumbent every `incumbent_stride` iterations with the 1e-6
// slack, rho and gamma from exp(k log(base)), and the optional
// trajectory record.
//
// Design.  One thread block per instance (grid = B, 512 threads), or a
// cluster of blocks where few instances are live (below); the window's loop
// runs inside the block, and no block waits on another outside its
// cluster.
// The TPU kernel keeps a block of instances' E and G^{-1} in VMEM.  Here
// the vectors live in shared memory (~50 KB at CA-500), and E takes one
// of four routes, chosen by the wrapper (ops/fused_lp.py) from E's data
// and shape:
//   * f32-stream, bf16-stream: E streams from L2/HBM on every pass (E 512
//     KB f32 / 256 KB bf16 per CA-500 instance does not fit a block);
//   * int8-stream: E held exactly in one byte per entry (every entry an
//     integer in [-127, 127], as CA's 0/1 incidence matrix is) streams
//     in place of the f32 one: a quarter of the bytes, more loads in
//     flight per thread;
//   * int8-resident: where the one-byte E fits beside the vectors (CA-500:
//     128 KB + 52.5 KB of 227 KB), the block copies its instance's E into
//     shared memory once at the window's start, and only G^{-1} (or
//     H^{-1}, E^T E) streams, which L2 holds across iterations at
//     CA-500 (32 MB for 128 instances).
// A one-byte entry is decoded exactly: its byte, biased by 128, is
// permuted into the mantissa of 2^23 and 2^23 + 128 subtracted (one byte
// permute and one add per entry).  Each product e * v is then the f32
// route's product and the sums keep their order, so every route gives the
// same bits.  The passes:
//   * E v and G^{-1} v: warps over rows, lanes along the row (4 entries a
//     lane: 16-byte f32 loads, 4-byte int8 loads), warp-shuffle reduction;
//   * E^T w: thread groups over column quads, each group over a strided
//     subset of rows, partial sums combined in shared memory;
//   * the two forward products (E rhs, E x0) share one pass over E and
//     the two transpose products (E^T u, E^T E x0) another: an m-side
//     iteration makes 3 passes over E (4 on incumbent iterations) and one
//     over G^{-1}.
// Thread-block clusters (``LpWindowArgs.cluster`` = C > 1): where few
// instances are live, one instance's window runs on a cluster of C blocks,
// so the window's streams reach C SMs an instance and not one.  The matrix
// passes split the rows: block r takes rows [r s, r s + s) of E and of
// G^{-1} (s = share_rows(m, C)), and on the n side rows of H^{-1} and
// E_f^T E_f by share_rows(n, C).  Each block keeps every n-vector whole and
// does the elementwise work and every block_sum over n on it, so those
// decisions agree across the cluster with no exchange; of the m-vectors
// (z4, y3, E x, ...) a block keeps and updates its own rows.
//   * forward products into n-vectors (H^{-1} rhs, E_f^T E_f x0), and
//     E rhs, which G^{-1} needs whole: each block writes its rows, and
//     after a cluster barrier copies the other blocks' rows from their
//     shared memory (cl_gather).  A row is summed as at C = 1, so the
//     forward products keep their bits;
//   * transpose products (E^T w, E^T u, E^T E x0): each block leaves its
//     partial sums over its rows in an exchange vector, and every block
//     adds the C partials in block-rank order (cl_sum): the same bits in
//     every block and from run to run, another order of sums than C = 1;
//   * the incumbent's count of violated rows: each block's count over its
//     rows, added over the cluster in rank order (cl_total);
//   * where a block's share of the factor fits beside the carve-up
//     (``fac_resident``), it is copied into shared memory once a window,
//     as E is on the resident route (which holds only the block's rows).
// Exchange buffers and barriers: a block may write a buffer that another
// block reads only after a cluster barrier that the reader passes after its
// read.  E^T w's partials go to xn (rewritten only after the next exchange),
// E^T u's to `xch` (m side); a gathered vector's rows are rewritten only
// after the next exchange.  A block leaves only after a last cluster
// barrier, so its shared memory outlives every remote read.  C = 1
// launches the one-block kernel (CL false; lp_window.cu), in which every
// row range is all rows and no exchange exists; C > 1 the cluster kernel
// (CL true; lp_window_cluster.cu, on the one-byte E routes), C a runtime
// cluster dimension, its shared memory raised so that no two of its
// blocks share an SM.
//
// Bound: per m-side iteration and instance the kernel must read E at
// least once per dependent product chain; the card-level bound that the
// smoke reports counts each input once per launch (bytes) against the
// f32 FMA work of the window (operations), see chip_smoke.py.
//
// Barrier discipline (a barrier that not every thread reaches hangs the
// block, or the cluster): every helper below is called by all threads and
// starts and ends with a barrier; every decision (keep, convergence, std
// stop, incumbent sampling, done) is computed from block sums, which every
// thread reads from the same shared slots (or, in the cluster kernel,
// reduces from the same partials in the same order), and from data that
// every block of a cluster holds bit for bit, so the branches are uniform
// across the cluster; an instance that is done leaves the loop with all
// its threads (in record mode it keeps writing its frozen x, with no
// barrier).  A done instance's iteration is an exact no-op in the TPU
// kernel, so leaving the loop early changes no output.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace lpw {

// The cluster kernel's launch and occupancy (lp_window_cluster.cu), on
// the one-byte E routes; `args` is an LpWindowArgs.
cudaError_t launch_cluster(const void* args, cudaStream_t stream);
cudaError_t cluster_occupancy(int e_route, int need, int C, int* out);

}  // namespace lpw

namespace {

constexpr int NT = 512;        // threads per block
constexpr int NW = NT / 32;    // warps per block
constexpr int HMAX = 32;       // largest objective-history ring
constexpr float EPS = 2.2204e-16f;

// E routes (LpWindowArgs.e_route; ops/fused_lp.E_ROUTES in this order)
enum ERoute {
  kF32Stream = 0, kBf16Stream = 1, kI8Stream = 2, kI8Resident = 3
};

struct LpWindowArgs {
  const void* E;           // (B, m, n) float32, bfloat16 or int8 (e_route)
  const float* fac;        // (B, m, m) G^{-1}, or (B, n, n) H^{-1} (n side)
  const float* ete;        // (B, n, n) E_f^T E_f (n side), else null
  const float* b;          // (B, n)
  const float* rmask;      // (B, m) 0/1
  const float* x_in;       // (B, n)
  const float* z1_in;      // (B, n)
  const float* z2_in;      // (B, n)
  const float* z4_in;      // (B, m)
  const float* feff;       // (B, m)
  const float* free_in;    // (B, n) 0/1
  const float* ring_in;    // (B, H)
  const int* count_in;     // (B,)
  const int* done_in;      // (B,) 0/1
  const float* curobj_in;  // (B,)
  const float* bestobj_in; // (B,)
  const float* bestsol_in; // (B, n)
  float* x_out;
  float* z1_out;
  float* z2_out;
  float* z4_out;
  float* ring_out;
  int* count_out;
  int* done_out;
  float* curobj_out;
  float* bestobj_out;
  float* bestsol_out;
  float* y1_out;
  float* y2_out;
  float* y3_out;
  float* ex_out;
  float* traj;             // (B, window, n) when record, else null
  int B, m, n, H, window, it0, skip_cvg_at, record, nside, e_route;
  int rho_change_step, incumbent_stride, feasible_incumbent;
  int smem_bytes;          // dynamic shared memory, as the caller sized it
  int cluster;             // blocks an instance (a cluster), 1 to 8
  int fac_resident;        // cluster > 1: the block's factor rows in shared
                           // memory, else streamed
  float initial_rho, log_learning_fact, gamma0, log_gamma_factor;
  float stop_threshold, std_threshold, pcg_tol2;
};

// Four one-byte entries as exact floats: each byte biased by 128 into the
// low mantissa byte of 2^23, then 2^23 + 128 subtracted.
__device__ __forceinline__ void dec4(unsigned w, float (&e)[4]) {
  const unsigned u = w ^ 0x80808080u;
  e[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  e[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  e[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  e[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

// Four consecutive matrix entries as floats, from global memory (SH
// false) or from shared memory (SH true, the resident one-byte E).
template <bool SH>
__device__ __forceinline__ void ld4(const float* p, float (&e)[4]) {
  if (SH) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    e[0] = t.x; e[1] = t.y; e[2] = t.z; e[3] = t.w;
  } else {
    lpbox::load4(p, e);
  }
}
template <bool SH>
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float (&e)[4]) {
  lpbox::load4(p, e);
}
template <bool SH>
__device__ __forceinline__ void ld4(const int8_t* p, float (&e)[4]) {
  dec4(SH ? *reinterpret_cast<const unsigned*>(p)
          : __ldg(reinterpret_cast<const unsigned*>(p)), e);
}

// Loop unrolling UN of the passes below: one-byte E streamed from global
// memory moves 4 bytes a load, so each thread keeps 16 loads in flight; 4
// otherwise.  Unrolling does not change the order of a thread's sums.
//
// out{0,1}[i] = sum_j M[i, j] * v{0,1}[j] for i < rows (v in shared memory).
// A warp takes RW rows at a time (the resident route: 4, so the loads and
// shuffle reductions of 4 rows overlap); each row is summed by one warp,
// lanes over quads q = lane, lane + 32, .. in order and then the shuffle
// tree, whatever RW is.
template <typename TM, int NV, bool SH = false, int RW = 1,
          int UN = (sizeof(TM) == 1 && !SH ? 16 : 4)>
__device__ void mv_rows(const TM* __restrict__ M, int rows, int cols,
                        const float* v0, const float* v1, float* o0,
                        float* o1, bool tail_sync = true) {
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nq = cols >> 2;
  for (int i0 = warp * RW; i0 < rows; i0 += NW * RW) {
    float s0[RW], s1[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) s0[r] = s1[r] = 0.f;
#pragma unroll (UN)
    for (int q = lane; q < nq; q += 32) {
      const float4 a = reinterpret_cast<const float4*>(v0)[q];
      float4 c;
      if (NV == 2) c = reinterpret_cast<const float4*>(v1)[q];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        if (RW > 1 && i0 + r >= rows) break;
        float e[4];
        ld4<SH>(M + (size_t)(i0 + r) * cols + 4 * q, e);
        s0[r] = fmaf(e[0], a.x, s0[r]); s0[r] = fmaf(e[1], a.y, s0[r]);
        s0[r] = fmaf(e[2], a.z, s0[r]); s0[r] = fmaf(e[3], a.w, s0[r]);
        if (NV == 2) {
          s1[r] = fmaf(e[0], c.x, s1[r]); s1[r] = fmaf(e[1], c.y, s1[r]);
          s1[r] = fmaf(e[2], c.z, s1[r]); s1[r] = fmaf(e[3], c.w, s1[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      if (RW > 1 && i0 + r >= rows) break;
      s0[r] = lpbox::warp_sum(s0[r]);
      if (NV == 2) s1[r] = lpbox::warp_sum(s1[r]);
      if (lane == 0) {
        o0[i0 + r] = s0[r];
        if (NV == 2) o1[i0 + r] = s1[r];
      }
    }
  }
  if (tail_sync) __syncthreads();
}

// o0[i] = M0[i, :] v0 and o1[i] = M1[i, :] v1 for i < rows (rows a
// multiple of 4) in one pass: the warps take the rows of both matrices, RW
// at a time, each row summed as mv_rows sums it (the n side's H^{-1} rhs
// and E_f^T E_f x0 of a cluster's block).
template <bool SH, int RW, int UN = 4>
__device__ void mv_rows2(const float* __restrict__ M0,
                         const float* __restrict__ M1, int rows, int cols,
                         const float* v0, const float* v1, float* o0,
                         float* o1, bool tail_sync = true) {
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nq = cols >> 2;
  for (int g0 = warp * RW; g0 < 2 * rows; g0 += NW * RW) {
    const bool second = g0 >= rows;
    const int i0 = second ? g0 - rows : g0;
    const float* M = second ? M1 : M0;
    const float* v = second ? v1 : v0;
    float s[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) s[r] = 0.f;
#pragma unroll (UN)
    for (int q = lane; q < nq; q += 32) {
      const float4 a = reinterpret_cast<const float4*>(v)[q];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        if (RW > 1 && i0 + r >= rows) break;
        float e[4];
        ld4<SH>(M + (size_t)(i0 + r) * cols + 4 * q, e);
        s[r] = fmaf(e[0], a.x, s[r]); s[r] = fmaf(e[1], a.y, s[r]);
        s[r] = fmaf(e[2], a.z, s[r]); s[r] = fmaf(e[3], a.w, s[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      if (RW > 1 && i0 + r >= rows) break;
      s[r] = lpbox::warp_sum(s[r]);
      if (lane == 0) (second ? o1 : o0)[i0 + r] = s[r];
    }
  }
  if (tail_sync) __syncthreads();
}

// out{0,1}[j] = sum_i M[i, j] * w{0,1}[i] for j < cols (w in shared memory).
// `part` holds NV * G * cols floats, G = max(1, NT / (cols / 4)).
template <typename TM, int NV, bool SH = false,
          int UN = (sizeof(TM) == 1 && !SH ? 16 : 4)>
__device__ void mv_cols(const TM* __restrict__ M, int rows, int cols,
                        const float* w0, const float* w1, float* o0,
                        float* o1, float* part, bool tail_sync = true) {
  __syncthreads();
  const int nq = cols >> 2;
  if (nq >= NT) {
    for (int q = threadIdx.x; q < nq; q += NT) {
      float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll (UN)
      for (int i = 0; i < rows; ++i) {
        float e[4];
        ld4<SH>(M + (size_t)i * cols + 4 * q, e);
        const float s0 = w0[i];
#pragma unroll
        for (int k = 0; k < 4; ++k) a0[k] = fmaf(e[k], s0, a0[k]);
        if (NV == 2) {
          const float s1 = w1[i];
#pragma unroll
          for (int k = 0; k < 4; ++k) a1[k] = fmaf(e[k], s1, a1[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        o0[4 * q + k] = a0[k];
        if (NV == 2) o1[4 * q + k] = a1[k];
      }
    }
    if (tail_sync) __syncthreads();
    return;
  }
  const int G = NT / nq;
  const int g = threadIdx.x / nq, q = threadIdx.x % nq;
  if (g < G) {
    float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll (UN)
    for (int i = g; i < rows; i += G) {
      float e[4];
      ld4<SH>(M + (size_t)i * cols + 4 * q, e);
      const float s0 = w0[i];
#pragma unroll
      for (int k = 0; k < 4; ++k) a0[k] = fmaf(e[k], s0, a0[k]);
      if (NV == 2) {
        const float s1 = w1[i];
#pragma unroll
        for (int k = 0; k < 4; ++k) a1[k] = fmaf(e[k], s1, a1[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      part[(g * NV) * cols + 4 * q + k] = a0[k];
      if (NV == 2) part[(g * NV + 1) * cols + 4 * q + k] = a1[k];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < cols; j += NT) {
    float s0 = 0.f, s1 = 0.f;
    for (int gg = 0; gg < G; ++gg) {
      s0 += part[(gg * NV) * cols + j];
      if (NV == 2) s1 += part[(gg * NV + 1) * cols + j];
    }
    o0[j] = s0;
    if (NV == 2) o1[j] = s1;
  }
  if (tail_sync) __syncthreads();
}

__host__ __device__ inline int col_groups(int n) {
  const int nq = n / 4;
  return nq >= NT ? 1 : NT / nq;
}

// Rows a block of a C-block cluster takes of `rows`: equal shares of a
// multiple of 4 (16-byte segments); the last block's may be shorter.
__host__ __device__ inline int share_rows(int rows, int C) {
  return (rows + 4 * C - 1) / (4 * C) * 4;
}

__device__ __forceinline__ const float4* remote4(float* p, int rank) {
  return reinterpret_cast<const float4*>(
      cg::this_cluster().map_shared_rank(p, rank));
}

// Each block of the cluster wrote its share (share_rows(rows, C) rows from
// rank * share) of o0 (and o1); after the barrier every block copies the
// other shares from their owners' shared memory.  The cluster barrier also
// orders the block's own threads, so the pass before it may skip its
// trailing __syncthreads (tail_sync false).
__device__ void cl_gather(float* o0, float* o1, int rows, int share, int C,
                          int rank) {
  cg::this_cluster().sync();
  const int q = share / 4, nq = rows / 4;
  for (int k = threadIdx.x; k < nq; k += NT) {
    const int s = k / q;
    if (s == rank) continue;
    reinterpret_cast<float4*>(o0)[k] = remote4(o0, s)[k];
    if (o1) reinterpret_cast<float4*>(o1)[k] = remote4(o1, s)[k];
  }
  __syncthreads();
}

// Each block of the cluster left its partial sums over its rows of a
// transpose product in src[0, NV * cols); every block adds the C (at most
// 8) partials in block-rank order into o0 (and o1).
template <int NV>
__device__ void cl_sum(float* src, int cols, int C, float* o0, float* o1) {
  cg::this_cluster().sync();
  const int nq = cols / 4;
  for (int k = threadIdx.x; k < NV * nq; k += NT) {
    float4 t[8];   // every remote load in flight before the sum
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (r < C) t[r] = remote4(src, r)[k];
    float4 acc = t[0];
#pragma unroll
    for (int r = 1; r < 8; ++r)
      if (r < C) {
        acc.x += t[r].x; acc.y += t[r].y; acc.z += t[r].z; acc.w += t[r].w;
      }
    float* o = (NV == 2 && k >= nq) ? o1 : o0;
    reinterpret_cast<float4*>(o)[k >= nq ? k - nq : k] = acc;
  }
  __syncthreads();
}

// A block-uniform value summed over the cluster in block-rank order and
// returned to every thread (`slot`: a float of shared memory that no block
// writes again before the next cluster barrier).
__device__ float cl_total(float v, float* slot, int C) {
  if (threadIdx.x == 0) *slot = v;
  cg::this_cluster().sync();
  float s = 0.f;
  for (int r = 0; r < C; ++r) s += *cg::this_cluster().map_shared_rank(slot, r);
  return s;
}

// lpbox::block_sum with one barrier, for the cluster kernel: every warp
// reduces the warps' partials itself (the sums of block_sum, in its order).
// `buf` (K * NW floats) may be written again only after a later barrier.
template <int K>
__device__ __forceinline__ void block_sum1(float (&v)[K], float* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = lpbox::warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) buf[k * NW + warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k)
    v[k] = lpbox::warp_sum(lane < NW ? buf[k * NW + lane] : 0.f);
}

// The kernel's block sums: lpbox::block_sum in the one-block kernel,
// block_sum1 (the same sums) into `buf` in the cluster kernel.
template <bool CL, int K>
__device__ __forceinline__ void bsum(float (&v)[K], float* red, float* buf) {
  if constexpr (CL) block_sum1<K>(v, buf);
  else lpbox::block_sum<K, NT>(v, red);
}

// Global to shared memory, 16 bytes a thread (`count` 16-byte pieces).
__device__ void copy16(void* dst, const void* src, size_t count) {
  uint4* d = static_cast<uint4*>(dst);
  const uint4* g = static_cast<const uint4*>(src);
  for (size_t k = threadIdx.x; k < count; k += NT) d[k] = __ldg(g + k);
}

// CL: the cluster kernel (C = a.cluster > 1 blocks an instance); without it
// C = 1 folds every row range to all rows and every exchange away, so the
// one-block kernel is compiled as if clusters did not exist.
template <typename TE, bool RES, bool CL>
__global__ void __launch_bounds__(NT) lp_window_kernel(const LpWindowArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int C = CL ? a.cluster : 1;
  const int inst = CL ? blockIdx.x / C : blockIdx.x, tid = threadIdx.x;
  const int rank = CL ? (int)cg::this_cluster().block_rank() : 0;
  const bool lead = rank == 0;   // the block that writes the n-vectors
  const int n = a.n, m = a.m, H = a.H;

  // shared-memory vectors (n and m are multiples of 4: 16-byte aligned)
  float* x = sm;          // committed iterate
  float* z1 = x + n;
  float* z2 = z1 + n;
  float* y1 = z2 + n;
  float* y2 = y1 + n;
  float* bb = y2 + n;     // objective
  float* fr = bb + n;     // free mask 0/1
  float* rhs = fr + n;
  float* x0 = rhs + n;    // warm start free * y1
  float* v1 = x0 + n;     // E^T w, then E^T u (m) / H^{-1} rhs (n)
  float* v2 = v1 + n;     // E^T E x0
  float* xn = v2 + n;     // x_exact, then x_new (C > 1: E^T w's partials)
  float* rnd = xn + n;    // rounding for the incumbent
  float* z4 = rnd + n;
  float* fe = z4 + m;     // f_eff
  float* rm = fe + m;     // row mask 0/1
  float* y3 = rm + m;
  float* exc = y3 + m;    // E (free * x) of the committed iterate
  float* w = exc + m;
  float* a1 = w + m;      // E rhs, then ex_new
  float* a2 = a1 + m;     // E x0, then E rounding
  float* u = a2 + m;      // G^{-1} E rhs
  float* part = u + m;    // 2 * G * n
  float* red = part + 2 * col_groups(n) * n;   // 4 * NW + 4
  // C > 1: the cluster sum's slot (4 floats), block_sum1's buffers (7 NW
  // floats), E^T u's and E^T E x0's partials (m side), then the factor rows
  float* csum = red + 4 * NW + 4;
  float* bsa = csum + 4;          // 1 NW: the y norm, incumbent objective
  float* bsb = bsa + NW;          // 2 NW: the keep test, violated rows
  float* bsc = bsb + 2 * NW;      // 4 NW: the convergence sums
  float* xch = csum + (CL ? 4 + 7 * NW : 0);
  float* fsh = xch + (CL && !a.nside ? 2 * n : 0);

  // this block's rows: of E and G^{-1} [r0, r0 + mb), of H^{-1} and
  // E_f^T E_f [q0, q0 + nb) (all of them at C = 1)
  const int ms = CL ? share_rows(m, C) : m, ns = CL ? share_rows(n, C) : n;
  const int r0 = CL ? min(m, rank * ms) : 0;
  const int mb = CL ? min(m, r0 + ms) - r0 : m;
  const int q0 = CL ? min(n, rank * ns) : 0;
  const int nb = CL ? min(n, q0 + ns) - q0 : n;
  bool done = a.done_in[inst] != 0;
  // the factor rows are loaded, and read from shared memory, only by an
  // instance that iterates (a done one leaves before the first pass)
  const bool fres = CL && a.fac_resident && !done;

  // rows a warp takes at a time in the row passes: one on the stream
  // routes, four on the resident route
  constexpr int RWE = RES ? 4 : 1;
  const TE* E = static_cast<const TE*>(a.E) + (size_t)inst * m * n +
                (size_t)r0 * n;
  const float* fac =
      a.fac + (size_t)inst * (a.nside ? (size_t)n * n : (size_t)m * m) +
      (a.nside ? (size_t)q0 * n : (size_t)r0 * m);
  const float* ete =
      a.nside ? a.ete + (size_t)inst * n * n + (size_t)q0 * n : nullptr;
  const size_t on = (size_t)inst * n, om = (size_t)inst * m;
  const size_t fsz = !(CL && a.fac_resident) ? 0
                     : a.nside ? 2 * (size_t)ns * n : (size_t)ms * m;
  if (fres) {
    // the block's factor rows into shared memory, once
    if (a.nside) {
      copy16(fsh, fac, (size_t)nb * n / 4);
      copy16(fsh + (size_t)nb * n, ete, (size_t)nb * n / 4);
      ete = fsh + (size_t)nb * n;
    } else {
      copy16(fsh, fac, (size_t)mb * m / 4);
    }
    fac = fsh;
  }
  if (RES) {
    // the resident route: the block's rows of the one-byte E (a multiple
    // of 16 bytes) into shared memory after the carve-up, once
    void* Es = fsh + fsz;
    copy16(Es, E, (size_t)mb * n / 16);
    E = static_cast<const TE*>(Es);
  }

  for (int j = tid; j < n; j += NT) {
    const float xv = a.x_in[on + j];
    x[j] = xv;
    z1[j] = a.z1_in[on + j];
    z2[j] = a.z2_in[on + j];
    bb[j] = a.b[on + j];
    fr[j] = a.free_in[on + j];
    y1[j] = xv;
    y2[j] = xv;
    x0[j] = fr[j] * xv;
    if (lead) a.bestsol_out[on + j] = a.bestsol_in[on + j];
  }
  for (int i = tid; i < m; i += NT) {
    z4[i] = a.z4_in[om + i];
    fe[i] = a.feff[om + i];
    rm[i] = a.rmask[om + i];
    y3[i] = fe[i];
  }
  // block-uniform scalars: every thread holds the same values; the
  // objective ring in registers, in the cluster kernel (which has fewer
  // registers to spare) one entry a lane, read by shuffles in the same order
  float ring[HMAX];
  float ring_l = 0.f;
  if constexpr (CL) {
    if ((tid & 31) < H) ring_l = a.ring_in[inst * H + (tid & 31)];
  } else {
#pragma unroll
    for (int k = 0; k < HMAX; ++k)
      ring[k] = k < H ? a.ring_in[inst * H + k] : 0.f;
  }
  auto ring_at = [&](int k) -> float {
    if constexpr (CL) return __shfl_sync(0xffffffffu, ring_l, k);
    else return ring[k];
  };
  int count = a.count_in[inst];
  float cur_obj = a.curobj_in[inst], best_obj = a.bestobj_in[inst];

  // E v into o0 (E v1 into o1 where given): this block's rows
  auto e_rows = [&](const float* v0, const float* v1_, float* o0, float* o1,
                    bool tail_sync = true) {
    if (v1_) mv_rows<TE, 2, RES, RWE>(E, mb, n, v0, v1_, o0 + r0, o1 + r0,
                                      tail_sync);
    else mv_rows<TE, 1, RES, RWE>(E, mb, n, v0, nullptr, o0 + r0, nullptr,
                                  tail_sync);
  };
  // a factor's rows (G^{-1} or H^{-1}, E_f^T E_f) times v, into o[lo, ..)
  auto f_rows = [&](const float* M, int rows, int cols, const float* v,
                    float* o) {
    if (fres) mv_rows<float, 1, true, 4>(M, rows, cols, v, nullptr, o,
                                         nullptr);
    else mv_rows<float, 1, false, RWE>(M, rows, cols, v, nullptr, o,
                                       nullptr);
  };

  __syncthreads();
  float nact[1] = {0.f};
  for (int j = tid; j < n; j += NT) nact[0] += fr[j];
  bsum<CL>(nact, red, bsa);
  const float sqrt_n = sqrtf(nact[0]);
  e_rows(x0, nullptr, exc, nullptr);                       // E (free x)

  for (int t = 0; t < a.window; ++t) {
    if (done) {
      if (!a.record) break;
      for (int j = tid; j < n; j += NT)
        a.traj[((size_t)inst * a.window + t) * n + j] = x[j];
      continue;
    }
    const int it = a.it0 + t;
    const float kf = (float)(it / a.rho_change_step);
    const float rho = a.initial_rho * expf(kf * a.log_learning_fact);
    const float gamma = fmaxf(a.gamma0 * expf(kf * a.log_gamma_factor), 1.f);
    const float c = rho + rho;

    // --- y updates -----------------------------------------------------
    float acc[1] = {0.f};
    for (int j = tid; j < n; j += NT) {
      const float xv = x[j];
      y1[j] = fminf(fmaxf(xv + z1[j] / rho, 0.f), 1.f);
      const float sh = fr[j] > 0.5f ? xv + z2[j] / rho - 0.5f : 0.f;
      y2[j] = sh;
      acc[0] += sh * sh;
    }
    bsum<CL>(acc, red, bsa);
    const float nrm = sqrtf(acc[0]);
    for (int j = tid; j < n; j += NT)
      y2[j] = fr[j] > 0.5f ? y2[j] * sqrt_n / (2.f * fmaxf(nrm, EPS)) + 0.5f
                           : x[j];
    for (int i = r0 + tid; i < r0 + mb; i += NT) {
      const float y3v = fmaxf(fe[i] - exc[i] - z4[i] / rho, 0.f);
      y3[i] = y3v;
      w[i] = rho * (fe[i] - y3v) - z4[i];
    }

    // --- rhs + exact solve ---------------------------------------------
    if constexpr (!CL) {
      mv_cols<TE, 1, RES>(E, m, n, w, nullptr, v1, nullptr, part);  // E^T w
    } else {
      mv_cols<TE, 1, RES>(E, mb, n, w + r0, nullptr, xn, nullptr, part,
                          false);
      cl_sum<1>(xn, n, C, v1, nullptr);
    }
    for (int j = tid; j < n; j += NT) {
      const float f = fr[j];
      rhs[j] = f * (rho * y1[j] + rho * y2[j] - (bb[j] + z1[j] + z2[j]) + v1[j]);
      x0[j] = f * y1[j];
    }
    if (a.nside) {
      if constexpr (!CL) {
        f_rows(fac, n, n, rhs, v1);
        f_rows(ete, n, n, x0, v2);
      } else {
        // H^{-1} rhs and E_f^T E_f x0 in one pass over the block's rows
        if (fres) mv_rows2<true, 4>(fac, ete, nb, n, rhs, x0, v1 + q0,
                                    v2 + q0, false);
        else mv_rows2<false, RWE>(fac, ete, nb, n, rhs, x0, v1 + q0,
                                  v2 + q0, false);
        cl_gather(v1, v2, n, ns, C, rank);
      }
      for (int j = tid; j < n; j += NT) xn[j] = fr[j] * v1[j] / rho;
    } else {
      e_rows(rhs, x0, a1, a2, !CL);                            // E rhs, E x0
      if constexpr (CL) cl_gather(a1, nullptr, m, ms, C, rank);
      f_rows(fac, mb, m, a1, u + r0);                          // u
      if constexpr (!CL) {
        mv_cols<TE, 2, RES>(E, m, n, u, a2, v1, v2, part);  // E^T u, E^T E x0
      } else {
        mv_cols<TE, 2, RES>(E, mb, n, u + r0, a2 + r0, xch, xch + n, part,
                            false);
        cl_sum<2>(xch, n, C, v1, v2);
      }
      for (int j = tid; j < n; j += NT) xn[j] = fr[j] * (rhs[j] - v1[j]) / c;
    }
    // PCG warm-start early exit (reference :204-209 semantics)
    float kv[2] = {0.f, 0.f};
    for (int j = tid; j < n; j += NT) {
      const float mx0 = fr[j] * (c * x0[j] + rho * v2[j]);
      const float r0v = rhs[j] - mx0;
      kv[0] += r0v * r0v;
      kv[1] += rhs[j] * rhs[j];
    }
    bsum<CL>(kv, red, bsb);
    const bool keep = kv[0] < a.pcg_tol2 * kv[1];
    for (int j = tid; j < n; j += NT)
      if (keep) xn[j] = x0[j];
    if (a.nside) {
      e_rows(xn, nullptr, a1, nullptr);                        // ex_new
    } else {
      for (int i = r0 + tid; i < r0 + mb; i += NT)
        a1[i] = keep ? a2[i] : u[i] / rho;
    }

    // --- dual ascent + convergence sums --------------------------------
    float cv[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = tid; j < n; j += NT) {
      const float f = fr[j], xv = xn[j];
      const float d1 = xv - y1[j], d2 = xv - y2[j];
      z1[j] = z1[j] + gamma * rho * f * d1;
      z2[j] = z2[j] + gamma * rho * f * d2;
      if (f > 0.5f) {
        cv[0] += xv * xv;
        cv[1] += d1 * d1;
        cv[2] += d2 * d2;
      }
      cv[3] += bb[j] * f * xv;
    }
    for (int i = r0 + tid; i < r0 + mb; i += NT) {
      z4[i] = z4[i] + gamma * rho * (a1[i] + y3[i] - fe[i]);
      exc[i] = a1[i];
    }
    bsum<CL>(cv, red, bsc);
    const float xnrm = fmaxf(sqrtf(cv[0]), EPS);
    const float c1 = sqrtf(cv[1]) / xnrm, c2 = sqrtf(cv[2]) / xnrm;
    bool cvg = c1 <= a.stop_threshold && c2 <= a.stop_threshold;
    if (it == a.skip_cvg_at) cvg = false;
    const float obj_val = cv[3];
    const bool push = !cvg;
    const int slot = count % H;
    if constexpr (CL) {
      if (push && (tid & 31) == slot) ring_l = obj_val;
    } else {
#pragma unroll
      for (int k = 0; k < HMAX; ++k)
        if (push && k == slot) ring[k] = obj_val;
    }
    if (push) ++count;
    float mean = 0.f;
#pragma unroll
    for (int k = 0; k < HMAX; ++k)
      if (k < H) mean += ring_at(k);
    mean /= (float)H;
    float var = 0.f;
#pragma unroll
    for (int k = 0; k < HMAX; ++k)
      if (k < H) {
        const float r = ring_at(k);
        var += (r - mean) * (r - mean);
      }
    var /= (float)(H - 1);
    float rel = sqrtf(var) / fmaxf(fabsf(obj_val), EPS);
    if (count < H) rel = 1.f;
    const bool newly_done = cvg || (push && rel <= a.std_threshold);

    // --- incumbent: best feasible rounding, every incumbent_stride -------
    if (!newly_done && (a.incumbent_stride <= 1 || it % a.incumbent_stride == 0)) {
      float ob[1] = {0.f};
      for (int j = tid; j < n; j += NT) {
        const float r = fr[j] * (xn[j] >= 0.5f ? 1.f : 0.f);
        rnd[j] = r;
        ob[0] += bb[j] * r;
      }
      bsum<CL>(ob, red, bsa);
      const float obj_bin = ob[0];
      cur_obj = obj_bin;
      bool better = best_obj >= obj_bin;
      if (a.feasible_incumbent) {
        e_rows(rnd, nullptr, a2, nullptr);                     // E rnd
        float bad[1] = {0.f};
        for (int i = r0 + tid; i < r0 + mb; i += NT)
          if (rm[i] > 0.5f && !(a2[i] <= fe[i] + 1e-6f)) bad[0] += 1.f;
        bsum<CL>(bad, red, bsb);
        if constexpr (CL) bad[0] = cl_total(bad[0], csum, C);
        better = better && bad[0] == 0.f;
      }
      if (better) {
        best_obj = obj_bin;
        if (lead)
          for (int j = tid; j < n; j += NT) a.bestsol_out[on + j] = xn[j];
      }
    }

    if (a.record)
      for (int j = tid; j < n; j += NT)
        a.traj[((size_t)inst * a.window + t) * n + j] = xn[j];
    for (int j = tid; j < n; j += NT) x[j] = xn[j];
    if (newly_done) done = true;
    __syncthreads();
  }

  __syncthreads();
  for (int i = r0 + tid; i < r0 + mb; i += NT) {   // this block's rows
    a.z4_out[om + i] = z4[i];
    a.y3_out[om + i] = y3[i];
    a.ex_out[om + i] = exc[i];
  }
  if (lead) {
    for (int j = tid; j < n; j += NT) {
      a.x_out[on + j] = x[j];
      a.z1_out[on + j] = z1[j];
      a.z2_out[on + j] = z2[j];
      a.y1_out[on + j] = y1[j];
      a.y2_out[on + j] = y2[j];
    }
    if constexpr (CL) {
      if (tid < H) a.ring_out[inst * H + tid] = ring_l;
    }
    if (tid == 0) {
      if constexpr (!CL) {
#pragma unroll
        for (int k = 0; k < HMAX; ++k)
          if (k < H) a.ring_out[inst * H + k] = ring[k];
      }
      a.count_out[inst] = count;
      a.done_out[inst] = done ? 1 : 0;
      a.curobj_out[inst] = cur_obj;
      a.bestobj_out[inst] = best_obj;
    }
  }
  // no block leaves while another may still read its shared memory
  if constexpr (CL) cg::this_cluster().sync();
}

}  // namespace
