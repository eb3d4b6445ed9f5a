// K3: one ADMM iteration's single pass over E for the large LP rungs.
//
// Replaces the TPU kernel lpbox_admm_tpu/ops/pallas_stream.py::_sweep_kernel
// (called by _run_sweep_ops, pallas_stream.py:431).  For every column j of
// E it forms the transpose products T = M E (M = [u, E x0, w_keep,
// w_exact], 4 x m) that finish iteration t, the per-column updates of
// both warm-start branches (keep: x = x0; exact: x = free (rhs - E^T u) /
// 2 rho) with the same arithmetic as the TPU kernel, and the forward
// products F = A E^T (A = [base, shift, free y1, rounded] per branch,
// 8 x n) that start iteration t+1, plus 14 per-instance sums.
//
// Bound: bytes.  E is read once per iteration (109 MB of bf16 at the
// (8, 1664, 4096) xl block, ~33 us at 3.35 TB/s) against 24 m n B flops
// (1.31 GFLOP, ~20 us at the f32 rate).
//
// Design.  The TPU kernel loads an (m, NB) column tile into VMEM once
// and uses it twice; here a thread block (512 threads) stages one (m, NB)
// tile of E in shared memory (NB = 32 for bf16 and 16 for f32 at
// m = 1664, both ~113 KB; NB = 16 / 8 up to m = 4096) and walks the
// `cw` columns of its chunk tile by tile, the loop standing in for the
// TPU's sequential grid axis.  Grid = (n / cw, B): 128 blocks for the xl
// block of 8 instances.  Per tile:
//   * transpose products: thread (column j, part p) sums rows p, p+16, ..
//     in order; the 16 parts are added in order p = 0..15;
//   * one thread per column does both branches' updates and writes the
//     12 per-column outputs, the 8 A values (to shared memory) and the
//     column's 14 sum terms (to a workspace);
//   * forward products: thread i holds F[:, i] for rows i, i+512, .. in
//     registers across the tiles and adds A[:, j] E[i, j] column by column.
// Every sum runs in an order that does not depend on NB or on E's type,
// so bf16 and f32 E (0/1 entries) give the same bits.  Blocks never wait
// on each other: each writes its partial F to a workspace, and a second
// launch adds the partials in block order and the column sum terms in a
// fixed tree.  No atomics: a repeat launch gives the same bits.
#include "common.cuh"

namespace {

constexpr int NT = 512;       // threads per block
constexpr int NP = 16;        // row parts of a transpose product
constexpr int RPT = 8;        // rows of F per thread: m <= RPT * NT
constexpr int NSUM = 14;      // per-instance sums (slots 14, 15 are 0)
constexpr int NACC = 16;
constexpr int SMEM_MAX = 232448;

struct StreamSweepArgs {
  const void* E;        // (B, m, n) float32 or bfloat16
  const float* M;       // (B, 4, m)
  const float* rhs;     // (B, n)
  const float* x0;
  const float* shift;
  const float* z1;
  const float* z2;
  const float* b;
  const float* free_f;  // (B, n) 0/1
  const float* s;       // (B,) sphere scale of iteration t
  float* V;             // (B, 12, n): x, z1, z2, y1, base, shift per branch
  float* F;             // (B, 8, m)
  float* acc;           // (B, 16)
  float* f_part;        // (B, n / cw, 8, m) workspace
  float* s_part;        // (B, 14, n) workspace
  int B, m, n, nb, cw, e_bf16;
  float rho, gamma, rho_nx;
};

template <typename TE>
__host__ __device__ constexpr int row_words(int nb) {
  // an odd number of 4-byte words per staged row: a warp reading one
  // column of 32 rows touches 32 banks
  return nb * (int)sizeof(TE) / 4 + 1;
}

template <typename TE>
__host__ __device__ int smem_bytes(int m, int nb) {
  return m * 16 + m * row_words<TE>(nb) * 4 + NP * 4 * nb * 4 + nb * 8 * 4;
}

__device__ __forceinline__ float elem(const uint32_t* row, int j, float) {
  return reinterpret_cast<const float*>(row)[j];
}
__device__ __forceinline__ float elem(const uint32_t* row, int j,
                                      __nv_bfloat16) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(row)[j]);
}

template <typename TE>
__global__ void __launch_bounds__(NT, 1) sweep_kernel(const StreamSweepArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int m = a.m, n = a.n, nb = a.nb;
  const int b = blockIdx.y, chunk = blockIdx.x, nchunk = gridDim.x;
  const int tid = threadIdx.x;
  const int rw = row_words<TE>(nb);
  float4* Ms = reinterpret_cast<float4*>(smem);                 // [m]
  float* As = smem + 4 * m;                                     // [nb][8]
  float* Tp = As + nb * 8;                                      // [NP][4][nb]
  uint32_t* tile = reinterpret_cast<uint32_t*>(Tp + NP * 4 * nb);  // [m][rw]

  const float* M = a.M + (size_t)b * 4 * m;
  for (int i = tid; i < m; i += NT)
    Ms[i] = make_float4(M[i], M[m + i], M[2 * m + i], M[3 * m + i]);

  const float rho = a.rho, gamma = a.gamma, rho_nx = a.rho_nx;
  const float c = rho + rho;
  const float gr = gamma * rho;
  const float s_t = a.s[b];
  const TE* E = static_cast<const TE*>(a.E) + (size_t)b * m * n;
  const int vpr = nb * (int)sizeof(TE) / 16;     // 16-byte pieces per row

  float fa[RPT][8];
#pragma unroll
  for (int q = 0; q < RPT; ++q)
#pragma unroll
    for (int r = 0; r < 8; ++r) fa[q][r] = 0.f;

  for (int j0 = chunk * a.cw; j0 < (chunk + 1) * a.cw; j0 += nb) {
    __syncthreads();   // the previous tile's readers are done
    for (int idx = tid; idx < m * vpr; idx += NT) {
      const int i = idx / vpr, v = idx - i * vpr;
      const uint4 g = __ldg(reinterpret_cast<const uint4*>(
                                E + (size_t)i * n + j0) + v);
      uint32_t* d = tile + i * rw + 4 * v;
      d[0] = g.x; d[1] = g.y; d[2] = g.z; d[3] = g.w;
    }
    __syncthreads();

    // transpose products, parts
    if (tid < NP * nb) {
      const int j = tid % nb, p = tid / nb;
      float t0 = 0.f, t1 = 0.f, t2 = 0.f, t3 = 0.f;
      for (int i = p; i < m; i += NP) {
        const float e = elem(tile + i * rw, j, TE());
        const float4 mm = Ms[i];
        t0 = fmaf(mm.x, e, t0);
        t1 = fmaf(mm.y, e, t1);
        t2 = fmaf(mm.z, e, t2);
        t3 = fmaf(mm.w, e, t3);
      }
      float* o = Tp + p * 4 * nb + j;
      o[0] = t0; o[nb] = t1; o[2 * nb] = t2; o[3 * nb] = t3;
    }
    __syncthreads();

    // per-column updates of both branches
    if (tid < nb) {
      const int j = tid, col = j0 + j;
      float T[4] = {0.f, 0.f, 0.f, 0.f};
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int k = 0; k < 4; ++k) T[k] += Tp[(p * 4 + k) * nb + j];
      const size_t o = (size_t)b * n + col;
      const float rhs = a.rhs[o], x0 = a.x0[o], shift = a.shift[o];
      const float z1 = a.z1[o], z2 = a.z2[o], bb = a.b[o], fr = a.free_f[o];
      const float y2 = 0.5f + s_t * shift;
      const float r0 = rhs - fr * (c * x0 + rho * T[1]);
      float* sp = a.s_part + (size_t)b * NSUM * n + col;
      sp[0] = r0 * r0;
      sp[(size_t)n] = rhs * rhs;
      float* V = a.V + (size_t)b * 12 * n + col;
#pragma unroll
      for (int bi = 0; bi < 2; ++bi) {
        const float xb = bi == 0 ? x0 : fr * (rhs - T[0]) / c;
        const float etw = T[2 + bi];
        const float z1n = z1 + gr * fr * (xb - x0);
        const float z2n = z2 + gr * fr * (xb - y2);
        const float y1n = fminf(fmaxf(xb + z1n / rho_nx, 0.f), 1.f);
        const float shfn = fr * (xb + z2n / rho_nx - 0.5f);
        const float base =
            fr * (rho_nx * y1n + rho_nx * 0.5f - (bb + z1n + z2n) + etw);
        const float rounded = fr * (xb >= 0.5f ? 1.f : 0.f);
        const float d1 = fr * (xb - x0), d2 = fr * (xb - y2);
        float* A = As + j * 8 + 4 * bi;
        A[0] = base; A[1] = shfn; A[2] = fr * y1n; A[3] = rounded;
        const float vals[6] = {xb, z1n, z2n, y1n, base, shfn};
#pragma unroll
        for (int k = 0; k < 6; ++k) V[(size_t)(2 * k + bi) * n] = vals[k];
        const float terms[6] = {shfn * shfn, d1 * d1, d2 * d2,
                                fr * xb * xb, bb * fr * xb, bb * rounded};
#pragma unroll
        for (int k = 0; k < 6; ++k) sp[(size_t)(2 + 2 * k + bi) * n] = terms[k];
      }
    }
    __syncthreads();

    // forward products: F[:, i] += A[:, j] E[i, j], column by column
    for (int j = 0; j < nb; ++j) {
      const float4 a0 = reinterpret_cast<const float4*>(As + j * 8)[0];
      const float4 a1 = reinterpret_cast<const float4*>(As + j * 8)[1];
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const int i = tid + q * NT;
        if (i < m) {
          const float e = elem(tile + i * rw, j, TE());
          fa[q][0] = fmaf(a0.x, e, fa[q][0]);
          fa[q][1] = fmaf(a0.y, e, fa[q][1]);
          fa[q][2] = fmaf(a0.z, e, fa[q][2]);
          fa[q][3] = fmaf(a0.w, e, fa[q][3]);
          fa[q][4] = fmaf(a1.x, e, fa[q][4]);
          fa[q][5] = fmaf(a1.y, e, fa[q][5]);
          fa[q][6] = fmaf(a1.z, e, fa[q][6]);
          fa[q][7] = fmaf(a1.w, e, fa[q][7]);
        }
      }
    }
  }

  float* fp = a.f_part + ((size_t)b * nchunk + chunk) * 8 * m;
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int i = tid + q * NT;
    if (i < m) {
#pragma unroll
      for (int r = 0; r < 8; ++r) fp[(size_t)r * m + i] = fa[q][r];
    }
  }
}

// Blocks [0, nf) add the F partials in chunk order, one (row, i) per
// thread; blocks nf.. reduce one of the 14 column sums each.
constexpr int NTF = 256;

__global__ void __launch_bounds__(NTF) finish_kernel(const StreamSweepArgs a,
                                                     int nchunk, int nf) {
  __shared__ float red[NTF / 32 + 1];
  const int b = blockIdx.y, m = a.m, n = a.n;
  if ((int)blockIdx.x < nf) {
    const int idx = blockIdx.x * NTF + threadIdx.x;
    if (idx >= 8 * m) return;
    const float* fp = a.f_part + (size_t)b * nchunk * 8 * m + idx;
    float s = 0.f;
    for (int c = 0; c < nchunk; ++c) s += fp[(size_t)c * 8 * m];
    a.F[(size_t)b * 8 * m + idx] = s;
    return;
  }
  const int k = blockIdx.x - nf;
  const float* sp = a.s_part + ((size_t)b * NSUM + k) * n;
  float v[1] = {0.f};
  for (int j = threadIdx.x; j < n; j += NTF) v[0] += sp[j];
  lpbox::block_sum<1, NTF>(v, red);
  if (threadIdx.x == 0) {
    a.acc[(size_t)b * NACC + k] = v[0];
    if (k == 0) a.acc[(size_t)b * NACC + 14] = a.acc[(size_t)b * NACC + 15] = 0.f;
  }
}

template <typename TE>
int launch(const StreamSweepArgs& a, cudaStream_t stream) {
  const int bytes = smem_bytes<TE>(a.m, a.nb);
  if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<TE>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int nchunk = a.n / a.cw;
  sweep_kernel<TE><<<dim3(nchunk, a.B), NT, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nf = (8 * a.m + NTF - 1) / NTF;
  finish_kernel<<<dim3(nf + NSUM, a.B), NTF, 0, stream>>>(a, nchunk, nf);
  return (int)cudaGetLastError();
}

}  // namespace

LPBOX_API int lpbox_stream_sweep_args_size() {
  return (int)sizeof(StreamSweepArgs);
}

// Shared memory a launch needs at (m, nb) for E of `e_bytes` per entry.
LPBOX_API int lpbox_stream_sweep_smem(int m, int nb, int e_bytes) {
  return e_bytes == 2 ? smem_bytes<__nv_bfloat16>(m, nb)
                      : smem_bytes<float>(m, nb);
}

LPBOX_API int lpbox_stream_sweep(const void* args, void* stream) {
  const StreamSweepArgs& a = *static_cast<const StreamSweepArgs*>(args);
  const int es = a.e_bf16 ? 2 : 4;
  if (a.m < 1 || a.m > RPT * NT || a.nb < 1 || a.nb * NP > NT ||
      (a.nb * es) % 16 || a.cw % a.nb || a.n % a.cw || a.B < 1 ||
      a.B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.e_bf16 ? launch<__nv_bfloat16>(a, s) : launch<float>(a, s);
}
