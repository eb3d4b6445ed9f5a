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
// (1.31 GFLOP, ~20 us at the f32 rate): the two are close, so the copy of
// E and the arithmetic on it have to overlap.
//
// Design: a persistent sweep with a cp.async ring.
//   * Work: the B * n columns are cut into units of UNIT columns, and
//     block g of the grid (one block per SM) walks the units
//     [g NU / G, (g+1) NU / G) in order, across instance boundaries, tile
//     by tile.  A tile is (m rows x 32 bytes): nb = 16 bf16 or 8 f32
//     columns (CPR = 2 chunks of 16 bytes per row), or half that where
//     three such stages do not fit (m > 2036).
//   * Ring: STAGES (2-4) tiles in shared memory: the tile being
//     transposed, the one being forwarded, and STAGES - 2 whose cp.async
//     copies are in flight.  Each stage also carries the tile's slice of
//     the 7 column vectors, so the per-column update reads no global
//     memory.  Rows are stored with the 16-byte chunks of every other
//     4-row group swapped, so 8 lanes reading one chunk of 8 consecutive
//     rows hit 32 banks.
//   * Two phases per tile t, one barrier each.  Phase 1, every warp: the
//     transpose products of t.  Phase 2: warp 0 runs the per-column
//     update of t while warps 1.. run the forward products of t-1, whose
//     A the update wrote one tile earlier (A is double-buffered), so the
//     update's long chain of dependent steps runs beside the forward
//     products instead of between two barriers.
//   * Transpose products: thread (chunk h, part p) sums rows p, p + P,
//     .. (P = 512 / CPR) of its chunk in order, for 4 x (16 / sizeof(E))
//     values; a warp reduces its 32 parts by a transposing butterfly
//     (xor 16, 8, 4, 2, 1), and the update adds the warps of a chunk in
//     warp order.
//   * Per-column update: one thread per (column, branch), operands from
//     the stage; A goes to shared memory, V and the sum terms to global.
//   * Forward products: forward thread f (warps 1..) holds F[:, i] for
//     rows i = f, f + 480, .. (RPT = ceil(m / 480) rows, a template
//     parameter: 4 at m = 1664) in registers across a segment (the
//     block's columns of one instance) and adds A[:, j] E[i, j] column by
//     column; at a segment's end it writes its partial F to slot g + b of
//     a workspace.
// Every sum runs in an order that depends neither on nb nor on E's type
// (the row parts, the butterfly and the column order are the same for
// bf16 and f32 E), so bf16 and f32 E (0/1 entries) give the same bits.
// Blocks never wait on each other: a second launch adds each instance's
// F partials in block order and the column sum terms in a fixed tree.  No
// atomics: a repeat launch gives the same bits.
#include "common.cuh"

namespace {

constexpr int NT = 512;        // threads per block
constexpr int NWARP = NT / 32;
constexpr int NSUM = 14;       // per-instance sums (slots 14, 15 are 0)
constexpr int NACC = 16;
constexpr int SMEM_MAX = 232448;
constexpr int UNIT = 32;       // columns per unit of work
constexpr int NB_MAX = 16;     // widest tile (bf16, two chunks per row)
constexpr int NVEC = 7;        // column vectors staged with each tile
constexpr int MAX_STAGES = 4;
constexpr int M_MAX = 4096;
constexpr int NF = NT - 32;    // forward-product threads (warps 1..)

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
  float* f_part;        // (grid + B - 1, 8, m) workspace
  float* s_part;        // (B, 14, n) workspace
  int B, m, n, nb, cpr, stages, grid, e_bf16;
  float rho, gamma, rho_nx;
};

// Shared memory of one block: M as float4 rows, the warps' transpose
// sums, A of two tiles, and the ring (each stage: m rows of cpr chunks,
// then the 7 vector slices, sized for the widest tile).
__host__ __device__ int fixed_bytes(int m) {
  return m * 16 + NWARP * 32 * 4 + 2 * NB_MAX * 8 * 4;
}
__host__ __device__ int stage_bytes(int m, int cpr) {
  return m * 16 * cpr + NVEC * NB_MAX * 4;
}
__host__ __device__ int smem_bytes(int m, int cpr, int stages) {
  return fixed_bytes(m) + stages * stage_bytes(m, cpr);
}
// Two chunks per row where three such stages fit (one tile in flight
// beside the two being computed on), else one; then as many stages as
// fit, at most MAX_STAGES.  Depends on m only, so bf16 and f32 E take the
// same row parts.
int plan_cpr(int m) {
  return smem_bytes(m, 2, 3) <= SMEM_MAX ? 2 : 1;
}
int plan_stages(int m, int cpr) {
  const int s = (SMEM_MAX - fixed_bytes(m)) / stage_bytes(m, cpr);
  return s < MAX_STAGES ? s : MAX_STAGES;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most `pending` groups of this thread are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::);
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
    asm volatile("cp.async.wait_group 2;\n" ::);
}

// The 16-byte chunk c of staged row i (chunks of rows 4..7 of every
// 8-row group swapped when a row has two).
__device__ __forceinline__ int phys_chunk(int i, int c, int cpr) {
  return cpr == 2 ? c ^ ((i >> 2) & 1) : c;
}

// 16 bytes of E as floats: 4 f32 or 8 bf16 values, in column order.
__device__ __forceinline__ void unpack(const uint4 w, float (&e)[4]) {
  e[0] = __uint_as_float(w.x); e[1] = __uint_as_float(w.y);
  e[2] = __uint_as_float(w.z); e[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack(const uint4 w, float (&e)[8]) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    e[2 * k] = __uint_as_float(u[k] << 16);
    e[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
  }
}

// Transposing butterfly over a warp, steps STEP.. of xor 16, 8, 4, 2, 1:
// at each step a lane keeps the half of its values that bit `off` of its
// lane index selects and adds the partner's copy of that half; lane l ends
// with value l (NV = 32) or l >> 1 (NV = 16) summed over the warp.  Every
// index is a compile-time constant, so v stays in registers (with ~190
// KB of shared memory a block has little L1 left for local memory).
template <int NV, int STEP>
__device__ __forceinline__ void butterfly(float (&v)[NV], int lane) {
  if constexpr (STEP < 5) {
    constexpr int OFF = 16 >> STEP, HALF = (NV >> STEP) / 2;
    const bool up = lane & OFF;
    if constexpr (HALF == 0) {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
    } else {
#pragma unroll
      for (int q = 0; q < HALF; ++q) {
        const float lo = v[q], hi = v[q + HALF];
        v[q] = (up ? hi : lo) +
               __shfl_xor_sync(0xffffffffu, up ? lo : hi, OFF);
      }
    }
    butterfly<NV, STEP + 1>(v, lane);
  }
}

// Copy tile `tile` (global tile index) and its vector slices into `dst`.
template <typename TE>
__device__ void load_tile(const StreamSweepArgs& a, int tile, char* dst) {
  const int m = a.m, n = a.n, nb = a.nb, cpr = a.cpr;
  const int tpi = n / nb;
  const int b = tile / tpi, j0 = (tile - b * tpi) * nb;
  const char* src = static_cast<const char*>(a.E) +
                    ((size_t)b * m * n + j0) * sizeof(TE);
  const size_t rs = (size_t)n * sizeof(TE);
  for (int idx = threadIdx.x; idx < m * cpr; idx += NT) {
    const int i = cpr == 2 ? idx >> 1 : idx, c = idx - i * cpr;
    cp_async16(dst + (size_t)i * 16 * cpr + 16 * phys_chunk(i, c, cpr),
               src + i * rs + 16 * c);
  }
  float* vd = reinterpret_cast<float*>(dst + (size_t)m * 16 * cpr);
  const int pieces = nb / 4;
  if ((int)threadIdx.x < NVEC * pieces) {
    const int v = threadIdx.x / pieces, p = threadIdx.x - v * pieces;
    const float* base = v == 0 ? a.rhs : v == 1 ? a.x0 : v == 2 ? a.shift
                        : v == 3 ? a.z1 : v == 4 ? a.z2 : v == 5 ? a.b
                        : a.free_f;
    cp_async16(vd + v * NB_MAX + 4 * p, base + (size_t)b * n + j0 + 4 * p);
  }
}

template <typename TE, int RPT>
__global__ void __launch_bounds__(NT, 1) sweep_kernel(const StreamSweepArgs a) {
  extern __shared__ __align__(16) char smem[];
  constexpr int CPC = 16 / (int)sizeof(TE);   // columns per chunk
  constexpr int NV = 4 * CPC;                 // transpose values per thread
  const int m = a.m, n = a.n, nb = a.nb, cpr = a.cpr, S = a.stages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float4* Ms = reinterpret_cast<float4*>(smem);          // [m]
  float* Tw = reinterpret_cast<float*>(Ms + m);          // [NWARP][32]
  float* As = Tw + NWARP * 32;                           // [2][NB_MAX][8]
  char* ring = reinterpret_cast<char*>(As + 2 * NB_MAX * 8);
  const int sb = stage_bytes(m, cpr);

  // this block's tiles: units [u0, u1) of B * n / UNIT
  const int tpi = n / nb, tpu = UNIT / nb;
  const long long NU = (long long)a.B * (n / UNIT);
  const int g = blockIdx.x, G = gridDim.x;
  const int t0 = (int)(g * NU / G) * tpu, t1 = (int)((g + 1) * NU / G) * tpu;

  const float rho = a.rho, gamma = a.gamma, rho_nx = a.rho_nx;
  const float c2 = rho + rho;
  const float gr = gamma * rho;

  float s_b;   // sphere scale of the current segment's instance
  auto load_M = [&](int b) {
    const float* M = a.M + (size_t)b * 4 * m;
    for (int i = tid; i < m; i += NT)
      Ms[i] = make_float4(M[i], M[m + i], M[2 * m + i], M[3 * m + i]);
    s_b = a.s[b];
  };
  // tiles in flight ahead of the one being transposed: the ring holds
  // the tile being transposed and the one being forwarded besides
  const int D = S - 2;
#pragma unroll 1
  for (int s = 0; s < D; ++s) {
    if (t0 + s < t1) load_tile<TE>(a, t0 + s, ring + (size_t)s * sb);
    cp_async_commit();
  }
  load_M(t0 / tpi);   // while the first tiles are in flight

  float fa[RPT][8];
#pragma unroll
  for (int q = 0; q < RPT; ++q)
#pragma unroll
    for (int r = 0; r < 8; ++r) fa[q][r] = 0.f;

  const int ppc = NT / cpr;             // row parts per chunk
  const int h = tid / ppc, p = tid - h * ppc;
  const int wpc = NWARP / cpr;          // warps per chunk
  const int f = tid - 32;               // forward rows f, f + NF, .. (warps 1..)

  // Iteration k (tile t = t0 + k): (A) phase 1, every warp: transpose
  // products of t; (B) phase 2, warp 0: the per-column update of t (its
  // A to buffer k % 2), warps 1..: forward products of t-1 (A from buffer
  // (k-1) % 2).  The loop runs once more after the last tile for its
  // forward products.
#pragma unroll 1
  for (int t = t0; t <= t1; ++t) {
    const int k = t - t0;
    const bool live = t < t1;
    if (D > 0) cp_async_wait(D - 1);
    __syncthreads();   // (A) tile t landed; stage of t-2 and Tw free
    {
      const int tn = t + D;
      if (tn < t1) load_tile<TE>(a, tn, ring + (size_t)((k + D) % S) * sb);
      cp_async_commit();
      if (D == 0) {
        cp_async_wait(0);
        __syncthreads();
      }
    }
    const char* st = ring + (size_t)(k % S) * sb;

    // phase 1: transpose products, this thread's rows of chunk h in order
    if (live) {
      float v[NV];
#pragma unroll
      for (int q = 0; q < NV; ++q) v[q] = 0.f;
#pragma unroll 2
      for (int i = p; i < m; i += ppc) {
        const float4 mm = Ms[i];
        float e[CPC];
        unpack(*reinterpret_cast<const uint4*>(
                   st + (size_t)i * 16 * cpr + 16 * phys_chunk(i, h, cpr)),
               e);
#pragma unroll
        for (int c = 0; c < CPC; ++c) {
          v[c] = fmaf(mm.x, e[c], v[c]);
          v[CPC + c] = fmaf(mm.y, e[c], v[CPC + c]);
          v[2 * CPC + c] = fmaf(mm.z, e[c], v[2 * CPC + c]);
          v[3 * CPC + c] = fmaf(mm.w, e[c], v[3 * CPC + c]);
        }
      }
      butterfly<NV, 0>(v, lane);
      const int idx = NV == 32 ? lane : lane >> 1;
      if (NV == 32 || (lane & 1) == 0) Tw[warp * 32 + idx] = v[0];
    }
    __syncthreads();   // (B) Tw ready; every read of Ms is done

    if (warp == 0) {
      // phase 2, warp 0: per-column updates, one thread per (column, branch)
      if (live && tid < 2 * nb) {
        const int b = t / tpi, j0 = (t - b * tpi) * nb;
        const int j = tid >> 1, bi = tid & 1, col = j0 + j;
        const int hh = j / CPC, cc = j - hh * CPC;
        // the chunk's warps in warp order, the 4 sums side by side
        float T[4] = {0.f, 0.f, 0.f, 0.f};
        for (int w = 0; w < wpc; ++w) {
          const float* tw = Tw + (hh * wpc + w) * 32 + cc;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) T[kk] += tw[kk * CPC];
        }
        const float* vd =
            reinterpret_cast<const float*>(st + (size_t)m * 16 * cpr);
        const float rhs = vd[j], x0 = vd[NB_MAX + j], shift = vd[2 * NB_MAX + j];
        const float z1 = vd[3 * NB_MAX + j], z2 = vd[4 * NB_MAX + j];
        const float bb = vd[5 * NB_MAX + j], fr = vd[6 * NB_MAX + j];
        const float y2 = 0.5f + s_b * shift;
        float* sp = a.s_part + (size_t)b * NSUM * n + col;
        if (bi == 0) {
          const float r0 = rhs - fr * (c2 * x0 + rho * T[1]);
          sp[0] = r0 * r0;
          sp[(size_t)n] = rhs * rhs;
        }
        const float xb = bi == 0 ? x0 : fr * (rhs - T[0]) / c2;
        const float etw = bi ? T[3] : T[2];
        const float z1n = z1 + gr * fr * (xb - x0);
        const float z2n = z2 + gr * fr * (xb - y2);
        const float y1n = fminf(fmaxf(xb + z1n / rho_nx, 0.f), 1.f);
        const float shfn = fr * (xb + z2n / rho_nx - 0.5f);
        const float base =
            fr * (rho_nx * y1n + rho_nx * 0.5f - (bb + z1n + z2n) + etw);
        const float rounded = fr * (xb >= 0.5f ? 1.f : 0.f);
        const float d1 = fr * (xb - x0), d2 = fr * (xb - y2);
        float* A = As + (k & 1) * NB_MAX * 8 + j * 8 + 4 * bi;
        A[0] = base; A[1] = shfn; A[2] = fr * y1n; A[3] = rounded;
        float* V = a.V + (size_t)b * 12 * n + col;
        const float vals[6] = {xb, z1n, z2n, y1n, base, shfn};
#pragma unroll
        for (int q = 0; q < 6; ++q) V[(size_t)(2 * q + bi) * n] = vals[q];
        const float terms[6] = {shfn * shfn, d1 * d1, d2 * d2,
                                fr * xb * xb, bb * fr * xb, bb * rounded};
#pragma unroll
        for (int q = 0; q < 6; ++q) sp[(size_t)(2 + 2 * q + bi) * n] = terms[q];
      }
    } else if (t > t0) {
      // phase 2, warps 1..: F[:, i] += A[:, j] E[i, j] for the columns
      // of tile t-1, column by column
      const int tp = t - 1;
      const char* sp_ = ring + (size_t)((k + S - 1) % S) * sb;
      const float* Ap = As + ((k - 1) & 1) * NB_MAX * 8;
      for (int c = 0; c < cpr; ++c) {
        uint4 w[RPT];
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
          const int i = f + q * NF;
          if (i < m)
            w[q] = *reinterpret_cast<const uint4*>(
                sp_ + (size_t)i * 16 * cpr + 16 * phys_chunk(i, c, cpr));
          else
            w[q] = make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int cc = 0; cc < CPC; ++cc) {
          const int j = c * CPC + cc;
          const float4 a0 = reinterpret_cast<const float4*>(Ap + j * 8)[0];
          const float4 a1 = reinterpret_cast<const float4*>(Ap + j * 8)[1];
#pragma unroll
          for (int q = 0; q < RPT; ++q) {
            float e[CPC];
            unpack(w[q], e);
            fa[q][0] = fmaf(a0.x, e[cc], fa[q][0]);
            fa[q][1] = fmaf(a0.y, e[cc], fa[q][1]);
            fa[q][2] = fmaf(a0.z, e[cc], fa[q][2]);
            fa[q][3] = fmaf(a0.w, e[cc], fa[q][3]);
            fa[q][4] = fmaf(a1.x, e[cc], fa[q][4]);
            fa[q][5] = fmaf(a1.y, e[cc], fa[q][5]);
            fa[q][6] = fmaf(a1.z, e[cc], fa[q][6]);
            fa[q][7] = fmaf(a1.w, e[cc], fa[q][7]);
          }
        }
      }
      const int bp = tp / tpi;
      if (tp + 1 == t1 || (tp + 1) / tpi != bp) {
        // the segment of instance bp ends with tile t-1
        float* fp = a.f_part + (size_t)(g + bp) * 8 * m;
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
          const int i = f + q * NF;
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            if (i < m) fp[(size_t)r * m + i] = fa[q][r];
            fa[q][r] = 0.f;
          }
        }
      }
    }
    // M and the sphere scale of the next tile's instance, read from (A)
    // on (warp 0 reads s_b in its update above, before this)
    if (t + 1 < t1 && (t + 1) / tpi != t / tpi) load_M((t + 1) / tpi);
  }
  cp_async_wait(0);
}

// Blocks [0, nf) add one instance's F partials in block order, one (row,
// i) per thread; blocks nf.. reduce one of the 14 column sums each.
constexpr int NTF = 256;

__global__ void __launch_bounds__(NTF) finish_kernel(const StreamSweepArgs a,
                                                     int nf) {
  __shared__ float red[NTF / 32 + 1];
  const int b = blockIdx.y, m = a.m, n = a.n;
  if ((int)blockIdx.x < nf) {
    const int idx = blockIdx.x * NTF + threadIdx.x;
    if (idx >= 8 * m) return;
    // the blocks whose units hold instance b's first and last column
    const long long G = a.grid, upi = n / UNIT, NU = (long long)a.B * upi;
    const int g_lo = (int)(((b * upi + 1) * G - 1) / NU);
    const int g_hi = (int)((((b + 1) * upi) * G - 1) / NU);
    float s = 0.f;
    for (int g = g_lo; g <= g_hi; ++g)
      s += a.f_part[(size_t)(g + b) * 8 * m + idx];
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

template <typename TE, int RPT>
cudaError_t launch_rpt(const StreamSweepArgs& a, cudaStream_t stream) {
  const int bytes = smem_bytes(a.m, a.cpr, a.stages);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<TE, RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  sweep_kernel<TE, RPT><<<a.grid, NT, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename TE>
int launch(const StreamSweepArgs& a, cudaStream_t stream) {
  const int rpt = (a.m + NF - 1) / NF;
  // rows of F per forward thread: 4 at the xl block (m = 1664); 9 covers
  // m up to 4320 > M_MAX
  cudaError_t err =
      rpt <= 1 ? launch_rpt<TE, 1>(a, stream)
      : rpt <= 2 ? launch_rpt<TE, 2>(a, stream)
      : rpt <= 4 ? launch_rpt<TE, 4>(a, stream)
                 : launch_rpt<TE, 9>(a, stream);
  if (err != cudaSuccess) return (int)err;
  const int nf = (8 * a.m + NTF - 1) / NTF;
  finish_kernel<<<dim3(nf + NSUM, a.B), NTF, 0, stream>>>(a, nf);
  return (int)cudaGetLastError();
}

}  // namespace

LPBOX_API int lpbox_stream_sweep_args_size() {
  return (int)sizeof(StreamSweepArgs);
}

// Shared memory a launch needs at m with `cpr` chunks per row and
// `stages` ring stages.
LPBOX_API int lpbox_stream_sweep_smem(int m, int cpr, int stages) {
  return smem_bytes(m, cpr, stages);
}

LPBOX_API int lpbox_stream_sweep(const void* args, void* stream) {
  const StreamSweepArgs& a = *static_cast<const StreamSweepArgs*>(args);
  const int es = a.e_bf16 ? 2 : 4;
  if (a.m < 1 || a.m > M_MAX || a.B < 1 || a.B > 65535 || a.n % UNIT)
    return (int)cudaErrorInvalidValue;
  // the caller's plan must be the kernel's own
  const int cpr = plan_cpr(a.m);
  const long long NU = (long long)a.B * (a.n / UNIT);
  if (a.cpr != cpr || a.nb != cpr * 16 / es ||
      a.stages != plan_stages(a.m, cpr) || a.stages < 2 || a.grid < 1 ||
      a.grid > NU)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.e_bf16 ? launch<__nv_bfloat16>(a, s) : launch<float>(a, s);
}
