// K1: a whole window of Woodbury-mode LP ADMM iterations in one launch.
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
// Design.  One thread block per instance (grid = B, 512 threads); the
// window's loop runs inside the block, and no block waits on another.
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
// Bound: per m-side iteration and instance the kernel must read E at
// least once per dependent product chain; the card-level bound that the
// smoke reports counts each input once per launch (bytes) against the
// f32 FMA work of the window (operations), see chip_smoke.py.
//
// Barrier discipline (a barrier that not every thread reaches hangs the
// block): every helper below is called by all threads and starts and
// ends with __syncthreads(); every decision (keep, convergence, std stop,
// incumbent sampling, done) is computed from block_sum results, which
// every thread reads from the same shared slots, so the branches are
// uniform; an instance that is done leaves the loop with all its threads
// (in record mode it keeps writing its frozen x, with no barrier).  A done
// instance's iteration is an exact no-op in the TPU kernel, so leaving the
// loop early changes no output.
#include "common.cuh"

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
  lpbox::load4(p, e);
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
                        float* o1) {
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
  __syncthreads();
}

// out{0,1}[j] = sum_i M[i, j] * w{0,1}[i] for j < cols (w in shared memory).
// `part` holds NV * G * cols floats, G = max(1, NT / (cols / 4)).
template <typename TM, int NV, bool SH = false,
          int UN = (sizeof(TM) == 1 && !SH ? 16 : 4)>
__device__ void mv_cols(const TM* __restrict__ M, int rows, int cols,
                        const float* w0, const float* w1, float* o0,
                        float* o1, float* part) {
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
    __syncthreads();
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
  __syncthreads();
}

__host__ __device__ inline int col_groups(int n) {
  const int nq = n / 4;
  return nq >= NT ? 1 : NT / nq;
}

template <typename TE, bool RES>
__global__ void __launch_bounds__(NT) lp_window_kernel(const LpWindowArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int inst = blockIdx.x, tid = threadIdx.x;
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
  float* xn = v2 + n;     // x_exact, then x_new
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

  // rows a warp takes at a time in the row passes: one on the stream
  // routes, four on the resident route
  constexpr int RWE = RES ? 4 : 1;
  const TE* E = static_cast<const TE*>(a.E) + (size_t)inst * m * n;
  if (RES) {
    // the resident route: this instance's one-byte E (m n bytes, a
    // multiple of 16) into shared memory after the carve-up, once
    uint4* Es = reinterpret_cast<uint4*>(red + 4 * NW + 4);
    const uint4* Eg = reinterpret_cast<const uint4*>(E);
    for (int k = tid; k < m * n / 16; k += NT) Es[k] = __ldg(Eg + k);
    E = reinterpret_cast<const TE*>(Es);
  }
  const float* fac =
      a.fac + (size_t)inst * (a.nside ? (size_t)n * n : (size_t)m * m);
  const float* ete = a.nside ? a.ete + (size_t)inst * n * n : nullptr;
  const size_t on = (size_t)inst * n, om = (size_t)inst * m;

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
    a.bestsol_out[on + j] = a.bestsol_in[on + j];
  }
  for (int i = tid; i < m; i += NT) {
    z4[i] = a.z4_in[om + i];
    fe[i] = a.feff[om + i];
    rm[i] = a.rmask[om + i];
    y3[i] = fe[i];
  }
  // block-uniform scalars: every thread holds the same values
  float ring[HMAX];
#pragma unroll
  for (int k = 0; k < HMAX; ++k) ring[k] = k < H ? a.ring_in[inst * H + k] : 0.f;
  int count = a.count_in[inst];
  bool done = a.done_in[inst] != 0;
  float cur_obj = a.curobj_in[inst], best_obj = a.bestobj_in[inst];

  __syncthreads();
  float nact[1] = {0.f};
  for (int j = tid; j < n; j += NT) nact[0] += fr[j];
  lpbox::block_sum<1, NT>(nact, red);
  const float sqrt_n = sqrtf(nact[0]);
  mv_rows<TE, 1, RES, RWE>(E, m, n, x0, nullptr, exc, nullptr);  // E (free x)

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
    lpbox::block_sum<1, NT>(acc, red);
    const float nrm = sqrtf(acc[0]);
    for (int j = tid; j < n; j += NT)
      y2[j] = fr[j] > 0.5f ? y2[j] * sqrt_n / (2.f * fmaxf(nrm, EPS)) + 0.5f
                           : x[j];
    for (int i = tid; i < m; i += NT) {
      const float y3v = fmaxf(fe[i] - exc[i] - z4[i] / rho, 0.f);
      y3[i] = y3v;
      w[i] = rho * (fe[i] - y3v) - z4[i];
    }

    // --- rhs + exact solve ---------------------------------------------
    mv_cols<TE, 1, RES>(E, m, n, w, nullptr, v1, nullptr, part);   // E^T w
    for (int j = tid; j < n; j += NT) {
      const float f = fr[j];
      rhs[j] = f * (rho * y1[j] + rho * y2[j] - (bb[j] + z1[j] + z2[j]) + v1[j]);
      x0[j] = f * y1[j];
    }
    if (a.nside) {
      mv_rows<float, 1, false, RWE>(fac, n, n, rhs, nullptr, v1, nullptr);
      mv_rows<float, 1, false, RWE>(ete, n, n, x0, nullptr, v2, nullptr);
      for (int j = tid; j < n; j += NT) xn[j] = fr[j] * v1[j] / rho;
    } else {
      mv_rows<TE, 2, RES, RWE>(E, m, n, rhs, x0, a1, a2);       // E rhs, E x0
      mv_rows<float, 1, false, RWE>(fac, m, m, a1, nullptr, u, nullptr);  // u
      mv_cols<TE, 2, RES>(E, m, n, u, a2, v1, v2, part);  // E^T u, E^T E x0
      for (int j = tid; j < n; j += NT) xn[j] = fr[j] * (rhs[j] - v1[j]) / c;
    }
    // PCG warm-start early exit (reference :204-209 semantics)
    float kv[2] = {0.f, 0.f};
    for (int j = tid; j < n; j += NT) {
      const float mx0 = fr[j] * (c * x0[j] + rho * v2[j]);
      const float r0 = rhs[j] - mx0;
      kv[0] += r0 * r0;
      kv[1] += rhs[j] * rhs[j];
    }
    lpbox::block_sum<2, NT>(kv, red);
    const bool keep = kv[0] < a.pcg_tol2 * kv[1];
    for (int j = tid; j < n; j += NT)
      if (keep) xn[j] = x0[j];
    if (a.nside) {
      mv_rows<TE, 1, RES, RWE>(E, m, n, xn, nullptr, a1, nullptr);  // ex_new
    } else {
      for (int i = tid; i < m; i += NT) a1[i] = keep ? a2[i] : u[i] / rho;
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
    for (int i = tid; i < m; i += NT) {
      z4[i] = z4[i] + gamma * rho * (a1[i] + y3[i] - fe[i]);
      exc[i] = a1[i];
    }
    lpbox::block_sum<4, NT>(cv, red);
    const float xnrm = fmaxf(sqrtf(cv[0]), EPS);
    const float c1 = sqrtf(cv[1]) / xnrm, c2 = sqrtf(cv[2]) / xnrm;
    bool cvg = c1 <= a.stop_threshold && c2 <= a.stop_threshold;
    if (it == a.skip_cvg_at) cvg = false;
    const float obj_val = cv[3];
    const bool push = !cvg;
    const int slot = count % H;
#pragma unroll
    for (int k = 0; k < HMAX; ++k)
      if (push && k == slot) ring[k] = obj_val;
    if (push) ++count;
    float mean = 0.f;
#pragma unroll
    for (int k = 0; k < HMAX; ++k)
      if (k < H) mean += ring[k];
    mean /= (float)H;
    float var = 0.f;
#pragma unroll
    for (int k = 0; k < HMAX; ++k)
      if (k < H) var += (ring[k] - mean) * (ring[k] - mean);
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
      lpbox::block_sum<1, NT>(ob, red);
      const float obj_bin = ob[0];
      cur_obj = obj_bin;
      bool better = best_obj >= obj_bin;
      if (a.feasible_incumbent) {
        mv_rows<TE, 1, RES, RWE>(E, m, n, rnd, nullptr, a2, nullptr);  // E rnd
        float bad[1] = {0.f};
        for (int i = tid; i < m; i += NT)
          if (rm[i] > 0.5f && !(a2[i] <= fe[i] + 1e-6f)) bad[0] += 1.f;
        lpbox::block_sum<1, NT>(bad, red);
        better = better && bad[0] == 0.f;
      }
      if (better) {
        best_obj = obj_bin;
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
  for (int j = tid; j < n; j += NT) {
    a.x_out[on + j] = x[j];
    a.z1_out[on + j] = z1[j];
    a.z2_out[on + j] = z2[j];
    a.y1_out[on + j] = y1[j];
    a.y2_out[on + j] = y2[j];
  }
  for (int i = tid; i < m; i += NT) {
    a.z4_out[om + i] = z4[i];
    a.y3_out[om + i] = y3[i];
    a.ex_out[om + i] = exc[i];
  }
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < HMAX; ++k)
      if (k < H) a.ring_out[inst * H + k] = ring[k];
    a.count_out[inst] = count;
    a.done_out[inst] = done ? 1 : 0;
    a.curobj_out[inst] = cur_obj;
    a.bestobj_out[inst] = best_obj;
  }
}

// The kernel's carve-up of shared memory in floats: 13 n-vectors, 9
// m-vectors, the column partial sums and the reduction scratch.
size_t carve_floats(int m, int n) {
  return 13 * (size_t)n + 9 * (size_t)m + 2 * (size_t)col_groups(n) * n +
         4 * NW + 4;
}

// Dynamic shared memory of a launch: the carve-up, and on the resident
// route the one-byte E after it (m n bytes, rounded up to 16).
size_t smem_need(int m, int n, int route) {
  return carve_floats(m, n) * sizeof(float) +
         (route == kI8Resident ? ((size_t)m * n + 15) / 16 * 16 : 0);
}

template <typename TE, bool RES>
cudaError_t launch(const LpWindowArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      lp_window_kernel<TE, RES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      a.smem_bytes);
  if (err != cudaSuccess) return err;
  lp_window_kernel<TE, RES><<<a.B, NT, a.smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

LPBOX_API int lpbox_lp_window_args_size() { return (int)sizeof(LpWindowArgs); }

LPBOX_API const char* lpbox_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launch one window on `stream`; returns the cudaError_t of the launch.
LPBOX_API int lpbox_lp_window(const void* args, void* stream) {
  const LpWindowArgs& a = *static_cast<const LpWindowArgs*>(args);
  if (a.n % 4 || a.m % 4 || a.n <= 0 || a.m <= 0 || a.H < 2 || a.H > HMAX ||
      a.rho_change_step <= 0 || (a.record && a.traj == nullptr) ||
      (a.nside && a.ete == nullptr) || a.e_route < kF32Stream ||
      a.e_route > kI8Resident ||
      (size_t)a.smem_bytes != smem_need(a.m, a.n, a.e_route))
    return (int)cudaErrorInvalidValue;
  if (a.B == 0 || a.window == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.e_route) {
    case kF32Stream: return (int)launch<float, false>(a, s);
    case kBf16Stream: return (int)launch<__nv_bfloat16, false>(a, s);
    case kI8Stream: return (int)launch<int8_t, false>(a, s);
    default: return (int)launch<int8_t, true>(a, s);
  }
}
