// P1-P3: three formulations of the batched matvec y[b] = E[b] v[b],
// E (bt, m, n) f32, v (bt, n) f32 -> y (bt, m) f32.
//
// Replace the TPU kernels of scripts/probe_dot.py, which probed which
// formulations lower in Mosaic and which is fastest per call (`run`, :30,
// and `timeit`, :74, call them through pl.pallas_call):
//   P1 k_batched (:43)  one batched dot_general;
//   P2 k_pairs   (:50)  one 2-D product (bt*m, n) @ (n, bt) -> (bt, m, bt)
//                       on the matrix unit, the diagonal b = b' selected
//                       and summed;
//   P3 k_vpu     (:61)  a broadcast multiply E * v[:, None, :] and row sum.
// Each keeps its formulation's own work, so the three stay three kernels:
// P2 does bt times the products of P1 and P3, as the TPU probe did.
//
// Bound: bytes, at both shapes the probe is timed at.  Each kernel must
// read E and v once and write y: at (8, 256, 256) 2.10 MB, 0.63 us at
// 3.35 TB/s; at (8, 1664, 4096) 218 MB, 65.1 us.  Operations: P1 and P3
// 1.05 MFLOP and 109 MFLOP of f32 work, 0.016 and 1.6 us at 67 TFLOP/s;
// P2's bt-fold product 8.39 MFLOP and 0.87 GFLOP, run three times on the
// TF32 tensor cores (below), 0.05 and 5.3 us at 495 TFLOP/s.
//
// P1: a persistent grid (as many 4-warp blocks on each SM as fit) whose
// warps split the bt*m rows into balanced contiguous ranges, so a warp
// streams one flat range of E from start to end, in 4 KB chunks, with no
// block-wide barrier.  Lane 0 of each warp keeps 3 chunks in flight into
// the warp's own ring in shared memory (cp.async.bulk completing an
// mbarrier: TMA), the lanes reading 16-byte quads from there.  Bulk
// copies need 16-byte aligned addresses and sizes, so each warp's range
// is rounded down to 4 floats at both ends and the < 4 floats past its
// end are read directly.  v is read per chunk through the read-only
// path, issued before the chunk is waited for: the quads of each step
// that lies in one row, and entry by entry at row edges.  So v takes no
// shared memory and P1 takes any n >= 1 and any bt.  Each row is summed
// by its warp, in one lane order and one butterfly: no atomics.
//
// P2 runs its product on the tensor cores (mma.sync m16n8k8 TF32).  One
// TF32 pass misses the probe's tolerance (6.0e-5 of max |ref| at
// (8, 256, 256) against 1e-5), so each operand is split a = hi + lo, hi
// = cvt.rna.tf32(a), lo = cvt.rna.tf32(a - hi), and lo*hi, hi*lo and
// hi*hi are accumulated (3xTF32: 1.4e-8 of max |ref| when the products
// are summed exactly).  The tensor core rounds its own f32 sums toward
// zero, a loss that grows with the accumulator: one fragment carried
// over a warp's 1024 columns at (8, 1664, 4096) was off by 1.1e-5 of max
// |ref|.  So each k-step's 3 mma's go into a zeroed fragment, and f32
// adds fold the 4 fragments of a 32-column chunk into the running sums.
// A block of 4 warps owns one 16-row tile of the bt*m flattened rows
// (128 blocks at the probe's shape, one per SM; 832 at the larger one,
// all resident at once, 8 to an SM); warp w takes the 32-column chunks
// w, w+4, ... of the k range and keeps all n-tiles (8 vectors each) of
// the tile in its accumulators.  Loads go straight into the fragment
// registers, 16 bytes a load: the k slots of a chunk are permuted (slot
// t <-> column 4t+s, slot t+4 <-> column 16+4t+s in k-step s; the
// product sums the same columns), so thread (g, t) reads columns 4t..
// and 16+4t.. of E's rows g and g+8 and of vector g, and 8 lanes read
// 128 contiguous bytes of a row.  A warp has one chunk's loads in
// flight; the 32 warps an SM holds (64 registers a thread at bt <= 8)
// keep the bytes in flight.  Two chunks per warp (one round trip at the
// probe's shape) took 102 registers, fewer resident blocks, and was no
// faster; a cp.async ring of 4 chunks per warp in shared memory, tried
// first, was slower at both shapes though its loads alone were not.
// The diagonal select takes, straight from the accumulator fragment,
// the column b' = b(row) of each row, row by row (a tile may span two
// instances); the 4 warps' selected sums are added in warp order.  n % 4
// or unaligned operands take 4-byte loads.  The earlier design, 256
// dependent scalar FMAs per thread from shared memory and 4 serial
// 64-column trips to memory, took 0.0147 ms per call with L2 cold at
// (8, 256, 256) against 0.0081 ms for torch.bmm (an H100 80GB HBM3 at
// 700 W).
//
// P3: one warp per row; each lane issues 8 16-byte loads of E's row and
// 8 of v (read-only path) before it uses the first, rounds each product
// on its own (__fmul_rn: no contraction into an FMA, which is what sets
// P3 apart from P1's dot), sums its products in order and ends with a
// butterfly shuffle: one memory round trip per 1024 columns, no shared
// memory and no barrier.  n % 4 or unaligned operands take scalar loads.
// The earlier design, a shared-memory tree with a barrier per level and
// two serial global trips per 128-column chunk, took 0.0122 ms at (8,
// 256, 256) on the same card.
//
// No atomics: every sum runs in a fixed order, so a repeat launch gives
// the same bits.
#include "common.cuh"

namespace {

struct ProbeArgs {
  const float* E;  // (bt, m, n)
  const float* v;  // (bt, n)
  float* y;        // (bt, m)
  int bt, m, n;
};

// P2_BTMAX and the grid.y limit 65535 of P3 are copied in the package's
// scripts/probe_dot.py, which refuses the same shapes before a launch.

// ---- P1 ---------------------------------------------------------------
constexpr int P1_WARPS = 4;    // warps of a block, each walking its own rows
constexpr int P1_STEP = 128;   // floats a warp takes at once: a quad a lane
constexpr int P1_U = 8;        // steps of a chunk: 8 quads a lane in flight
constexpr int P1_CHUNK = P1_U * P1_STEP;  // 4 KB of E
constexpr int P1_STAGES = 3;   // ring slots a warp: 12 KB
constexpr int P1_SMEM = P1_WARPS * P1_STAGES * (P1_CHUNK * 4 + 8);

// One warp's walk over its rows [r, rb) of the flat (bt*m, n) view of E,
// fed 128-float steps in flat order.  Warp-uniform but for acc.
struct P1Walk {
  long long r, rb;  // the row being summed, the end of the warp's rows
  long long r0;     // flat index of row r's first entry
  long long bend;   // first row of the next instance
  const float* vb;  // v of row r's instance
  float acc;        // this lane's products of row r so far, in flat order
};

// a / b for 0 <= a, 0 < b, in 32 bits where both fit (every shape the
// probe times): a 64-bit division is a long serial routine, paid by each
// warp before its first load.
__device__ __forceinline__ long long p1_div(long long a, long long b) {
  return (unsigned long long)(a | b) >> 32 == 0
             ? (long long)((unsigned)a / (unsigned)b)
             : a / b;
}

__device__ __forceinline__ void p1_next_row(P1Walk& w, const ProbeArgs& a) {
  ++w.r;
  w.r0 += a.n;
  if (w.r == w.bend) {
    w.bend += a.m;
    w.vb += a.n;
  }
}

// Row r is whole: the warp's butterfly sum, written by lane 0.
__device__ __forceinline__ void p1_end_row(P1Walk& w, const ProbeArgs& a,
                                          int lane) {
  const float s = lpbox::warp_sum(w.acc);
  if (lane == 0) a.y[w.r] = s;
  w.acc = 0.f;
  p1_next_row(w, a);
}

// Any step: the lane's quad x holds E's flat entries g .. g+3, g = gs +
// 4 lane; entries at or past `hi` are not the warp's.  Every row the step
// touches takes the lane's entries that fall in it, FMA'd in flat order,
// and a row that ends in the step is summed.
__device__ __forceinline__ void p1_step(P1Walk& w, const ProbeArgs& a,
                                        long long gs, const float4& x,
                                        long long hi, int lane) {
  const long long g = gs + 4 * lane;
  const float e[4] = {x.x, x.y, x.z, x.w};
  while (w.r < w.rb && w.r0 < hi) {
    const long long rend = w.r0 + a.n, up = rend < hi ? rend : hi;
    const float* vp = w.vb + (g - w.r0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (g + i >= w.r0 && g + i < up) w.acc = fmaf(e[i], __ldg(vp + i), w.acc);
    if (rend > hi) break;  // row r goes on in the next step
    p1_end_row(w, a, lane);
  }
}

// A quad of v from vp: one 16-byte load (VEC: n % 4 == 0 and v aligned,
// so a quad that starts a step in one row starts at a multiple of 4) or
// four.
template <bool VEC>
__device__ __forceinline__ float4 p1_vquad(const float* vp) {
  return VEC ? __ldg(reinterpret_cast<const float4*>(vp))
             : make_float4(__ldg(vp), __ldg(vp + 1), __ldg(vp + 2),
                           __ldg(vp + 3));
}

// The steps of the chunk at c0 that lie whole in one row, as a bit mask,
// and for each of them the lane's quad of v, loaded before the chunk's
// E is used: the walk of rows needs no data of E.
template <bool VEC>
__device__ __forceinline__ unsigned p1_plan(P1Walk w, const ProbeArgs& a,
                                            long long c0, long long A1,
                                            int lane, float4 (&q)[P1_U]) {
  unsigned one = 0;
#pragma unroll
  for (int u = 0; u < P1_U; ++u) {
    const long long gs = c0 + u * P1_STEP;
    q[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gs + P1_STEP > A1) continue;
    while (w.r < w.rb && w.r0 + a.n <= gs) p1_next_row(w, a);
    if (w.r < w.rb && w.r0 <= gs && w.r0 + a.n >= gs + P1_STEP) {
      one |= 1u << u;
      q[u] = p1_vquad<VEC>(w.vb + (gs + 4 * lane - w.r0));
    }
  }
  return one;
}

__device__ __forceinline__ unsigned p1_smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Lane 0: chunk c of the warp's copy range [A0, A1) into its ring slot,
// completing the slot's mbarrier.  The fence orders the warp's earlier
// reads of the slot (generic proxy) before the copy's writes (async).
__device__ __forceinline__ void p1_issue(const float* E, long long A0,
                                         long long A1, long long c,
                                         float* ring,
                                         unsigned long long* bar) {
  const int s = (int)(c % P1_STAGES);
  const long long f0 = A0 + c * P1_CHUNK;
  const long long nf = A1 - f0 < P1_CHUNK ? A1 - f0 : P1_CHUNK;
  const unsigned bytes = (unsigned)(4 * nf);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(p1_smem_u32(bar + s)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(p1_smem_u32(ring + s * P1_CHUNK)),
      "l"(E + f0), "r"(bytes), "r"(p1_smem_u32(bar + s))
      : "memory");
}

// Until phase `parity` of `bar` completes; a wait that never ends (a
// fault) traps instead of hanging the card.
__device__ __forceinline__ void p1_wait(unsigned long long* bar,
                                        unsigned parity) {
  const unsigned addr = p1_smem_u32(bar);
  for (unsigned k = 0;; ++k) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, "
        "[%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (k == (1u << 22)) __trap();
  }
}

// Persistent: the grid's warps split the bt*m rows into balanced
// contiguous ranges, so a warp's rows are one flat range [F0, F1) of E,
// walked in 4 KB chunks: [A0, A1), both ends rounded down to 4 floats
// (16 bytes); the < 4 floats past A1 are read at the end.  Lane 0 copies
// the chunks into the warp's ring of P1_STAGES slots in shared memory
// (cp.async.bulk with an mbarrier), P1_STAGES ahead of the lanes, which
// read their 8 quads of a chunk from there.  A chunk that lies whole in
// one row loads its 8 quads of v before it is waited for; in any other,
// each step that lies whole in one row (every step at n % 128 == 0) has
// its quad of v loaded ahead as well (p1_plan), and the rest go entry by
// entry through p1_step.  The whole-chunk path is the walk's fast case:
// without it the xl block took 14% longer (PERF.md).  A row's sum (one
// lane order, one butterfly) is fixed by the shape and the grid.
template <bool VEC>
__global__ void __launch_bounds__(P1_WARPS * 32)
    probe_batched_kernel(const ProbeArgs a) {
  extern __shared__ __align__(128) unsigned char p1_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long R = (long long)a.bt * a.m;
  const long long P = (long long)gridDim.x * P1_WARPS;
  const long long p = (long long)blockIdx.x * P1_WARPS + warp;
  P1Walk w;
  w.r = p1_div(R * p, P);
  w.rb = p1_div(R * (p + 1), P);
  if (w.r == w.rb) return;  // no barrier is shared between warps
  const long long F0 = w.r * a.n, F1 = w.rb * a.n;
  const long long A0 = F0 & ~3LL, A1 = F1 & ~3LL;
  const long long b = p1_div(w.r, a.m);
  w.r0 = F0;
  w.bend = (b + 1) * a.m;
  w.vb = a.v + b * a.n;
  w.acc = 0.f;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const long long nc = (A1 - A0 + P1_CHUNK - 1) / P1_CHUNK;
  float* ring = reinterpret_cast<float*>(p1_smem) +
                (size_t)warp * P1_STAGES * P1_CHUNK;
  unsigned long long* bar =
      reinterpret_cast<unsigned long long*>(
          p1_smem + (size_t)P1_WARPS * P1_STAGES * P1_CHUNK * 4) +
      warp * P1_STAGES;
  if (lane == 0) {
    for (int s = 0; s < P1_STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
          p1_smem_u32(bar + s)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (long long c = 0; c < P1_STAGES && c < nc; ++c)
      p1_issue(a.E, A0, A1, c, ring, bar);
  }
  __syncwarp();
  for (long long c = 0; c < nc; ++c) {
    const long long c0 = A0 + c * P1_CHUNK;
    // a chunk that lies whole in one row (every chunk at n % 1024 == 0)
    // needs no walk of rows: its 8 quads of v and 32 FMAs straight
    const bool whole = c0 + P1_CHUNK <= A1 && w.r0 <= c0 &&
                       w.r0 + a.n >= c0 + P1_CHUNK;
    float4 x[P1_U], q[P1_U];
    unsigned one = (1u << P1_U) - 1;
    if (whole) {
      const float* vp = w.vb + (c0 + 4 * lane - w.r0);
#pragma unroll
      for (int u = 0; u < P1_U; ++u) q[u] = p1_vquad<VEC>(vp + P1_STEP * u);
    } else {
      one = p1_plan<VEC>(w, a, c0, A1, lane, q);
    }
    const int s = (int)(c % P1_STAGES);
    p1_wait(bar + s, (unsigned)((c / P1_STAGES) & 1));
    const float4* buf =
        reinterpret_cast<const float4*>(ring + s * P1_CHUNK) + lane;
#pragma unroll
    for (int u = 0; u < P1_U; ++u)
      x[u] = c0 + u * P1_STEP + 4 * lane < A1 ? buf[32 * u] : zero;
    if (whole) {
#pragma unroll
      for (int u = 0; u < P1_U; ++u) {
        w.acc = fmaf(x[u].x, q[u].x, w.acc);
        w.acc = fmaf(x[u].y, q[u].y, w.acc);
        w.acc = fmaf(x[u].z, q[u].z, w.acc);
        w.acc = fmaf(x[u].w, q[u].w, w.acc);
      }
      if (w.r0 + a.n == c0 + P1_CHUNK) p1_end_row(w, a, lane);
    } else {
#pragma unroll
      for (int u = 0; u < P1_U; ++u) {
        const long long gs = c0 + u * P1_STEP;
        if (gs >= A1) break;
        if (one >> u & 1) {  // step u lies whole in row r
          w.acc = fmaf(x[u].x, q[u].x, w.acc);
          w.acc = fmaf(x[u].y, q[u].y, w.acc);
          w.acc = fmaf(x[u].z, q[u].z, w.acc);
          w.acc = fmaf(x[u].w, q[u].w, w.acc);
          if (w.r0 + a.n == gs + P1_STEP) p1_end_row(w, a, lane);
        } else {
          p1_step(w, a, gs, x[u], gs + P1_STEP < A1 ? gs + P1_STEP : A1,
                  lane);
        }
      }
    }
    __syncwarp();
    if (lane == 0 && c + P1_STAGES < nc)
      p1_issue(a.E, A0, A1, c + P1_STAGES, ring, bar);
  }
  if (A1 < F1) {  // the < 4 floats past the last 16-byte boundary
    float4 x = zero;
    if (lane == 0) {
      x.x = __ldcs(a.E + A1);
      if (A1 + 1 < F1) x.y = __ldcs(a.E + A1 + 1);
      if (A1 + 2 < F1) x.z = __ldcs(a.E + A1 + 2);
    }
    p1_step(w, a, A1, x, F1, lane);
  }
}

// ---- P2 ---------------------------------------------------------------
constexpr int P2_KW = 4;       // warps of a block, splitting the k range
constexpr int P2_NTH = P2_KW * 32;
constexpr int P2_KC = 32;      // columns per chunk: 4 k-steps of 8
constexpr int P2_BTMAX = 64;   // vectors: at most 8 n-tiles of 8

// a = hi + lo, both TF32 (round to nearest, ties away: cvt.rna); a - hi
// is exact in f32.
__device__ __forceinline__ void tf32_split(float a, unsigned& hi,
                                           unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(a));
  const float r = a - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

__device__ __forceinline__ float lane_of(const float4& f, int s) {
  return s == 0 ? f.x : s == 1 ? f.y : s == 2 ? f.z : f.w;
}

// Columns k..k+3 of row p, zeros past n or where !ok: one 16-byte load
// (VEC: n % 4 == 0 and p 16-byte aligned) or four guarded 4-byte ones.
// E streams (evict first); v is read through the read-only path.
template <bool VEC, bool STREAM>
__device__ __forceinline__ float4 p2_quad(const float* p, int k, int n,
                                          bool ok) {
  if (VEC) {
    if (!ok || k >= n) return make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* q = reinterpret_cast<const float4*>(p + k);
    return STREAM ? __ldcs(q) : __ldg(q);
  }
  float e[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    e[i] = ok && k + i < n ? (STREAM ? __ldcs(p + k + i) : __ldg(p + k + i))
                           : 0.f;
  return make_float4(e[0], e[1], e[2], e[3]);
}

// One 32-column chunk: A holds rows g, g+8 at columns 4t.., 16+4t..
// (fragment registers a0..a3 over the 4 k-steps), B[j] vector 8j+g at
// the same columns (b0, b1).  Each k-step's lo*hi, hi*lo and hi*hi go
// into a zeroed fragment; f32 adds fold the 4 fragments into acc in
// order.
template <int NT>
__device__ __forceinline__ void p2_chunk(const float4 (&A)[4],
                                         const float4 (&B)[NT][2],
                                         float (&acc)[NT][4]) {
  unsigned ah[4][4], al[4][4];  // [k-step][fragment register]
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      tf32_split(lane_of(A[q], s), ah[s][q], al[s][q]);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float c[4][4] = {};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      unsigned bh0, bl0, bh1, bl1;
      tf32_split(lane_of(B[j][0], s), bh0, bl0);
      tf32_split(lane_of(B[j][1], s), bh1, bl1);
      lpbox::mma_tf32(c[s], al[s], bh0, bh1);
      lpbox::mma_tf32(c[s], ah[s], bl0, bl1);
      lpbox::mma_tf32(c[s], ah[s], bh0, bh1);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      acc[j][q] += ((c[0][q] + c[1][q]) + c[2][q]) + c[3][q];
  }
}

// NT n-tiles of 8 vectors (bt <= 8 NT; vectors past bt are zeros).  At
// bt <= 8, 64 registers a thread: 8 blocks of 4 warps on each SM.
template <bool VEC, int NT>
__global__ void __launch_bounds__(P2_NTH, NT == 1 ? 8 : 1)
    probe_pairs_kernel(const ProbeArgs a) {
  __shared__ float part[P2_KW][16];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, n = a.n;
  const long long R = (long long)a.bt * a.m;
  const long long r0 = (long long)blockIdx.x * 16;
  const bool ok0 = r0 + g < R, ok8 = r0 + g + 8 < R;
  const float* e0 = a.E + (ok0 ? (r0 + g) * n : 0);
  const float* e8 = a.E + (ok8 ? (r0 + g + 8) * n : 0);
  float acc[NT][4] = {};
  // warp w takes the chunks w, w + 4, ...
  for (int k1 = w * P2_KC + 4 * t; k1 - 4 * t < n; k1 += P2_KW * P2_KC) {
    const int k2 = k1 + 16;
    const float4 A[4] = {p2_quad<VEC, true>(e0, k1, n, ok0),
                         p2_quad<VEC, true>(e8, k1, n, ok8),
                         p2_quad<VEC, true>(e0, k2, n, ok0),
                         p2_quad<VEC, true>(e8, k2, n, ok8)};
    float4 B[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const bool okv = 8 * j + g < a.bt;
      const float* vr = a.v + (okv ? (size_t)(8 * j + g) * n : 0);
      B[j][0] = p2_quad<VEC, false>(vr, k1, n, okv);
      B[j][1] = p2_quad<VEC, false>(vr, k2, n, okv);
    }
    p2_chunk<NT>(A, B, acc);
  }
  // Diagonal select from the accumulator fragment: thread (g, t) holds
  // rows g (registers 0, 1) and g + 8 (2, 3) at vectors 8j + 2t and
  // 8j + 2t + 1; row G keeps vector b' = G / m only.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long G = r0 + g + 8 * h;
    if (G >= R) continue;
    const int b = (int)(G / a.m);
    if (((b & 7) >> 1) != t) continue;
    float val = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)  // constant indices: acc stays in registers
      if (j == (b >> 3)) val = b & 1 ? acc[j][2 * h + 1] : acc[j][2 * h];
    part[w][g + 8 * h] = val;
  }
  __syncthreads();
  if (threadIdx.x < 16 && r0 + threadIdx.x < R) {
    float s = part[0][threadIdx.x];
#pragma unroll
    for (int k = 1; k < P2_KW; ++k) s += part[k][threadIdx.x];
    a.y[r0 + threadIdx.x] = s;
  }
}

// ---- P3 ---------------------------------------------------------------
constexpr int P3_WARPS = 8;  // rows per block, one warp each
constexpr int P3_U = 8;      // 16-byte loads of E (and of v) per lane

template <bool VEC>
__global__ void __launch_bounds__(P3_WARPS * 32)
    probe_vpu_kernel(const ProbeArgs a) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * P3_WARPS + (threadIdx.x >> 5);
  if (row >= a.m) return;  // no barrier follows
  const int b = blockIdx.y, n = a.n;
  const float* e = a.E + ((size_t)b * a.m + row) * n;
  const float* v = a.v + (size_t)b * n;
  float s = 0.f;
  if (VEC) {
    const int nq = n >> 2;
    const float4* e4 = reinterpret_cast<const float4*>(e);
    const float4* v4 = reinterpret_cast<const float4*>(v);
    for (int q0 = 0; q0 < nq; q0 += 32 * P3_U) {
      float4 x[P3_U], y[P3_U];
#pragma unroll
      for (int u = 0; u < P3_U; ++u) {
        const int q = q0 + lane + 32 * u;
        x[u] = q < nq ? __ldcs(e4 + q) : make_float4(0.f, 0.f, 0.f, 0.f);
        y[u] = q < nq ? __ldg(v4 + q) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < P3_U; ++u) {
        s += __fmul_rn(x[u].x, y[u].x);
        s += __fmul_rn(x[u].y, y[u].y);
        s += __fmul_rn(x[u].z, y[u].z);
        s += __fmul_rn(x[u].w, y[u].w);
      }
    }
  } else {
    constexpr int U = 4 * P3_U;
    for (int j0 = 0; j0 < n; j0 += 32 * U) {
      float x[U], y[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + lane + 32 * u;
        x[u] = j < n ? __ldcs(e + j) : 0.f;
        y[u] = j < n ? __ldg(v + j) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) s += __fmul_rn(x[u], y[u]);
    }
  }
  s = lpbox::warp_sum(s);
  if (lane == 0) a.y[(size_t)b * a.m + row] = s;
}

bool valid(const ProbeArgs& a) {
  return a.E && a.v && a.y && a.bt >= 1 && a.m >= 1 && a.n >= 1;
}

// 16-byte copies and loads need n % 4 == 0 and 16-byte aligned operands.
bool vec_ok(const ProbeArgs& a) {
  return a.n % 4 == 0 && reinterpret_cast<uintptr_t>(a.E) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a.v) % 16 == 0;
}

// P1's persistent grid: as many blocks on each SM as fit, asked of the
// device once per instance and device (the ring's shared memory, over
// 48 KB, is allowed first).
template <bool VEC>
cudaError_t p1_launch(const ProbeArgs& a, cudaStream_t s) {
  constexpr int kMaxDev = 64;
  static int grid[kMaxDev];
  const auto kernel = probe_batched_kernel<VEC>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDev) return cudaErrorInvalidValue;
  if (grid[dev] == 0) {
    int sms = 0, fit = 0;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P1_SMEM);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel,
                                                        P1_WARPS * 32,
                                                        P1_SMEM);
    if (err != cudaSuccess) return err;
    if (fit < 1) return cudaErrorInvalidConfiguration;
    grid[dev] = sms * fit;
  }
  kernel<<<grid[dev], P1_WARPS * 32, P1_SMEM, s>>>(a);
  return cudaGetLastError();
}

// P1's quads of v: n % 4 == 0 and v 16-byte aligned (E must be).
bool p1_vec_ok(const ProbeArgs& a) {
  return a.n % 4 == 0 && reinterpret_cast<uintptr_t>(a.v) % 16 == 0;
}

template <bool VEC>
void pairs_launch(const ProbeArgs& a, unsigned tiles, cudaStream_t s) {
  const int nt = (a.bt + 7) / 8;
  if (nt == 1)
    probe_pairs_kernel<VEC, 1><<<tiles, P2_NTH, 0, s>>>(a);
  else if (nt == 2)
    probe_pairs_kernel<VEC, 2><<<tiles, P2_NTH, 0, s>>>(a);
  else if (nt <= 4)
    probe_pairs_kernel<VEC, 4><<<tiles, P2_NTH, 0, s>>>(a);
  else
    probe_pairs_kernel<VEC, 8><<<tiles, P2_NTH, 0, s>>>(a);
}

}  // namespace

LPBOX_API int lpbox_probe_args_size() { return (int)sizeof(ProbeArgs); }

LPBOX_API int lpbox_probe_batched(const void* args, void* stream) {
  const ProbeArgs& a = *static_cast<const ProbeArgs*>(args);
  if (!valid(a) || reinterpret_cast<uintptr_t>(a.E) % 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(p1_vec_ok(a) ? p1_launch<true>(a, s) : p1_launch<false>(a, s));
}

LPBOX_API int lpbox_probe_pairs(const void* args, void* stream) {
  const ProbeArgs& a = *static_cast<const ProbeArgs*>(args);
  const long long tiles = ((long long)a.bt * a.m + 15) / 16;
  if (!valid(a) || a.bt > P2_BTMAX || tiles > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_ok(a))
    pairs_launch<true>(a, (unsigned)tiles, s);
  else
    pairs_launch<false>(a, (unsigned)tiles, s);
  return (int)cudaGetLastError();
}

LPBOX_API int lpbox_probe_vpu(const void* args, void* stream) {
  const ProbeArgs& a = *static_cast<const ProbeArgs*>(args);
  if (!valid(a) || a.bt > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.m + P3_WARPS - 1) / P3_WARPS, a.bt);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec_ok(a))
    probe_vpu_kernel<true><<<grid, P3_WARPS * 32, 0, s>>>(a);
  else
    probe_vpu_kernel<false><<<grid, P3_WARPS * 32, 0, s>>>(a);
  return (int)cudaGetLastError();
}
