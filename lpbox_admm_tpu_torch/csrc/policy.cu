// K2: evaluation forward of the early-fixing policy, one sigmoid per
// trajectory row.
//
// Replaces the TPU kernel lpbox_admm_tpu/models/pallas_policy.py::
// _policy_kernel (called by pallas_policy_scores, pallas_policy.py:248).
// Same math on the same packed weights (BatchNorm folded, the
// attention init shift applied at pack time): embedding of the row's
// tokens ("chunk" windows: token t = row[t*C : t*C+C]; "sliding":
// stride 1) plus the position-encoding bias, L x (8-head attention,
// out-projection, folded BN, ReLU feed-forward, folded BN), and the
// token-concat classifier T*128 -> 256 -> 128 -> 16 -> 1 with a sigmoid.
//
// Bound.  At T = 20, E = 128, F = 512, L = 2 a row is 8.77 M FMAs, 92%
// of them in the encoder's dense layers and 7.9% in the classifier's
// first layer.  Held to f32 accuracy, the least time is three TF32
// passes on the tensor cores: 3 x 1.150 TFLOP / 495 TFLOP/s = 6.97 ms for
// 65 536 rows.  One TF32 pass misses the 1e-4 tolerance on the sigmoids
// (tests/test_torch_k2_precision.py), so every dense product sums lo*hi
// + hi*lo + hi*hi of splits a = hi + lo on mma.sync m16n8k8.  The
// tensor core's own f32 sums round toward zero, a loss that grows with
// the carried sum (P2's finding), so each tile's products of one chunk
// (K <= 32, at most 12 mma's) go into a zeroed fragment that f32 adds
// fold into the running sums.  What this design leaves on the table is
// mma.sync itself: it reaches about two thirds of the TF32 peak on this
// card (lpbox_admm_tpu_torch/scripts/tc_rate.py), and only wgmma reaches
// the rest.  A wgmma encoder (64-token blocks: 3 rows, wgmma's N; the
// weights as register A; h, o and the feed-forward split into hi|lo
// operands in shared memory) was right but slower than this one: at
// N = 32 or 64 a warpgroup waits on its own products, and 64-token
// blocks read the weights a third more often.
//
// Two kernels, one call of the wrapper:
//
// 1. policy_encoder_kernel: 80 token slots a block (R = 80 / T rows:
//    4 at T = 20), 16 warps, one block an SM (218 148 B of shared
//    memory).  h (80 x 128) and q|k|v (80 x 384) stay in shared memory.
//    Every dense layer is a block product on the tensor cores with the
//    WEIGHTS as the A operand (16 output features x 8 k) and the tokens
//    as B (8 tokens x 8 k): the weights, laid out once per solve in
//    fragment order (fused_policy.policy_operand), are one 16-byte load
//    a lane.  A warp owns 16 or 32 output features and 40 tokens; the k
//    slots are permuted (slot t <-> k 2t, slot t+4 <-> k 2t+1, in the
//    weights' layout too), so a token operand is one 8-byte load from a
//    row stride of 8 mod 32 banks (conflict-free).  Both operands are
//    split in registers in two instructions (tsplit).
//    The weights of all layers are one stream of 16 KB chunks in the
//    order the block uses them.  One thread copies a chunk into a ring
//    of 3 slots with a bulk copy (TMA) that completes an mbarrier; the
//    last warp to finish with a slot refills it, so warps wait for bytes
//    and not for each other inside a product (a block barrier stands
//    only where an activation is written and then read), and the ring
//    runs ahead across attention and the epilogues.  The old kernel
//    read every weight with scalar __ldg from every thread of 16 384
//    blocks: 71.4 GB from L2 a 65 536-row launch, against 26.1 GB for
//    this encoder and 5.6 GB for the classifier (chip_smoke.k2_l2_bytes,
//    closed form).
//    Attention stays on the CUDA cores (2.3% of the FMAs): a warp takes
//    5 query tokens at once (five independent chains), lane = 4 * head
//    + quarter holds 4 of the head's 16 dimensions (16-byte loads, a
//    warp reads 512 contiguous bytes: no bank conflict), the logit is
//    summed over the quad by two shuffles, and one pass with a running
//    maximum keeps no per-key array (one exp2 a key).  80 tokens on 16
//    warps are 5 full rounds.  The last h goes to device memory
//    (n_rows x T*128 f32).
// 2. policy_classifier_kernel: 64 rows a block, 16 warps.  The first
//    layer, (64 x T*128) x (T*128 x 256), reads the encoder's h and wc0
//    (split into TF32 hi|lo once per solve, in fragment order) through a
//    3-stage cp.async ring, so wc0 is read from L2 once per 64 rows
//    instead of once per 4.  wc1 (hi|lo) runs on the tensor cores from
//    L2; wc2, w3 and the sigmoid on the CUDA cores.
//
// Both kernels use at most 128 registers a thread (512 threads, one
// block an SM).  No atomics in any sum: a repeat launch gives the same
// bits.
#include "common.cuh"

namespace {

constexpr int E = 128;            // embedding width
constexpr int E3 = 3 * E;
constexpr int TMAX = 20;          // most tokens per row
constexpr int FH = 256;           // feed-forward hidden units per half
constexpr int C0 = 256, C1 = 128, C2 = 16;   // classifier widths

// encoder
constexpr int ENC_WARPS = 16;
constexpr int ENC_NT = ENC_WARPS * 32;
constexpr int TOK = 80;           // token slots a block: 10 n-tiles of 8
constexpr int TOK_WARP = 40;      // tokens a warp: 5 n-tiles
constexpr int FGROUPS = ENC_WARPS * TOK_WARP / TOK;   // feature groups
constexpr int HS = E + 8;         // row strides (floats), 8 mod 32 banks
constexpr int BS = E3 + 8;
constexpr int CHUNK = 4096;       // floats of a weight chunk (16 KB)
constexpr int STAGES = 3;
constexpr int ENC_SMEM = (TOK * HS + TOK * BS + STAGES * CHUNK) * 4 +
                         STAGES * (8 + 4);   // + barriers, release counts
static_assert(FGROUPS * TOK == ENC_WARPS * TOK_WARP, "warp grid");

// classifier
constexpr int CLS_WARPS = 16;
constexpr int CLS_NT = CLS_WARPS * 32;
constexpr int BR = 64;            // rows a block
constexpr int KC = 32;            // k columns a stage: 4 k-steps
constexpr int HCS = KC + 8;       // staged h row stride: 40, conflict-free
constexpr int WC_STAGE = KC * C0 * 2;        // wc0 hi|lo floats a stage
constexpr int CSTAGE = WC_STAGE + BR * HCS;
constexpr int CSTAGES = 3;
constexpr int Z0S = C0 + 8, Z1S = C1 + 4;
constexpr int CLS_SMEM = (CSTAGES * CSTAGE > BR * (Z0S + Z1S)
                              ? CSTAGES * CSTAGE
                              : BR * (Z0S + Z1S)) * 4;

struct PolicyArgs {
  const float* rows;   // (n_rows, ws)
  const float* enc;    // (L, 65536 + 256 F) dense layers, fragment order
  const float* wc0;    // (T*E*256*2,) hi|lo fragment order
  const float* wc1;    // (256*128*2,) hi|lo fragment order
  const float* w_top;  // (C, E)
  const float* peb;    // (T, E) position encoding @ embed + bias
  const float* g1;     // (L, E)
  const float* c1;     // (L, E)
  const float* b1;     // (L, F)
  const float* b2;     // (L, E)
  const float* g2;     // (L, E)
  const float* c2;     // (L, E)
  const float* bc0;    // (256,)
  const float* bc1;    // (128,)
  const float* wc2;    // (128, 16)
  const float* bc2;    // (16,)
  const float* w3;     // (16,)
  const float* b3;     // (1,)
  float* hout;         // (n_rows, T*E) the encoder's last h
  float* out;          // (n_rows,)
  int n_rows, ws, T, C, stride, L, F;
};

// 16 bytes global -> shared, zeros where !ok (src-size 0; src stays a
// valid address).
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     bool ok = true) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a = hi + lo in two instructions: hi = a truncated to TF32 (its 13 low
// bits cleared), lo = a - hi (exact), handed to the tensor core as it
// is: a .tf32 mma reads the top 19 bits of a register, so it takes lo
// truncated too.  hi*hi + hi*lo + lo*hi then carries a product to about
// 2^-20 of its size.  Rounding both parts to nearest (cvt.rna.tf32, as
// P2 does) carries it to 2^-22 but takes nine instructions on sm_90a.
__device__ __forceinline__ void tsplit(float a, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(a) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(const float4& q, unsigned (&hi)[4],
                                       unsigned (&lo)[4]) {
  tsplit(q.x, hi[0], lo[0]);
  tsplit(q.y, hi[1], lo[1]);
  tsplit(q.z, hi[2], lo[2]);
  tsplit(q.w, hi[3], lo[3]);
}

__device__ __forceinline__ void as_bits(const float4& q, unsigned (&u)[4]) {
  u[0] = __float_as_uint(q.x);
  u[1] = __float_as_uint(q.y);
  u[2] = __float_as_uint(q.z);
  u[3] = __float_as_uint(q.w);
}

// lo*hi + hi*lo + hi*hi into c, small terms first.
__device__ __forceinline__ void mma3(float (&c)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4], unsigned bh0,
                                     unsigned bh1, unsigned bl0,
                                     unsigned bl1) {
  lpbox::mma_tf32(c, al, bh0, bh1);
  lpbox::mma_tf32(c, ah, bl0, bl1);
  lpbox::mma_tf32(c, ah, bh0, bh1);
}

// Tokens nb + 8j + g, k slots 2t and 2t + 1 of the k-step at k0: one
// 8-byte load from a row of stride ld, split.
__device__ __forceinline__ void token_frag(const float* B, int ld, int row,
                                           int k, unsigned& bh0,
                                           unsigned& bh1, unsigned& bl0,
                                           unsigned& bl1) {
  const float2 b = *reinterpret_cast<const float2*>(B + row * ld + k);
  tsplit(b.x, bh0, bl0);
  tsplit(b.y, bh1, bl1);
}

template <int M, int N>
__device__ __forceinline__ void fold(float (&acc)[M][N][4],
                                     float (&c)[M][N][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[i][j][q] += c[i][j][q];
        c[i][j][q] = 0.f;
      }
}

// ---- encoder --------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The weight stream: STAGES slots of one chunk, each with an mbarrier
// that a bulk copy (TMA, one thread, 16 KB) completes.  Chunk c lives in
// slot c % STAGES and completes phase (c / STAGES) & 1 of its barrier.
// A warp done with a chunk adds one to the slot's release count; the
// warp that brings it to a multiple of ENC_WARPS (every warp is done)
// refills the slot with chunk c + STAGES.  So no warp waits for another
// inside a product, only for its chunk's bytes.
struct Ring {
  float* buf;
  unsigned long long* full;   // (STAGES,) mbarriers
  int* released;              // (STAGES,) release counts
  const float* src;
  int total;
};

__device__ __forceinline__ void ring_issue(const Ring& r, int c) {
  const int s = c % STAGES;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(r.full + s)), "r"(CHUNK * 4) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(r.buf + s * CHUNK)),
      "l"(r.src + (size_t)c * CHUNK), "r"(CHUNK * 4),
      "r"(smem_u32(r.full + s))
      : "memory");
}

// Thread 0: barriers, then the first STAGES chunks; every thread passes
// the barrier before any wait.
__device__ __forceinline__ void ring_start(const Ring& r) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
          smem_u32(r.full + s)));
      r.released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < STAGES && c < r.total; ++c) ring_issue(r, c);
  }
  __syncthreads();
}

// Chunk ci, once its bytes have landed.  A wait that never ends (a
// fault) traps instead of hanging the card.
__device__ __forceinline__ const float* ring_wait(const Ring& r, int ci) {
  const int s = ci % STAGES;
  const unsigned parity = (ci / STAGES) & 1, bar = smem_u32(r.full + s);
  for (unsigned n = 0;; ++n) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, "
        "[%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) break;
    if (n == (1u << 22)) __trap();
  }
  return r.buf + s * CHUNK;
}

__device__ __forceinline__ void ring_release(const Ring& r, int ci) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    __threadfence_block();
    const int s = ci % STAGES;
    if (atomicAdd(r.released + s, 1) % ENC_WARPS == ENC_WARPS - 1 &&
        ci + STAGES < r.total)
      ring_issue(r, ci + STAGES);
  }
}

// out(n, f) = epi(n, f, sum_k B[n, k] W[k, f]) over the block's 80
// tokens n and the pass's NP features f, K a multiple of 32; W streams
// through the ring in fragment order ([k-step][m-tile][lane][4]), B
// (tokens x K) is in shared memory.  Warp w takes the MF m-tiles of
// feature group w % FGROUPS and the 5 n-tiles of token half w / FGROUPS.
// Each tile's products of a chunk (2 or 4 k-steps) go into a zeroed
// fragment, added to the tile's running sums in f32.
template <int NP, bool SYNC = true, class Epi>
__device__ __forceinline__ void enc_gemm(const float* B, int ldb, int K,
                                         const Ring& ring, int& ci,
                                         Epi epi) {
  constexpr int MT = NP / 16;
  constexpr int MF = MT / FGROUPS;      // m-tiles a warp
  constexpr int KS = CHUNK / (8 * NP);  // k-steps a chunk
  constexpr int NT = TOK_WARP / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mt0 = (warp % FGROUPS) * MF, nb = (warp / FGROUPS) * TOK_WARP;
  float acc[MF][NT][4] = {};
  const int nchunks = K / (KS * 8);
  // B written (and what the epilogue overwrites read) by every warp
  if (SYNC) __syncthreads();
  for (int c = 0; c < nchunks; ++c, ++ci) {
    const float* w = ring_wait(ring, ci);
    unsigned ah[KS][MF][4], al[KS][MF][4];
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
        split4(*reinterpret_cast<const float4*>(
                   w + ((s * MT + mt0 + mf) * 32 + lane) * 4),
               ah[s][mf], al[s][mf]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      unsigned bh[KS][2], bl[KS][2];
#pragma unroll
      for (int s = 0; s < KS; ++s)
        token_frag(B, ldb, nb + 8 * j + g, (c * KS + s) * 8 + 2 * t,
                   bh[s][0], bh[s][1], bl[s][0], bl[s][1]);
#pragma unroll
      for (int mf = 0; mf < MF; ++mf) {
        float cc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int s = 0; s < KS; ++s)
          mma3(cc, ah[s][mf], al[s][mf], bh[s][0], bh[s][1], bl[s][0],
               bl[s][1]);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mf][j][q] += cc[q];
      }
    }
    ring_release(ring, ci);
  }
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int f = (mt0 + mf) * 16 + g, n = nb + 8 * j + 2 * t;
      epi(n, f, acc[mf][j][0]);
      epi(n + 1, f, acc[mf][j][1]);
      epi(n, f + 8, acc[mf][j][2]);
      epi(n + 1, f + 8, acc[mf][j][3]);
    }
}

// Attention over q|k|v in `big` (token rows of stride BS), the result
// written over q.  A warp takes query tokens warp + 16 i (i < 5) at once
// (five independent chains); lane = 4 * head + quarter holds dimensions
// 4 * quarter .. + 3 of its head.  One pass over the keys with a running
// maximum (the sum and the weighted values rescaled when it grows), so
// no per-key array is kept.
constexpr int ATT_Q = TOK / ENC_WARPS;
__device__ __forceinline__ void attention(float* big, int T, int RT) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = 4 * lane;
  // logits in base 2: exp(x) = exp2(x log2(e))
  const float scale = 0.25f * 1.4426950408889634f;   // log2(e) / sqrt(16)
  const float* kv[ATT_Q];
  float4 q[ATT_Q], o[ATT_Q];
  float mx[ATT_Q], den[ATT_Q];
#pragma unroll
  for (int i = 0; i < ATT_Q; ++i) {
    const int tq = min(warp + ENC_WARPS * i, RT - 1);
    kv[i] = big + (tq / T) * T * BS + col;
    q[i] = *reinterpret_cast<const float4*>(big + tq * BS + col);
    q[i].x *= scale;
    q[i].y *= scale;
    q[i].z *= scale;
    q[i].w *= scale;
    o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    mx[i] = -3.0e38f;
    den[i] = 0.f;
  }
  for (int s = 0; s < T; ++s) {
#pragma unroll
    for (int i = 0; i < ATT_Q; ++i) {
      const float4 k =
          *reinterpret_cast<const float4*>(kv[i] + s * BS + E);
      float p = fmaf(q[i].w, k.w,
                     fmaf(q[i].z, k.z, fmaf(q[i].y, k.y, q[i].x * k.x)));
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      // one exp2 a key: a new maximum rescales the sums, else the key
      // is weighted against the running maximum
      const float lg = p, d = lg - mx[i];
      float x;
      asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(x) : "f"(-fabsf(d)));
      const bool up = d > 0.f;
      const float cor = up ? x : 1.f, e = up ? 1.f : x;
      const float4 v =
          *reinterpret_cast<const float4*>(kv[i] + s * BS + 2 * E);
      den[i] = fmaf(den[i], cor, e);
      o[i].x = fmaf(o[i].x, cor, e * v.x);
      o[i].y = fmaf(o[i].y, cor, e * v.y);
      o[i].z = fmaf(o[i].z, cor, e * v.z);
      o[i].w = fmaf(o[i].w, cor, e * v.w);
      mx[i] = up ? lg : mx[i];
    }
  }
  __syncthreads();                // every key and value read
#pragma unroll
  for (int i = 0; i < ATT_Q; ++i) {
    const int tq = warp + ENC_WARPS * i;
    const float inv = 1.f / den[i];
    if (tq < RT)
      *reinterpret_cast<float4*>(big + tq * BS + col) = make_float4(
          o[i].x * inv, o[i].y * inv, o[i].z * inv, o[i].w * inv);
  }
}

__global__ void __launch_bounds__(ENC_NT, 1)
    policy_encoder_kernel(const PolicyArgs a) {
  extern __shared__ __align__(16) float sm[];
  float* h = sm;                  // (TOK, HS): token r*T + t of row r
  float* big = h + TOK * HS;      // (TOK, BS): q|k|v; then FF half | sum
  const int T = a.T, R = TOK / T, RT = R * T, F = a.F;
  const int row0 = blockIdx.x * R;
  const int layer = E * E3 + E * E + 2 * E * F;   // floats a layer
  float* ring_buf = big + TOK * BS;               // STAGES weight chunks
  const Ring ring{ring_buf,
                  reinterpret_cast<unsigned long long*>(ring_buf +
                                                        STAGES * CHUNK),
                  reinterpret_cast<int*>(ring_buf + STAGES * CHUNK +
                                         2 * STAGES),
                  a.enc, a.L * layer / CHUNK};
  ring_start(ring);

  // embed: h[r*T + t] = row[t*stride : +C] @ W_top + peb[t]; zeros in the
  // slots past R*T
  {
    // column col of tokens tok0 + 4 u (u < TOK / 4): the loads of all
    // of a thread's tokens in flight together
    constexpr int U = TOK * E / ENC_NT;
    const int col = threadIdx.x % E, tok0 = threadIdx.x / E;
    const float* x[U];
    float acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int tok = tok0 + (ENC_NT / E) * u, r = tok / T, row = row0 + r;
      const bool ok = tok < RT && row < a.n_rows;
      x[u] = ok ? a.rows + (size_t)row * a.ws + (tok - r * T) * a.stride
                : nullptr;
      acc[u] = tok < RT ? __ldg(a.peb + (tok - r * T) * E + col) : 0.f;
    }
    float emb[U] = {};
    for (int c = 0; c < a.C; ++c) {
      const float w = __ldg(a.w_top + c * E + col);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (x[u]) emb[u] = fmaf(__ldg(x[u] + c), w, emb[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      h[(tok0 + (ENC_NT / E) * u) * HS + col] = emb[u] + acc[u];
  }
  // (the first product's barrier orders these writes before any read)

  int ci = 0;
  for (int l = 0; l < a.L; ++l) {
    const float* g1 = a.g1 + l * E;
    const float* c1 = a.c1 + l * E;
    const float* b1 = a.b1 + (size_t)l * F;
    const float* b2 = a.b2 + l * E;
    const float* g2 = a.g2 + l * E;
    const float* c2 = a.c2 + l * E;
    enc_gemm<256>(h, HS, E, ring, ci,
                [&](int n, int f, float v) { big[n * BS + f] = v; });
    enc_gemm<128, false>(h, HS, E, ring, ci,
                [&](int n, int f, float v) { big[n * BS + 2 * E + f] = v; });
    __syncthreads();
    attention(big, T, RT);        // ends with a barrier
    // out-projection + residual + folded BN1, in place on h (each
    // element read and written by the thread that owns its output)
    enc_gemm<128>(big, BS, E, ring, ci,
                [&](int n, int f, float v) {
                  float* p = h + n * HS + f;
                  *p = (*p + v) * __ldg(g1 + f) + __ldg(c1 + f);
                });
    // feed-forward in halves of FH hidden units: relu part in
    // big[:, 0:FH], the running down-projection in big[:, FH:FH+E]; the
    // last half adds the residual and folded BN2 into h
    for (int f0 = 0; f0 < F; f0 += FH) {
      enc_gemm<256>(h, HS, E, ring, ci,
                  [&](int n, int f, float v) {
                    big[n * BS + f] = fmaxf(v + __ldg(b1 + f0 + f), 0.f);
                  });
      const bool first = f0 == 0, last = f0 + FH == F;
      enc_gemm<128>(big, BS, FH, ring, ci,
                  [&](int n, int f, float v) {
                    float* d = big + n * BS + FH + f;
                    const float run = first ? v : *d + v;
                    if (last) {
                      float* p = h + n * HS + f;
                      *p = (*p + (run + __ldg(b2 + f))) * __ldg(g2 + f) +
                           __ldg(c2 + f);
                    } else {
                      *d = run;
                    }
                  });
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < RT * (E / 4); i += ENC_NT) {
    const int tok = i / (E / 4), q = i % (E / 4);
    const int r = tok / T, tt = tok - r * T, row = row0 + r;
    if (row < a.n_rows)
      *reinterpret_cast<float4*>(a.hout + (size_t)row * T * E + tt * E +
                                 4 * q) =
          *reinterpret_cast<const float4*>(h + tok * HS + 4 * q);
  }
}

// ---- classifier -----------------------------------------------------

__global__ void __launch_bounds__(CLS_NT, 1)
    policy_classifier_kernel(const PolicyArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int K = a.T * E, nchunks = K / KC;
  const int row0 = blockIdx.x * BR;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int fg = warp & 7, nb = (warp >> 3) * 32;

  // stage c: wc0's k rows [c*KC, +KC) (hi|lo, fragment order) and the
  // block's h rows at those columns (zeros past n_rows)
  auto issue = [&](int c) {
    if (c < nchunks) {
      float* st = sm + (c % CSTAGES) * CSTAGE;
      const float* w = a.wc0 + (size_t)c * WC_STAGE;
      for (int i = threadIdx.x; i < WC_STAGE / 4; i += CLS_NT)
        cp16(st + 4 * i, w + 4 * i);
      if (threadIdx.x < BR * KC / 4) {
        const int r = threadIdx.x / (KC / 4), q = threadIdx.x % (KC / 4);
        const bool ok = row0 + r < a.n_rows;
        cp16(st + WC_STAGE + r * HCS + 4 * q,
             a.hout + (size_t)(ok ? row0 + r : 0) * K + c * KC + 4 * q, ok);
      }
    }
    cp_commit();
  };
  for (int c = 0; c < CSTAGES - 1; ++c) issue(c);

  // z0 = relu(h @ wc0 + bc0): warp takes features 32 fg .. + 31 and rows
  // nb .. + 31
  float acc[2][4][4] = {};
  float cc[2][4][4] = {};
  for (int c = 0; c < nchunks; ++c) {
    cp_wait<CSTAGES - 2>();
    __syncthreads();
    issue(c + CSTAGES - 1);
    const float* st = sm + (c % CSTAGES) * CSTAGE;
    const float* hb = st + WC_STAGE;
#pragma unroll
    for (int s = 0; s < KC / 8; ++s) {
      unsigned ah[2][4], al[2][4];
#pragma unroll
      for (int mf = 0; mf < 2; ++mf) {
        const float* p = st + (s * 16 + 2 * fg + mf) * 256 + 4 * lane;
        as_bits(*reinterpret_cast<const float4*>(p), ah[mf]);
        as_bits(*reinterpret_cast<const float4*>(p + 128), al[mf]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        unsigned bh0, bh1, bl0, bl1;
        token_frag(hb, HCS, nb + 8 * j + g, s * 8 + 2 * t, bh0, bh1, bl0,
                   bl1);
#pragma unroll
        for (int mf = 0; mf < 2; ++mf)
          mma3(cc[mf][j], ah[mf], al[mf], bh0, bh1, bl0, bl1);
      }
    }
    fold(acc, cc);
  }
  cp_wait<0>();
  __syncthreads();                // the ring's memory becomes z0 | z1
  float* z0 = sm;                 // (BR, Z0S)
  float* z1 = sm + BR * Z0S;      // (BR, Z1S)
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = (2 * fg + mf) * 16 + g, n = nb + 8 * j + 2 * t;
      const float b0 = __ldg(a.bc0 + f), b8 = __ldg(a.bc0 + f + 8);
      z0[n * Z0S + f] = fmaxf(acc[mf][j][0] + b0, 0.f);
      z0[(n + 1) * Z0S + f] = fmaxf(acc[mf][j][1] + b0, 0.f);
      z0[n * Z0S + f + 8] = fmaxf(acc[mf][j][2] + b8, 0.f);
      z0[(n + 1) * Z0S + f + 8] = fmaxf(acc[mf][j][3] + b8, 0.f);
    }
  __syncthreads();

  // z1 = relu(z0 @ wc1 + bc1): wc1 (hi|lo, fragment order) from L2, warp
  // takes features 16 fg .. + 15 and rows nb .. + 31; folded every 4
  // k-steps
  {
    float acc1[1][4][4] = {};
    float cc1[1][4][4] = {};
    for (int k0 = 0; k0 < C0 / 8; k0 += 4) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int ks = k0 + s;
        unsigned ah[4], al[4];
        const float4* p = reinterpret_cast<const float4*>(
            a.wc1 + (ks * 8 + fg) * 256 + 4 * lane);
        as_bits(__ldg(p), ah);
        as_bits(__ldg(p + 32), al);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          unsigned bh0, bh1, bl0, bl1;
          token_frag(z0, Z0S, nb + 8 * j + g, ks * 8 + 2 * t, bh0, bh1, bl0,
                     bl1);
          mma3(cc1[0][j], ah, al, bh0, bh1, bl0, bl1);
        }
      }
      fold(acc1, cc1);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = fg * 16 + g, n = nb + 8 * j + 2 * t;
      const float b0 = __ldg(a.bc1 + f), b8 = __ldg(a.bc1 + f + 8);
      z1[n * Z1S + f] = fmaxf(acc1[0][j][0] + b0, 0.f);
      z1[(n + 1) * Z1S + f] = fmaxf(acc1[0][j][1] + b0, 0.f);
      z1[n * Z1S + f + 8] = fmaxf(acc1[0][j][2] + b8, 0.f);
      z1[(n + 1) * Z1S + f + 8] = fmaxf(acc1[0][j][3] + b8, 0.f);
    }
  }
  __syncthreads();

  // z2 = relu(z1 @ wc2 + bc2) and the sigmoid of z2 . w3 + b3: a
  // half-warp per row, lane % 16 = feature
  const int f = lane & 15;
  for (int r = 2 * warp + (lane >> 4); r < BR; r += 2 * CLS_WARPS) {
    float s = 0.f;
    for (int k = 0; k < C1; ++k)
      s = fmaf(z1[r * Z1S + k], __ldg(a.wc2 + k * C2 + f), s);
    float z = fmaxf(s + __ldg(a.bc2 + f), 0.f) * __ldg(a.w3 + f);
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) z += __shfl_xor_sync(0xffffffffu, z, o);
    if (f == 0 && row0 + r < a.n_rows)
      a.out[row0 + r] = 1.f / (1.f + expf(-(z + __ldg(a.b3))));
  }
}

}  // namespace

LPBOX_API int lpbox_policy_args_size() { return (int)sizeof(PolicyArgs); }

// Score a.n_rows rows on `stream` (the encoder, then the classifier);
// returns the cudaError_t of the launches.
LPBOX_API int lpbox_policy_forward(const void* args, void* stream) {
  const PolicyArgs& a = *static_cast<const PolicyArgs*>(args);
  if (a.T <= 0 || a.T > TMAX || a.C <= 0 || a.L < 0 ||
      (a.L > 0 && (a.F <= 0 || a.F % FH)) || a.stride <= 0 ||
      (a.T - 1) * a.stride + a.C > a.ws || a.hout == nullptr)
    return (int)cudaErrorInvalidValue;
  if (a.n_rows == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      policy_encoder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      ENC_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(policy_classifier_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               CLS_SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = TOK / a.T;
  policy_encoder_kernel<<<(a.n_rows + R - 1) / R, ENC_NT, ENC_SMEM, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  policy_classifier_kernel<<<(a.n_rows + BR - 1) / BR, CLS_NT, CLS_SMEM,
                             s>>>(a);
  return (int)cudaGetLastError();
}
