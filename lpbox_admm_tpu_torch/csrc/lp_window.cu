// K1's one-block launch and the C interface of both launches (the
// kernel and its design: lp_window.cuh).
#include "lp_window.cuh"

namespace {

// The kernel's carve-up of shared memory in floats: 13 n-vectors, 9
// m-vectors, the column partial sums and the reduction scratch.
size_t carve_floats(int m, int n) {
  return 13 * (size_t)n + 9 * (size_t)m + 2 * (size_t)col_groups(n) * n +
         4 * NW + 4;
}

// Dynamic shared memory of a launch: the carve-up; with a cluster (C > 1)
// the cluster sum's slot (4 floats), block_sum1's buffers (7 NW floats),
// E^T u's exchange (m side, 2 n-vectors) and, where resident, the block's
// factor rows; on the resident route the block's rows of the one-byte E
// after it (rounded up to 16 bytes).  ops/fused_lp.window_bytes mirrors
// it; a cluster launch may take more (spread_bytes).
size_t smem_need(int m, int n, int route, int C, int fac_resident,
                 int nside) {
  size_t floats = carve_floats(m, n);
  if (C > 1) {
    floats += 4 + 7 * NW + (nside ? 0 : 2 * (size_t)n);
    if (fac_resident)
      floats += nside ? 2 * (size_t)share_rows(n, C) * n
                      : (size_t)share_rows(m, C) * m;
  }
  return floats * sizeof(float) +
         (route == kI8Resident
              ? ((size_t)share_rows(m, C) * n + 15) / 16 * 16 : 0);
}

template <typename TE, bool RES>
cudaError_t launch(const LpWindowArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      lp_window_kernel<TE, RES, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
  if (err != cudaSuccess) return err;
  lp_window_kernel<TE, RES, false><<<a.B, NT, a.smem_bytes, stream>>>(a);
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
  const bool cl_ok = a.cluster == 1 || a.cluster == 2 || a.cluster == 4 ||
                     a.cluster == 8;
  if (a.n % 4 || a.m % 4 || a.n <= 0 || a.m <= 0 || a.H < 2 || a.H > HMAX ||
      a.rho_change_step <= 0 || (a.record && a.traj == nullptr) ||
      (a.nside && a.ete == nullptr) || a.e_route < kF32Stream ||
      a.e_route > kI8Resident || !cl_ok || (a.cluster > 1 && a.record) ||
      (a.fac_resident && a.cluster == 1) ||
      (size_t)a.smem_bytes != smem_need(a.m, a.n, a.e_route, a.cluster,
                                        a.fac_resident, a.nside))
    return (int)cudaErrorInvalidValue;
  if (a.B == 0 || a.window == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.cluster > 1) return (int)lpw::launch_cluster(args, s);
  switch (a.e_route) {
    case kF32Stream: return (int)launch<float, false>(a, s);
    case kBf16Stream: return (int)launch<__nv_bfloat16, false>(a, s);
    case kI8Stream: return (int)launch<int8_t, false>(a, s);
    default: return (int)launch<int8_t, true>(a, s);
  }
}

// Clusters of `cluster` blocks with `smem_bytes` each that the card holds
// at once for the cluster kernel of route `e_route` (a one-byte route); a
// negative cudaError_t on a refusal.
LPBOX_API int lpbox_lp_window_max_clusters(int e_route, int smem_bytes,
                                           int cluster) {
  int out = 0;
  const cudaError_t err =
      lpw::cluster_occupancy(e_route, smem_bytes, cluster, &out);
  return err == cudaSuccess ? out : -(int)err;
}
