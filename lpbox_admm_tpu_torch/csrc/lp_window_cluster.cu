// K1's cluster launch (C = LpWindowArgs.cluster > 1 blocks an instance,
// a runtime cluster dimension) on the one-byte E routes, whose kernels are
// compiled here, beside lp_window.cu's one-block kernels, so that the two
// build in parallel.  The kernel and its design: lp_window.cuh.
#include "lp_window.cuh"

namespace {

// A cluster launch's shared memory: its need, raised where needed so that
// no two of its blocks fit one SM (the card places a cluster's blocks on
// the SMs of one GPC, two to an SM where they fit, and a block then shares
// its SM's bandwidth).
cudaError_t spread_bytes(int need, int* out) {
  int dev, per_sm, reserved;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err == cudaSuccess) *out = max(need, per_sm / 2 - reserved + 16);
  return err;
}

// The cluster kernel's launch configuration: B C blocks, C a cluster, its
// shared memory spread one block an SM.
template <typename TE, bool RES>
cudaError_t cluster_config(int B, int C, int need, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* at) {
  int smem;
  cudaError_t err = spread_bytes(need, &smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(lp_window_kernel<TE, RES, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(B * C);
  cfg->blockDim = dim3(NT);
  cfg->dynamicSmemBytes = smem;
  at->id = cudaLaunchAttributeClusterDimension;
  at->val.clusterDim.x = C;
  at->val.clusterDim.y = 1;
  at->val.clusterDim.z = 1;
  cfg->attrs = at;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

namespace lpw {

cudaError_t launch_cluster(const void* args, cudaStream_t stream) {
  const LpWindowArgs& a = *static_cast<const LpWindowArgs*>(args);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute at;
  cudaError_t err;
  switch (a.e_route) {
    case kI8Stream:
      err = cluster_config<int8_t, false>(a.B, a.cluster, a.smem_bytes, &cfg,
                                          &at);
      if (err != cudaSuccess) return err;
      cfg.stream = stream;
      err = cudaLaunchKernelEx(&cfg, lp_window_kernel<int8_t, false, true>, a);
      break;
    case kI8Resident:
      err = cluster_config<int8_t, true>(a.B, a.cluster, a.smem_bytes, &cfg,
                                         &at);
      if (err != cudaSuccess) return err;
      cfg.stream = stream;
      err = cudaLaunchKernelEx(&cfg, lp_window_kernel<int8_t, true, true>, a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t cluster_occupancy(int e_route, int need, int C, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute at;
  cudaError_t err;
  switch (e_route) {
    case kI8Stream:
      err = cluster_config<int8_t, false>(1, C, need, &cfg, &at);
      return err != cudaSuccess ? err : cudaOccupancyMaxActiveClusters(
          out, lp_window_kernel<int8_t, false, true>, &cfg);
    case kI8Resident:
      err = cluster_config<int8_t, true>(1, C, need, &cfg, &at);
      return err != cudaSuccess ? err : cudaOccupancyMaxActiveClusters(
          out, lp_window_kernel<int8_t, true, true>, &cfg);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace lpw
