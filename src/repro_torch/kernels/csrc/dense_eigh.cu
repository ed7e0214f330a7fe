// cuSOLVER's syevd on the caller's stream, with no host sync of its own:
// the binding `chip_smoke.py --level0-probe` asks whether the level-0 root
// of a learned-θ step could be an eigendecomposition inside a CUDA graph.
//
// Replaces no Pallas kernel: the JAX package computes the level-0 root (a
// dense symmetric matrix of the chart's level-0 points, 1,024 to 4,096 on
// the port's charts) by jnp.linalg.eigh outside any kernel, and XLA
// compiles that call into the step. torch.linalg.eigh reads cuSOLVER's
// info on the host; this binding leaves it on the device, takes its device
// workspace from the caller (torch's allocator, so a captured call draws
// it from the graph's pool), and creates the device's cuSOLVER handle at
// the first workspace query, which the caller makes eagerly. On the H100
// with CUDA 12.8 syevd itself invalidates the capture at all three sizes,
// so the port's root is a float64 Cholesky factor (core/refine.py) and no
// path calls this binding.
#include <cusolverDn.h>

#include <cstdlib>

#include "common.cuh"

namespace {

constexpr int kMaxDevices = 64;
// what an entry returns for a cuSOLVER status s != 0
constexpr int kCusolverBase = 20000;

cusolverDnHandle_t g_handle[kMaxDevices];
cusolverDnParams_t g_params[kMaxDevices];
void* g_host[kMaxDevices];
size_t g_host_bytes[kMaxDevices];

int ready(int device) {
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (g_handle[device] == nullptr) {
    cusolverStatus_t s = cusolverDnCreate(&g_handle[device]);
    if (s != CUSOLVER_STATUS_SUCCESS) return kCusolverBase + (int)s;
    s = cusolverDnCreateParams(&g_params[device]);
    if (s != CUSOLVER_STATUS_SUCCESS) return kCusolverBase + (int)s;
  }
  return 0;
}

}  // namespace

// syevd's workspace for one n x n float32 matrix at `a` (eigenvalues to
// `w`): the device bytes into *dev_bytes, the host bytes into *host_bytes
// (a host buffer of that size is kept per device for the runs).
extern "C" int dense_eigh_workspace(int n, void* a, void* w,
                                    void* dev_bytes, void* host_bytes,
                                    int device) {
  int err = ready(device);
  if (err != 0) return err;
  size_t d = 0, h = 0;
  cusolverStatus_t s = cusolverDnXsyevd_bufferSize(
      g_handle[device], g_params[device], CUSOLVER_EIG_MODE_VECTOR,
      CUBLAS_FILL_MODE_LOWER, n, CUDA_R_32F, a, n, CUDA_R_32F, w, CUDA_R_32F,
      &d, &h);
  if (s != CUSOLVER_STATUS_SUCCESS) return kCusolverBase + (int)s;
  if (h > g_host_bytes[device]) {
    std::free(g_host[device]);
    g_host[device] = std::malloc(h);
    if (g_host[device] == nullptr) return (int)cudaErrorMemoryAllocation;
    g_host_bytes[device] = h;
  }
  *static_cast<long long*>(dev_bytes) = (long long)d;
  *static_cast<long long*>(host_bytes) = (long long)h;
  return 0;
}

// Eigenpairs of the symmetric n x n float32 matrix at `a` (its lower
// triangle in column-major order: any triangle of a symmetric matrix),
// enqueued on `stream`: `a` is overwritten by the eigenvectors (column j is
// eigenvector j), `w` gets the eigenvalues ascending, *info cuSOLVER's
// info (0: success), all on the device.
extern "C" int dense_eigh_run(int n, void* a, void* w, void* info,
                              void* work, long long work_bytes, int device,
                              void* stream) {
  int err = ready(device);
  if (err != 0) return err;
  cusolverStatus_t s =
      cusolverDnSetStream(g_handle[device], static_cast<cudaStream_t>(stream));
  if (s != CUSOLVER_STATUS_SUCCESS) return kCusolverBase + (int)s;
  s = cusolverDnXsyevd(g_handle[device], g_params[device],
                       CUSOLVER_EIG_MODE_VECTOR, CUBLAS_FILL_MODE_LOWER, n,
                       CUDA_R_32F, a, n, CUDA_R_32F, w, CUDA_R_32F, work,
                       (size_t)work_bytes, g_host[device],
                       g_host_bytes[device], static_cast<int*>(info));
  if (s != CUSOLVER_STATUS_SUCCESS) return kCusolverBase + (int)s;
  return (int)cudaGetLastError();
}
