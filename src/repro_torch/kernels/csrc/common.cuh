// Shared helpers of the port's refinement kernels: storage <-> float
// conversion by intrinsics only (float or bf16 storage, f32 accumulation).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// A load of *p. COHERENT loads go through the L2 only (ld.global.cg): the
// pyramid reads fields that other blocks of the same launch wrote before a
// grid.sync(), and the read-only path (ld.global.nc, which __restrict__
// const pointers let nvcc pick) is defined only for data that no one
// writes during the launch. Other loads are plain.
template <bool COHERENT, typename T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (COHERENT)
    return __ldcg(p);
  else
    return *p;
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  if (bytes > (size_t)optin) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Stored index of padded coordinate `p` of an axis of `n` stored entries
// reflect-padded by `pad` on each side (numpy's "reflect": the edge is not
// repeated). With pad = 0 and p in [0, n) it is p itself: the per-level
// kernels read fields padded beforehand, the pyramid pads in this index.
__host__ __device__ __forceinline__ int reflect_index(int p, int pad, int n) {
  int i = p - pad;
  i = i < 0 ? -i : i;
  return i >= n ? 2 * (n - 1) - i : i;
}

constexpr int kThreads = 256;
constexpr int kMaxCsz = 9;  // n_csz bound of the register windows
constexpr int kMaxFsz = 8;  // n_fsz bound of the register noise rows

}  // namespace repro

// Each kernel library is one translation unit, so this is defined once
// per library: the Python wrappers turn a returned code into a message.
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
