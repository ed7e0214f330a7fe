// Shared helpers of the port's refinement kernels: storage <-> float
// conversion by intrinsics only (float or bf16 storage, f32 accumulation),
// and spans moved with the widest accesses their address allows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

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
// What an entry returns when the grid or dynamic shared memory it derives
// differs from the launch plan it was handed (kernels/launch.py): the
// launch does not run.
constexpr int kPlanMismatch = 10000;
// Runs (threads) of one streaming launch: the run index is 32-bit.
constexpr long long kMaxRuns = (1LL << 31) - kThreads;
// Whether a streaming launch of `threads` threads matches its plan's grid
// (gx, gy) and dynamic shared memory: ceil(threads / kThreads) x 1 blocks
// and none.
inline bool stream_plan_matches(long long threads, int gx, int gy,
                                int smem) {
  return gx == (threads + kThreads - 1) / kThreads && gy == 1 && smem == 0;
}
constexpr int kMaxCsz = 9;  // n_csz bound of the register windows
constexpr int kMaxFsz = 8;  // n_fsz bound of the register noise rows

// Families per run of the streaming charted kernels, forward and adjoint,
// by stencil (icr_refine.CHARTED_FAMILIES holds the same): 2 at (2, 3), 1
// at (4, 5) (their compile-time instances) and for the runtime-size
// instance.
__host__ __device__ constexpr int charted_families(int F, int C) {
  return F == 2 && C == 3 ? 2 : 1;
}

// -- spans ------------------------------------------------------------------
// A span is N consecutive elements of one row, held as N floats. It moves
// with the widest accesses (up to 16 bytes) its address allows: narrower
// ones up to the first 16-byte boundary, 16-byte ones, a narrower tail.
// Rows are not assumed aligned (rows of 524 290 floats start 8 bytes past
// a boundary every other row, rows of 68 bf16 values 8 bytes past one), so
// the span's offset within its 16-byte segment is read at run time and
// picks one of 16 / sizeof(T) unrolled access sequences.

template <int V>
struct Int {
  static constexpr int value = V;
};

template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);  // elements of a 16-byte access

// The widest access, in elements (a power of two), that starts at element
// `off` of a 16-byte segment and moves at most `n` elements.
template <typename T>
__host__ __device__ constexpr int access_width(int off, int n) {
  int w = kVec<T>;
  while (w > 1 && (off % w != 0 || w > n)) w /= 2;
  return w;
}

template <int BYTES>
struct Bits;
template <>
struct Bits<4> {
  using type = unsigned;
};
template <>
struct Bits<8> {
  using type = uint2;
};
template <>
struct Bits<16> {
  using type = uint4;
};

// W elements at p, aligned to their size, as floats (COHERENT: through
// the L2 only, see load). A bf16 pair is one 32-bit word, the first value
// in the low half; widening it is exact.
template <bool COHERENT, typename T, int W>
__device__ __forceinline__ void load_access(const T* p, float* v) {
  constexpr int bytes = W * (int)sizeof(T);
  if constexpr (bytes == 2) {
    v[0] = to_float(load<COHERENT>(p));
  } else {
    using B = typename Bits<bytes>::type;
    const B bits = load<COHERENT>(reinterpret_cast<const B*>(p));
    unsigned w[bytes / 4];
    memcpy(w, &bits, bytes);
#pragma unroll
    for (int i = 0; i < bytes / 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        v[i] = __uint_as_float(w[i]);
      } else {
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
}

// W floats stored at p, aligned to their size, each rounded once.
template <typename T, int W>
__device__ __forceinline__ void store_access(T* p, const float* v) {
  constexpr int bytes = W * (int)sizeof(T);
  if constexpr (bytes == 2) {
    *p = from_float<T>(v[0]);
  } else {
    unsigned w[bytes / 4];
#pragma unroll
    for (int i = 0; i < bytes / 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        w[i] = __float_as_uint(v[i]);
      } else {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        memcpy(&w[i], &h, 4);
      }
    }
    using B = typename Bits<bytes>::type;
    B bits;
    memcpy(&bits, w, bytes);
    *reinterpret_cast<B*>(p) = bits;
  }
}

// Elements [I, N) of a span whose first element sits at element OFF of its
// 16-byte segment.
template <bool COHERENT, typename T, int N, int OFF, int I = 0>
__device__ __forceinline__ void load_span_at(const T* p, float* v) {
  if constexpr (I < N) {
    constexpr int w = access_width<T>((OFF + I) % kVec<T>, N - I);
    load_access<COHERENT, T, w>(p + I, v + I);
    load_span_at<COHERENT, T, N, OFF, I + w>(p, v);
  }
}

template <typename T, int N, int OFF, int I = 0>
__device__ __forceinline__ void store_span_at(T* p, const float* v) {
  if constexpr (I < N) {
    constexpr int w = access_width<T>((OFF + I) % kVec<T>, N - I);
    store_access<T, w>(p + I, v + I);
    store_span_at<T, N, OFF, I + w>(p, v);
  }
}

// fn(Int<off>{}) for the run-time offset `off` in [0, kVec<T>).
template <typename T, int OFF = 0, typename Fn>
__device__ __forceinline__ void at_offset(int off, Fn&& fn) {
  if constexpr (OFF + 1 < kVec<T>) {
    if (off != OFF) {
      at_offset<T, OFF + 1>(off, fn);
      return;
    }
  }
  fn(Int<OFF>{});
}

template <typename T>
__device__ __forceinline__ int segment_offset(const T* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) & 15u) / sizeof(T));
}

// v = p[0, N), p anywhere in a row; COHERENT through the L2 only.
template <bool COHERENT = false, typename T, int N>
__device__ __forceinline__ void load_span(const T* p, float (&v)[N]) {
  at_offset<T>(segment_offset(p), [&](auto off) {
    load_span_at<COHERENT, T, N, decltype(off)::value>(p, v);
  });
}

// p[0, N) = v, p anywhere in a row.
template <typename T, int N>
__device__ __forceinline__ void store_span(T* p, const float (&v)[N]) {
  at_offset<T>(segment_offset(p), [&](auto off) {
    store_span_at<T, N, decltype(off)::value>(p, v);
  });
}

// The edge of a row of n elements, one element per access: v[i] =
// row[first + i] where 0 <= first + i < n, else 0; nothing else is read.
template <bool COHERENT = false, typename T, int N>
__device__ __forceinline__ void load_range(const T* row, int first, int n,
                                           float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = 0.f;
    if (first + i >= 0 && first + i < n)
      v[i] = to_float(load<COHERENT>(row + first + i));
  }
}

// p[i] = v[i] for i < n only.
template <typename T, int N>
__device__ __forceinline__ void store_prefix(T* p, int n, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n) p[i] = from_float<T>(v[i]);
}

}  // namespace repro

// Each kernel library is one translation unit, so this is defined once
// per library: the Python wrappers turn a returned code into a message.
extern "C" const char* repro_cuda_error_string(int code) {
  if (code == repro::kPlanMismatch)
    return "the launch's grid or shared memory differs from its plan";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
