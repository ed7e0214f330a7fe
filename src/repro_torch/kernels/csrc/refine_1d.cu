// The 1-D forward refinement kernels of the port (paper Eq. 11-12, §4.3).
//
// Replace the Pallas kernels of src/repro/kernels/icr_refine.py:
//   _stationary_kernel    (l.98)  - one stencil shared by every family;
//   _charted_kernel       (l.129) - per-family stencils R[t], sqrtD[t];
//   _stationary_nn_kernel (l.115) and _charted_nn_kernel (l.145) - the
//     same without xi or sqrtD, for the non-final passes of the nd-axes
//     route (the NOISE = false instances).
// With noise they compute, with s = n_fsz/2,
//   fine[b, t*F + f] = sum_k R[t][f][k] coarse[b, t*s + k]
//                    + sum_j D[t][f][j] xi[b, t, j].
//
// What bounds them: bytes. An output costs n_csz + n_fsz fused
// multiply-adds (18 FLOP at 5x4) against 8 bytes of xi read and fine
// write plus half a coarse element, about 2 FLOP per byte at f32: a tenth
// of the H100's f32 ridge (67 TFLOP/s over 3.35 TB/s). Without noise it is
// 10 FLOP against ~6 bytes. So every byte is read and written once, and
// what decides the time is how many bytes each SM keeps in flight.
//
// Stationary (refine_1d_stationary_fwd): a streaming kernel with no shared
// memory and no barrier. Each thread owns a run of NF consecutive families
// of one row: it reads their coarse window ((NF-1)*s + n_csz values, the
// n_csz - s halo shared with the next run served by L1) and, with noise,
// their xi, with the widest accesses the addresses allow (common.cuh
// spans: 16 bytes where aligned, any row start), and writes their NF*F
// outputs the same way. The stencil lives in registers, loaded once per
// thread. Runs are numbered row by row over the whole grid, so rows
// shorter than a block's work (the trailing axes of an N-D level: 128
// outputs) pack several to a block with every lane busy. The charts'
// stencils (2, 3) and (4, 5) are compile-time instances whose loops unroll
// fully; any other stencil runs a runtime-size instance, one family per
// run with one element per access. The last run of a row takes what is
// left of it, element by element. On an H100 the instances take no longer
// than a device copy of as many bytes (chip_smoke.py's copy_ms, PERF.md).
//
// Charted (refine_1d_charted_fwd): the same streaming body with a stencil
// per family. Its shapes are of two kinds, as the charted adjoint's: long
// rows and few samples (a charted 1-D chart: 8 rows of 65K families),
// where R[t] and D[t] weigh as much as xi, and very many short rows (the
// axis-0 pass of the nd-axes route: 16K rows of 16 families). So a thread
// owns a run of NF families of SB rows: it reads its families' stencils
// once, holds them in registers for all SB rows, and per row streams the
// coarse window and xi in and its outputs out through spans; on short rows
// the few families' stencils stay in L1 and a block packs several rows.
// The launch geometry (NF, SB, runs) is icr_refine.charted_shape_1d, the
// charted adjoint's. Both bodies live in refine_1d_tile.cuh, shared with
// the pyramid's 1-D levels.
//
// Storage is float or bf16 (intrinsic conversions); every sum is f32, in
// the order of refine_1d_tile.cuh, and each output is rounded once.
#include "refine_1d_tile.cuh"

namespace repro {

// One run of rows per thread: thread i owns run i % runs of the rows
// [(i / runs) * SB, + SB). F = 0 is the runtime-size instance (NF = 1).
template <typename T, bool NOISE, int F, int C, int NF>
__global__ void __launch_bounds__(kThreads) refine_1d_charted_kernel(
    const T* __restrict__ coarse, const T* __restrict__ xi,
    const T* __restrict__ r, const T* __restrict__ d, T* __restrict__ out,
    int B, int L, int nT, int Crt, int Frt, int runs, int SB) {
  const unsigned run = blockIdx.x * kThreads + threadIdx.x;
  const unsigned chunk = run / runs;
  const size_t b0 = (size_t)chunk * SB;
  if (b0 >= (size_t)B) return;
  const int nb = min(SB, B - (int)b0);
  const int t0 = (int)(run - chunk * runs) * NF;
  if constexpr (F > 0) {
    charted_fwd_run<T, NOISE, F, C, NF>(coarse, xi, r, d, out, b0, nb, L, 0,
                                        nT, t0);
  } else {
    for (int bi = 0; bi < nb; ++bi)
      charted_fwd_family<T, NOISE>(coarse, xi, r, d, out, b0 + bi, L, 0, nT,
                                   Crt, Frt, t0);
  }
}

template <typename T, bool NOISE, int F, int C, int NF>
cudaError_t launch_charted(const void* coarse, const void* xi, const void* r,
                           const void* d, void* out, int B, int L, int nT,
                           int Crt, int Frt, int runs, int SB,
                           cudaStream_t stream) {
  if (runs < 1 || SB < 1) return cudaErrorInvalidValue;
  const long long threads = (long long)((B + SB - 1) / SB) * runs;
  if (threads > kMaxRuns) return cudaErrorInvalidValue;
  if (threads == 0) return cudaSuccess;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  refine_1d_charted_kernel<T, NOISE, F, C, NF>
      <<<blocks, kThreads, 0, stream>>>(
          static_cast<const T*>(coarse), static_cast<const T*>(xi),
          static_cast<const T*>(r), static_cast<const T*>(d),
          static_cast<T*>(out), B, L, nT, Crt, Frt, runs, SB);
  return cudaGetLastError();
}

// One run per thread: run i is run i % runs of row i / runs. F = 0 is the
// runtime-size instance (NF = 1).
template <typename T, bool NOISE, int F, int C, int NF>
__global__ void __launch_bounds__(kThreads) refine_1d_stationary_kernel(
    const T* __restrict__ coarse, const T* __restrict__ xi,
    const T* __restrict__ r, const T* __restrict__ d, T* __restrict__ out,
    int B, int L, int nT, int Crt, int Frt, int runs) {
  const unsigned run = blockIdx.x * kThreads + threadIdx.x;
  const unsigned b = run / runs;
  if (b >= (unsigned)B) return;
  const int t0 = (int)(run - b * runs) * NF;
  if constexpr (F > 0)
    stationary_fwd_run<T, NOISE, F, C, NF>(coarse, xi, r, d, out, b, L, 0,
                                           nT, t0);
  else
    stationary_fwd_family<T, NOISE>(coarse, xi, r, d, out, b, L, 0, nT, Crt,
                                     Frt, t0);
}

template <typename T, bool NOISE, int F, int C, int NF>
cudaError_t launch_stationary(const void* coarse, const void* xi,
                              const void* r, const void* d, void* out, int B,
                              int L, int nT, int Crt, int Frt, int runs,
                              cudaStream_t stream) {
  const long long threads = (long long)B * runs;
  if (runs < 1 || threads > kMaxRuns) return cudaErrorInvalidValue;
  if (threads == 0) return cudaSuccess;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  refine_1d_stationary_kernel<T, NOISE, F, C, NF>
      <<<blocks, kThreads, 0, stream>>>(
          static_cast<const T*>(coarse), static_cast<const T*>(xi),
          static_cast<const T*>(r), static_cast<const T*>(d),
          static_cast<T*>(out), B, L, nT, Crt, Frt, runs);
  return cudaGetLastError();
}

// The compile-time instances, NF families per run by stencil and storage
// type (icr_refine.STREAM_FAMILIES["forward"] picks the same), and the
// runtime-size instance (NF = 1) for any other stencil.
template <typename T, bool NOISE>
cudaError_t launch_stationary_any(const void* coarse, const void* xi,
                                  const void* r, const void* d, void* out,
                                  int B, int L, int nT, int C, int F, int NF,
                                  int runs, cudaStream_t st) {
  constexpr int NF23 = stream_fwd_families<T>(2, 3);
  constexpr int NF45 = stream_fwd_families<T>(4, 5);
  if (F == 2 && C == 3 && NF == NF23)
    return launch_stationary<T, NOISE, 2, 3, NF23>(coarse, xi, r, d, out, B,
                                                   L, nT, C, F, runs, st);
  if (F == 4 && C == 5 && NF == NF45)
    return launch_stationary<T, NOISE, 4, 5, NF45>(coarse, xi, r, d, out, B,
                                                   L, nT, C, F, runs, st);
  if (NF != 1) return cudaErrorInvalidValue;
  return launch_stationary<T, NOISE, 0, 0, 1>(coarse, xi, r, d, out, B, L,
                                              nT, C, F, runs, st);
}

// The compile-time instances of the charted forward, NF families per run
// by stencil (charted_families; icr_refine.CHARTED_FAMILIES picks the
// same), and the runtime-size instance (NF = 1) for any other stencil.
template <typename T, bool NOISE>
cudaError_t launch_charted_any(const void* coarse, const void* xi,
                               const void* r, const void* d, void* out, int B,
                               int L, int nT, int C, int F, int NF, int SB,
                               int runs, cudaStream_t st) {
  constexpr int NF23 = charted_families(2, 3), NF45 = charted_families(4, 5);
  if (F == 2 && C == 3 && NF == NF23)
    return launch_charted<T, NOISE, 2, 3, NF23>(coarse, xi, r, d, out, B, L,
                                                nT, C, F, runs, SB, st);
  if (F == 4 && C == 5 && NF == NF45)
    return launch_charted<T, NOISE, 4, 5, NF45>(coarse, xi, r, d, out, B, L,
                                                nT, C, F, runs, SB, st);
  if (NF != 1) return cudaErrorInvalidValue;
  return launch_charted<T, NOISE, 0, 0, 1>(coarse, xi, r, d, out, B, L, nT, C,
                                           F, runs, SB, st);
}

template <typename T>
cudaError_t launch_charted_dtype(int noise, const void* coarse,
                                 const void* xi, const void* r, const void* d,
                                 void* out, int B, int L, int nT, int C,
                                 int F, int NF, int SB, int runs,
                                 cudaStream_t st) {
  return noise ? launch_charted_any<T, true>(coarse, xi, r, d, out, B, L, nT,
                                             C, F, NF, SB, runs, st)
               : launch_charted_any<T, false>(coarse, xi, r, d, out, B, L,
                                              nT, C, F, NF, SB, runs, st);
}

template <typename T>
cudaError_t launch_stationary_dtype(int noise, const void* coarse,
                                    const void* xi, const void* r,
                                    const void* d, void* out, int B, int L,
                                    int nT, int C, int F, int NF, int runs,
                                    cudaStream_t st) {
  return noise ? launch_stationary_any<T, true>(coarse, xi, r, d, out, B, L,
                                                nT, C, F, NF, runs, st)
               : launch_stationary_any<T, false>(coarse, xi, r, d, out, B, L,
                                                 nT, C, F, NF, runs, st);
}

}  // namespace repro

// dtype: 0 float32, 1 bfloat16. Shapes: coarse (B, L), xi (B, nT, F),
// r (nT, F, C), d (nT, F, F), out (B, nT*F); all contiguous,
// L >= (nT-1)*F/2 + C, on `device`, launched on `stream`. noise = 0 drops
// xi and d (they may be null). A thread owns NF families (an instance of
// the stencil's, or 1 for the runtime-size instance) of SB rows, a row
// `runs` = ceil(nT / NF) threads, the grid ceil(ceil(B / SB) * runs / 256)
// blocks of 256. plan_gx, plan_gy, plan_smem: the launch plan's grid and
// dynamic shared memory, which must be that grid, 1 and 0. Returns the
// launch's cudaError_t, or kPlanMismatch.
extern "C" int refine_1d_charted_fwd(int dtype, int noise, const void* coarse,
                                     const void* xi, const void* r,
                                     const void* d, void* out, int B, int L,
                                     int nT, int C, int F, int NF, int SB,
                                     int runs, int plan_gx, int plan_gy,
                                     int plan_smem, int device,
                                     void* stream) {
  if (SB < 1) return (int)cudaErrorInvalidValue;
  if (!repro::stream_plan_matches((long long)((B + SB - 1) / SB) * runs,
                                  plan_gx, plan_gy, plan_smem))
    return repro::kPlanMismatch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::launch_charted_dtype<float>(noise, coarse, xi, r, d, out, B,
                                              L, nT, C, F, NF, SB, runs, st);
  if (dtype == 1)
    return repro::launch_charted_dtype<__nv_bfloat16>(
        noise, coarse, xi, r, d, out, B, L, nT, C, F, NF, SB, runs, st);
  return (int)cudaErrorInvalidValue;
}

// As refine_1d_charted_fwd with r (F, C) and d (F, F) shared by every
// family. A thread owns NF families of one row (an instance of the
// stencil's, or 1 for the runtime-size instance), a row `runs` =
// ceil(nT / NF) threads, the grid ceil(B * runs / 256) blocks of 256,
// which the plan's must be.
extern "C" int refine_1d_stationary_fwd(int dtype, int noise,
                                        const void* coarse, const void* xi,
                                        const void* r, const void* d,
                                        void* out, int B, int L, int nT,
                                        int C, int F, int NF, int runs,
                                        int plan_gx, int plan_gy,
                                        int plan_smem, int device,
                                        void* stream) {
  if (!repro::stream_plan_matches((long long)B * runs, plan_gx, plan_gy,
                                  plan_smem))
    return repro::kPlanMismatch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::launch_stationary_dtype<float>(
        noise, coarse, xi, r, d, out, B, L, nT, C, F, NF, runs, st);
  if (dtype == 1)
    return repro::launch_stationary_dtype<__nv_bfloat16>(
        noise, coarse, xi, r, d, out, B, L, nT, C, F, NF, runs, st);
  return (int)cudaErrorInvalidValue;
}
