// The 1-D forward refinement kernel of the port (paper Eq. 11-12, §4.3).
//
// Replaces the Pallas kernels of src/repro/kernels/icr_refine.py:
//   _stationary_kernel    (l.98)  - one stencil shared by every family;
//   _charted_kernel       (l.129) - per-family stencils R[t], sqrtD[t];
//   _stationary_nn_kernel (l.115) and _charted_nn_kernel (l.145) - the
//     same without xi or sqrtD, for the non-final passes of the nd-axes
//     route (the NOISE = false instances).
// With noise they compute, with s = n_fsz/2,
//   fine[b, t*F + f] = sum_k R[t][f][k] coarse[b, t*s + k]
//                    + sum_j D[t][f][j] xi[b, t, j].
//
// What bounds it: bytes. An output costs n_csz + n_fsz fused multiply-adds
// (18 FLOP at 5x4) against 8 bytes of xi read and fine write plus half a
// coarse element, about 2 FLOP per byte at f32: a tenth of the H100's f32
// ridge (67 TFLOP/s over 3.35 TB/s). Without noise it is 10 FLOP against
// ~6 bytes. So the design reads and writes every byte once, coalesced
// (refine_1d_tile.cuh):
//  * a block owns BF consecutive families and BB samples; per sample it
//    stages the coarse run (BF-1)*s + n_csz (the overlapping windows and
//    their halo) and, with noise, the xi tile in shared memory with
//    coalesced loads;
//  * charted stencils of the block's families are loaded once per block
//    and reused for all of its samples (the TPU kernel's batch block);
//  * one thread per output element, so the writes are fully coalesced;
//  * the last block masks its family count; nothing is zero-padded in
//    device memory and there is no halo view or reshape trick.
// This first version runs at 22-39 % of the byte bound on an H100 (PERF.md):
// scalar loads and the per-sample barriers leave it latency-limited.
// Storage is float or bf16 (intrinsic conversions); accumulation is f32.
#include "refine_1d_tile.cuh"

namespace repro {

template <typename T, bool CHARTED, bool NOISE>
__global__ void __launch_bounds__(kThreads) refine_1d_fwd_kernel(
    const T* __restrict__ coarse, const T* __restrict__ xi,
    const T* __restrict__ r, const T* __restrict__ d, T* __restrict__ out,
    int B, int L, int nT, int C, int F, int BF, int BB) {
  extern __shared__ float smem[];
  refine_1d_tile<T, CHARTED, NOISE>(coarse, xi, r, d, out, B, L, 0, nT, C,
                                    F, BF, BB, blockIdx.x, blockIdx.y, smem);
}

template <typename T, bool CHARTED, bool NOISE>
cudaError_t launch_1d(const void* coarse, const void* xi, const void* r,
                      const void* d, void* out, int B, int L, int nT, int C,
                      int F, int BF, int BB, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * refine_1d_smem_floats(CHARTED, NOISE, BF, C, F);
  auto kernel = refine_1d_fwd_kernel<T, CHARTED, NOISE>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((nT + BF - 1) / BF, (B + BB - 1) / BB);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(coarse), static_cast<const T*>(xi),
      static_cast<const T*>(r), static_cast<const T*>(d),
      static_cast<T*>(out), B, L, nT, C, F, BF, BB);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_1d_any(int charted, int noise, const void* coarse,
                          const void* xi, const void* r, const void* d,
                          void* out, int B, int L, int nT, int C, int F,
                          int BF, int BB, cudaStream_t st) {
  if (charted)
    return noise ? launch_1d<T, true, true>(coarse, xi, r, d, out, B, L, nT,
                                            C, F, BF, BB, st)
                 : launch_1d<T, true, false>(coarse, xi, r, d, out, B, L, nT,
                                             C, F, BF, BB, st);
  return noise ? launch_1d<T, false, true>(coarse, xi, r, d, out, B, L, nT,
                                           C, F, BF, BB, st)
               : launch_1d<T, false, false>(coarse, xi, r, d, out, B, L, nT,
                                            C, F, BF, BB, st);
}

}  // namespace repro

// dtype: 0 float32, 1 bfloat16. Shapes: coarse (B, L), xi (B, nT, F),
// r (F, C) or (nT, F, C), d (F, F) or (nT, F, F), out (B, nT*F); all
// contiguous, L >= (nT-1)*F/2 + C, on `device`, launched on `stream`.
// noise = 0 drops xi and d (they may be null). Returns the launch's
// cudaError_t.
extern "C" int refine_1d_fwd(int dtype, int charted, int noise,
                             const void* coarse, const void* xi,
                             const void* r, const void* d, void* out, int B,
                             int L, int nT, int C, int F, int BF, int BB,
                             int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::launch_1d_any<float>(charted, noise, coarse, xi, r, d, out,
                                       B, L, nT, C, F, BF, BB, st);
  if (dtype == 1)
    return repro::launch_1d_any<__nv_bfloat16>(charted, noise, coarse, xi, r,
                                               d, out, B, L, nT, C, F, BF, BB,
                                               st);
  return (int)cudaErrorInvalidValue;
}
