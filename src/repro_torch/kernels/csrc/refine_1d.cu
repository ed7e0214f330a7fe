// The 1-D forward refinement kernel of the port (paper Eq. 11-12, §4.3).
//
// Replaces the Pallas kernels of src/repro/kernels/icr_refine.py:
//   _stationary_kernel (l.98)  - one stencil shared by every family;
//   _charted_kernel    (l.129) - per-family stencils R[t], sqrtD[t].
// Both compute, with s = n_fsz/2,
//   fine[b, t*F + f] = sum_k R[t][f][k] coarse[b, t*s + k]
//                    + sum_j D[t][f][j] xi[b, t, j].
//
// What bounds it: bytes. An output costs n_csz + n_fsz fused multiply-adds
// (18 FLOP at 5x4) against 8 bytes of xi read and fine write plus half a
// coarse element, about 2 FLOP per byte at f32: a tenth of the H100's f32
// ridge (67 TFLOP/s over 3.35 TB/s). So the design reads and writes every
// byte once, coalesced:
//  * a block owns BF consecutive families and BB samples; per sample it
//    stages the coarse run (BF-1)*s + n_csz (the overlapping windows and
//    their halo) and the xi tile in shared memory with coalesced loads;
//  * charted stencils of the block's families are loaded once per block
//    and reused for all of its samples (the TPU kernel's batch block);
//  * one thread per output element, so the writes are fully coalesced;
//  * the last block masks its family count; nothing is zero-padded in
//    device memory and there is no halo view or reshape trick.
// This first version runs at 22-39 % of the byte bound on an H100 (PERF.md):
// scalar loads and the per-sample barriers leave it latency-limited.
// Storage is float or bf16 (intrinsic conversions); accumulation is f32.
#include "common.cuh"

namespace repro {

template <typename T, bool CHARTED>
__global__ void __launch_bounds__(kThreads) refine_1d_fwd_kernel(
    const T* __restrict__ coarse, const T* __restrict__ xi,
    const T* __restrict__ r, const T* __restrict__ d, T* __restrict__ out,
    int B, int L, int nT, int C, int F, int BF, int BB) {
  extern __shared__ float smem[];
  const int s = F / 2, FC = F * C, FF = F * F;
  const int t0 = blockIdx.x * BF;
  const int nf = min(BF, nT - t0);
  const int b0 = blockIdx.y * BB;
  const int nb = min(BB, B - b0);
  const int run = (nf - 1) * s + C;
  const int nmat = CHARTED ? BF : 1;
  float* sr = smem;                     // stencils R
  float* sd = sr + nmat * FC;           // noise factors sqrtD
  float* sc = sd + nmat * FF;           // coarse run of one sample
  float* sx = sc + (BF - 1) * s + C;    // xi tile of one sample

  const int nr = (CHARTED ? nf : 1) * FC;
  const int ndd = (CHARTED ? nf : 1) * FF;
  const T* rg = r + (CHARTED ? (size_t)t0 * FC : 0);
  const T* dg = d + (CHARTED ? (size_t)t0 * FF : 0);
  for (int i = threadIdx.x; i < nr; i += blockDim.x) sr[i] = to_float(rg[i]);
  for (int i = threadIdx.x; i < ndd; i += blockDim.x) sd[i] = to_float(dg[i]);

  const int nout = nf * F;
  for (int bi = 0; bi < nb; ++bi) {
    const size_t b = (size_t)(b0 + bi);
    __syncthreads();  // the previous sample's readers are done
    const T* cg = coarse + b * L + (size_t)t0 * s;
    for (int i = threadIdx.x; i < run; i += blockDim.x) sc[i] = to_float(cg[i]);
    const T* xg = xi + (b * nT + t0) * F;
    for (int i = threadIdx.x; i < nout; i += blockDim.x)
      sx[i] = to_float(xg[i]);
    __syncthreads();
    T* og = out + (b * nT + t0) * F;
    for (int i = threadIdx.x; i < nout; i += blockDim.x) {
      const int t = i / F, f = i - t * F;
      const float* rr = sr + (CHARTED ? t * FC : 0) + f * C;
      const float* dd = sd + (CHARTED ? t * FF : 0) + f * F;
      const float* w = sc + t * s;
      const float* x = sx + t * F;
      float acc = 0.f, noise = 0.f;
      for (int k = 0; k < C; ++k) acc = fmaf(rr[k], w[k], acc);
      for (int j = 0; j < F; ++j) noise = fmaf(dd[j], x[j], noise);
      og[i] = from_float<T>(acc + noise);
    }
  }
}

template <typename T, bool CHARTED>
cudaError_t launch_1d(const void* coarse, const void* xi, const void* r,
                      const void* d, void* out, int B, int L, int nT, int C,
                      int F, int BF, int BB, cudaStream_t stream) {
  const int s = F / 2;
  const size_t smem =
      sizeof(float) * ((size_t)(CHARTED ? BF : 1) * (F * C + F * F) +
                       (size_t)(BF - 1) * s + C + (size_t)BF * F);
  auto kernel = refine_1d_fwd_kernel<T, CHARTED>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((nT + BF - 1) / BF, (B + BB - 1) / BB);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(coarse), static_cast<const T*>(xi),
      static_cast<const T*>(r), static_cast<const T*>(d),
      static_cast<T*>(out), B, L, nT, C, F, BF, BB);
  return cudaGetLastError();
}

}  // namespace repro

// dtype: 0 float32, 1 bfloat16. Shapes: coarse (B, L), xi (B, nT, F),
// r (F, C) or (nT, F, C), d (F, F) or (nT, F, F), out (B, nT*F); all
// contiguous, L >= (nT-1)*F/2 + C, on `device`, launched on `stream`.
// Returns the launch's cudaError_t.
extern "C" int refine_1d_fwd(int dtype, int charted, const void* coarse,
                             const void* xi, const void* r, const void* d,
                             void* out, int B, int L, int nT, int C, int F,
                             int BF, int BB, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return charted ? repro::launch_1d<float, true>(coarse, xi, r, d, out, B,
                                                   L, nT, C, F, BF, BB, st)
                   : repro::launch_1d<float, false>(coarse, xi, r, d, out, B,
                                                    L, nT, C, F, BF, BB, st);
  if (dtype == 1)
    return charted
               ? repro::launch_1d<__nv_bfloat16, true>(coarse, xi, r, d, out,
                                                       B, L, nT, C, F, BF, BB,
                                                       st)
               : repro::launch_1d<__nv_bfloat16, false>(coarse, xi, r, d, out,
                                                        B, L, nT, C, F, BF,
                                                        BB, st);
  return (int)cudaErrorInvalidValue;
}
