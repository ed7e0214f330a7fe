// The 1-D adjoint refinement kernel of the port: the transpose of
// refine_1d.cu, the backward of every refinement route.
//
// Replaces the Pallas kernels of src/repro/kernels/icr_refine.py:
//   _stationary_adjoint_kernel    (l.184) - one stencil, with dxi;
//   _stationary_adjoint_nn_kernel (l.204) - one stencil, no dxi;
//   _charted_adjoint_kernel       (l.220) - per-family R[t], sqrtD[t];
//   _charted_adjoint_nn_kernel    (l.242) - per-family R[t], no dxi.
// With s = F/2 and q_max = (C-1)/s, from the fine cotangent g (B, nT*F):
//   dcoarse[b, i] = sum_{t, k = i - t*s in [0, C)} sum_f g[b,t,f] R[t][f][k]
//   dxi[b, t, j]  = sum_f g[b,t,f] D[t][f][j]                 (NOISE only)
// and dcoarse is exactly zero past the last window, (nT-1)*s + C <= i < L.
//
// What bounds it: bytes. A family costs F*C + F*F fused multiply-adds
// against F g values read and s coarse plus F xi values written: about
// 2-3 FLOP per byte at f32, a tenth of the H100's f32 ridge. So every
// byte is read and written once, coalesced, and there are no atomics:
//  * gather form. A block owns the coarse outputs [t0*s, (t0+BF)*s) of
//    BB samples (the last block runs on to L). Every output gathers its
//    <= q_max+1 contributions itself, from the g rows of the families
//    whose windows touch it: the block's own BF families and the q_max
//    families to their left, staged in shared memory (with their R[t]
//    when charted). Nothing is front-padded or read through a halo view,
//    and no grid step is spent on the coarse tail;
//  * dxi comes from the same staged g rows, for the block's own families;
//  * charted stencils are staged once per block and serve all its
//    samples; short rows (the trailing axes of an N-D level) stage SB
//    samples at once, so that a pass keeps the block's threads busy;
//  * one thread per output element: every write is coalesced.
// Storage is float or bf16 (intrinsic conversions); every sum is f32 and
// each output is rounded once.
#include "common.cuh"

namespace repro {

template <typename T, bool CHARTED, bool NOISE>
__global__ void __launch_bounds__(kThreads) refine_1d_adj_kernel(
    const T* __restrict__ g, const T* __restrict__ r, const T* __restrict__ d,
    T* __restrict__ dc, T* __restrict__ dxi, int B, int L, int nT, int C,
    int F, int BF, int BB, int SB) {
  extern __shared__ float smem[];
  const int s = F / 2, FC = F * C, FF = F * F;
  const int qmax = (C - 1) / s;
  const int t0 = blockIdx.x * BF;
  const int nf = min(BF, nT - t0);
  const int tlo = max(0, t0 - qmax);    // first family staged (halo)
  const int nst = t0 + nf - tlo;        // families staged
  const int c0 = t0 * s;                // first coarse output owned
  const int nc = (t0 + nf == nT) ? L - c0 : nf * s;  // last block: to L
  const int b0 = blockIdx.y * BB;
  const int nb = min(BB, B - b0);
  float* sr = smem;                                    // stencils R
  float* sd = sr + (CHARTED ? BF + qmax : 1) * FC;     // noise factors
  float* sg = sd + (NOISE ? (CHARTED ? BF : 1) * FF : 0);  // g rows

  const int nr = (CHARTED ? nst : 1) * FC;
  const T* rg = r + (CHARTED ? (size_t)tlo * FC : 0);
  for (int i = threadIdx.x; i < nr; i += blockDim.x) sr[i] = to_float(rg[i]);
  if (NOISE) {
    const int ndd = (CHARTED ? nf : 1) * FF;
    const T* dg = d + (CHARTED ? (size_t)t0 * FF : 0);
    for (int i = threadIdx.x; i < ndd; i += blockDim.x)
      sd[i] = to_float(dg[i]);
  }

  const int ng = nst * F;  // staged g values per sample
  for (int bs = 0; bs < nb; bs += SB) {
    const int ns = min(SB, nb - bs);
    const size_t b = (size_t)(b0 + bs);
    __syncthreads();  // the previous samples' readers are done
    for (int i = threadIdx.x; i < ns * ng; i += blockDim.x) {
      const int si = i / ng, e = i - si * ng;
      sg[i] = to_float(g[((b + si) * nT + tlo) * F + e]);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < ns * nc; i += blockDim.x) {
      const int si = i / nc, c = c0 + (i - si * nc);
      const float* gs = sg + si * ng;
      float acc = 0.f;
      // families t whose window covers c, nearest first: k = c - t*s grows
      for (int t = min(c / s, nT - 1); t >= tlo; --t) {
        const int k = c - t * s;
        if (k >= C) break;
        const float* gr = gs + (t - tlo) * F;
        const float* rr = sr + (CHARTED ? (t - tlo) * FC : 0) + k;
        for (int f = 0; f < F; ++f) acc = fmaf(gr[f], rr[f * C], acc);
      }
      dc[(b + si) * L + c] = from_float<T>(acc);
    }
    if (NOISE) {
      const int nx = nf * F;
      for (int i = threadIdx.x; i < ns * nx; i += blockDim.x) {
        const int si = i / nx, e = i - si * nx;
        const int tl = e / F, j = e - tl * F;
        const float* gr = sg + si * ng + (t0 - tlo + tl) * F;
        const float* dd = sd + (CHARTED ? tl * FF : 0) + j;
        float acc = 0.f;
        for (int f = 0; f < F; ++f) acc = fmaf(gr[f], dd[f * F], acc);
        dxi[((b + si) * nT + t0) * F + e] = from_float<T>(acc);
      }
    }
  }
}

template <typename T, bool CHARTED, bool NOISE>
cudaError_t launch_adj(const void* g, const void* r, const void* d, void* dc,
                       void* dxi, int B, int L, int nT, int C, int F, int BF,
                       int BB, int SB, cudaStream_t stream) {
  const int qmax = (C - 1) / (F / 2);
  const size_t smem =
      sizeof(float) *
      ((size_t)(CHARTED ? BF + qmax : 1) * F * C +
       (NOISE ? (size_t)(CHARTED ? BF : 1) * F * F : 0) +
       (size_t)SB * (BF + qmax) * F);
  auto kernel = refine_1d_adj_kernel<T, CHARTED, NOISE>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((nT + BF - 1) / BF, (B + BB - 1) / BB);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(r),
      static_cast<const T*>(d), static_cast<T*>(dc), static_cast<T*>(dxi), B,
      L, nT, C, F, BF, BB, SB);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_adj_dtype(int charted, int noise, const void* g,
                             const void* r, const void* d, void* dc,
                             void* dxi, int B, int L, int nT, int C, int F,
                             int BF, int BB, int SB, cudaStream_t st) {
  if (charted)
    return noise ? launch_adj<T, true, true>(g, r, d, dc, dxi, B, L, nT, C,
                                             F, BF, BB, SB, st)
                 : launch_adj<T, true, false>(g, r, d, dc, dxi, B, L, nT, C,
                                              F, BF, BB, SB, st);
  return noise ? launch_adj<T, false, true>(g, r, d, dc, dxi, B, L, nT, C, F,
                                            BF, BB, SB, st)
               : launch_adj<T, false, false>(g, r, d, dc, dxi, B, L, nT, C,
                                             F, BF, BB, SB, st);
}

}  // namespace repro

// dtype: 0 float32, 1 bfloat16. Shapes: g (B, nT*F), r (F, C) or
// (nT, F, C), d (F, F) or (nT, F, F) (unused when noise == 0), dc (B, L),
// dxi (B, nT, F) (unused when noise == 0); all contiguous,
// L >= (nT-1)*F/2 + C, on `device`, launched on `stream`. A block owns BF
// families of BB samples and stages SB samples at a time. Returns the
// launch's cudaError_t.
extern "C" int refine_1d_adj(int dtype, int charted, int noise,
                             const void* g, const void* r, const void* d,
                             void* dc, void* dxi, int B, int L, int nT, int C,
                             int F, int BF, int BB, int SB, int device,
                             void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::launch_adj_dtype<float>(charted, noise, g, r, d, dc, dxi, B,
                                          L, nT, C, F, BF, BB, SB, st);
  if (dtype == 1)
    return repro::launch_adj_dtype<__nv_bfloat16>(charted, noise, g, r, d, dc,
                                                  dxi, B, L, nT, C, F, BF, BB,
                                                  SB, st);
  return (int)cudaErrorInvalidValue;
}
