// The 1-D adjoint refinement kernels of the port: the transpose of
// refine_1d.cu, the backward of every refinement route.
//
// Replace the Pallas kernels of src/repro/kernels/icr_refine.py:
//   _stationary_adjoint_kernel    (l.184) - one stencil, with dxi;
//   _stationary_adjoint_nn_kernel (l.204) - one stencil, no dxi;
//   _charted_adjoint_kernel       (l.220) - per-family R[t], sqrtD[t];
//   _charted_adjoint_nn_kernel    (l.242) - per-family R[t], no dxi.
// With s = F/2 and q_max = (C-1)/s, from the fine cotangent g (B, nT*F):
//   dcoarse[b, i] = sum_{t, k = i - t*s in [0, C)} sum_f g[b,t,f] R[t][f][k]
//   dxi[b, t, j]  = sum_f g[b,t,f] D[t][f][j]                 (NOISE only)
// and dcoarse is exactly zero past the last window, (nT-1)*s + C <= i < L.
//
// What bounds them: bytes. A family costs F*C + F*F fused multiply-adds
// against F g values read and s coarse plus F xi values written: about
// 2-3 FLOP per byte at f32, a tenth of the H100's f32 ridge. So every
// byte is read and written once, in gather form (each output sums its
// <= q_max + 1 contributions itself: no atomics, no front padding, no halo
// view), and what decides the time is the bytes each SM keeps in flight.
//
// Stationary (refine_1d_stationary_adj): a streaming kernel with no shared
// memory and no barrier. Each thread owns a run of NF families of one row:
// the coarse outputs [t0*s, (t0+NF)*s) and, with noise, the dxi of the
// same families. It reads the g values of its families and of the q_max
// families to their left (re-read by the neighbouring run, served by L1)
// with the widest accesses the addresses allow (common.cuh spans: 16 bytes
// where aligned, any row start), and writes its outputs the same way. The
// stencils live in registers, loaded once per thread. The last run of a
// row also writes dcoarse's tail, from its families' windows on to L, so
// that no thread of a row runs a different path but the first (whose left
// families are zero) and the last. Runs are numbered row by
// row over the whole grid, so short rows (the trailing axes of an N-D
// level) pack several to a block with every lane busy. The charts'
// stencils (2, 3) and (4, 5) are compile-time instances (q_max = 2: a
// coarse output gathers from at most three families, known at compile
// time); any other stencil runs a runtime-size instance, one family per
// run with one element per access. On an H100 the instances take no longer
// than a device copy of as many bytes (chip_smoke.py's copy_ms, PERF.md).
//
// Charted (refine_1d_charted_adj): a block owns the coarse outputs
// [t0*s, (t0+BF)*s) of BB samples (the last block runs on to L). It stages
// the g rows and R[t] of its BF families and of the q_max families to
// their left in shared memory, the stencils once per block for all its
// samples; short rows stage SB samples at once. One thread per output.
//
// Storage is float or bf16 (intrinsic conversions); every sum is f32, in
// the same order in both bodies (nearest family first, then f), and each
// output is rounded once.
#include "common.cuh"

namespace repro {

template <typename T, bool NOISE>
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
  float* sr = smem;                                // stencils R
  float* sd = sr + (BF + qmax) * FC;               // noise factors
  float* sg = sd + (NOISE ? BF * FF : 0);          // g rows

  const int nr = nst * FC;
  const T* rg = r + (size_t)tlo * FC;
  for (int i = threadIdx.x; i < nr; i += blockDim.x) sr[i] = to_float(rg[i]);
  if (NOISE) {
    const int ndd = nf * FF;
    const T* dg = d + (size_t)t0 * FF;
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
        const float* rr = sr + (t - tlo) * FC + k;
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
        const float* dd = sd + tl * FF + j;
        float acc = 0.f;
        for (int f = 0; f < F; ++f) acc = fmaf(gr[f], dd[f * F], acc);
        dxi[((b + si) * nT + t0) * F + e] = from_float<T>(acc);
      }
    }
  }
}

template <typename T, bool NOISE>
cudaError_t launch_charted(const void* g, const void* r, const void* d,
                           void* dc, void* dxi, int B, int L, int nT, int C,
                           int F, int BF, int BB, int SB,
                           cudaStream_t stream) {
  const int qmax = (C - 1) / (F / 2);
  const size_t smem =
      sizeof(float) * ((size_t)(BF + qmax) * F * C +
                       (NOISE ? (size_t)BF * F * F : 0) +
                       (size_t)SB * (BF + qmax) * F);
  auto kernel = refine_1d_adj_kernel<T, NOISE>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((nT + BF - 1) / BF, (B + BB - 1) / BB);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(r),
      static_cast<const T*>(d), static_cast<T*>(dc), static_cast<T*>(dxi), B,
      L, nT, C, F, BF, BB, SB);
  return cudaGetLastError();
}

// Families [t0, t0 + NF) of row b and their coarse outputs [t0*s,
// (t0+NF)*s); the row's last run also writes dcoarse on to L. Stencil
// (F, C) fixed at compile time.
template <typename T, bool NOISE, int F, int C, int NF>
__device__ __forceinline__ void stationary_adj_run(
    const T* __restrict__ g, const T* __restrict__ r, const T* __restrict__ d,
    T* __restrict__ dc, T* __restrict__ dxi, size_t b, int L, int nT,
    int t0) {
  constexpr int s = F / 2, Q = (C - 1) / s;   // Q = q_max
  constexpr int NC = NF * s, V = NF * F;
  constexpr int NE = NC + Q * s;  // outputs a last run can reach: the tail
  float rr[F * C];
  load_span(r, rr);
  const T* grow = g + b * nT * F;
  const int c0 = t0 * s;
  const bool full = t0 + NF <= nT, last = t0 + NF >= nT;
  // g of families t0 - Q + u (u < Q: the left families; u >= Q: the
  // run's own), 0 where no family is
  float gh[Q * F], go[V];
  if (t0 >= Q)
    load_span(grow + (size_t)(t0 - Q) * F, gh);
  else
    load_range(grow, (t0 - Q) * F, nT * F, gh);
  if (full)
    load_span(grow + (size_t)t0 * F, go);
  else
    load_range(grow, t0 * F, nT * F, go);
  auto gv = [&](int u, int f) { return u < Q ? gh[u * F + f]
                                             : go[(u - Q) * F + f]; };
  float oc[NE];
#pragma unroll
  for (int i = 0; i < NE; ++i) {
    // families whose window covers c0 + i, nearest first: k grows by s.
    // Outputs past NC are stored by the row's last run only, and the
    // families past its own (u >= NF + Q) that would reach them do not
    // exist.
    float acc = 0.f;
#pragma unroll
    for (int k = i % s; k < C; k += s) {
      const int u = Q + (i - k) / s;
      if (u < NF + Q)
#pragma unroll
        for (int f = 0; f < F; ++f) acc = fmaf(gv(u, f), rr[f * C + k], acc);
    }
    oc[i] = acc;
  }
  T* dcw = dc + b * L + c0;
  if (!last) {
    float head[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) head[i] = oc[i];
    store_span(dcw, head);
  } else {
    store_prefix(dcw, L - c0, oc);
    for (int i = NE; i < L - c0; ++i) dcw[i] = from_float<T>(0.f);
  }
  if constexpr (NOISE) {
    float dd[F * F], ox[V];
    load_span(d, dd);
#pragma unroll
    for (int u = 0; u < NF; ++u)
#pragma unroll
      for (int j = 0; j < F; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int f = 0; f < F; ++f)
          acc = fmaf(go[u * F + f], dd[f * F + j], acc);
        ox[u * F + j] = acc;
      }
    T* xw = dxi + (b * nT + t0) * F;
    if (full)
      store_span(xw, ox);
    else
      store_prefix(xw, (nT - t0) * F, ox);
  }
}

// Family t of row b and its coarse outputs [t*s, (t+1)*s) (the last
// family's on to L), stencil (F, C) given at run time.
template <typename T, bool NOISE>
__device__ __forceinline__ void stationary_adj_family(
    const T* __restrict__ g, const T* __restrict__ r, const T* __restrict__ d,
    T* __restrict__ dc, T* __restrict__ dxi, size_t b, int L, int nT, int C,
    int F, int t) {
  const int s = F / 2;
  const T* grow = g + b * nT * F;
  const int cend = t == nT - 1 ? L : min((t + 1) * s, L);
  for (int c = t * s; c < cend; ++c) {
    float acc = 0.f;
    for (int tt = min(c / s, nT - 1); tt >= 0; --tt) {
      const int k = c - tt * s;
      if (k >= C) break;
      for (int f = 0; f < F; ++f)
        acc = fmaf(to_float(grow[tt * F + f]), to_float(r[f * C + k]), acc);
    }
    dc[b * L + c] = from_float<T>(acc);
  }
  if (NOISE)
    for (int j = 0; j < F; ++j) {
      float acc = 0.f;
      for (int f = 0; f < F; ++f)
        acc = fmaf(to_float(grow[t * F + f]), to_float(d[f * F + j]), acc);
      dxi[(b * nT + t) * F + j] = from_float<T>(acc);
    }
}

// One run per thread: run i is run i % runs of row i / runs. F = 0 is the
// runtime-size instance (NF = 1).
template <typename T, bool NOISE, int F, int C, int NF>
__global__ void __launch_bounds__(kThreads) refine_1d_stationary_adj_kernel(
    const T* __restrict__ g, const T* __restrict__ r, const T* __restrict__ d,
    T* __restrict__ dc, T* __restrict__ dxi, int B, int L, int nT, int Crt,
    int Frt, int runs) {
  const unsigned run = blockIdx.x * kThreads + threadIdx.x;
  const unsigned b = run / runs;
  if (b >= (unsigned)B) return;
  const int t0 = (int)(run - b * runs) * NF;
  if constexpr (F > 0)
    stationary_adj_run<T, NOISE, F, C, NF>(g, r, d, dc, dxi, b, L, nT, t0);
  else
    stationary_adj_family<T, NOISE>(g, r, d, dc, dxi, b, L, nT, Crt, Frt,
                                    t0);
}

template <typename T, bool NOISE, int F, int C, int NF>
cudaError_t launch_stationary(const void* g, const void* r, const void* d,
                              void* dc, void* dxi, int B, int L, int nT,
                              int Crt, int Frt, int runs,
                              cudaStream_t stream) {
  const long long threads = (long long)B * runs;
  if (runs < 1 || threads > kMaxRuns) return cudaErrorInvalidValue;
  if (threads == 0) return cudaSuccess;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  refine_1d_stationary_adj_kernel<T, NOISE, F, C, NF>
      <<<blocks, kThreads, 0, stream>>>(
          static_cast<const T*>(g), static_cast<const T*>(r),
          static_cast<const T*>(d), static_cast<T*>(dc),
          static_cast<T*>(dxi), B, L, nT, Crt, Frt, runs);
  return cudaGetLastError();
}

// The compile-time instances, NF families per run by stencil and storage
// type (icr_refine.STREAM_FAMILIES["adjoint"] picks the same), and the
// runtime-size instance (NF = 1) for any other stencil.
template <typename T, bool NOISE>
cudaError_t launch_stationary_any(const void* g, const void* r, const void* d,
                                  void* dc, void* dxi, int B, int L, int nT,
                                  int C, int F, int NF, int runs,
                                  cudaStream_t st) {
  constexpr int NF23 = sizeof(T) == 4 ? 2 : 4, NF45 = 2;
  if (F == 2 && C == 3 && NF == NF23)
    return launch_stationary<T, NOISE, 2, 3, NF23>(g, r, d, dc, dxi, B, L,
                                                   nT, C, F, runs, st);
  if (F == 4 && C == 5 && NF == NF45)
    return launch_stationary<T, NOISE, 4, 5, NF45>(g, r, d, dc, dxi, B, L,
                                                   nT, C, F, runs, st);
  if (NF != 1) return cudaErrorInvalidValue;
  return launch_stationary<T, NOISE, 0, 0, 1>(g, r, d, dc, dxi, B, L, nT, C,
                                              F, runs, st);
}

template <typename T>
cudaError_t launch_charted_any(int noise, const void* g, const void* r,
                               const void* d, void* dc, void* dxi, int B,
                               int L, int nT, int C, int F, int BF, int BB,
                               int SB, cudaStream_t st) {
  return noise ? launch_charted<T, true>(g, r, d, dc, dxi, B, L, nT, C, F,
                                         BF, BB, SB, st)
               : launch_charted<T, false>(g, r, d, dc, dxi, B, L, nT, C, F,
                                          BF, BB, SB, st);
}

template <typename T>
cudaError_t launch_stationary_dtype(int noise, const void* g, const void* r,
                                    const void* d, void* dc, void* dxi,
                                    int B, int L, int nT, int C, int F,
                                    int NF, int runs, cudaStream_t st) {
  return noise ? launch_stationary_any<T, true>(g, r, d, dc, dxi, B, L, nT,
                                                C, F, NF, runs, st)
               : launch_stationary_any<T, false>(g, r, d, dc, dxi, B, L, nT,
                                                 C, F, NF, runs, st);
}

}  // namespace repro

// dtype: 0 float32, 1 bfloat16. Shapes: g (B, nT*F), r (nT, F, C),
// d (nT, F, F) (unused when noise == 0), dc (B, L), dxi (B, nT, F)
// (unused when noise == 0); all contiguous, L >= (nT-1)*F/2 + C, on
// `device`, launched on `stream`. A block owns BF families of BB samples
// and stages SB samples at a time. Returns the launch's cudaError_t.
extern "C" int refine_1d_charted_adj(int dtype, int noise, const void* g,
                                     const void* r, const void* d, void* dc,
                                     void* dxi, int B, int L, int nT, int C,
                                     int F, int BF, int BB, int SB,
                                     int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::launch_charted_any<float>(noise, g, r, d, dc, dxi, B, L,
                                            nT, C, F, BF, BB, SB, st);
  if (dtype == 1)
    return repro::launch_charted_any<__nv_bfloat16>(
        noise, g, r, d, dc, dxi, B, L, nT, C, F, BF, BB, SB, st);
  return (int)cudaErrorInvalidValue;
}

// As refine_1d_charted_adj with r (F, C) and d (F, F) shared by every
// family. A thread owns NF families of one row (an instance of the
// stencil's, or 1 for the runtime-size instance), a row `runs` =
// ceil(nT / NF) threads, the last of which writes dcoarse on to L, the
// grid ceil(B * runs / 256) blocks of 256.
extern "C" int refine_1d_stationary_adj(int dtype, int noise, const void* g,
                                        const void* r, const void* d,
                                        void* dc, void* dxi, int B, int L,
                                        int nT, int C, int F, int NF,
                                        int runs, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::launch_stationary_dtype<float>(noise, g, r, d, dc, dxi, B,
                                                 L, nT, C, F, NF, runs, st);
  if (dtype == 1)
    return repro::launch_stationary_dtype<__nv_bfloat16>(
        noise, g, r, d, dc, dxi, B, L, nT, C, F, NF, runs, st);
  return (int)cudaErrorInvalidValue;
}
