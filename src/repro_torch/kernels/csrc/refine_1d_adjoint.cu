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
// Charted (refine_1d_charted_adj): the same streaming body with a stencil
// per family. Its shapes are of two kinds: long rows and few samples (a
// charted 1-D chart: 8 rows of 65K families), where R[t] and D[t] are as
// many bytes as g, and very many short rows (the axis-0 pass of an N-D
// backward: 131K rows of 16 families). So a thread owns a run of NF
// families of SB rows: it reads its families' stencils once (of the left
// families' only the columns that reach its outputs stay live), holds
// them in registers for all SB rows, and per row streams g in and dcoarse
// and dxi out through spans, as above; on short rows the few families'
// stencils stay in L1 and a block packs several rows. The launch geometry
// (NF, SB, runs) is icr_refine.charted_shape_1d, the charted forward's.
//
// Storage is float or bf16 (intrinsic conversions); every sum is f32, in
// the same order in both bodies (nearest family first, then f), and each
// output is rounded once.
#include "common.cuh"

namespace repro {

// Families [t0, t0 + NF) of rows [b0, b0 + nb) and their coarse outputs
// [t0*s, (t0+NF)*s); the row's last run also writes dcoarse on to L.
// Stencil (F, C) fixed at compile time; the families' stencils R[t] (and
// D[t]) are read once and held in registers for all nb rows.
template <typename T, bool NOISE, int F, int C, int NF>
__device__ __forceinline__ void charted_adj_run(
    const T* __restrict__ g, const T* __restrict__ r, const T* __restrict__ d,
    T* __restrict__ dc, T* __restrict__ dxi, size_t b0, int nb, int L,
    int nT, int t0) {
  constexpr int s = F / 2, Q = (C - 1) / s;  // Q = q_max
  constexpr int FC = F * C, FF = F * F, NC = NF * s, V = NF * F;
  const int c0 = t0 * s;
  const bool full = t0 + NF <= nT, last = t0 + NF >= nT;
  // stencils of families t0 - Q + u (u < Q: the left families; u >= Q:
  // the run's own), 0 where no family is; only the columns that reach the
  // run's outputs stay live
  float rh[Q * FC], ro[NF * FC];
  if (t0 >= Q)
    load_span(r + (size_t)(t0 - Q) * FC, rh);
  else
    load_range(r, (t0 - Q) * FC, nT * FC, rh);
  if (full)
    load_span(r + (size_t)t0 * FC, ro);
  else
    load_range(r, t0 * FC, nT * FC, ro);
  auto rv = [&](int u, int f, int k) {
    return u < Q ? rh[u * FC + f * C + k] : ro[(u - Q) * FC + f * C + k];
  };
  float dd[NOISE ? NF * FF : 1];
  if constexpr (NOISE) {
    if (full)
      load_span(d + (size_t)t0 * FF, dd);
    else
      load_range(d, t0 * FF, nT * FF, dd);
  }
  for (int bi = 0; bi < nb; ++bi) {
    const size_t b = b0 + bi;
    const T* grow = g + b * nT * F;
    float gh[Q * F], go[V];
    if (t0 >= Q)
      load_span(grow + (size_t)(t0 - Q) * F, gh);
    else
      load_range(grow, (t0 - Q) * F, nT * F, gh);
    if (full)
      load_span(grow + (size_t)t0 * F, go);
    else
      load_range(grow, t0 * F, nT * F, go);
    auto gv = [&](int u, int f) {
      return u < Q ? gh[u * F + f] : go[(u - Q) * F + f];
    };
    float oc[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      // families whose window covers c0 + i, nearest first: k grows by s
      float acc = 0.f;
#pragma unroll
      for (int k = i % s; k < C; k += s) {
        const int u = Q + (i - k) / s;
#pragma unroll
        for (int f = 0; f < F; ++f) acc = fmaf(gv(u, f), rv(u, f, k), acc);
      }
      oc[i] = acc;
    }
    T* dcw = dc + b * L + c0;
    if (!last) {
      store_span(dcw, oc);
    } else {
      store_prefix(dcw, L - c0, oc);
      // dcoarse's tail past the run: the last families' far columns, then 0
      for (int c = c0 + NC; c < L; ++c) {
        float acc = 0.f;
        for (int t = min(c / s, nT - 1); t >= 0; --t) {
          const int k = c - t * s;
          if (k >= C) break;
          for (int f = 0; f < F; ++f)
            acc = fmaf(to_float(grow[t * F + f]),
                       to_float(r[((size_t)t * F + f) * C + k]), acc);
        }
        dcw[c - c0] = from_float<T>(acc);
      }
    }
    if constexpr (NOISE) {
      float ox[V];
#pragma unroll
      for (int u = 0; u < NF; ++u)
#pragma unroll
        for (int j = 0; j < F; ++j) {
          float acc = 0.f;
#pragma unroll
          for (int f = 0; f < F; ++f)
            acc = fmaf(go[u * F + f], dd[u * FF + f * F + j], acc);
          ox[u * F + j] = acc;
        }
      T* xw = dxi + (b * nT + t0) * F;
      if (full)
        store_span(xw, ox);
      else
        store_prefix(xw, (nT - t0) * F, ox);
    }
  }
}

// Family t of row b and its coarse outputs [t*s, (t+1)*s) (the last
// family's on to L), per-family stencils, (F, C) given at run time.
template <typename T, bool NOISE>
__device__ __forceinline__ void charted_adj_family(
    const T* __restrict__ g, const T* __restrict__ r, const T* __restrict__ d,
    T* __restrict__ dc, T* __restrict__ dxi, size_t b, int L, int nT, int C,
    int F, int t) {
  const int s = F / 2, FC = F * C, FF = F * F;
  const T* grow = g + b * nT * F;
  const int cend = t == nT - 1 ? L : min((t + 1) * s, L);
  for (int c = t * s; c < cend; ++c) {
    float acc = 0.f;
    for (int tt = min(c / s, nT - 1); tt >= 0; --tt) {
      const int k = c - tt * s;
      if (k >= C) break;
      for (int f = 0; f < F; ++f)
        acc = fmaf(to_float(grow[tt * F + f]),
                   to_float(r[(size_t)tt * FC + f * C + k]), acc);
    }
    dc[b * L + c] = from_float<T>(acc);
  }
  if (NOISE)
    for (int j = 0; j < F; ++j) {
      float acc = 0.f;
      for (int f = 0; f < F; ++f)
        acc = fmaf(to_float(grow[t * F + f]),
                   to_float(d[(size_t)t * FF + f * F + j]), acc);
      dxi[(b * nT + t) * F + j] = from_float<T>(acc);
    }
}

// One run of rows per thread: thread i owns run i % runs of the rows
// [(i / runs) * SB, + SB). F = 0 is the runtime-size instance (NF = 1).
template <typename T, bool NOISE, int F, int C, int NF>
__global__ void __launch_bounds__(kThreads) refine_1d_charted_adj_kernel(
    const T* __restrict__ g, const T* __restrict__ r, const T* __restrict__ d,
    T* __restrict__ dc, T* __restrict__ dxi, int B, int L, int nT, int Crt,
    int Frt, int runs, int SB) {
  const unsigned run = blockIdx.x * kThreads + threadIdx.x;
  const unsigned chunk = run / runs;
  const size_t b0 = (size_t)chunk * SB;
  if (b0 >= (size_t)B) return;
  const int nb = min(SB, B - (int)b0);
  const int t0 = (int)(run - chunk * runs) * NF;
  if constexpr (F > 0) {
    charted_adj_run<T, NOISE, F, C, NF>(g, r, d, dc, dxi, b0, nb, L, nT, t0);
  } else {
    for (int bi = 0; bi < nb; ++bi)
      charted_adj_family<T, NOISE>(g, r, d, dc, dxi, b0 + bi, L, nT, Crt,
                                   Frt, t0);
  }
}

template <typename T, bool NOISE, int F, int C, int NF>
cudaError_t launch_charted(const void* g, const void* r, const void* d,
                           void* dc, void* dxi, int B, int L, int nT, int Crt,
                           int Frt, int runs, int SB, cudaStream_t stream) {
  if (runs < 1 || SB < 1) return cudaErrorInvalidValue;
  const long long threads = (long long)((B + SB - 1) / SB) * runs;
  if (threads > kMaxRuns) return cudaErrorInvalidValue;
  if (threads == 0) return cudaSuccess;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  refine_1d_charted_adj_kernel<T, NOISE, F, C, NF>
      <<<blocks, kThreads, 0, stream>>>(
          static_cast<const T*>(g), static_cast<const T*>(r),
          static_cast<const T*>(d), static_cast<T*>(dc),
          static_cast<T*>(dxi), B, L, nT, Crt, Frt, runs, SB);
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

// The compile-time instances of the charted adjoint, NF families per run
// by stencil (charted_families; icr_refine.CHARTED_FAMILIES picks the
// same), and the runtime-size instance (NF = 1) for any other stencil.
template <typename T, bool NOISE>
cudaError_t launch_charted_any(const void* g, const void* r, const void* d,
                               void* dc, void* dxi, int B, int L, int nT,
                               int C, int F, int NF, int SB, int runs,
                               cudaStream_t st) {
  constexpr int NF23 = charted_families(2, 3), NF45 = charted_families(4, 5);
  if (F == 2 && C == 3 && NF == NF23)
    return launch_charted<T, NOISE, 2, 3, NF23>(g, r, d, dc, dxi, B, L, nT,
                                                C, F, runs, SB, st);
  if (F == 4 && C == 5 && NF == NF45)
    return launch_charted<T, NOISE, 4, 5, NF45>(g, r, d, dc, dxi, B, L, nT,
                                                C, F, runs, SB, st);
  if (NF != 1) return cudaErrorInvalidValue;
  return launch_charted<T, NOISE, 0, 0, 1>(g, r, d, dc, dxi, B, L, nT, C, F,
                                           runs, SB, st);
}

template <typename T>
cudaError_t launch_charted_dtype(int noise, const void* g, const void* r,
                                 const void* d, void* dc, void* dxi, int B,
                                 int L, int nT, int C, int F, int NF, int SB,
                                 int runs, cudaStream_t st) {
  return noise ? launch_charted_any<T, true>(g, r, d, dc, dxi, B, L, nT, C,
                                             F, NF, SB, runs, st)
               : launch_charted_any<T, false>(g, r, d, dc, dxi, B, L, nT, C,
                                              F, NF, SB, runs, st);
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
// `device`, launched on `stream`. A thread owns NF families (an instance
// of the stencil's, or 1 for the runtime-size instance) of SB rows, a row
// `runs` = ceil(nT / NF) threads, the last of which writes dcoarse on to
// L, the grid ceil(ceil(B / SB) * runs / 256) blocks of 256, which the
// plan's grid (plan_gx, plan_gy, no shared memory) must be. Returns the
// launch's cudaError_t, or kPlanMismatch.
extern "C" int refine_1d_charted_adj(int dtype, int noise, const void* g,
                                     const void* r, const void* d, void* dc,
                                     void* dxi, int B, int L, int nT, int C,
                                     int F, int NF, int SB, int runs,
                                     int plan_gx, int plan_gy, int plan_smem,
                                     int device, void* stream) {
  if (SB < 1) return (int)cudaErrorInvalidValue;
  if (!repro::stream_plan_matches((long long)((B + SB - 1) / SB) * runs,
                                  plan_gx, plan_gy, plan_smem))
    return repro::kPlanMismatch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::launch_charted_dtype<float>(noise, g, r, d, dc, dxi, B, L,
                                              nT, C, F, NF, SB, runs, st);
  if (dtype == 1)
    return repro::launch_charted_dtype<__nv_bfloat16>(
        noise, g, r, d, dc, dxi, B, L, nT, C, F, NF, SB, runs, st);
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
                                        int runs, int plan_gx, int plan_gy,
                                        int plan_smem, int device,
                                        void* stream) {
  if (!repro::stream_plan_matches((long long)B * runs, plan_gx, plan_gy,
                                  plan_smem))
    return repro::kPlanMismatch;
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
