// The bodies of the 1-D forward refinement, shared by the per-level
// kernels (refine_1d.cu) and the pyramid (pyramid.cu), so that a level
// computes the same in both: the streaming runs of the stationary kernel
// (stationary_fwd_run, stationary_fwd_family) and of the charted one
// (charted_fwd_run, charted_fwd_family).
//
// With s = F/2,
//   fine[b, t*F + f] = sum_k R[t][f][k] coarse[b, t*s + k]
//                    (+ sum_j D[t][f][j] xi[b, t, j]   if NOISE),
// R and D shared (stationary) or per family (charted). A thread owns a run
// of NF consecutive families: it reads their coarse window ((NF-1)*s + C
// values) and, with noise, their xi in spans (common.cuh: the widest
// accesses the addresses allow), and writes their NF*F outputs the same
// way; no shared memory, no barrier. The stationary run holds the one
// stencil in registers; the charted run holds its families' R[t] (and
// D[t]) in registers for all the rows it owns. The noise-free variant
// (NOISE = false) has no xi or sqrtD operand. Every output is summed in
// f32 in one order, sum_k over R*w in k order, then the noise sum_j in j
// order, then acc + noise, and rounded once.
//
// Coarse rows hold L stored entries and are read at padded coordinates
// through reflect_index: pad = 0 reads them as they are (the per-level
// route pads beforehand), pad = b reflect-pads in the index (the pyramid).
// COHERENT reads every operand through the L2 only (load<true>): the
// pyramid's coarse rows were written by other blocks of the same launch,
// and its other operands take the same path, so that no load of a
// pyramid instance goes through the read-only or L1 path.
#pragma once

#include "common.cuh"

namespace repro {

// Families per run of the streaming stationary forward, by stencil and
// storage type (icr_refine.STREAM_FAMILIES["forward"] holds the same): the
// compile-time instances of the charts' stencils (2, 3) and (4, 5), and 1
// for the runtime-size instance.
template <typename T>
__host__ __device__ constexpr int stream_fwd_families(int F, int C) {
  return F == 2 && C == 3 ? (sizeof(T) == 4 ? 4 : 8)
                          : (F == 4 && C == 5 ? 2 : 1);
}

// The first n values of a coarse window of W at padded coordinates p0...
// of a row of L stored entries reflect-padded by `pad` (0 for a row
// padded beforehand), the rest 0: in a span where the whole window lies
// inside the row, else element by element through reflect_index (a row's
// first and last runs).
template <bool COHERENT, typename T, int W>
__device__ __forceinline__ void load_window(const T* crow, int p0, int n,
                                            int pad, int L, float (&w)[W]) {
  const int first = p0 - pad;  // stored index of the window's start
  if (n == W && first >= 0 && first + W <= L) {
    load_span<COHERENT>(crow + first, w);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i)
      w[i] = i < n ? to_float(load<COHERENT>(
                         crow + reflect_index(p0 + i, pad, L)))
                   : 0.f;
  }
}

// Families [t0, t0 + NF) of row b, stencil (F, C) fixed at compile time:
// their coarse window ((NF-1)*s + C values at padded coordinates t0*s...,
// the C - s halo shared with the next run served by L1) and, with noise,
// their xi, in spans; their NF*F outputs out in a span. The row holds L
// stored entries, reflect-padded by `pad` in the index (load_window).
template <typename T, bool NOISE, int F, int C, int NF, bool COHERENT = false>
__device__ __forceinline__ void stationary_fwd_run(
    const T* __restrict__ coarse, const T* __restrict__ xi,
    const T* __restrict__ r, const T* __restrict__ d, T* __restrict__ out,
    size_t b, int L, int pad, int nT, int t0) {
  constexpr int s = F / 2, W = (NF - 1) * s + C, V = NF * F;
  float rr[F * C];
  load_span<COHERENT>(r, rr);
  const size_t o0 = (b * nT + t0) * F;
  const bool full = t0 + NF <= nT;
  float w[W];
  load_window<COHERENT>(coarse + b * L, t0 * s,
                        full ? W : (nT - t0 - 1) * s + C, pad, L, w);
  float o[V];
#pragma unroll
  for (int u = 0; u < NF; ++u)
#pragma unroll
    for (int f = 0; f < F; ++f) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < C; ++k) acc = fmaf(rr[f * C + k], w[u * s + k], acc);
      o[u * F + f] = acc;
    }
  if constexpr (NOISE) {
    float dd[F * F], x[V];
    load_span<COHERENT>(d, dd);
    if (full)
      load_span<COHERENT>(xi + o0, x);
    else
      load_range<COHERENT>(xi + o0, 0, (nT - t0) * F, x);
#pragma unroll
    for (int u = 0; u < NF; ++u)
#pragma unroll
      for (int f = 0; f < F; ++f) {
        float noise = 0.f;
#pragma unroll
        for (int j = 0; j < F; ++j)
          noise = fmaf(dd[f * F + j], x[u * F + j], noise);
        o[u * F + f] += noise;
      }
  }
  if (full)
    store_span(out + o0, o);
  else
    store_prefix(out + o0, (nT - t0) * F, o);
}

// Family t of row b, stencil (F, C) given at run time; reflect padding as
// in stationary_fwd_run.
template <typename T, bool NOISE, bool COHERENT = false>
__device__ __forceinline__ void stationary_fwd_family(
    const T* __restrict__ coarse, const T* __restrict__ xi,
    const T* __restrict__ r, const T* __restrict__ d, T* __restrict__ out,
    size_t b, int L, int pad, int nT, int C, int F, int t) {
  const int s = F / 2;
  const T* crow = coarse + b * L;
  const size_t o0 = (b * nT + t) * F;
  for (int f = 0; f < F; ++f) {
    float acc = 0.f;
    for (int k = 0; k < C; ++k)
      acc = fmaf(to_float(load<COHERENT>(r + f * C + k)),
                 to_float(load<COHERENT>(
                     crow + reflect_index(t * s + k, pad, L))),
                 acc);
    if (NOISE) {
      float noise = 0.f;
      for (int j = 0; j < F; ++j)
        noise = fmaf(to_float(load<COHERENT>(d + f * F + j)),
                     to_float(load<COHERENT>(xi + o0 + j)), noise);
      acc += noise;
    }
    out[o0 + f] = from_float<T>(acc);
  }
}

// Families [t0, t0 + NF) of rows [b0, b0 + nb), per-family stencils,
// (F, C) fixed at compile time: R[t] (and D[t]) of the run's families are
// read once and held in registers for all nb rows; per row the coarse
// window and xi come in spans and the NF*F outputs go out in a span.
// Reflect padding as in load_window.
template <typename T, bool NOISE, int F, int C, int NF, bool COHERENT = false>
__device__ __forceinline__ void charted_fwd_run(
    const T* __restrict__ coarse, const T* __restrict__ xi,
    const T* __restrict__ r, const T* __restrict__ d, T* __restrict__ out,
    size_t b0, int nb, int L, int pad, int nT, int t0) {
  constexpr int s = F / 2, FC = F * C, FF = F * F;
  constexpr int W = (NF - 1) * s + C, V = NF * F;
  const bool full = t0 + NF <= nT;
  float rr[NF * FC];
  if (full)
    load_span<COHERENT>(r + (size_t)t0 * FC, rr);
  else
    load_range<COHERENT>(r, t0 * FC, nT * FC, rr);
  float dd[NOISE ? NF * FF : 1];
  if constexpr (NOISE) {
    if (full)
      load_span<COHERENT>(d + (size_t)t0 * FF, dd);
    else
      load_range<COHERENT>(d, t0 * FF, nT * FF, dd);
  }
  const int n = full ? W : (nT - t0 - 1) * s + C;  // window values used
  for (int bi = 0; bi < nb; ++bi) {
    const size_t b = b0 + bi;
    const size_t o0 = (b * nT + t0) * F;
    float w[W];
    load_window<COHERENT>(coarse + b * L, t0 * s, n, pad, L, w);
    float o[V];
#pragma unroll
    for (int u = 0; u < NF; ++u)
#pragma unroll
      for (int f = 0; f < F; ++f) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < C; ++k)
          acc = fmaf(rr[u * FC + f * C + k], w[u * s + k], acc);
        o[u * F + f] = acc;
      }
    if constexpr (NOISE) {
      float x[V];
      if (full)
        load_span<COHERENT>(xi + o0, x);
      else
        load_range<COHERENT>(xi + o0, 0, (nT - t0) * F, x);
#pragma unroll
      for (int u = 0; u < NF; ++u)
#pragma unroll
        for (int f = 0; f < F; ++f) {
          float noise = 0.f;
#pragma unroll
          for (int j = 0; j < F; ++j)
            noise = fmaf(dd[u * FF + f * F + j], x[u * F + j], noise);
          o[u * F + f] += noise;
        }
    }
    if (full)
      store_span(out + o0, o);
    else
      store_prefix(out + o0, (nT - t0) * F, o);
  }
}

// Family t of row b, per-family stencils, (F, C) given at run time;
// reflect padding as in stationary_fwd_run.
template <typename T, bool NOISE, bool COHERENT = false>
__device__ __forceinline__ void charted_fwd_family(
    const T* __restrict__ coarse, const T* __restrict__ xi,
    const T* __restrict__ r, const T* __restrict__ d, T* __restrict__ out,
    size_t b, int L, int pad, int nT, int C, int F, int t) {
  stationary_fwd_family<T, NOISE, COHERENT>(
      coarse, xi, r + (size_t)t * F * C, NOISE ? d + (size_t)t * F * F : d,
      out, b, L, pad, nT, C, F, t);
}

}  // namespace repro
