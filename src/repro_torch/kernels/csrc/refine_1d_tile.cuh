// The bodies of the 1-D forward refinement, shared by the per-level
// kernels (refine_1d.cu) and the pyramid (pyramid.cu), so that a level
// computes the same in both: the streaming run of the stationary kernel
// (stationary_fwd_run, stationary_fwd_family) and the tile of the charted
// one (refine_1d_tile).
//
// One tile is BF consecutive families of BB samples. With s = F/2,
//   fine[b, t*F + f] = sum_k R[t][f][k] coarse[b, t*s + k]
//                    (+ sum_j D[t][f][j] xi[b, t, j]   if NOISE),
// R and D shared (stationary) or per family (CHARTED). Per sample the tile
// stages the coarse run (BF-1)*s + n_csz (its windows and their halo) and,
// with noise, the xi tile in shared memory with coalesced loads; one thread
// per output element, so the writes are coalesced. The noise-free variant
// (NOISE = false) has no xi or sqrtD operand and stages neither.
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

// Shared memory (floats) of one tile.
__host__ __device__ inline size_t refine_1d_smem_floats(bool charted,
                                                        bool noise, int BF,
                                                        int C, int F) {
  const int s = F / 2;
  return (size_t)(charted ? BF : 1) * (F * C + (noise ? F * F : 0)) +
         (size_t)(BF - 1) * s + C + (noise ? (size_t)BF * F : 0);
}

// Tile (fb, bb): families [fb*BF, fb*BF + BF) of samples [bb*BB, bb*BB +
// BB), the last of each masked. Every thread of the block calls it.
template <typename T, bool CHARTED, bool NOISE, bool COHERENT = false>
__device__ __forceinline__ void refine_1d_tile(
    const T* __restrict__ coarse, const T* __restrict__ xi,
    const T* __restrict__ r, const T* __restrict__ d, T* __restrict__ out,
    int B, int L, int pad, int nT, int C, int F, int BF, int BB, int fb,
    int bb, float* smem) {
  const int s = F / 2, FC = F * C, FF = F * F;
  const int t0 = fb * BF;
  const int nf = min(BF, nT - t0);
  const int b0 = bb * BB;
  const int nb = min(BB, B - b0);
  const int run = (nf - 1) * s + C;
  const int nmat = CHARTED ? BF : 1;
  float* sr = smem;                          // stencils R
  float* sd = sr + nmat * FC;                // noise factors sqrtD
  float* sc = sd + (NOISE ? nmat * FF : 0);  // coarse run of one sample
  float* sx = sc + (BF - 1) * s + C;         // xi tile of one sample

  const int nr = (CHARTED ? nf : 1) * FC;
  const T* rg = r + (CHARTED ? (size_t)t0 * FC : 0);
  for (int i = threadIdx.x; i < nr; i += blockDim.x)
    sr[i] = to_float(load<COHERENT>(rg + i));
  if (NOISE) {
    const int ndd = (CHARTED ? nf : 1) * FF;
    const T* dg = d + (CHARTED ? (size_t)t0 * FF : 0);
    for (int i = threadIdx.x; i < ndd; i += blockDim.x)
      sd[i] = to_float(load<COHERENT>(dg + i));
  }

  const int nout = nf * F;
  for (int bi = 0; bi < nb; ++bi) {
    const size_t b = (size_t)(b0 + bi);
    __syncthreads();  // the previous sample's readers are done
    const T* cg = coarse + b * L;
    for (int i = threadIdx.x; i < run; i += blockDim.x)
      sc[i] = to_float(
          load<COHERENT>(cg + reflect_index(t0 * s + i, pad, L)));
    if (NOISE) {
      const T* xg = xi + (b * nT + t0) * F;
      for (int i = threadIdx.x; i < nout; i += blockDim.x)
        sx[i] = to_float(load<COHERENT>(xg + i));
    }
    __syncthreads();
    T* og = out + (b * nT + t0) * F;
    for (int i = threadIdx.x; i < nout; i += blockDim.x) {
      const int t = i / F, f = i - t * F;
      const float* rr = sr + (CHARTED ? t * FC : 0) + f * C;
      const float* w = sc + t * s;
      float acc = 0.f;
      for (int k = 0; k < C; ++k) acc = fmaf(rr[k], w[k], acc);
      if (NOISE) {
        const float* dd = sd + (CHARTED ? t * FF : 0) + f * F;
        const float* x = sx + t * F;
        float noise = 0.f;
        for (int j = 0; j < F; ++j) noise = fmaf(dd[j], x[j], noise);
        acc += noise;
      }
      og[i] = from_float<T>(acc);
    }
  }
}

// Families [t0, t0 + NF) of row b, stencil (F, C) fixed at compile time:
// their coarse window ((NF-1)*s + C values at padded coordinates t0*s...,
// the C - s halo shared with the next run served by L1) and, with noise,
// their xi, in spans; their NF*F outputs out in a span. The row holds L
// stored entries, reflect-padded by `pad` in the index (0 for a row padded
// beforehand): a window that reaches past either end (the row's first and
// last runs) is read element by element through reflect_index.
template <typename T, bool NOISE, int F, int C, int NF, bool COHERENT = false>
__device__ __forceinline__ void stationary_fwd_run(
    const T* __restrict__ coarse, const T* __restrict__ xi,
    const T* __restrict__ r, const T* __restrict__ d, T* __restrict__ out,
    size_t b, int L, int pad, int nT, int t0) {
  constexpr int s = F / 2, W = (NF - 1) * s + C, V = NF * F;
  float rr[F * C];
  load_span<COHERENT>(r, rr);
  const T* crow = coarse + b * L;
  const int first = t0 * s - pad;  // stored index of the window's start
  const size_t o0 = (b * nT + t0) * F;
  const bool full = t0 + NF <= nT;
  float w[W];
  if (full && first >= 0 && first + W <= L) {
    load_span<COHERENT>(crow + first, w);
  } else {
    const int n = full ? W : (nT - t0 - 1) * s + C;
#pragma unroll
    for (int i = 0; i < W; ++i)
      w[i] = i < n ? to_float(load<COHERENT>(
                         crow + reflect_index(t0 * s + i, pad, L)))
                   : 0.f;
  }
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

}  // namespace repro
