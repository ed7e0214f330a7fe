// The tile body of the 1-D forward refinement, shared by the per-level
// kernel (refine_1d.cu) and the pyramid (pyramid.cu), so that a level
// computes the same in both.
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
// COHERENT reads them through the L2 only (load<true>): the pyramid's
// coarse rows were written by other blocks of the same launch.
#pragma once

#include "common.cuh"

namespace repro {

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
  for (int i = threadIdx.x; i < nr; i += blockDim.x) sr[i] = to_float(rg[i]);
  if (NOISE) {
    const int ndd = (CHARTED ? nf : 1) * FF;
    const T* dg = d + (CHARTED ? (size_t)t0 * FF : 0);
    for (int i = threadIdx.x; i < ndd; i += blockDim.x)
      sd[i] = to_float(dg[i]);
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
        sx[i] = to_float(xg[i]);
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

}  // namespace repro
