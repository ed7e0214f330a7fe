// The tile body of the fused N-D forward refinement level, shared by the
// per-level kernel (nd_fused.cu) and the pyramid (pyramid.cu), so that a
// level computes the same in both. See nd_fused.cu for what it computes
// and why the families are tiled on every axis.
//
// The field holds L_a stored entries per axis and is read at padded
// coordinates through reflect_index: pad_a = 0 reads it as it is (the
// per-level route pads beforehand), pad_a = b reflect-pads in the index
// (the pyramid), which also reads it through the L2 only (COHERENT,
// load<true>): other blocks of the same launch wrote it. A 2-D level runs
// as a 3-D one whose middle axis has extent 1, no padding and no
// contraction.
#pragma once

#include "common.cuh"

namespace repro {

struct NdParams {
  int L0, L1, L2;        // stored coarse extents (L1 = 1 for a 2-D level)
  int pad0, pad1, pad2;  // reflect padding read through the index
  int T0, T1, T2;        // families per axis (T1 = 1 for a 2-D level)
  int C, F;              // n_csz, n_fsz
  int ch0, ch1, ch2;     // per-family (charted) factors on each axis
  int B0, B1, B2;        // families per block on each axis
  int contract1;         // 1 for a 3-D level
};

// Tiles of one sample.
__host__ __device__ inline int nd_tiles_per_sample(const NdParams& p) {
  return ((p.T0 + p.B0 - 1) / p.B0) * ((p.T1 + p.B1 - 1) / p.B1) *
         ((p.T2 + p.B2 - 1) / p.B2);
}

// Shared memory (floats) of one tile, sized for the largest tile.
__host__ __device__ inline size_t nd_smem_floats(const NdParams& p) {
  const int s = p.F / 2, FC = p.F * p.C, FF = p.F * p.F;
  const size_t E0m = (size_t)(p.B0 - 1) * s + p.C;
  const size_t E1m = p.contract1 ? (size_t)(p.B1 - 1) * s + p.C : 1;
  const size_t E2m = (size_t)(p.B2 - 1) * s + p.C;
  const size_t G1m = p.contract1 ? (size_t)p.B1 * p.F : 1;
  const size_t G2m = (size_t)p.B2 * p.F;
  size_t floats = E0m * E1m * E2m > E0m * G1m * G2m ? E0m * E1m * E2m
                                                    : E0m * G1m * G2m;
  floats += E0m * E1m * G2m;
  floats += (size_t)(p.ch0 ? p.B0 : 1) * (FC + FF);
  floats += p.contract1 ? (size_t)(p.ch1 ? p.B1 : 1) * FC : 0;
  floats += (size_t)(p.ch2 ? p.B2 : 1) * FC;
  return floats;
}

// Tile `tile` (of nd_tiles_per_sample) of sample `sample`: its families'
// fine outputs, written once. Every thread of the block calls it.
template <typename T, bool COHERENT = false>
__device__ __forceinline__ void nd_fused_tile(
    const T* __restrict__ field, const T* __restrict__ xi0,
    const T* __restrict__ r0, const T* __restrict__ d0,
    const T* __restrict__ r1, const T* __restrict__ r2, T* __restrict__ out,
    const NdParams& p, int tile, size_t sample, float* smem) {
  const int C = p.C, F = p.F, s = F / 2, FC = F * C, FF = F * F;
  const int n1 = (p.T1 + p.B1 - 1) / p.B1, n2 = (p.T2 + p.B2 - 1) / p.B2;
  const int j2 = tile % n2;
  const int j1 = (tile / n2) % n1;
  const int j0 = tile / (n1 * n2);
  const int f0 = j0 * p.B0, f1 = j1 * p.B1, f2 = j2 * p.B2;
  const int nb0 = min(p.B0, p.T0 - f0), nb1 = min(p.B1, p.T1 - f1),
            nb2 = min(p.B2, p.T2 - f2);
  // coarse box of this block, and the extents after each stage
  const int E0 = (nb0 - 1) * s + C;
  const int E1 = p.contract1 ? (nb1 - 1) * s + C : 1;
  const int E2 = (nb2 - 1) * s + C;
  const int G1 = p.contract1 ? nb1 * F : 1, G2 = nb2 * F;
  // shared layout, sized for the largest tile (nd_smem_floats)
  const int E0m = (p.B0 - 1) * s + C;
  const int E1m = p.contract1 ? (p.B1 - 1) * s + C : 1;
  const int E2m = (p.B2 - 1) * s + C;
  const int G1m = p.contract1 ? p.B1 * F : 1, G2m = p.B2 * F;
  float* bufA = smem;
  float* bufB = bufA + max(E0m * E1m * E2m, E0m * G1m * G2m);
  float* sr0 = bufB + E0m * E1m * G2m;
  float* sd0 = sr0 + (p.ch0 ? p.B0 : 1) * FC;
  float* sr1 = sd0 + (p.ch0 ? p.B0 : 1) * FF;
  float* sr2 = sr1 + (p.contract1 ? (p.ch1 ? p.B1 : 1) * FC : 0);

  // -- load the matrices and the coarse box ---------------------------------
  {
    const int n = (p.ch0 ? nb0 : 1) * FC, m = (p.ch0 ? nb0 : 1) * FF;
    const T* rg = r0 + (p.ch0 ? (size_t)f0 * FC : 0);
    const T* dg = d0 + (p.ch0 ? (size_t)f0 * FF : 0);
    for (int i = threadIdx.x; i < n; i += blockDim.x) sr0[i] = to_float(rg[i]);
    for (int i = threadIdx.x; i < m; i += blockDim.x) sd0[i] = to_float(dg[i]);
    if (p.contract1) {
      const int n1r = (p.ch1 ? nb1 : 1) * FC;
      const T* g = r1 + (p.ch1 ? (size_t)f1 * FC : 0);
      for (int i = threadIdx.x; i < n1r; i += blockDim.x)
        sr1[i] = to_float(g[i]);
    }
    const int n2r = (p.ch2 ? nb2 : 1) * FC;
    const T* g2 = r2 + (p.ch2 ? (size_t)f2 * FC : 0);
    for (int i = threadIdx.x; i < n2r; i += blockDim.x)
      sr2[i] = to_float(g2[i]);
  }
  {
    const int o0 = f0 * s, o1 = p.contract1 ? f1 * s : 0, o2 = f2 * s;
    const int n = E0 * E1 * E2;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int i2 = i % E2, i1 = (i / E2) % E1, i0 = i / (E2 * E1);
      const size_t g0 = reflect_index(o0 + i0, p.pad0, p.L0);
      const size_t g1 = reflect_index(o1 + i1, p.pad1, p.L1);
      const size_t g2 = reflect_index(o2 + i2, p.pad2, p.L2);
      bufA[i] = to_float(load<COHERENT>(
          field + ((sample * p.L0 + g0) * p.L1 + g1) * p.L2 + g2));
    }
  }
  __syncthreads();

  // -- axis 2: bufA (E0, E1, E2) -> bufB (E0, E1, G2) ---------------------
  {
    const int n = E0 * E1 * nb2;
    for (int w = threadIdx.x; w < n; w += blockDim.x) {
      const int t = w % nb2, row = w / nb2;
      const float* win = bufA + row * E2 + t * s;
      const float* rr = sr2 + (p.ch2 ? t * FC : 0);
      float* o = bufB + row * G2 + t * F;
      for (int f = 0; f < F; ++f) {
        float acc = 0.f;
        for (int k = 0; k < C; ++k) acc = fmaf(rr[f * C + k], win[k], acc);
        o[f] = acc;
      }
    }
  }
  __syncthreads();

  // -- axis 1 (3-D only): bufB (E0, E1, G2) -> bufA (E0, G1, G2) ----------
  const float* src = bufB;
  if (p.contract1) {
    const int n = E0 * nb1 * G2;
    for (int w = threadIdx.x; w < n; w += blockDim.x) {
      const int i2 = w % G2, t = (w / G2) % nb1, i0 = w / (G2 * nb1);
      const float* win = bufB + (i0 * E1 + t * s) * G2 + i2;
      const float* rr = sr1 + (p.ch1 ? t * FC : 0);
      float* o = bufA + (i0 * G1 + t * F) * G2 + i2;
      for (int f = 0; f < F; ++f) {
        float acc = 0.f;
        for (int k = 0; k < C; ++k)
          acc = fmaf(rr[f * C + k], win[k * G2], acc);
        o[f * G2] = acc;
      }
    }
    __syncthreads();
    src = bufA;
  }

  // -- axis 0 + noise: src (E0, G1, G2) -> fine (nb0*F, G1, G2) -----------
  {
    const size_t F2tot = (size_t)p.T2 * F;
    const size_t P = (p.contract1 ? (size_t)p.T1 * F : 1) * F2tot;
    const int n = nb0 * G1 * G2;
    for (int w = threadIdx.x; w < n; w += blockDim.x) {
      const int i2 = w % G2, i1 = (w / G2) % G1, t = w / (G2 * G1);
      float win[kMaxCsz], x[kMaxFsz];
#pragma unroll
      for (int k = 0; k < kMaxCsz; ++k)
        if (k < C) win[k] = src[((t * s + k) * G1 + i1) * G2 + i2];
      const size_t g1 = p.contract1 ? (size_t)f1 * F + i1 : 0;
      const size_t pp = g1 * F2tot + (size_t)f2 * F + i2;
      const size_t base = (sample * p.T0 * F + (size_t)(f0 + t) * F) * P + pp;
#pragma unroll
      for (int j = 0; j < kMaxFsz; ++j)
        if (j < F) x[j] = to_float(xi0[base + j * P]);
      const float* rr = sr0 + (p.ch0 ? t * FC : 0);
      const float* dd = sd0 + (p.ch0 ? t * FF : 0);
#pragma unroll
      for (int f = 0; f < kMaxFsz; ++f) {
        if (f < F) {
          float acc = 0.f, noise = 0.f;
#pragma unroll
          for (int k = 0; k < kMaxCsz; ++k)
            if (k < C) acc = fmaf(rr[f * C + k], win[k], acc);
#pragma unroll
          for (int j = 0; j < kMaxFsz; ++j)
            if (j < F) noise = fmaf(dd[f * F + j], x[j], noise);
          out[base + f * P] = from_float<T>(acc + noise);
        }
      }
    }
  }
}

}  // namespace repro
