// The tile body of the fused N-D forward refinement level, shared by the
// per-level kernel (nd_fused.cu) and the pyramid (pyramid.cu), so that a
// level computes the same in both. See nd_fused.cu for what it computes
// and why the families are tiled on every axis.
//
// The field holds L_a stored entries per axis and is read at padded
// coordinates through reflect_index: pad_a = 0 reads it as it is (the
// per-level route pads beforehand), pad_a = b reflect-pads in the index
// (the pyramid); a tile whose box lies inside the stored field on every
// axis skips reflect_index. COHERENT reads every operand through the L2
// only (load<true>): the pyramid's field was written by other blocks of
// the same launch. A 2-D level runs as a 3-D one whose middle axis has
// extent 1, no padding and no contraction.
//
// A tile is B_0 x B_1 x B_2 families of one sample, in four stages:
//  1. the block stages the matrices and the coarse box, kBox loads in
//     flight per thread before their shared stores, the box coordinates
//     advanced without division (stage 4's xi0 loads are not issued here:
//     held across this stage, their 4*F registers do not fit the 64 that
//     four blocks per SM allow, and the kernel was slower on the H100);
//  2. axis 2: box (E0, E1, E2) -> (E0, E1, G2), each thread one family's
//     F outputs of a row from its window read once;
//  3. axis 1 (3-D only): -> (E0, G1, G2), each thread one family's F
//     outputs of a 4-wide column, 16-byte shared loads and stores (lanes
//     on consecutive 16-byte words: no bank conflicts);
//  4. axis 0 and the noise, which move nearly all the bytes (xi0 in, the
//     fine field out): a work item is four consecutive trailing-axis fine
//     positions of one axis-0 family, its window read from shared memory
//     in 16-byte words, its F xi0 rows and F fine rows moved as spans
//     (16 bytes at f32 where aligned; common.cuh).
// The box and the axis-1 output share one buffer, so a tile of 2 x 8 x 8
// families at n_fsz = 4 takes 46 KB and four blocks of 256 threads fit on
// an SM. Sums are f32 in the order of the stages (axis 2, axis 1, axis 0,
// then the noise), each output rounded once.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kBox = 4;  // box loads a thread keeps in flight

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

// Extents of the largest tile's buffers (see nd_smem_floats).
struct NdPitch {
  int E0, E1, E2;  // coarse box
  int G1, G2;      // fine extents after axes 1 and 2; G2 a multiple of 4
  __host__ __device__ NdPitch(const NdParams& p) {
    const int s = p.F / 2;
    E0 = (p.B0 - 1) * s + p.C;
    E1 = p.contract1 ? (p.B1 - 1) * s + p.C : 1;
    E2 = (p.B2 - 1) * s + p.C;
    G1 = p.contract1 ? p.B1 * p.F : 1;
    G2 = (p.B2 * p.F + 3) / 4 * 4;
  }
  // the axis-2 output (E0, E1, G2), first: 16-byte aligned
  __host__ __device__ size_t buf_b() const { return (size_t)E0 * E1 * G2; }
  // the box, then the axis-1 output (E0, G1, G2)
  __host__ __device__ size_t buf_a(const NdParams& p) const {
    const size_t box = (size_t)E0 * E1 * E2;
    const size_t a1 = p.contract1 ? (size_t)E0 * G1 * G2 : 0;
    return box > a1 ? box : a1;
  }
};

// Shared memory (floats) of one tile, sized for the largest tile.
__host__ __device__ inline size_t nd_smem_floats(const NdParams& p) {
  const NdPitch m(p);
  const size_t FC = (size_t)p.F * p.C, FF = (size_t)p.F * p.F;
  return m.buf_b() + m.buf_a(p) + (size_t)(p.ch0 ? p.B0 : 1) * (FC + FF) +
         (p.contract1 ? (size_t)(p.ch1 ? p.B1 : 1) * FC : 0) +
         (size_t)(p.ch2 ? p.B2 : 1) * FC;
}

// Tile `tile` (of nd_tiles_per_sample) of sample `sample`: its families'
// fine outputs, written once. Every thread of the block calls it; `smem`
// is 16-byte aligned. FT, CT: the stencil (n_fsz, n_csz) at compile time,
// or 0 for the runtime-size instance (p.F, p.C).
template <typename T, bool COHERENT, int FT, int CT>
__device__ __forceinline__ void nd_fused_tile(
    const T* __restrict__ field, const T* __restrict__ xi0,
    const T* __restrict__ r0, const T* __restrict__ d0,
    const T* __restrict__ r1, const T* __restrict__ r2, T* __restrict__ out,
    const NdParams& p, int tile, size_t sample, float* smem) {
  constexpr int FM = FT > 0 ? FT : kMaxFsz, CM = CT > 0 ? CT : kMaxCsz;
  const int F = FT > 0 ? FT : p.F, C = CT > 0 ? CT : p.C;
  const int s = F / 2, FC = F * C, FF = F * F;
  const int n1 = (p.T1 + p.B1 - 1) / p.B1, n2 = (p.T2 + p.B2 - 1) / p.B2;
  const int j2 = tile % n2;
  const int j1 = (tile / n2) % n1;
  const int j0 = tile / (n1 * n2);
  const int f0 = j0 * p.B0, f1 = j1 * p.B1, f2 = j2 * p.B2;
  const int nb0 = min(p.B0, p.T0 - f0), nb1 = min(p.B1, p.T1 - f1),
            nb2 = min(p.B2, p.T2 - f2);
  // this tile's coarse box, and the fine extents after axes 2 and 1
  const int E0 = (nb0 - 1) * s + C;
  const int E1 = p.contract1 ? (nb1 - 1) * s + C : 1;
  const int E2 = (nb2 - 1) * s + C;
  const int G1 = p.contract1 ? nb1 * F : 1, G2 = nb2 * F;
  const int nq = (G2 + 3) / 4;  // 4-wide columns of a row
  const NdPitch m(p);
  float* bufB = smem;
  float* bufA = bufB + m.buf_b();
  float* sr0 = bufA + m.buf_a(p);
  float* sd0 = sr0 + (p.ch0 ? nb0 : 1) * FC;
  float* sr1 = sd0 + (p.ch0 ? nb0 : 1) * FF;
  float* sr2 = sr1 + (p.contract1 ? (p.ch1 ? nb1 : 1) * FC : 0);

  // fine element (t, f, g1, g2) of the tile: obase + (t*F + f)*P +
  // g1*F2tot + g2
  const size_t F2tot = (size_t)p.T2 * F;
  const size_t P = (p.contract1 ? (size_t)p.T1 * F : 1) * F2tot;
  const size_t obase = (sample * p.T0 + f0) * F * P +
                       (p.contract1 ? (size_t)f1 * F * F2tot : 0) +
                       (size_t)f2 * F;
  const int nitems = nb0 * G1 * nq;
  // xi0 of work item w: F rows of 4 (nv valid) trailing positions
  auto load_xi = [&](int w, float (&x)[FM][4]) {
    const int q = w % nq, g1 = (w / nq) % G1, t = w / (nq * G1);
    const int nv = min(4, G2 - 4 * q);
    const T* px = xi0 + obase + (size_t)t * F * P + (size_t)g1 * F2tot + 4 * q;
#pragma unroll
    for (int j = 0; j < FM; ++j)
      if (j < F) {
        if (nv == 4)
          load_span<COHERENT>(px + j * P, x[j]);
        else
          load_range<COHERENT>(px + j * P, 0, nv, x[j]);
      }
  };

  // -- 1. the matrices and the coarse box: this stage's loads are issued
  // before its shared stores ---------------------------------------------
  // the matrices, one flat range over their four segments (sr0, sd0, sr1,
  // sr2 are consecutive in shared memory); a block of 256 threads takes
  // them in one round at the charts' stencils
  const int m0 = (p.ch0 ? nb0 : 1) * FC, m1 = m0 + (p.ch0 ? nb0 : 1) * FF;
  const int m2 = m1 + (p.contract1 ? (p.ch1 ? nb1 : 1) * FC : 0);
  const int m3 = m2 + (p.ch2 ? nb2 : 1) * FC;
  auto mat = [&](int j, float*& dst) {
    const T* g;
    if (j < m0) {
      g = r0 + (p.ch0 ? (size_t)f0 * FC : 0) + j;
      dst = sr0 + j;
    } else if (j < m1) {
      g = d0 + (p.ch0 ? (size_t)f0 * FF : 0) + (j - m0);
      dst = sd0 + (j - m0);
    } else if (j < m2) {
      g = r1 + (p.ch1 ? (size_t)f1 * FC : 0) + (j - m1);
      dst = sr1 + (j - m1);
    } else {
      g = r2 + (p.ch2 ? (size_t)f2 * FC : 0) + (j - m2);
      dst = sr2 + (j - m2);
    }
    return to_float(load<COHERENT>(g));
  };
  float mv = 0.f;
  float* mdst = nullptr;
  if ((int)threadIdx.x < m3) mv = mat(threadIdx.x, mdst);
  {
    // box element i = (i0*E1 + i1)*E2 + e is padded coordinate
    // (o0 + i0, o1 + i1, o2 + e); a thread takes i = tid + k*blockDim.x,
    // kBox at a time with their loads in flight together, and advances its
    // coordinates without division
    const int o0 = f0 * s, o1 = p.contract1 ? f1 * s : 0, o2 = f2 * s;
    const bool inside = o0 >= p.pad0 && o0 - p.pad0 + E0 <= p.L0 &&
                        o1 >= p.pad1 && o1 - p.pad1 + E1 <= p.L1 &&
                        o2 >= p.pad2 && o2 - p.pad2 + E2 <= p.L2;
    const int n = E0 * E1 * E2;
    const int step_r = blockDim.x / E2, step_e = blockDim.x - step_r * E2;
    int e = threadIdx.x % E2, i1 = threadIdx.x / E2, i0 = i1 / E1;
    i1 -= i0 * E1;
    const T* fs = field + sample * p.L0 * p.L1 * p.L2;
    for (int i = threadIdx.x; i < n; i += kBox * blockDim.x) {
      float v[kBox];
      int at[kBox];
#pragma unroll
      for (int k = 0; k < kBox; ++k) {
        at[k] = -1;
        if (i + k * (int)blockDim.x < n) {
          const int g0 = inside ? o0 + i0 - p.pad0
                                : reflect_index(o0 + i0, p.pad0, p.L0);
          const int g1 = inside ? o1 + i1 - p.pad1
                                : reflect_index(o1 + i1, p.pad1, p.L1);
          const int g2 = inside ? o2 + e - p.pad2
                                : reflect_index(o2 + e, p.pad2, p.L2);
          v[k] = to_float(
              load<COHERENT>(fs + ((size_t)g0 * p.L1 + g1) * p.L2 + g2));
          at[k] = (i0 * E1 + i1) * m.E2 + e;
        }
        e += step_e;
        i1 += step_r;
        if (e >= E2) {
          e -= E2;
          ++i1;
        }
        if (i1 >= E1) {
          const int c = E1 == 1 ? i1 : i1 / E1;
          i0 += c;
          i1 -= c * E1;
        }
      }
      if (mdst != nullptr) {
        *mdst = mv;
        mdst = nullptr;
      }
#pragma unroll
      for (int k = 0; k < kBox; ++k)
        if (at[k] >= 0) bufA[at[k]] = v[k];
    }
  }
  if (mdst != nullptr) *mdst = mv;
  for (int j = threadIdx.x + blockDim.x; j < m3; j += blockDim.x) {
    float* dst;
    const float v = mat(j, dst);
    *dst = v;
  }
  __syncthreads();

  // -- 2. axis 2: box (E0, E1, E2) -> bufB (E0, E1, G2), one family's F
  // outputs of a row per thread, its window read once ----------------------
  {
    const int n = E0 * E1 * nb2;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int t = i % nb2, row = i / nb2;
      const float* wv = bufA + row * m.E2 + t * s;
      const float* rr = sr2 + (p.ch2 ? t * FC : 0);
      float w[CM], o[FM];
#pragma unroll
      for (int k = 0; k < CM; ++k)
        if (k < C) w[k] = wv[k];
#pragma unroll
      for (int f = 0; f < FM; ++f)
        if (f < F) {
          float acc = 0.f;
#pragma unroll
          for (int k = 0; k < CM; ++k)
            if (k < C) acc = fmaf(rr[f * C + k], w[k], acc);
          o[f] = acc;
        }
      float* ob = bufB + (size_t)row * m.G2 + t * F;
      if constexpr (FT == 4) {
        *reinterpret_cast<float4*>(ob) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int f = 0; f < FM; ++f)
          if (f < F) ob[f] = o[f];
      }
    }
  }
  __syncthreads();

  // -- 3. axis 1 (3-D only): bufB (E0, E1, G2) -> bufA (E0, G1, G2), one
  // family's F outputs of a 4-wide column per thread, its window read once
  const float* src = bufB;
  if (p.contract1) {
    const int n = E0 * nb1 * nq;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int q = i % nq, t = (i / nq) % nb1, i0 = i / (nq * nb1);
      const float* rr = sr1 + (p.ch1 ? t * FC : 0);
      const float* win = bufB + (size_t)(i0 * E1 + t * s) * m.G2 + 4 * q;
      float4 w[CM];
#pragma unroll
      for (int k = 0; k < CM; ++k)
        if (k < C) w[k] = *reinterpret_cast<const float4*>(win + k * m.G2);
      float* ob = bufA + (size_t)(i0 * G1 + t * F) * m.G2 + 4 * q;
#pragma unroll
      for (int f = 0; f < FM; ++f)
        if (f < F) {
          float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int k = 0; k < CM; ++k)
            if (k < C) {
              const float a = rr[f * C + k];
              acc.x = fmaf(a, w[k].x, acc.x);
              acc.y = fmaf(a, w[k].y, acc.y);
              acc.z = fmaf(a, w[k].z, acc.z);
              acc.w = fmaf(a, w[k].w, acc.w);
            }
          *reinterpret_cast<float4*>(ob + f * m.G2) = acc;
        }
    }
    __syncthreads();
    src = bufA;
  }

  // -- 4. axis 0 + noise: src (E0, G1, G2) -> fine (nb0*F, G1, G2) ---------
  for (int w = threadIdx.x; w < nitems; w += blockDim.x) {
    float x[FM][4];
    load_xi(w, x);
    const int q = w % nq, g1 = (w / nq) % G1, t = w / (nq * G1);
    const int nv = min(4, G2 - 4 * q);
    float win[CM][4];
#pragma unroll
    for (int k = 0; k < CM; ++k)
      if (k < C) {
        const float4 v = *reinterpret_cast<const float4*>(
            src + (size_t)((t * s + k) * G1 + g1) * m.G2 + 4 * q);
        win[k][0] = v.x;
        win[k][1] = v.y;
        win[k][2] = v.z;
        win[k][3] = v.w;
      }
    const float* rr = sr0 + (p.ch0 ? t * FC : 0);
    const float* dd = sd0 + (p.ch0 ? t * FF : 0);
    T* po = out + obase + (size_t)t * F * P + (size_t)g1 * F2tot + 4 * q;
#pragma unroll
    for (int f = 0; f < FM; ++f) {
      if (f < F) {
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float acc = 0.f, noise = 0.f;
#pragma unroll
          for (int k = 0; k < CM; ++k)
            if (k < C) acc = fmaf(rr[f * C + k], win[k][e], acc);
#pragma unroll
          for (int j = 0; j < FM; ++j)
            if (j < F) noise = fmaf(dd[f * F + j], x[j][e], noise);
          o[e] = acc + noise;
        }
        if (nv == 4)
          store_span(po + f * P, o);
        else
          store_prefix(po + f * P, nv, o);
      }
    }
  }
}

}  // namespace repro
