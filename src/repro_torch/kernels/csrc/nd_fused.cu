// The fused N-D forward refinement level of the port (nd = 2 and 3).
//
// Replaces the Pallas kernel src/repro/kernels/nd_fused.py:_nd_fused_kernel
// (l.119): one launch computes a whole N-D level,
//   fine = (R_0 ⊗ R_1 ⊗ R_2) windows(field) + (sqrtD_0 ⊗ 1 ⊗ 1) xi0,
// contracting the trailing axes d-1..1 with their factors R_a (shared, or
// per family on a charted axis), then axis 0 with R_0, and adding the
// axis-0 noise. The trailing noise factors are already contracted into xi0
// outside the kernel (nd_fused.prepare_xi0).
//
// What bounds it: bytes. Per fine output it moves 8 bytes of xi0 and fine
// at f32 (plus the 2^-d smaller coarse field) for about 15 fused
// multiply-adds at 5x4 stencils: ~4 FLOP per byte, a fifth of the f32
// ridge. The TPU tile is b_f axis-0 families times the whole extent of
// every trailing axis; on the flagship's last level that is >227 KB even
// for b_f = 1. So this kernel tiles the families on EVERY axis:
//  * a block owns B_0 x B_1 x B_2 families of one sample; it stages the
//    coarse halo box ((B_a-1)*s + n_csz per axis) in shared memory once;
//  * it contracts axis 2, then axis 1, shared memory to shared memory in
//    f32 (the reference keeps these stages in f32 too);
//  * the axis-0 stage reads its window from shared memory and xi0 from
//    device memory, adds the noise and writes the fine tile once. Threads
//    run along the last axis, so xi0 reads and fine writes are coalesced;
//  * every device byte but the box halo is read once; edges are masked by
//    the per-block family counts.
// This first version runs at ~17 % of the byte bound on an H100 (PERF.md):
// scalar loads, index arithmetic and ~72 KB of shared memory per block
// (three blocks per SM) leave it latency-limited.
// A 2-D level runs as a 3-D one whose middle axis has extent 1 and no
// contraction. Storage is float or bf16; accumulation is f32.
#include "common.cuh"

namespace repro {

struct NdParams {
  int L0, L1, L2;   // padded coarse extents (L1 = 1 for a 2-D level)
  int T0, T1, T2;   // families per axis (T1 = 1 for a 2-D level)
  int C, F;         // n_csz, n_fsz
  int ch0, ch1, ch2;  // per-family (charted) factors on each axis
  int B0, B1, B2;   // families per block on each axis
  int contract1;    // 1 for a 3-D level
};

template <typename T>
__global__ void __launch_bounds__(kThreads) refine_nd_fused_kernel(
    const T* __restrict__ field, const T* __restrict__ xi0,
    const T* __restrict__ r0, const T* __restrict__ d0,
    const T* __restrict__ r1, const T* __restrict__ r2, T* __restrict__ out,
    NdParams p) {
  extern __shared__ float smem[];
  const int C = p.C, F = p.F, s = F / 2, FC = F * C, FF = F * F;
  const int n1 = (p.T1 + p.B1 - 1) / p.B1, n2 = (p.T2 + p.B2 - 1) / p.B2;
  const int j2 = blockIdx.x % n2;
  const int j1 = (blockIdx.x / n2) % n1;
  const int j0 = blockIdx.x / (n1 * n2);
  const size_t sample = blockIdx.y;
  const int f0 = j0 * p.B0, f1 = j1 * p.B1, f2 = j2 * p.B2;
  const int nb0 = min(p.B0, p.T0 - f0), nb1 = min(p.B1, p.T1 - f1),
            nb2 = min(p.B2, p.T2 - f2);
  // coarse box of this block, and the extents after each stage
  const int E0 = (nb0 - 1) * s + C;
  const int E1 = p.contract1 ? (nb1 - 1) * s + C : 1;
  const int E2 = (nb2 - 1) * s + C;
  const int G1 = p.contract1 ? nb1 * F : 1, G2 = nb2 * F;
  // shared layout, sized for the largest tile (the host's formula)
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
    const size_t o0 = (size_t)f0 * s, o1 = p.contract1 ? (size_t)f1 * s : 0,
                 o2 = (size_t)f2 * s;
    const int n = E0 * E1 * E2;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int i2 = i % E2, i1 = (i / E2) % E1, i0 = i / (E2 * E1);
      bufA[i] = to_float(
          field[((sample * p.L0 + o0 + i0) * p.L1 + o1 + i1) * p.L2 + o2 +
                i2]);
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

template <typename T>
cudaError_t launch_nd(const void* field, const void* xi0, const void* r0,
                      const void* d0, const void* r1, const void* r2,
                      void* out, int S, const NdParams& p,
                      cudaStream_t stream) {
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
  const size_t smem = floats * sizeof(float);
  auto kernel = refine_nd_fused_kernel<T>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const unsigned tiles = (unsigned)((p.T0 + p.B0 - 1) / p.B0) *
                         ((p.T1 + p.B1 - 1) / p.B1) *
                         ((p.T2 + p.B2 - 1) / p.B2);
  dim3 grid(tiles, S);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(field), static_cast<const T*>(xi0),
      static_cast<const T*>(r0), static_cast<const T*>(d0),
      static_cast<const T*>(r1), static_cast<const T*>(r2),
      static_cast<T*>(out), p);
  return cudaGetLastError();
}

}  // namespace repro

// dtype: 0 float32, 1 bfloat16. field (S, L0, L1, L2) contiguous and
// padded so that L_a >= (T_a-1)*n_fsz/2 + n_csz; xi0 and out
// (S, T0*F, P) with P = (contract1 ? T1*F : 1) * T2*F; r0/d0 (F, C)/(F, F)
// or per family (T0, F, C)/(T0, F, F); r1 (unused unless contract1) and r2
// (F, C) or (T_a, F, C); all on `device`, launched on `stream`. Returns
// the launch's cudaError_t.
extern "C" int refine_nd_fused_fwd(int dtype, const void* field,
                                   const void* xi0, const void* r0,
                                   const void* d0, const void* r1,
                                   const void* r2, void* out, int S, int L0,
                                   int L1, int L2, int T0, int T1, int T2,
                                   int C, int F, int ch0, int ch1, int ch2,
                                   int B0, int B1, int B2, int contract1,
                                   int device, void* stream) {
  if (C > repro::kMaxCsz || F > repro::kMaxFsz)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  repro::NdParams p{L0, L1, L2, T0, T1, T2, C, F, ch0, ch1, ch2,
                    B0, B1, B2, contract1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::launch_nd<float>(field, xi0, r0, d0, r1, r2, out, S, p, st);
  if (dtype == 1)
    return repro::launch_nd<__nv_bfloat16>(field, xi0, r0, d0, r1, r2, out, S,
                                           p, st);
  return (int)cudaErrorInvalidValue;
}
