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
// for b_f = 1. So this kernel tiles the families on EVERY axis: a block
// owns B_0 x B_1 x B_2 families of one sample, stages their coarse halo
// box ((B_a-1)*s + n_csz per axis) in shared memory once, contracts the
// trailing axes there in f32 (the reference keeps these stages in f32
// too), and streams xi0 in and the fine tile out in the axis-0 stage. The
// tile body (nd_tile.cuh, shared with the pyramid) keeps xi0 loads in
// flight while the box is staged, moves xi0 and the fine field in 16-byte
// accesses, and fits four blocks of 256 threads on an SM; the tile shape
// (nd_fused.nd_tile) gives small levels enough blocks to fill the card.
// A 2-D level runs as a 3-D one whose middle axis has extent 1 and no
// contraction. Storage is float or bf16; accumulation is f32. The charts'
// stencils (4, 5) and (2, 3) are compile-time instances; any other runs
// the runtime-size instance.
#include "nd_tile.cuh"

namespace repro {

template <typename T, int FT, int CT>
__global__ void __launch_bounds__(kThreads, 4) refine_nd_fused_kernel(
    const T* __restrict__ field, const T* __restrict__ xi0,
    const T* __restrict__ r0, const T* __restrict__ d0,
    const T* __restrict__ r1, const T* __restrict__ r2, T* __restrict__ out,
    NdParams p) {
  extern __shared__ __align__(16) float smem[];
  nd_fused_tile<T, false, FT, CT>(field, xi0, r0, d0, r1, r2, out, p,
                                  blockIdx.x, blockIdx.y, smem);
}

template <typename T, int FT, int CT>
cudaError_t launch_nd(const void* field, const void* xi0, const void* r0,
                      const void* d0, const void* r1, const void* r2,
                      void* out, int S, const NdParams& p,
                      cudaStream_t stream) {
  const size_t smem = nd_smem_floats(p) * sizeof(float);
  auto kernel = refine_nd_fused_kernel<T, FT, CT>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((unsigned)nd_tiles_per_sample(p), S);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(field), static_cast<const T*>(xi0),
      static_cast<const T*>(r0), static_cast<const T*>(d0),
      static_cast<const T*>(r1), static_cast<const T*>(r2),
      static_cast<T*>(out), p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_nd_any(const void* field, const void* xi0, const void* r0,
                          const void* d0, const void* r1, const void* r2,
                          void* out, int S, const NdParams& p,
                          cudaStream_t st) {
  if (p.F == 4 && p.C == 5)
    return launch_nd<T, 4, 5>(field, xi0, r0, d0, r1, r2, out, S, p, st);
  if (p.F == 2 && p.C == 3)
    return launch_nd<T, 2, 3>(field, xi0, r0, d0, r1, r2, out, S, p, st);
  return launch_nd<T, 0, 0>(field, xi0, r0, d0, r1, r2, out, S, p, st);
}

}  // namespace repro

// dtype: 0 float32, 1 bfloat16. field (S, L0, L1, L2) contiguous and
// padded so that L_a >= (T_a-1)*n_fsz/2 + n_csz; xi0 and out
// (S, T0*F, P) with P = (contract1 ? T1*F : 1) * T2*F; r0/d0 (F, C)/(F, F)
// or per family (T0, F, C)/(T0, F, F); r1 (unused unless contract1) and r2
// (F, C) or (T_a, F, C); all on `device`, launched on `stream`. The grid
// is (tiles of one sample, S) blocks of 256 with nd_smem_floats floats of
// dynamic shared memory, which the launch plan's plan_gx, plan_gy and
// plan_smem (bytes) must be. Returns the launch's cudaError_t, or
// kPlanMismatch.
extern "C" int refine_nd_fused_fwd(int dtype, const void* field,
                                   const void* xi0, const void* r0,
                                   const void* d0, const void* r1,
                                   const void* r2, void* out, int S, int L0,
                                   int L1, int L2, int T0, int T1, int T2,
                                   int C, int F, int ch0, int ch1, int ch2,
                                   int B0, int B1, int B2, int contract1,
                                   int plan_gx, int plan_gy, int plan_smem,
                                   int device, void* stream) {
  if (C > repro::kMaxCsz || F > repro::kMaxFsz || B0 < 1 || B1 < 1 ||
      B2 < 1)
    return (int)cudaErrorInvalidValue;
  repro::NdParams p{L0, L1, L2, 0,  0,  0,  T0, T1, T2, C,
                    F,  ch0, ch1, ch2, B0, B1, B2, contract1};
  if (plan_gx != repro::nd_tiles_per_sample(p) || plan_gy != S ||
      (size_t)plan_smem != repro::nd_smem_floats(p) * sizeof(float))
    return repro::kPlanMismatch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::launch_nd_any<float>(field, xi0, r0, d0, r1, r2, out, S,
                                       p, st);
  if (dtype == 1)
    return repro::launch_nd_any<__nv_bfloat16>(field, xi0, r0, d0, r1, r2,
                                               out, S, p, st);
  return (int)cudaErrorInvalidValue;
}
