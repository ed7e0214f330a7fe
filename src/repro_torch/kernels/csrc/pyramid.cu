// The pyramid: the first k refinement levels of a chart in ONE launch.
//
// Replaces the Pallas kernel src/repro/kernels/pyramid.py:_pyramid_kernel
// (l.150), which keeps whole early levels resident in a TPU core's VMEM
// and writes only the last one. A Hopper block has at most 227 KB of
// shared memory, far less than one such level, so this kernel does not
// carry over the TPU's block structure. What it keeps is the point of the
// reference: the fields that one covered level hands to the next are
// never sent out to be re-read by another launch. Here they stay in the
// H100's 50 MB L2 between grid-wide barriers:
//  * one cooperative launch (cudaLaunchCooperativeKernel), its grid sized
//    by the occupancy calculator to every block that can be co-resident;
//  * the levels run in turn: the blocks walk each level's tiles with a
//    grid stride, then meet at cooperative_groups::this_grid().sync()
//    before the next level reads what they wrote;
//  * a level runs the per-level kernel's own body (nd_tile.cuh for 2-D
//    and 3-D levels; refine_1d_tile.cuh for 1-D levels: the streaming runs
//    of the stationary and charted kernels, one run of families per
//    thread, in a grid-stride loop), so every level computes exactly what
//    its per-level kernel computes;
//  * every load goes through the L2 only (ld.global.cg, the bodies'
//    COHERENT flag): a level's field was written by other blocks before
//    the grid.sync(), where the read-only path is not defined, and no
//    load of this kernel takes the read-only or L1 path;
//  * reflect padding is done in the read index (reflect_index), the
//    counterpart of _reflect_pad_axis: no padded copy is made;
//  * intermediate fields live in two ping-pong scratch fields of the
//    storage dtype, allocated by the wrapper, so every level's output is
//    rounded to the storage dtype as the reference rounds it (l.128-130);
//  * the per-level operands (xi0 with the trailing noise contracted, R_a,
//    sqrtD_0, shapes and tiles) come in one by-value parameter struct of at
//    most kMaxLevels levels, read in place (__grid_constant__);
//  * a chart's levels are all 1-D or all N-D, so the kernel is compiled
//    once per kind (ND) and stencil (the charts' (4, 5) and (2, 3), and a
//    runtime-size instance): each instance holds one kind's registers.
//    Four blocks of 256 threads fit on an SM with an N-D instance (its
//    shared memory allows four), three with a 1-D one (80 registers: the
//    charted run holds its families' stencils in registers across rows,
//    and at 64 it spilled up to 540 bytes and ran its levels slower).
// What bounds it: bytes, as each of its levels (~2-4 FLOP per byte at
// f32): the first field read, every level's xi0 and matrices read once and
// the last field written once are the device-memory traffic it cannot
// avoid; the intermediate fields should be L2 traffic. The residency rule
// (dispatch.pyramid_prefix) keeps their sum within half the L2.
// Storage is float or bf16; accumulation is f32.
#include <cooperative_groups.h>

#include "nd_tile.cuh"
#include "refine_1d_tile.cuh"

namespace cg = cooperative_groups;

namespace repro {

constexpr int kMaxLevels = 16;
// int64 fields of one level in the host table (see refine_pyramid_fwd)
constexpr int kLevelFields = 22;

struct PyrLevel {
  const void* xi0;
  const void* r0;
  const void* d0;
  const void* r1;  // 3-D levels only
  const void* r2;  // N-D levels only
  NdParams q;      // a 1-D level uses L0, pad0, T0, ch0, B0, C, F
  int ndim;        // 1, 2 or 3
  int BB;          // runs per row of a 1-D level
  int tiles;       // tiles (N-D) or blocks of runs (1-D) of this level
};

struct PyrParams {
  const void* field;  // (S, *coarse shape of level 0), unpadded
  void* out;          // (S, *fine shape of the last level)
  void* scratch[2];   // ping-pong intermediate fields
  int S, n_levels;
  PyrLevel lv[kMaxLevels];
};

// Level l of the pyramid: the field it reads and the one it writes.
template <typename T>
__device__ __forceinline__ const T* level_in(const PyrParams& p, int l) {
  return static_cast<const T*>(l == 0 ? p.field : p.scratch[(l - 1) & 1]);
}
template <typename T>
__device__ __forceinline__ T* level_out(const PyrParams& p, int l) {
  return static_cast<T*>(l + 1 == p.n_levels ? p.out : p.scratch[l & 1]);
}

template <typename T, bool ND, int FT, int CT>
__global__ void __launch_bounds__(kThreads, ND ? 4 : 3)
    refine_pyramid_kernel(const __grid_constant__ PyrParams p) {
  constexpr int NF = stream_fwd_families<T>(FT, CT);
  constexpr int NFC = charted_families(FT, CT);
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  if constexpr (ND) {
    // the level's parameters in shared memory: the tile body reads them
    // from there after each of its barriers instead of holding them in
    // registers (a level index known only at run time would put them in
    // registers for the whole tile, and the instance would spill)
    __shared__ PyrLevel slv;
    __shared__ const void* sio[2];
    for (int l = 0; l < p.n_levels; ++l) {
      if (threadIdx.x == 0) {
        slv = p.lv[l];
        sio[0] = level_in<T>(p, l);
        sio[1] = level_out<T>(p, l);
      }
      __syncthreads();
      const int tiles = slv.tiles, per = nd_tiles_per_sample(slv.q);
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        nd_fused_tile<T, true, FT, CT>(
            static_cast<const T*>(sio[0]), static_cast<const T*>(slv.xi0),
            static_cast<const T*>(slv.r0), static_cast<const T*>(slv.d0),
            static_cast<const T*>(slv.r1), static_cast<const T*>(slv.r2),
            static_cast<T*>(const_cast<void*>(sio[1])), slv.q, tile % per,
            (size_t)(tile / per), smem);
        __syncthreads();  // the next tile reuses shared memory
      }
      // the next level reads what every block wrote; grid.sync() orders
      // the writes before those reads
      if (l + 1 < p.n_levels) grid.sync();
    }
  } else {
    for (int l = 0; l < p.n_levels; ++l) {
      const PyrLevel& lv = p.lv[l];
      const NdParams& q = lv.q;
      const T* in = level_in<T>(p, l);
      T* out = level_out<T>(p, l);
      const T* xi0 = static_cast<const T*>(lv.xi0);
      const T* r0 = static_cast<const T*>(lv.r0);
      const T* d0 = static_cast<const T*>(lv.d0);
      if (!q.ch0) {
        // a stationary level: run i % runs (of NF = B0 families) of row
        // i / runs, the runs of all rows over the grid
        const int runs = lv.BB;
        const long long total = (long long)p.S * runs;
        for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
             i < total; i += (long long)gridDim.x * kThreads) {
          const size_t b = (size_t)(i / runs);
          const int t0 = (int)(i - (long long)b * runs) * NF;
          if constexpr (FT > 0)
            stationary_fwd_run<T, true, FT, CT, NF, true>(
                in, xi0, r0, d0, out, b, q.L0, q.pad0, q.T0, t0);
          else
            stationary_fwd_family<T, true, true>(in, xi0, r0, d0, out, b,
                                                 q.L0, q.pad0, q.T0, q.C,
                                                 q.F, t0);
        }
      } else {
        // a charted level: run i % runs (of NFC = B0 families) of the rows
        // [(i / runs) * SB, + SB), SB = B1, over the grid
        const int runs = lv.BB, SB = q.B1;
        const long long total = (long long)((p.S + SB - 1) / SB) * runs;
        for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
             i < total; i += (long long)gridDim.x * kThreads) {
          const int chunk = (int)(i / runs);
          const size_t b0 = (size_t)chunk * SB;
          const int nb = min(SB, p.S - chunk * SB);
          const int t0 = (int)(i - (long long)chunk * runs) * NFC;
          if constexpr (FT > 0) {
            charted_fwd_run<T, true, FT, CT, NFC, true>(
                in, xi0, r0, d0, out, b0, nb, q.L0, q.pad0, q.T0, t0);
          } else {
            for (int bi = 0; bi < nb; ++bi)
              charted_fwd_family<T, true, true>(in, xi0, r0, d0, out,
                                                b0 + bi, q.L0, q.pad0, q.T0,
                                                q.C, q.F, t0);
          }
        }
      }
      if (l + 1 < p.n_levels) grid.sync();
    }
  }
}

// The co-resident blocks of an instance (blocks per SM times SMs) into
// *resident; with p, the launch of min(resident, max_tiles, max_blocks if
// > 0) blocks, that grid in *grid_out, where the plan's grid plan_grid
// must equal it.
template <typename T, bool ND, int FT, int CT>
cudaError_t launch_pyramid(const PyrParams* p, size_t smem, int max_tiles,
                           int max_blocks, int plan_grid, int* grid_out,
                           int* resident, cudaStream_t stream) {
  auto kernel = refine_pyramid_kernel<T, ND, FT, CT>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *resident = per_sm * sms;
  if (p == nullptr) return cudaSuccess;
  // every co-resident block, but no more than the largest level has tiles;
  // max_blocks > 0 caps it further (the tests' striding check)
  int grid = per_sm * sms;
  if (grid > max_tiles) grid = max_tiles;
  if (max_blocks > 0 && grid > max_blocks) grid = max_blocks;
  *grid_out = grid;
  if (plan_grid != grid) return (cudaError_t)kPlanMismatch;
  void* args[] = {const_cast<PyrParams*>(p)};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(grid), dim3(kThreads), args, smem,
                                  stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, bool ND>
cudaError_t launch_stencil(const PyrParams* p, int C, int F, size_t smem,
                           int max_tiles, int max_blocks, int plan_grid,
                           int* grid_out, int* resident, cudaStream_t st) {
  if (F == 4 && C == 5)
    return launch_pyramid<T, ND, 4, 5>(p, smem, max_tiles, max_blocks,
                                       plan_grid, grid_out, resident, st);
  if (F == 2 && C == 3)
    return launch_pyramid<T, ND, 2, 3>(p, smem, max_tiles, max_blocks,
                                       plan_grid, grid_out, resident, st);
  return launch_pyramid<T, ND, 0, 0>(p, smem, max_tiles, max_blocks,
                                     plan_grid, grid_out, resident, st);
}

template <typename T>
cudaError_t launch_kind(const PyrParams& p, int C, int F, size_t smem,
                        int max_tiles, int max_blocks, int plan_grid,
                        int* grid_out, cudaStream_t st) {
  // a 1-D level's runs hold the instance's families
  for (int l = 0; l < p.n_levels; ++l)
    if (p.lv[l].ndim == 1 &&
        p.lv[l].q.B0 != (p.lv[l].q.ch0 ? charted_families(F, C)
                                        : stream_fwd_families<T>(F, C)))
      return cudaErrorInvalidValue;
  int resident = 0;
  return p.lv[0].ndim > 1
             ? launch_stencil<T, true>(&p, C, F, smem, max_tiles, max_blocks,
                                       plan_grid, grid_out, &resident, st)
             : launch_stencil<T, false>(&p, C, F, smem, max_tiles,
                                        max_blocks, plan_grid, grid_out,
                                        &resident, st);
}

}  // namespace repro

// dtype: 0 float32, 1 bfloat16. `table` holds kLevelFields int64 per
// level, in order: ndim, xi0, r0, d0, r1, r2 (device pointers, r1/r2 0
// where absent), L0, L1, L2 (stored coarse extents), pad0, pad1, pad2
// (reflect padding per axis), T0, T1, T2, ch0, ch1, ch2 (charted axes),
// B0, B1, B2 (families per tile; of a 1-D level, families per run and, of
// a charted one, rows per thread), BB (runs per row of a 1-D level);
// 2-D levels set the middle axis to extent 1, 1-D levels the two
// trailing axes; the levels are all 1-D or all 2-D/3-D. field (S, *coarse
// shape of level 0), out (S, *fine shape of the last level),
// scratch0/scratch1 each holding the largest intermediate field; all
// contiguous on `device`, launched on `stream`. max_blocks > 0 caps the
// grid. Writes the grid size to *grid_out and
// returns the launch's cudaError_t: a grid that cannot be co-resident, or
// a device without cooperative launch, is an error, never a fallback.
// plan_gx, plan_gy and plan_smem are the launch plan's grid (x, 1) and
// dynamic shared memory (bytes): where they differ from the grid and
// shared memory derived here, nothing launches and it returns
// kPlanMismatch.
extern "C" int refine_pyramid_fwd(int dtype, const long long* table,
                                  int n_levels, int S, int C, int F,
                                  const void* field, void* out,
                                  void* scratch0, void* scratch1,
                                  int max_blocks, int* grid_out, int plan_gx,
                                  int plan_gy, int plan_smem, int device,
                                  void* stream) {
  if (C > repro::kMaxCsz || F > repro::kMaxFsz || n_levels < 1 ||
      n_levels > repro::kMaxLevels)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  repro::PyrParams p{};
  p.field = field;
  p.out = out;
  p.scratch[0] = scratch0;
  p.scratch[1] = scratch1;
  p.S = S;
  p.n_levels = n_levels;
  size_t smem_floats = 0;
  int max_tiles = 1;
  for (int l = 0; l < n_levels; ++l) {
    const long long* f = table + (size_t)l * repro::kLevelFields;
    repro::PyrLevel& lv = p.lv[l];
    lv.ndim = (int)f[0];
    lv.xi0 = reinterpret_cast<const void*>(f[1]);
    lv.r0 = reinterpret_cast<const void*>(f[2]);
    lv.d0 = reinterpret_cast<const void*>(f[3]);
    lv.r1 = reinterpret_cast<const void*>(f[4]);
    lv.r2 = reinterpret_cast<const void*>(f[5]);
    repro::NdParams& q = lv.q;
    q.L0 = (int)f[6]; q.L1 = (int)f[7]; q.L2 = (int)f[8];
    q.pad0 = (int)f[9]; q.pad1 = (int)f[10]; q.pad2 = (int)f[11];
    q.T0 = (int)f[12]; q.T1 = (int)f[13]; q.T2 = (int)f[14];
    q.ch0 = (int)f[15]; q.ch1 = (int)f[16]; q.ch2 = (int)f[17];
    q.B0 = (int)f[18]; q.B1 = (int)f[19]; q.B2 = (int)f[20];
    lv.BB = (int)f[21];
    q.C = C;
    q.F = F;
    q.contract1 = lv.ndim == 3;
    if (lv.ndim < 1 || lv.ndim > 3 || q.B0 < 1 || q.B1 < 1 || q.B2 < 1 ||
        lv.BB < 1 || (lv.ndim == 1) != (p.lv[0].ndim == 1))
      return (int)cudaErrorInvalidValue;
    size_t floats;
    long long tiles;
    if (lv.ndim == 1) {
      const long long chunks = q.ch0 ? (S + q.B1 - 1) / q.B1 : S;
      floats = 0;
      tiles = (chunks * lv.BB + repro::kThreads - 1) / repro::kThreads;
    } else {
      floats = repro::nd_smem_floats(q);
      tiles = (long long)repro::nd_tiles_per_sample(q) * S;
    }
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    lv.tiles = (int)tiles;
    if (floats > smem_floats) smem_floats = floats;
    if (lv.tiles > max_tiles) max_tiles = lv.tiles;
  }
  const size_t smem = smem_floats * sizeof(float);
  if (plan_gy != 1 || (size_t)plan_smem != smem) return repro::kPlanMismatch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)repro::launch_kind<float>(p, C, F, smem, max_tiles,
                                          max_blocks, plan_gx, grid_out, st);
  if (dtype == 1)
    return (int)repro::launch_kind<__nv_bfloat16>(
        p, C, F, smem, max_tiles, max_blocks, plan_gx, grid_out, st);
  return (int)cudaErrorInvalidValue;
}

// The co-resident blocks (blocks per SM times SMs) of the instance that a
// pyramid of `nd`-D levels (1, or 2/3) with stencil (F, C) runs at `smem`
// bytes of dynamic shared memory, into *blocks: what a launch plan's grid
// is made of. Returns a cudaError_t.
extern "C" int refine_pyramid_resident(int dtype, int nd, int C, int F,
                                       int smem, int device, int* blocks) {
  if (C > repro::kMaxCsz || F > repro::kMaxFsz)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  int grid = 0;
  const size_t bytes = (size_t)smem;
  if (dtype == 0)
    return nd > 1 ? (int)repro::launch_stencil<float, true>(
                        nullptr, C, F, bytes, 0, 0, 0, &grid, blocks, 0)
                  : (int)repro::launch_stencil<float, false>(
                        nullptr, C, F, bytes, 0, 0, 0, &grid, blocks, 0);
  if (dtype == 1)
    return nd > 1 ? (int)repro::launch_stencil<__nv_bfloat16, true>(
                        nullptr, C, F, bytes, 0, 0, 0, &grid, blocks, 0)
                  : (int)repro::launch_stencil<__nv_bfloat16, false>(
                        nullptr, C, F, bytes, 0, 0, 0, &grid, blocks, 0);
  return (int)cudaErrorInvalidValue;
}
