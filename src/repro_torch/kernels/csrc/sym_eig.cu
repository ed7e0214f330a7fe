// Batched symmetric eigensolver of the port: cyclic Jacobi, fixed sweeps.
//
// Replaces no Pallas kernel. A learned-θ step rebuilds every refinement
// matrix from θ, and on the TPU XLA compiles the build's eigh, a Jacobi
// eigensolver, into the step. torch.linalg.eigh reads its status on the
// host and cannot be captured in a CUDA graph; this kernel computes the
// same eigenpairs on the device, for every family of a level in one launch
// (65,536 4x4 matrices on the charted 1-D levels), and leaves a per-matrix
// status on the device for the caller to read after a whole fit.
//
// What it computes (kernels/sym_eig.py holds the plain version, the same
// arithmetic in torch): for each symmetric n x n float32 matrix A, n <= 32,
// `sweeps` sweeps of the round-robin cyclic ordering. Round r of the m - 1
// (m = n rounded up to even) pairs index r with m - 1 and (r + i) mod
// (m - 1) with (r - i) mod (m - 1), 0 < i < m/2 (a pair with index n of odd
// n is skipped); every pair's rotation is taken from A at the round's start
// (jacobi_rotation), then A <- A J (columns), A <- J^T A (rows), V <- V J.
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn, ...),
// as torch computes the plain version op by op, so the eigenpairs equal
// the plain version's on the card bit for bit. The eigenvalues are written
// ascending (NaN last, ties by index: torch.sort(stable=True)), the
// eigenvectors as the columns of evecs, and status[b] = the Frobenius norm
// of A's off-diagonal after the last sweep over that of the input.
//
// What bounds it: at the families' sizes (n = 2..5) bytes, (2n^2 + n + 1)
// floats per matrix, of which the card moves 65,536 4x4 matrices in ~3 us;
// a thread holds its matrix and V in registers (n known at compile time),
// so the rotations cost no memory traffic. n = 6..32 (the level-0 roots of
// small charts) takes a warp per matrix, A and V in shared memory with
// rows padded to n + 1, a lane per row or column of each rotation pass:
// O(n^3) operations per sweep, bound by operations.
#include "common.cuh"

namespace repro {

constexpr int kMaxEigN = 32;
constexpr int kThreadMaxN = 5;
constexpr int kWarps = kThreads / 32;

// floats of one warp's shared memory: A and V (rows of n + 1), then c and
// s of a round and its pairs' p and q (as ints)
__host__ __device__ constexpr int warp_floats(int n) {
  return 2 * n * (n + 1) + 4 * (kMaxEigN / 2);
}

// Pair i of round r of the circle method over m indices.
__host__ __device__ constexpr int pair_p(int m, int r, int i) {
  return i == 0 ? r : (r + i) % (m - 1);
}
__host__ __device__ constexpr int pair_q(int m, int r, int i) {
  return i == 0 ? m - 1 : (r - i + (m - 1)) % (m - 1);
}

// The rotation that zeroes A[p][q]: t = sign(tau) / (|tau| + sqrt(1 +
// tau^2)), tau = (A_qq - A_pp) / (2 A_pq), c = 1 / sqrt(1 + t^2), s = t c.
__device__ __forceinline__ void jacobi_rotation(float app, float aqq,
                                                float apq, float& c,
                                                float& s) {
  if (apq == 0.f) {
    c = 1.f;
    s = 0.f;
    return;
  }
  const float tau = __fdiv_rn(__fsub_rn(aqq, app), __fmul_rn(2.f, apq));
  const float sign = tau >= 0.f ? 1.f : -1.f;
  const float t = __fdiv_rn(
      sign, __fadd_rn(fabsf(tau),
                      __fsqrt_rn(__fadd_rn(1.f, __fmul_rn(tau, tau)))));
  c = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(1.f, __fmul_rn(t, t))));
  s = __fmul_rn(t, c);
}

// (x, y) <- (c x - s y, s x + c y)
__device__ __forceinline__ void rotate(float& x, float& y, float c,
                                       float s) {
  const float nx = __fsub_rn(__fmul_rn(c, x), __fmul_rn(s, y));
  const float ny = __fadd_rn(__fmul_rn(s, x), __fmul_rn(c, y));
  x = nx;
  y = ny;
}

// torch.sort's order: NaN above everything, ties by index
__device__ __forceinline__ bool sorts_before(float a, int i, float b,
                                             int j) {
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an == bn ? i < j : bn;
  return a < b || (a == b && i < j);
}

// n <= 5: one thread per matrix, A and V in registers.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads) sym_eig_thread_kernel(
    const T* __restrict__ a, T* __restrict__ evals, T* __restrict__ evecs,
    T* __restrict__ status, int batch, int sweeps) {
  constexpr int M = N + N % 2;
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (b >= batch) return;
  float A[N][N], V[N][N];
  float norm = 0.f;
  const T* src = a + b * N * N;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      A[i][j] = to_float(src[i * N + j]);
      V[i][j] = i == j ? 1.f : 0.f;
      norm += A[i][j] * A[i][j];
    }
#pragma unroll 1
  for (int sw = 0; sw < sweeps; ++sw) {
#pragma unroll
    for (int r = 0; r < M - 1; ++r) {
      float c[M / 2], s[M / 2];
#pragma unroll
      for (int i = 0; i < M / 2; ++i) {
        const int p = pair_p(M, r, i), q = pair_q(M, r, i);
        if (p < N && q < N) jacobi_rotation(A[p][p], A[q][q], A[p][q], c[i],
                                            s[i]);
      }
#pragma unroll
      for (int i = 0; i < M / 2; ++i) {
        const int p = pair_p(M, r, i), q = pair_q(M, r, i);
        if (p < N && q < N) {
#pragma unroll
          for (int k = 0; k < N; ++k) rotate(A[k][p], A[k][q], c[i], s[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < M / 2; ++i) {
        const int p = pair_p(M, r, i), q = pair_q(M, r, i);
        if (p < N && q < N) {
#pragma unroll
          for (int k = 0; k < N; ++k) rotate(A[p][k], A[q][k], c[i], s[i]);
#pragma unroll
          for (int k = 0; k < N; ++k) rotate(V[k][p], V[k][q], c[i], s[i]);
        }
      }
    }
  }
  float off = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (i != j) off += A[i][j] * A[i][j];
  status[b] = from_float<T>(norm > 0.f ? sqrtf(off) / sqrtf(norm)
                                       : sqrtf(off));
#pragma unroll
  for (int k = 0; k < N; ++k) {
    int rank = 0;
#pragma unroll
    for (int j = 0; j < N; ++j)
      rank += sorts_before(A[j][j], j, A[k][k], k) ? 1 : 0;
    evals[b * N + rank] = from_float<T>(A[k][k]);
#pragma unroll
    for (int i = 0; i < N; ++i)
      evecs[b * N * N + i * N + rank] = from_float<T>(V[i][k]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// n = 1 and 6..32: one warp per matrix, kWarps to a block, A and V in
// shared memory; a lane owns a row in the column passes and a column in
// the row pass.
template <typename T>
__global__ void __launch_bounds__(kThreads) sym_eig_warp_kernel(
    const T* __restrict__ a, T* __restrict__ evals, T* __restrict__ evecs,
    T* __restrict__ status, int batch, int n, int sweeps) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long b = (long long)blockIdx.x * kWarps + warp;
  if (b >= batch) return;  // the whole warp: nothing below syncs the block
  const int ld = n + 1, m = n + n % 2;
  float* A = smem + warp * warp_floats(n);
  float* V = A + n * ld;
  float* cs = V + n * ld;
  int* pq = reinterpret_cast<int*>(cs + kMaxEigN);
  const T* src = a + b * n * n;
  float norm = 0.f;
  for (int idx = lane; idx < n * n; idx += 32) {
    const int i = idx / n, j = idx % n;
    const float x = to_float(src[idx]);
    A[i * ld + j] = x;
    V[i * ld + j] = i == j ? 1.f : 0.f;
    norm += x * x;
  }
  norm = warp_sum(norm);
  __syncwarp();
  for (int sw = 0; sw < sweeps; ++sw) {
    for (int r = 0; r < m - 1; ++r) {
      if (lane < m / 2) {
        const int p = pair_p(m, r, lane), q = pair_q(m, r, lane);
        float c = 1.f, s = 0.f;
        const bool valid = p < n && q < n;
        if (valid)
          jacobi_rotation(A[p * ld + p], A[q * ld + q], A[p * ld + q], c, s);
        cs[lane] = c;
        cs[kMaxEigN / 2 + lane] = s;
        pq[lane] = valid ? p : -1;
        pq[kMaxEigN / 2 + lane] = q;
      }
      __syncwarp();
      if (lane < n) {
        for (int i = 0; i < m / 2; ++i) {
          const int p = pq[i];
          if (p < 0) continue;
          const int q = pq[kMaxEigN / 2 + i];
          const float c = cs[i], s = cs[kMaxEigN / 2 + i];
          rotate(A[lane * ld + p], A[lane * ld + q], c, s);
          rotate(V[lane * ld + p], V[lane * ld + q], c, s);
        }
      }
      __syncwarp();
      if (lane < n) {
        for (int i = 0; i < m / 2; ++i) {
          const int p = pq[i];
          if (p < 0) continue;
          const int q = pq[kMaxEigN / 2 + i];
          rotate(A[p * ld + lane], A[q * ld + lane], cs[i],
                 cs[kMaxEigN / 2 + i]);
        }
      }
      __syncwarp();
    }
  }
  float off = 0.f;
  if (lane < n)
    for (int j = 0; j < n; ++j)
      if (j != lane) off += A[lane * ld + j] * A[lane * ld + j];
  off = warp_sum(off);
  if (lane == 0)
    status[b] = from_float<T>(norm > 0.f ? sqrtf(off) / sqrtf(norm)
                                         : sqrtf(off));
  if (lane < n) {
    const float d = A[lane * ld + lane];
    int rank = 0;
    for (int j = 0; j < n; ++j)
      rank += sorts_before(A[j * ld + j], j, d, lane) ? 1 : 0;
    evals[b * n + rank] = from_float<T>(d);
    for (int i = 0; i < n; ++i)
      evecs[b * n * n + i * n + rank] = from_float<T>(V[i * ld + lane]);
  }
}

template <int N>
cudaError_t launch_thread(const float* a, float* evals, float* evecs,
                          float* status, int batch, int sweeps, int grid,
                          cudaStream_t st) {
  sym_eig_thread_kernel<float, N>
      <<<grid, kThreads, 0, st>>>(a, evals, evecs, status, batch, sweeps);
  return cudaGetLastError();
}

}  // namespace repro

// Eigenpairs of `batch` symmetric n x n float32 matrices (1 <= n <= 32),
// one launch: n = 2..5 one thread per matrix, ceil(batch / 256) blocks and
// no shared memory; otherwise one warp per matrix, ceil(batch / 8) blocks
// of 8 warps with warp_floats(n) floats of shared memory each. The plan's
// grid and shared memory must be these.
extern "C" int sym_eig_launch(int n, int batch, int sweeps, const void* a,
                              void* evals, void* evecs, void* status,
                              int plan_gx, int plan_gy, int plan_smem,
                              int device, void* stream) {
  using namespace repro;
  if (n < 1 || n > kMaxEigN || batch < 1 || sweeps < 0)
    return (int)cudaErrorInvalidValue;
  const bool thread = n >= 2 && n <= kThreadMaxN;
  const long long gx = thread ? (batch + kThreads - 1) / kThreads
                              : (batch + kWarps - 1) / kWarps;
  const int smem = thread ? 0 : kWarps * warp_floats(n) * (int)sizeof(float);
  if (gx != plan_gx || plan_gy != 1 || smem != plan_smem) return kPlanMismatch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* A = static_cast<const float*>(a);
  float* W = static_cast<float*>(evals);
  float* Vt = static_cast<float*>(evecs);
  float* S = static_cast<float*>(status);
  const int grid = (int)gx;
  switch (thread ? n : 0) {
    case 2: return (int)launch_thread<2>(A, W, Vt, S, batch, sweeps, grid, st);
    case 3: return (int)launch_thread<3>(A, W, Vt, S, batch, sweeps, grid, st);
    case 4: return (int)launch_thread<4>(A, W, Vt, S, batch, sweeps, grid, st);
    case 5: return (int)launch_thread<5>(A, W, Vt, S, batch, sweeps, grid, st);
    default: break;
  }
  e = allow_smem(sym_eig_warp_kernel<float>, (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  sym_eig_warp_kernel<float>
      <<<grid, kThreads, smem, st>>>(A, W, Vt, S, batch, n, sweeps);
  return (int)cudaGetLastError();
}
