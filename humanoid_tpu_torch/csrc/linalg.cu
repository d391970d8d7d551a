// Batched Cholesky factor, apply and solve of small SPD systems, one thread
// per env.
//
// Replaces the TPU kernels of humanoid_tpu/ops/linalg.py:
//   chol_factor_kernel  <- _chol_factor_kernel (factor_spd_pallas): L with
//                          its true diagonal and zeros above it;
//   chol_apply_kernel   <- _chol_apply_kernel (apply_spd_pallas): the two
//                          triangular sweeps L y = b, L^T x = y against a
//                          cached factor;
//   chol_solve_kernel   <- _chol_solve_kernel (solve_spd_pallas): factor and
//                          both sweeps in one pass, M x = b.
// The arithmetic is the TPU kernels': a left-looking factor with an rsqrt
// pivot, d = s * rsqrt(s), and the sweeps multiplying by the inverse
// diagonal (rsqrt in the solve, 1 / L[i][i] in the apply). A matrix that is
// not positive definite gives NaN, never an error: rsqrt of a negative
// pivot is NaN and 0 * rsqrt(0) is NaN, and both spread to every later
// entry.
//
// Layout: the port's env-major tensors, M and L (N, n, n) row-major, b and
// x (N, n); n is a runtime argument, at most MAX_N. The factor reads only
// the lower triangle of M.
//
// What bounds it: at n = 18 a factor is 2,127 fp32 operations per env
// against 1,980 bytes moved (M's lower triangle in, the whole L out), a
// solve 2,775 against 828 bytes (M's lower triangle and b in, x out): all
// three are bound by bytes on this card. One thread per env
// reads its own matrix, so the loads of a warp touch 32 rows 1,296 bytes
// apart (uncoalesced; each thread walks its rows through L1), and the
// factor lives in the thread's local memory. Staging a block's matrices
// through shared memory (coalesced loads) and more threads per env are the
// later work that addresses it.
//
// The per-env bodies are __host__ __device__ so that a host compiler can
// check their arithmetic; the wrappers never run them on the host.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__
#else
#include <cmath>
#define HD
static inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
#endif

#define MAX_N 24
#define TRI(n) ((n) * ((n) + 1) / 2)

HD inline int tri(int i, int j) { return i * (i + 1) / 2 + j; }  // j <= i

// Packed lower factor L of the row-major M (n, n), and its inverse
// diagonal.
HD inline void factor(const float* M, int n, float* L, float* invd) {
  for (int j = 0; j < n; ++j) {
    float s = M[j * n + j];
    for (int k = 0; k < j; ++k) s -= L[tri(j, k)] * L[tri(j, k)];
    const float iv = rsqrtf(s);
    invd[j] = iv;
    L[tri(j, j)] = s * iv;
    for (int i = j + 1; i < n; ++i) {
      float t = M[i * n + j];
      for (int k = 0; k < j; ++k) t -= L[tri(i, k)] * L[tri(j, k)];
      L[tri(i, j)] = t * iv;
    }
  }
}

// x = (L L^T)^-1 b with the packed factor; x may alias b.
HD inline void sweeps(const float* L, const float* invd, int n, const float* b, float* x) {
  for (int i = 0; i < n; ++i) {
    float s = b[i];
    for (int k = 0; k < i; ++k) s -= L[tri(i, k)] * x[k];
    x[i] = s * invd[i];
  }
  for (int i = n - 1; i >= 0; --i) {
    float s = x[i];
    for (int k = i + 1; k < n; ++k) s -= L[tri(k, i)] * x[k];
    x[i] = s * invd[i];
  }
}

HD void factor_env(const float* M, float* Lout, int n) {
  float L[TRI(MAX_N)], invd[MAX_N];
  factor(M, n, L, invd);
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) Lout[i * n + j] = j <= i ? L[tri(i, j)] : 0.0f;
}

HD void apply_env(const float* Lin, const float* b, float* x, int n) {
  float L[TRI(MAX_N)], invd[MAX_N], y[MAX_N];
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) L[tri(i, j)] = Lin[i * n + j];
    invd[i] = 1.0f / Lin[i * n + i];
    y[i] = b[i];
  }
  sweeps(L, invd, n, y, y);
  for (int i = 0; i < n; ++i) x[i] = y[i];
}

HD void solve_env(const float* M, const float* b, float* x, int n) {
  float L[TRI(MAX_N)], invd[MAX_N], y[MAX_N];
  factor(M, n, L, invd);
  for (int i = 0; i < n; ++i) y[i] = b[i];
  sweeps(L, invd, n, y, y);
  for (int i = 0; i < n; ++i) x[i] = y[i];
}

#ifdef __CUDACC__

#define THREADS 32  // one warp per block spreads 4096 envs over 128 SMs

__global__ void __launch_bounds__(THREADS)
chol_factor_kernel(const float* __restrict__ M, float* __restrict__ L, int N, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= N) return;
  const long long off = static_cast<long long>(e) * n * n;
  factor_env(M + off, L + off, n);
}

__global__ void __launch_bounds__(THREADS)
chol_apply_kernel(const float* __restrict__ L, const float* __restrict__ b,
                  float* __restrict__ x, int N, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= N) return;
  apply_env(L + static_cast<long long>(e) * n * n, b + static_cast<long long>(e) * n,
            x + static_cast<long long>(e) * n, n);
}

__global__ void __launch_bounds__(THREADS)
chol_solve_kernel(const float* __restrict__ M, const float* __restrict__ b,
                  float* __restrict__ x, int N, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= N) return;
  solve_env(M + static_cast<long long>(e) * n * n, b + static_cast<long long>(e) * n,
            x + static_cast<long long>(e) * n, n);
}

static inline int blocks(int N) { return (N + THREADS - 1) / THREADS; }

extern "C" int chol_factor_launch(const float* M, float* L, int N, int n, void* stream) {
  if (N == 0) return 0;
  chol_factor_kernel<<<blocks(N), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(M, L, N, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int chol_apply_launch(const float* L, const float* b, float* x, int N, int n,
                                 void* stream) {
  if (N == 0) return 0;
  chol_apply_kernel<<<blocks(N), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(L, b, x, N, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int chol_solve_launch(const float* M, const float* b, float* x, int N, int n,
                                 void* stream) {
  if (N == 0) return 0;
  chol_solve_kernel<<<blocks(N), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(M, b, x, N, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int linalg_max_n() { return MAX_N; }

#endif
