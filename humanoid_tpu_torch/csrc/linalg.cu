// Batched Cholesky factor, apply and solve of small SPD systems.
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
// three are bound by bytes on this card.
//
// Design of the factor and the apply: one thread per env, 32 per block.
// The loads of a warp touch 32 matrices 1,296 bytes apart (uncoalesced),
// and the factor lives in each thread's local memory.
//
// Design of the solve: a warp per env, SOLVE_ENVS envs per block. The
// block copies its envs' matrices, which are contiguous, into shared
// memory with coalesced (float4 where aligned) loads, keeping the lower
// triangle, each row at an odd stride so that the lanes reading one column
// of their rows hit distinct banks. Lane i owns row i and keeps it in
// registers: in column j of the factor the lanes i >= j form their entries
// in the left-looking order against row j of L, which lane j wrote back to
// shared memory, and take the pivot from lane j by shuffle; the forward
// sweep runs by columns (x_j from lane j by shuffle, then lanes i > j
// update from their registers), the backward sweep reads row j of L across
// the lanes (lanes i < j update). b is read and x written by the lanes
// side by side. The loops over columns are unrolled to MAX_N, so that a
// lane's row stays in registers.
//
// The per-env bodies are __host__ __device__ so that a host compiler can
// check their arithmetic; the wrappers never run them on the host. The
// solve's body is written for L lanes, lane l owning rows l, l + L, ...;
// outside nvcc's device pass its shuffles and syncs compile to nothing and
// a host build runs it with one lane.

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

// ---------------------------------------------------------------------------
// The solve: lane `lane` of L lanes owns rows lane, lane + L, ...

#ifdef __CUDA_ARCH__
#define LANES_SYNC() __syncwarp()
#else
#define LANES_SYNC() ((void)0)
#endif

// v of lane `src` of the warp, on every lane (off the device: v).
HD inline float from_lane(float v, int src) {
#ifdef __CUDA_ARCH__
  return __shfl_sync(0xffffffffu, v, src);
#else
  (void)src;
  return v;
#endif
}

// x = M^-1 b for the lower triangle of M in S (row i at S + i * P). Each
// lane keeps its rows in registers (a) and writes L back into S, where the
// lanes read row j of L in column j of the factor and in the backward
// sweep. Every lane of the L takes the same path through the shuffles and
// syncs.
template <int L, int P>
HD void solve_lanes(float* S, const float* b, float* x, int n, int lane) {
  constexpr int R = (MAX_N + L - 1) / L;   // rows a lane owns, at most
  float a[R][MAX_N], y[R], iv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + r * L;
#pragma unroll
    for (int k = 0; k < MAX_N; ++k) a[r][k] = i < n && k <= i ? S[i * P + k] : 0.0f;
    y[r] = i < n ? b[i] : 0.0f;
    iv[r] = 0.0f;
  }
  // the factor, column by column
#pragma unroll
  for (int j = 0; j < MAX_N; ++j) {
    if (j >= n) break;
    float tj = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + r * L;
      if (i >= j && i < n) {
        float s = a[r][j];
#pragma unroll
        for (int k = 0; k < j; ++k) s -= a[r][k] * S[j * P + k];
        a[r][j] = s;
        if (i == j) tj = s;
      }
    }
    const float s = from_lane(tj, j % L);
    const float ivj = rsqrtf(s);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + r * L;
      if (i >= j && i < n) {
        a[r][j] = i == j ? s * ivj : a[r][j] * ivj;
        S[i * P + j] = a[r][j];
        if (i == j) iv[r] = ivj;
      }
    }
    LANES_SYNC();   // column j is written before column j + 1 reads row j + 1
  }
  // L y = b by columns: x_j from its lane, then the rows below it
#pragma unroll
  for (int j = 0; j < MAX_N; ++j) {
    if (j >= n) break;
    float mine = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (lane + r * L == j) mine = y[r] * iv[r];
    const float xj = from_lane(mine, j % L);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + r * L;
      if (i == j) y[r] = xj;
      else if (i > j && i < n) y[r] -= a[r][j] * xj;
    }
  }
  // L^T x = y by rows of L: x_j from its lane, then the rows above it
#pragma unroll
  for (int j = MAX_N - 1; j >= 0; --j) {
    if (j >= n) continue;
    float mine = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (lane + r * L == j) mine = y[r] * iv[r];
    const float xj = from_lane(mine, j % L);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + r * L;
      if (i == j) y[r] = xj;
      else if (i < j) y[r] -= S[j * P + i] * xj;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane + r * L;
    if (i < n) x[i] = y[r];
  }
}

// One env's solve with one lane: the host build's entry.
HD void solve_env(const float* M, const float* b, float* x, int n) {
  float S[MAX_N * MAX_N];
  for (int i = 0; i < n; ++i)
    for (int j = 0; j <= i; ++j) S[i * MAX_N + j] = M[i * n + j];
  solve_lanes<1, MAX_N>(S, b, x, n, 0);
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

#define WARP 32
constexpr int SOLVE_ENVS = 8;        // envs (warps) per block
constexpr int SOLVE_P = MAX_N | 1;   // the row stride: odd, so a column's lanes hit distinct banks
constexpr int SOLVE_STRIDE = MAX_N * SOLVE_P;   // floats per env

// The solve: a warp per env, the block's matrices staged in shared memory.
__global__ void __launch_bounds__(SOLVE_ENVS * WARP)
chol_solve_kernel(const float* __restrict__ M, const float* __restrict__ b,
                  float* __restrict__ x, int N, int n) {
  __shared__ float S[SOLVE_ENVS * SOLVE_STRIDE];
  const int first = blockIdx.x * SOLVE_ENVS;
  const int envs = min(SOLVE_ENVS, N - first);
  const int nn = n * n, total = envs * nn;
  const float inv_nn = 1.0f / nn, inv_n = 1.0f / n;
  const float* src = M + static_cast<long long>(first) * nn;
  // entry s of the block's matrices into its env's rows, if it is on or
  // below the diagonal (the quotients in float: exact for s < 2^22, since
  // s + 0.5 sits 0.5 / nn inside its interval)
  auto put = [&](int s, float v) {
    const int e = static_cast<int>((s + 0.5f) * inv_nn), r = s - e * nn;
    const int i = static_cast<int>((r + 0.5f) * inv_n), j = r - i * n;
    if (j <= i) S[e * SOLVE_STRIDE + i * SOLVE_P + j] = v;
  };
  int s0 = 0;
  if ((reinterpret_cast<unsigned long long>(src) & 15u) == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int q = threadIdx.x; q < total / 4; q += blockDim.x) {
      const float4 v = src4[q];
      put(4 * q, v.x);
      put(4 * q + 1, v.y);
      put(4 * q + 2, v.z);
      put(4 * q + 3, v.w);
    }
    s0 = total / 4 * 4;
  }
  for (int s = s0 + threadIdx.x; s < total; s += blockDim.x) put(s, src[s]);
  __syncthreads();
  const int w = threadIdx.x / WARP;
  if (w >= envs) return;   // a whole warp past N: no later sync waits for it
  const long long e = first + w;
  solve_lanes<WARP, SOLVE_P>(S + w * SOLVE_STRIDE, b + e * n, x + e * n, n, threadIdx.x % WARP);
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
  chol_solve_kernel<<<(N + SOLVE_ENVS - 1) / SOLVE_ENVS, SOLVE_ENVS * WARP, 0,
                      static_cast<cudaStream_t>(stream)>>>(M, b, x, N, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int linalg_max_n() { return MAX_N; }

extern "C" int chol_solve_envs_per_block() { return SOLVE_ENVS; }

#endif
