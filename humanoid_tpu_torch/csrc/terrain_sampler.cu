// The heightfield sampler as one CUDA kernel.
//
// Replaces the TPU kernel humanoid_tpu/ops/terrain_kernel.py::_sampler_kernel
// (built by build_sampler, wrapped by TerrainSampler). Every control step
// of a heightfield task needs, per env, the min3 height under each of the
// 187 height-scan points (the critic's height scan) and the 4 corner
// heights and in-cell lerp parameters under each contact point (the next
// step's contact planes). The TPU kernel fetched one int16 tile per env
// and picked heights out with one-hot matmuls, because a gather is slow
// there; on Hopper a gather is a plain load, so this kernel reads the
// int16 raster directly.
//
// Design: one thread per (env, point). Scan threads come first
// (n_scan = N * Ps of them), then contact threads (n_con = N * Pc). Each
// reads its world xy, does the cell math of physics/contact.py::Terrain
// (an IEEE division by the cell size, then floor and clip exactly as
// Terrain._corners and Terrain.sample_min3 do; no reciprocal, no fast
// math, so a floor never flips at a cell edge), and reads 3 or 4 int16
// counts. Heights leave as counts times vertical_scale in float32, the
// same product the reference sampler forms, so the two agree exactly.
//
// What bounds it: bytes. Per point it reads 8 bytes of coordinates and
// 6-8 bytes of raster (the 1300 x 2100 int16 raster, 5.5 MB, stays in the
// 50 MB L2) and writes 4 (scan) or 24 (contact) bytes; a handful of
// operations per point. Loads and stores of coordinates and outputs are
// coalesced; the raster loads are gathers.
//
// The per-point functions are __host__ __device__ so that a host compiler
// can check their arithmetic; the wrapper never runs them on the host.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__
#else
#include <cmath>
#define HD
#endif

struct SamplerGrid {
  int H, W;          // raster rows (x) and columns (y)
  float border;      // metres
  float hs;          // metres per cell
  float vs;          // metres per count
  float fx_max;      // H - 1.001 and W - 1.001: the contact clip of Terrain._corners
  float fy_max;
};

HD inline float clampf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }

HD inline int min3i(int a, int b, int c) {
  const int m = a < b ? a : b;
  return m < c ? m : c;
}

// Terrain.sample_min3 at world (x, y): min of cells (x0, y0), (x0+1, y0),
// (x0, y0+1), with floor(f) clipped to [0, H-2] x [0, W-2] (clipping f
// before the floor gives the same cell).
HD inline float scan_point(const int16_t* raster, const SamplerGrid& g, float x, float y) {
  const float fx = (x + g.border) / g.hs;
  const float fy = (y + g.border) / g.hs;
  const int x0 = static_cast<int>(floorf(clampf(fx, 0.0f, static_cast<float>(g.H - 2))));
  const int y0 = static_cast<int>(floorf(clampf(fy, 0.0f, static_cast<float>(g.W - 2))));
  const int16_t* r = raster + static_cast<long long>(x0) * g.W + y0;
  return static_cast<float>(min3i(r[0], r[g.W], r[1])) * g.vs;
}

// Terrain._corners at world (x, y): h00, h10, h01, h11 (metres), tx, ty.
HD inline void contact_point(const int16_t* raster, const SamplerGrid& g, float x, float y,
                             float out[6]) {
  const float fx = clampf((x + g.border) / g.hs, 0.0f, g.fx_max);
  const float fy = clampf((y + g.border) / g.hs, 0.0f, g.fy_max);
  const float x0f = floorf(fx), y0f = floorf(fy);
  const int16_t* r = raster + static_cast<long long>(x0f) * g.W + static_cast<int>(y0f);
  out[0] = static_cast<float>(r[0]) * g.vs;
  out[1] = static_cast<float>(r[g.W]) * g.vs;
  out[2] = static_cast<float>(r[1]) * g.vs;
  out[3] = static_cast<float>(r[g.W + 1]) * g.vs;
  out[4] = fx - x0f;
  out[5] = fy - y0f;
}

// Point i of the launch: scan point i (i < n_scan) or contact point
// i - n_scan. scan_xy (n_scan, 2), con_xy (n_con, 2); scan_h (n_scan,),
// corners (6, n_con).
HD inline void sample_point(const int16_t* raster, const SamplerGrid& g, long long i,
                            const float* scan_xy, long long n_scan, const float* con_xy,
                            long long n_con, float* scan_h, float* corners) {
  if (i < n_scan) {
    scan_h[i] = scan_point(raster, g, scan_xy[2 * i], scan_xy[2 * i + 1]);
    return;
  }
  const long long j = i - n_scan;
  float out[6];
  contact_point(raster, g, con_xy[2 * j], con_xy[2 * j + 1], out);
  for (int k = 0; k < 6; ++k) corners[k * n_con + j] = out[k];
}

#ifdef __CUDACC__

#define THREADS 256

__global__ void __launch_bounds__(THREADS)
terrain_sampler_kernel(const int16_t* __restrict__ raster, SamplerGrid g,
                       const float* __restrict__ scan_xy, long long n_scan,
                       const float* __restrict__ con_xy, long long n_con,
                       float* __restrict__ scan_h, float* __restrict__ corners) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_scan + n_con) return;
  sample_point(raster, g, i, scan_xy, n_scan, con_xy, n_con, scan_h, corners);
}

extern "C" int terrain_sample_launch(const int16_t* raster, int H, int W, float border,
                                     float hs, float vs, float fx_max, float fy_max,
                                     const float* scan_xy, long long n_scan,
                                     const float* con_xy, long long n_con, float* scan_h,
                                     float* corners, void* stream) {
  const long long total = n_scan + n_con;
  if (total == 0) return 0;
  const SamplerGrid g{H, W, border, hs, vs, fx_max, fy_max};
  const unsigned int blocks = static_cast<unsigned int>((total + THREADS - 1) / THREADS);
  terrain_sampler_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      raster, g, scan_xy, n_scan, con_xy, n_con, scan_h, corners);
  return static_cast<int>(cudaGetLastError());
}

#endif
