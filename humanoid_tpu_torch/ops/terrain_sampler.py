"""The heightfield sampler: its wrapper and plain version.

`TerrainSampler` gives, for every env, the height scan (the min3 height
under each scan point, Terrain.sample_min3) and the cell corners under
each contact point (h00, h10, h01, h11, tx, ty of Terrain._corners, for
Terrain.interp_from_corners). On a CUDA tensor it launches the
hand-written kernel csrc/terrain_sampler.cu, the port of
humanoid_tpu/ops/terrain_kernel.py::_sampler_kernel; on a CPU tensor it
runs `sample_plain`, the same gather in PyTorch indexing. There is no
fallback from one to the other.

The heightfield is held as int16 counts of `vertical_scale` (the values
the terrain generator writes are such counts), so a height is a count
times vertical_scale in float32, as in the reference sampler.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..physics.contact import corner_cells, min3_cells


def heightfield_counts(height_m, vertical_scale: float) -> np.ndarray:
    """The heightfield in metres as int16 counts of vertical_scale."""
    counts = np.round(np.asarray(height_m, dtype=np.float64) / vertical_scale)
    if np.abs(counts).max() >= 32000:
        raise ValueError("heightfield exceeds the int16 range of counts")
    return counts.astype(np.int16)


def sample_plain(raster, vertical_scale: float, horizontal_scale: float, border: float,
                 scan_xy, con_xy):
    """The plain version. raster (H, W) int16; scan_xy (N, Ps, 2) and
    con_xy (N, Pc, 2) world xy. Returns (scan_h (N, Ps),
    (h00, h10, h01, h11, tx, ty) each (N, Pc)), heights in metres."""
    vs = vertical_scale

    def at(x0, y0):
        return raster[x0, y0].to(torch.float32)

    sx, sy = min3_cells(raster.shape, border, horizontal_scale, scan_xy)
    scan_h = torch.minimum(torch.minimum(at(sx, sy), at(sx + 1, sy)), at(sx, sy + 1)) * vs
    fx, fy, x0, y0 = corner_cells(raster.shape, border, horizontal_scale, con_xy)
    corners = (at(x0, y0) * vs, at(x0 + 1, y0) * vs, at(x0, y0 + 1) * vs,
               at(x0 + 1, y0 + 1) * vs, fx - torch.floor(fx), fy - torch.floor(fy))
    return scan_h, corners


class TerrainSampler:
    """Wrapper of the sampler kernel for one heightfield.

    `launches` counts kernel launches (CUDA calls only). The library is
    built with nvcc at the first CUDA call; `build_info` then holds the
    build seconds and the ptxas report."""

    def __init__(self, height_m, vertical_scale: float, horizontal_scale: float,
                 border: float, device="cuda"):
        self.raster = torch.as_tensor(heightfield_counts(height_m, vertical_scale),
                                      device=device).contiguous()
        self.H, self.W = self.raster.shape
        self.vs = float(vertical_scale)
        self.hs = float(horizontal_scale)
        self.border = float(border)
        self.launches = 0
        self.build_info = None
        self._lib = None

    def build(self):
        """Build (or load) the kernel library; returns the ctypes handle."""
        if self._lib is None:
            from .build import build

            info = build("terrain_sampler.cu")
            lib = info.lib
            lib.terrain_sample_launch.restype = ctypes.c_int
            lib.terrain_sample_launch.argtypes = (
                [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_float] * 5
                + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong]
                + [ctypes.c_void_p] * 3)
            self.build_info = info
            self._lib = lib
        return self._lib

    def plain(self, scan_xy, con_xy):
        return sample_plain(self.raster.to(scan_xy.device), self.vs, self.hs, self.border,
                            scan_xy, con_xy)

    def __call__(self, scan_xy, con_xy):
        """scan_xy (N, Ps, 2), con_xy (N, Pc, 2) world xy. Returns
        (scan_h (N, Ps), (h00, h10, h01, h11, tx, ty) each (N, Pc))."""
        dev = scan_xy.device
        if dev.type == "cpu":
            return self.plain(scan_xy, con_xy)
        if dev.type != "cuda":
            raise ValueError(f"terrain sampler runs on cuda or cpu tensors, not {dev.type}")
        N = scan_xy.shape[0]
        for name, x in (("scan_xy", scan_xy), ("con_xy", con_xy)):
            if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous() \
                    or x.dim() != 3 or x.shape[0] != N or x.shape[2] != 2:
                raise ValueError(
                    f"{name}: need a contiguous float32 (N={N}, P, 2) tensor on {dev}, got "
                    f"{x.dtype} {tuple(x.shape)} on {x.device} (contiguous={x.is_contiguous()})")
        if self.raster.device != dev:
            raise ValueError(f"the heightfield lies on {self.raster.device}, the points on {dev}")
        Ps, Pc = scan_xy.shape[1], con_xy.shape[1]
        lib = self.build()
        scan_h = torch.empty((N, Ps), device=dev, dtype=torch.float32)
        corners = torch.empty((6, N, Pc), device=dev, dtype=torch.float32)
        err = lib.terrain_sample_launch(
            self.raster.data_ptr(), self.H, self.W, self.border, self.hs, self.vs,
            self.H - 1.001, self.W - 1.001, scan_xy.data_ptr(), N * Ps, con_xy.data_ptr(),
            N * Pc, scan_h.data_ptr(), corners.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"terrain_sampler_kernel launch failed: cudaError {err}")
        self.launches += 1
        return scan_h, tuple(corners.unbind(0))


def sample_bytes(n_scan: int, n_con: int, raster_cells: int) -> int:
    """Bytes one launch must move: world xy in (8 per point), heights out
    (4 per scan point, 24 per contact point), and each distinct raster
    cell the points touch read once (2 bytes)."""
    return 12 * n_scan + 32 * n_con + 2 * raster_cells


def touched_cells(raster, horizontal_scale: float, border: float, scan_xy, con_xy) -> int:
    """The number of distinct raster cells that one call on these points
    reads (3 per scan point, 4 per contact point, shared ones once)."""
    W = raster.shape[1]
    sx, sy = min3_cells(raster.shape, border, horizontal_scale, scan_xy)
    _, _, cx, cy = corner_cells(raster.shape, border, horizontal_scale, con_xy)
    ids = [sx * W + sy, (sx + 1) * W + sy, sx * W + sy + 1]
    ids += [(cx + dx) * W + cy + dy for dx in (0, 1) for dy in (0, 1)]
    return int(torch.unique(torch.cat([i.flatten() for i in ids])).numel())
