"""ctypes bindings for the C++ terrain synthesizer (terrain.cpp).

`build_terrain_native(cfg, seed)` builds the heightfield and trimesh worlds
of the port (utils/registry.py::build_env), as the reference package does
wherever g++ is present: the same TerrainWorld and curriculum layout
(difficulty = row / rows, type = column) as env/terrain.py::build_terrain.
The two agree in bits on the deterministic cells (flat, slopes, stairs);
the random cells (rough, discrete, stepping stones, gap, pit, uneven) draw
from the C++ generator's own RNG. env/terrain.py stays as the plain version
the tests hold this one against.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..config.structs import TerrainCfg
from ..env.terrain import TerrainWorld
from .build import load_library

_c_double_p = ctypes.POINTER(ctypes.c_double)
_c_int16_p = ctypes.POINTER(ctypes.c_int16)

# selected-terrain primitive ids (must match terrain.cpp selected_cell)
SELECTED_IDS = {
    "flat": 0, "rough": 1, "slope": 2, "stairs": 3, "discrete": 4,
    "stepping_stones": 5, "gap": 6, "pit": 7, "uneven": 8,
}


def _lib():
    lib = load_library("terrain")
    if not getattr(lib, "_sigs_set", False):
        lib.ht_build_world.argtypes = [
            _c_double_p, _c_double_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, _c_double_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
            ctypes.c_double,
        ]
        lib.ht_build_world.restype = None
        lib.ht_pyramid_slope.argtypes = [
            _c_int16_p, ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double,
        ]
        lib.ht_pyramid_slope.restype = None
        lib.ht_pyramid_stairs.argtypes = [
            _c_int16_p, ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ]
        lib.ht_pyramid_stairs.restype = None
        lib._sigs_set = True
    return lib


def pyramid_slope_native(n, hs, vs, slope, platform=1.0) -> np.ndarray:
    h = np.zeros((n, n), dtype=np.int16)
    _lib().ht_pyramid_slope(h.ctypes.data_as(_c_int16_p), n, hs, vs, slope, platform)
    return h


def pyramid_stairs_native(n, hs, vs, step_w, step_h, platform=1.0) -> np.ndarray:
    h = np.zeros((n, n), dtype=np.int16)
    _lib().ht_pyramid_stairs(h.ctypes.data_as(_c_int16_p), n, hs, vs, step_w, step_h,
                             platform)
    return h


def build_terrain_native(cfg: TerrainCfg, seed: int = 0) -> TerrainWorld:
    lib = _lib()
    size_px = int(cfg.terrain_length / cfg.horizontal_scale)
    border_px = int(cfg.border_size / cfg.horizontal_scale)
    H = cfg.num_rows * size_px + 2 * border_px
    W = cfg.num_cols * size_px + 2 * border_px
    field = np.zeros((H, W), dtype=np.float64)
    origins = np.zeros((cfg.num_rows, cfg.num_cols, 3), dtype=np.float64)
    props = np.asarray(cfg.terrain_proportions, dtype=np.float64)
    selected = SELECTED_IDS[cfg.selected_type] if cfg.selected_type else -1
    lib.ht_build_world(
        field.ctypes.data_as(_c_double_p),
        origins.ctypes.data_as(_c_double_p),
        cfg.num_rows, cfg.num_cols, size_px, border_px,
        cfg.horizontal_scale, cfg.vertical_scale, cfg.terrain_length,
        props.ctypes.data_as(_c_double_p), len(props),
        1 if cfg.curriculum else 0,
        1 if cfg.generator_set == "base" else 0, selected, seed,
        cfg.uneven_amplitude,
    )
    return TerrainWorld(
        height=field,
        horizontal_scale=cfg.horizontal_scale,
        border=cfg.border_size,
        env_origins=origins,
        num_rows=cfg.num_rows,
        num_cols=cfg.num_cols,
        terrain_length=cfg.terrain_length,
    )
