"""Terrain synthesis: a heightfield grid of curriculum sub-terrains.

Copy of the reference package's env/terrain.py (numpy only), so that the
port imports nothing of that package. Given the same TerrainCfg and seed it
gives the same `height` and `env_origins`, bit for bit
(tests/test_torch_terrain.py). It produces:

  * a global float heightfield (metres) whose values are int16 counts of
    `vertical_scale`, sampled by physics/contact.py::Terrain and by the
    heightfield sampler (ops/terrain_sampler.py),
  * per-cell env origins with the platform-max rule,
  * the (num_rows x num_cols) level/type grid of the game curriculum.

Generation happens once on the host at env construction.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from ..config.structs import TerrainCfg


class SubTerrain:
    def __init__(self, size_px: int, horizontal_scale: float,
                 vertical_scale: float):
        self.size = size_px
        self.horizontal_scale = horizontal_scale
        self.vertical_scale = vertical_scale
        self.height_field_raw = np.zeros((size_px, size_px), dtype=np.int16)

    @property
    def width_m(self) -> float:
        return self.size * self.horizontal_scale


def random_uniform_terrain(t: SubTerrain, min_height, max_height, step=0.005,
                           downsampled_scale=0.2, rng=None):
    rng = rng or np.random
    heights_range = np.arange(min_height, max_height + step, step)
    n_down = max(2, int(t.width_m / downsampled_scale))
    low = rng.choice(heights_range, (n_down, n_down)) / t.vertical_scale
    # bilinear upsample to the full grid
    xi = np.linspace(0, n_down - 1, t.size)
    x0 = np.clip(xi.astype(int), 0, n_down - 2)
    fx = xi - x0
    rows = (
        low[x0] * (1 - fx)[:, None] + low[x0 + 1] * fx[:, None]
    )
    cols = (
        rows[:, x0] * (1 - fx)[None, :] + rows[:, x0 + 1] * fx[None, :]
    )
    t.height_field_raw += cols.astype(np.int16)
    return t


def pyramid_sloped_terrain(t: SubTerrain, slope, platform_size=1.0):
    n = t.size
    x = np.arange(n)
    center = (n - 1) / 2
    # distance-to-edge pyramid: 0 at the border, peaks at the center
    dist = np.minimum(
        np.minimum(x, n - 1 - x)[:, None],
        np.minimum(x, n - 1 - x)[None, :],
    ).astype(np.float64)
    max_h = slope * (n / 2) * t.horizontal_scale / t.vertical_scale
    h = dist / center * max_h
    # flatten the central platform at its rim height
    plat_px = int(platform_size / t.horizontal_scale / 2)
    plat_dist = center - plat_px
    h = np.minimum(h, plat_dist / center * max_h) if slope >= 0 else np.maximum(
        h, plat_dist / center * max_h
    )
    t.height_field_raw += h.astype(np.int16)
    return t


def pyramid_stairs_terrain(t: SubTerrain, step_width, step_height,
                           platform_size=1.0):
    n = t.size
    step_px = max(1, int(step_width / t.horizontal_scale))
    h_px = step_height / t.vertical_scale
    plat_px = int(platform_size / t.horizontal_scale / 2)
    x = np.arange(n)
    dist = np.minimum(
        np.minimum(x, n - 1 - x)[:, None],
        np.minimum(x, n - 1 - x)[None, :],
    )
    ring = dist // step_px
    max_ring = max(0, (n // 2 - plat_px) // step_px)
    ring = np.minimum(ring, max_ring)
    t.height_field_raw += (ring * h_px).astype(np.int16)
    return t


def discrete_obstacles_terrain(t: SubTerrain, max_height, min_size, max_size,
                               num_rects, platform_size=1.0, rng=None):
    rng = rng or np.random
    h_choices = [-max_height, -max_height / 2, max_height / 2, max_height]
    for _ in range(num_rects):
        w = int(rng.uniform(min_size, max_size) / t.horizontal_scale)
        l = int(rng.uniform(min_size, max_size) / t.horizontal_scale)
        x = rng.randint(0, max(1, t.size - w))
        y = rng.randint(0, max(1, t.size - l))
        h = rng.choice(h_choices) / t.vertical_scale
        t.height_field_raw[x : x + w, y : y + l] = int(h)
    # flat central platform
    p = int(platform_size / t.horizontal_scale / 2)
    c = t.size // 2
    t.height_field_raw[c - p : c + p, c - p : c + p] = 0
    return t


def stepping_stones_terrain(t: SubTerrain, stone_size, stone_distance,
                            max_height=0.0, platform_size=1.0, depth=-10.0,
                            rng=None):
    rng = rng or np.random
    stone_px = max(1, int(stone_size / t.horizontal_scale))
    dist_px = max(0, int(stone_distance / t.horizontal_scale))
    t.height_field_raw[:] = int(depth / t.vertical_scale)
    period = stone_px + dist_px
    hmax = int(max_height / t.vertical_scale)
    for x0 in range(0, t.size, period):
        for y0 in range(0, t.size, period):
            h = rng.randint(-hmax, hmax + 1) if hmax > 0 else 0
            t.height_field_raw[x0 : x0 + stone_px, y0 : y0 + stone_px] = h
    p = int(platform_size / t.horizontal_scale / 2)
    c = t.size // 2
    t.height_field_raw[c - p : c + p, c - p : c + p] = 0
    return t


def gap_terrain(t: SubTerrain, gap_size, platform_size=1.0):
    gap_px = int(gap_size / t.horizontal_scale)
    plat_px = int(platform_size / t.horizontal_scale)
    c = t.size // 2
    x1 = (t.size - plat_px) // 2
    x2 = x1 + gap_px
    t.height_field_raw[c - x2 : c + x2, c - x2 : c + x2] = -1000
    t.height_field_raw[c - x1 : c + x1, c - x1 : c + x1] = 0
    return t


def pit_terrain(t: SubTerrain, depth, platform_size=1.0):
    d = int(depth / t.vertical_scale)
    p = int(platform_size / t.horizontal_scale / 2)
    x1, x2 = t.size // 2 - p, t.size // 2 + p
    t.height_field_raw[x1:x2, x1:x2] = -d
    return t


class TerrainWorld(NamedTuple):
    """Everything the env needs from generated terrain."""
    height: np.ndarray          # (H, W) float meters
    horizontal_scale: float
    border: float               # meters
    env_origins: np.ndarray     # (num_rows, num_cols, 3)
    num_rows: int
    num_cols: int
    terrain_length: float


def humanoid_make_terrain(cfg: TerrainCfg, choice: float, difficulty: float,
                          size_px: int, rng) -> SubTerrain:
    """HumanoidTerrain.make_terrain (terrain.py:200-231): gentler set —
    [flat, discrete obstacles, rough, slope up, slope down, stairs up,
    stairs down, uneven, flat] selected by cumulative proportions.

    Slot 8 ("uneven") is our extension past the reference generator set:
    long-wavelength rough terrain with the statistics of the reference's
    own deployment oracle (XBot-L-terrain.xml + terrain/uneven.png —
    independent uniform node heights spanning 0.35 m on a ~1 m lattice,
    MuJoCo-normalized to size="50 50 0.35"). The reference's rough
    primitive (±0.07·d at 0.2 m wavelength) never produces that spectrum,
    which is why round-3 terrain policies walked the curriculum but fell
    within 2 s on the terrain MJCF; at difficulty 0.9 this slot reaches
    ±0.18 m (0.36 m range) at 1 m wavelength — the oracle's amplitude."""
    t = SubTerrain(size_px, cfg.horizontal_scale, cfg.vertical_scale)
    props = np.cumsum(cfg.terrain_proportions)
    obstacle_h = difficulty * 0.04
    r_height = difficulty * 0.07
    h_slope = difficulty * 0.15
    u_height = difficulty * cfg.uneven_amplitude
    if choice < props[0]:
        pass  # flat
    elif len(props) > 1 and choice < props[1]:
        discrete_obstacles_terrain(t, obstacle_h, 1.0, 2.0, 20,
                                   platform_size=3.0, rng=rng)
    elif len(props) > 2 and choice < props[2]:
        random_uniform_terrain(t, -r_height, r_height, rng=rng)
    elif len(props) > 3 and choice < props[3]:
        pyramid_sloped_terrain(t, h_slope, platform_size=0.1)
    elif len(props) > 4 and choice < props[4]:
        pyramid_sloped_terrain(t, -h_slope, platform_size=0.1)
    elif len(props) > 5 and choice < props[5]:
        pyramid_stairs_terrain(t, 0.4, obstacle_h, platform_size=1.0)
    elif len(props) > 6 and choice < props[6]:
        pyramid_stairs_terrain(t, 0.4, -obstacle_h, platform_size=1.0)
    elif len(props) > 7 and choice < props[7]:
        random_uniform_terrain(t, -u_height, u_height, step=0.005,
                               downsampled_scale=1.0, rng=rng)
    return t


def base_make_terrain(cfg: TerrainCfg, choice: float, difficulty: float,
                      size_px: int, rng) -> SubTerrain:
    """The generic base-Terrain.make_terrain set (terrain.py:110-143):
    difficulty-scaled slopes, rough slopes, stairs, discrete obstacles,
    stepping stones, gap, pit — pit is the remainder past the last
    proportion, exactly like the reference's trailing `else`."""
    t = SubTerrain(size_px, cfg.horizontal_scale, cfg.vertical_scale)
    props = np.cumsum(cfg.terrain_proportions)
    slope = difficulty * 0.4
    step_height = 0.05 + 0.18 * difficulty
    discrete_obstacles_height = 0.05 + difficulty * 0.2
    stepping_stones_size = 1.5 * (1.05 - difficulty)
    stone_distance = 0.05 if difficulty == 0 else 0.1
    gap_size = 1.0 * difficulty
    pit_depth = 1.0 * difficulty
    if choice < props[0]:
        if choice < props[0] / 2:
            slope *= -1
        pyramid_sloped_terrain(t, slope, platform_size=3.0)
    elif len(props) > 1 and choice < props[1]:
        pyramid_sloped_terrain(t, slope, platform_size=3.0)
        random_uniform_terrain(t, -0.05, 0.05, step=0.005,
                               downsampled_scale=0.2, rng=rng)
    elif len(props) > 3 and choice < props[3]:
        if choice < props[2]:
            step_height *= -1
        pyramid_stairs_terrain(t, 0.31, step_height, platform_size=3.0)
    elif len(props) > 4 and choice < props[4]:
        discrete_obstacles_terrain(t, discrete_obstacles_height, 1.0, 2.0,
                                   20, platform_size=3.0, rng=rng)
    elif len(props) > 5 and choice < props[5]:
        stepping_stones_terrain(t, stepping_stones_size, stone_distance,
                                max_height=0.0, platform_size=4.0, rng=rng)
    elif len(props) > 6 and choice < props[6]:
        gap_terrain(t, gap_size, platform_size=3.0)
    else:
        pit_terrain(t, pit_depth, platform_size=4.0)
    return t


def selected_make_terrain(cfg: TerrainCfg, name: str, difficulty: float,
                          size_px: int, rng) -> SubTerrain:
    """Selected-terrain mode (terrain.py:95-107): every cell is the named
    primitive at the given difficulty (the reference eval()'s a type string
    from terrain_kwargs; we use an explicit name table)."""
    t = SubTerrain(size_px, cfg.horizontal_scale, cfg.vertical_scale)
    d = difficulty
    if name == "flat":
        pass
    elif name == "rough":
        random_uniform_terrain(t, -0.05 - 0.05 * d, 0.05 + 0.05 * d, rng=rng)
    elif name == "slope":
        pyramid_sloped_terrain(t, 0.4 * d, platform_size=3.0)
    elif name == "stairs":
        pyramid_stairs_terrain(t, 0.31, 0.05 + 0.18 * d, platform_size=3.0)
    elif name == "discrete":
        discrete_obstacles_terrain(t, 0.05 + 0.2 * d, 1.0, 2.0, 20,
                                   platform_size=3.0, rng=rng)
    elif name == "stepping_stones":
        stepping_stones_terrain(t, 1.5 * (1.05 - d), 0.1, max_height=0.0,
                                platform_size=4.0, rng=rng)
    elif name == "gap":
        gap_terrain(t, 1.0 * d, platform_size=3.0)
    elif name == "pit":
        pit_terrain(t, 1.0 * d, platform_size=4.0)
    elif name == "uneven":
        # the deployment oracle's spectrum (uneven.png: ~1 m lattice,
        # 0.35 m range at full difficulty) — see humanoid_make_terrain
        random_uniform_terrain(t, -cfg.uneven_amplitude * d,
                               cfg.uneven_amplitude * d, step=0.005,
                               downsampled_scale=1.0, rng=rng)
    else:
        raise ValueError(f"unknown selected terrain type {name!r}")
    return t


def build_terrain(cfg: TerrainCfg, seed: int = 0) -> TerrainWorld:
    """Curriculum grid: difficulty = row / num_rows, type = column
    (terrain.py:86-93), with the generator set picked by
    cfg.generator_set ("humanoid" | "base") or a forced cfg.selected_type.
    Randomized (non-curriculum) mode draws difficulty from the base set's
    {0.5, 0.75, 0.9} (terrain.py:79-81) when generator_set == "base"."""
    rng = np.random.RandomState(seed)
    size_px = int(cfg.terrain_length / cfg.horizontal_scale)
    border_px = int(cfg.border_size / cfg.horizontal_scale)
    H = cfg.num_rows * size_px + 2 * border_px
    W = cfg.num_cols * size_px + 2 * border_px
    field = np.zeros((H, W), dtype=np.float64)
    origins = np.zeros((cfg.num_rows, cfg.num_cols, 3))
    for j in range(cfg.num_cols):
        for i in range(cfg.num_rows):
            if cfg.curriculum:
                difficulty = i / cfg.num_rows
                choice = j / cfg.num_cols + 0.001
            elif cfg.generator_set == "base":
                difficulty = rng.choice([0.5, 0.75, 0.9])
                choice = rng.uniform(0, 1)
            else:
                difficulty = rng.uniform(0, 1)
                choice = rng.uniform(0, 1)
            if cfg.selected_type:
                t = selected_make_terrain(
                    cfg, cfg.selected_type, difficulty, size_px, rng
                )
            elif cfg.generator_set == "base":
                t = base_make_terrain(cfg, choice, difficulty, size_px, rng)
            else:
                t = humanoid_make_terrain(cfg, choice, difficulty, size_px,
                                          rng)
            x0 = border_px + i * size_px
            y0 = border_px + j * size_px
            field[x0 : x0 + size_px, y0 : y0 + size_px] = (
                t.height_field_raw * cfg.vertical_scale
            )
            # origin: center of the cell, z = max height within the central
            # 2x2 m patch (terrain.py:163-169)
            cx = (i + 0.5) * cfg.terrain_length
            cy = (j + 0.5) * cfg.terrain_length
            r0 = int((cfg.terrain_length / 2 - 1) / cfg.horizontal_scale)
            r1 = int((cfg.terrain_length / 2 + 1) / cfg.horizontal_scale)
            z = np.max(t.height_field_raw[r0:r1, r0:r1]) * cfg.vertical_scale
            origins[i, j] = [cx, cy, z]
    return TerrainWorld(
        height=field,
        horizontal_scale=cfg.horizontal_scale,
        border=cfg.border_size,
        env_origins=origins,
        num_rows=cfg.num_rows,
        num_cols=cfg.num_cols,
        terrain_length=cfg.terrain_length,
    )
