"""Non-flat MuJoCo oracles from the port's terrain generators: the reference
package's deploy/terrain_oracle.py.

The shipped XBot-L terrain MJCF (`XBot-L-terrain.xml`) stands the robot on
an hfield image (`terrain/uneven.png`). This module keeps that
independently written robot model and swaps the hfield image for a raster
synthesized by one of the port's terrain primitives
(env/terrain.selected_make_terrain: stairs, discrete obstacles, gaps, ...),
so that a policy trained on trimesh stairs can be replayed on a MuJoCo
stairs course, in a simulator it was not trained in.

MuJoCo normalizes hfield image data to [0, 1] and scales it by size[2]; the
riser of each stair becomes a one-cell (horizontal_scale) ramp under
bilinear hfield collision, the same smoothing the shipped uneven.png has.
The base MJCF comes from the asset root (assets.xbot_mjcf): without it,
FileNotFoundError.
"""
from __future__ import annotations

import os
import re

import numpy as np


def make_hfield_oracle(kind: str = "stairs", difficulty: float = 0.4,
                       size_m: float = 16.0, horizontal_scale: float = 0.1,
                       seed: int = 0) -> str:
    """Write `<prepared-dir>/oracle_<kind>_<difficulty>.xml` and its png;
    returns the xml path. The robot spawns on the primitive's central
    platform (the origin), so "stairs" is a descend-the-pyramid course."""
    from PIL import Image

    from ..assets import prepare_mujoco_xml, xbot_mjcf
    from ..config.structs import TerrainCfg
    from ..env.terrain import selected_make_terrain

    cfg = TerrainCfg(horizontal_scale=horizontal_scale, vertical_scale=0.005)
    size_px = int(size_m / horizontal_scale)
    rng = np.random.RandomState(seed)
    t = selected_make_terrain(cfg, kind, difficulty, size_px, rng)
    h = t.height_field_raw.astype(np.float64) * cfg.vertical_scale
    hmin = float(h.min())
    elev = max(float(h.max()) - hmin, 1e-3)
    img = np.round((h - hmin) / elev * 255.0).astype(np.uint8)

    xml_path = prepare_mujoco_xml(xbot_mjcf(terrain=True))
    d = os.path.dirname(xml_path)
    png = os.path.join(d, f"oracle_{kind}_{difficulty:g}.png")
    Image.fromarray(img).save(png)
    with open(xml_path) as f:
        xml = f.read()
    hf = (f'<hfield file="{png}" name="hf1" ncol="0" nrow="0" '
          f'size="{size_m / 2:g} {size_m / 2:g} {elev:.4f} 0.1" />')
    xml, n = re.subn(r'<hfield file="[^"]*" name="hf1"[^>]*/>', hf, xml)
    if n != 1:
        raise RuntimeError(f"{xml_path}: no hfield line named hf1 to replace")
    out = os.path.join(d, f"oracle_{kind}_{difficulty:g}.xml")
    with open(out, "w") as f:
        f.write(xml)
    return out


def parse_oracle_spec(spec: str):
    """"stairs:0.4" -> (kind, difficulty); a bare kind takes 0.4."""
    if ":" in spec:
        kind, diff = spec.split(":", 1)
        return kind, float(diff)
    return spec, 0.4
