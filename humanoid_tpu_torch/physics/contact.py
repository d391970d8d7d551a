"""Penalty contact for the termination proxy spheres, on a flat plane.
Port of the flat-plane parts of the reference package's physics/contact.py:
the PGS path keeps only the termination spheres on this compliant model
(they matter during falls only). Heightfield terrain is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


class ContactParams(NamedTuple):
    kn: float = 2.0e4       # normal stiffness [N/m]
    cn: float = 80.0        # normal damping [N s/m]
    v_reg: float = 0.05     # friction regularization velocity [m/s]


@dataclasses.dataclass(frozen=True)
class Terrain:
    """The ground. Only the flat plane z = 0 is ported."""
    flat: bool = True

    @staticmethod
    def plane() -> "Terrain":
        return Terrain(flat=True)

    def sample(self, xy):
        """Ground height at world xy (..., 2)."""
        return torch.zeros(xy.shape[:-1], dtype=xy.dtype, device=xy.device)


def _point_forces(pts, vels, heights, mu, params: ContactParams):
    """Penalty normal force + regularized Coulomb friction on the flat plane.

    pts/vels: (..., 3) world positions/velocities; heights: (...,) ground
    height; mu broadcasts against heights. Returns (force (..., 3),
    fn (...,) normal force magnitude)."""
    phi = pts[..., 2] - heights
    pen = (phi < 0.0).to(pts.dtype)
    fn = torch.clamp(-params.kn * phi - params.cn * vels[..., 2], min=0.0) * pen
    vt = vels[..., 0:2]
    speed = torch.sqrt(torch.sum(vt * vt, dim=-1) + params.v_reg ** 2)
    ft = -(mu * fn / speed)[..., None] * vt
    return torch.cat([ft, fn[..., None]], dim=-1), fn
