"""RobotModel: the static, compiled description of an articulated robot.

A numpy copy of the reference package's physics/model.py. The URDF
compiler (urdf.py) produces it once on the host; fixed joints are collapsed
at compile time, so the runtime tree is just base + actuated links. The
torch physics turns the arrays it needs into tensors on its device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Compiled kinematic/dynamic model.

    Bodies are indexed 0..nb-1 with 0 = floating base; joint j connects
    parent[j+1] -> body j+1, so dof j maps to body j+1. Arrays are numpy on
    purpose: the model is static host data.
    """

    # topology
    nb: int                      # number of bodies (base + actuated links)
    nv: int                      # generalized velocity dim (6 + nj)
    nj: int                      # actuated joint count
    parent: np.ndarray           # (nb,) int, parent body index, -1 for base
    body_names: Tuple[str, ...]
    joint_names: Tuple[str, ...]

    # per-joint fixed transform (parent link frame -> joint frame), composed
    # across any collapsed fixed joints. rot is a 3x3 matrix.
    joint_pos: np.ndarray        # (nj, 3)
    joint_rot: np.ndarray        # (nj, 3, 3)
    joint_axis: np.ndarray       # (nj, 3) axis in the child (joint) frame

    # per-body inertial params in the body's own frame (after merging all
    # fixed-joint descendants)
    mass: np.ndarray             # (nb,)
    com: np.ndarray              # (nb, 3)
    inertia: np.ndarray          # (nb, 3, 3) about com, body frame

    # joint limits (from URDF, before safety factors)
    dof_lower: np.ndarray        # (nj,)
    dof_upper: np.ndarray        # (nj,)
    dof_effort: np.ndarray       # (nj,)
    dof_velocity: np.ndarray     # (nj,)
    dof_armature: np.ndarray     # (nj,)
    dof_damping: np.ndarray      # (nj,)

    # collision model: named body sets + foot geometry
    foot_bodies: Tuple[int, ...]      # body indices whose name contains foot_name
    knee_bodies: Tuple[int, ...]
    foot_box_size: np.ndarray         # (3,) foot collision bbox (link frame)
    foot_box_offset: np.ndarray       # (3,) bbox center in the foot link frame
    foot_corners: np.ndarray          # (n_feet, 4, 3) sole corners, link frame
    # proxy collision spheres for termination/collision bodies (base etc.):
    # (body_index, offset_xyz, radius) rows
    term_sphere_body: np.ndarray      # (nt,) int
    term_sphere_offset: np.ndarray    # (nt, 3)
    term_sphere_radius: np.ndarray    # (nt,)

    # world orientation of every body at the zero pose (identity base), used
    # to orient collision geometry whose link frames are not world-aligned
    body_zero_rot: np.ndarray  # (nb, 3, 3)

    gravity: float = -9.81

    @property
    def total_mass(self) -> float:
        return float(self.mass.sum())

    def contact_points(self) -> Tuple[np.ndarray, np.ndarray]:
        """Foot contact point set: 4 sole corners per foot, derived at
        compile time from the foot link's collision-mesh bbox face that
        points world-down at the zero pose (urdf.py).

        Returns (body_idx (P,), offsets (P,3)) in the foot link frame."""
        bodies = np.repeat(
            np.array(self.foot_bodies, dtype=np.int32), 4
        )
        return bodies, self.foot_corners.reshape(-1, 3)

    def ancestor_matrix(self) -> np.ndarray:
        """(nb, nj) 1.0 where joint j is on the path base->body b."""
        anc = np.zeros((self.nb, self.nj), dtype=np.float64)
        for b in range(1, self.nb):
            p = b
            while p > 0:
                anc[b, p - 1] = 1.0
                p = int(self.parent[p])
        return anc
