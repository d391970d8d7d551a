"""URDF -> RobotModel compiler (host-side, one-time).

A numpy copy of the reference package's physics/urdf.py: fixed joints are
collapsed at compile time by merging child inertias into the nearest movable
ancestor, producing a minimal tree (floating base + actuated links).
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence

import numpy as np

from .model import RobotModel


def _rpy_to_mat(rpy: np.ndarray) -> np.ndarray:
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    return np.array(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ]
    )


def _parse_vec(s: Optional[str], default="0 0 0") -> np.ndarray:
    return np.array([float(x) for x in (s or default).split()])


class _Link:
    def __init__(self, el: ET.Element):
        self.name = el.get("name")
        self.mass = 0.0
        self.com = np.zeros(3)
        self.inertia = np.zeros((3, 3))
        inert = el.find("inertial")
        if inert is not None:
            origin = inert.find("origin")
            xyz = _parse_vec(origin.get("xyz") if origin is not None else None)
            rpy = _parse_vec(origin.get("rpy") if origin is not None else None)
            self.mass = float(inert.find("mass").get("value"))
            iel = inert.find("inertia")
            ixx, ixy, ixz = (float(iel.get(k, "0")) for k in ("ixx", "ixy", "ixz"))
            iyy, iyz, izz = (float(iel.get(k, "0")) for k in ("iyy", "iyz", "izz"))
            I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
            R = _rpy_to_mat(rpy)
            self.com = xyz
            self.inertia = R @ I @ R.T  # about com, link frame
        # first box collision, if any
        self.box_size = None
        self.box_offset = None
        for col in el.findall("collision"):
            box = col.find("geometry/box")
            if box is not None:
                self.box_size = _parse_vec(box.get("size"))
                origin = col.find("origin")
                self.box_offset = _parse_vec(
                    origin.get("xyz") if origin is not None else None
                )
                break
        # mesh filename (collision preferred, else visual) for bbox-derived
        # contact geometry
        self.mesh_file = None
        for tag in ("collision", "visual"):
            for el2 in el.findall(tag):
                mesh = el2.find("geometry/mesh")
                if mesh is not None and self.mesh_file is None:
                    self.mesh_file = mesh.get("filename")


class _Joint:
    def __init__(self, el: ET.Element):
        self.name = el.get("name")
        self.type = el.get("type")
        self.parent = el.find("parent").get("link")
        self.child = el.find("child").get("link")
        origin = el.find("origin")
        self.xyz = _parse_vec(origin.get("xyz") if origin is not None else None)
        self.rpy = _parse_vec(origin.get("rpy") if origin is not None else None)
        axis = el.find("axis")
        self.axis = _parse_vec(axis.get("xyz") if axis is not None else "1 0 0")
        n = np.linalg.norm(self.axis)
        if n > 0:
            self.axis = self.axis / n
        lim = el.find("limit")
        self.lower = float(lim.get("lower", "0")) if lim is not None else 0.0
        self.upper = float(lim.get("upper", "0")) if lim is not None else 0.0
        self.effort = float(lim.get("effort", "0")) if lim is not None else 0.0
        self.velocity = float(lim.get("velocity", "0")) if lim is not None else 0.0
        dyn = el.find("dynamics")
        self.damping = float(dyn.get("damping", "0")) if dyn is not None else 0.0

    @property
    def rot(self) -> np.ndarray:
        return _rpy_to_mat(self.rpy)


def _stl_bounds(path: str):
    """Axis-aligned bounding box of an STL mesh (binary or ASCII)."""
    import struct

    with open(path, "rb") as f:
        header = f.read(80)
        rest = f.read()
    if header[:5] == b"solid" and b"facet" in rest[:200]:
        verts = []
        for line in rest.decode("ascii", "ignore").splitlines():
            t = line.split()
            if t[:1] == ["vertex"]:
                verts.append([float(x) for x in t[1:4]])
        v = np.array(verts)
    else:
        n = struct.unpack("<I", rest[:4])[0]
        data = np.frombuffer(rest[4 : 4 + n * 50], dtype=np.uint8)
        v = data.reshape(n, 50)[:, 12:48].copy().view("<f4").reshape(-1, 3)
    return v.min(axis=0), v.max(axis=0)


def load_urdf(
    path: str,
    joint_order: Optional[Sequence[str]] = None,
    foot_name: str = "ankle_roll",
    knee_name: str = "knee",
    terminate_on: Sequence[str] = ("base_link",),
    armature: float = 0.0,
) -> RobotModel:
    """Compile a URDF into a RobotModel.

    joint_order: explicit dof ordering (must be topologically valid per
    chain); defaults to document order of movable joints. This pins the dof
    layout to the reference's config order
    (humanoid_config.py:199-218 of the upstream task).
    """
    root = ET.parse(path).getroot()
    links: Dict[str, _Link] = {}
    for el in root.findall("link"):
        links[el.get("name")] = _Link(el)
    joints: List[_Joint] = [_Joint(el) for el in root.findall("joint")]

    child_of = {j.child: j for j in joints}
    root_link = next(name for name in links if name not in child_of)

    movable = [j for j in joints if j.type in ("revolute", "continuous")]
    for j in joints:
        if j.type not in ("revolute", "continuous", "fixed"):
            raise NotImplementedError(f"joint type {j.type} not supported")
    if joint_order is not None:
        by_name = {j.name: j for j in movable}
        movable = [by_name[n] for n in joint_order]

    # ------------------------------------------------------------------
    # Assign every link to its owning movable body; compute the transform
    # (owner frame -> link frame) by composing fixed-joint origins.
    # ------------------------------------------------------------------
    movable_children = {j.child for j in movable}

    def owner_and_xform(link_name: str):
        """Walk up fixed joints until hitting a movable child link or root."""
        R = np.eye(3)
        p = np.zeros(3)
        name = link_name
        while name != root_link and name not in movable_children:
            j = child_of[name]
            # T_parent<-link = T_parent<-child ∘ T_child<-link
            p = j.xyz + j.rot @ p
            R = j.rot @ R
            name = j.parent
        return name, R, p

    # body list: 0 = base (root link cluster), then movable joints in order
    body_names = [root_link] + [j.child for j in movable]
    body_index = {n: i for i, n in enumerate(body_names)}
    nb = len(body_names)
    nj = len(movable)

    # merge inertias of every link into its owner
    agg_mass = np.zeros(nb)
    agg_mcom = np.zeros((nb, 3))
    merged = {i: [] for i in range(nb)}  # (mass, com_in_owner, I_in_owner)
    for name, link in links.items():
        owner, R, p = owner_and_xform(name)
        oi = body_index[owner]
        com_o = p + R @ link.com
        I_o = R @ link.inertia @ R.T
        merged[oi].append((link.mass, com_o, I_o))
        agg_mass[oi] += link.mass
        agg_mcom[oi] += link.mass * com_o

    mass = agg_mass
    com = np.where(mass[:, None] > 0, agg_mcom / np.maximum(mass[:, None], 1e-12), 0.0)
    inertia = np.zeros((nb, 3, 3))
    for i in range(nb):
        for m, c, I in merged[i]:
            d = c - com[i]
            inertia[i] += I + m * ((d @ d) * np.eye(3) - np.outer(d, d))

    # ------------------------------------------------------------------
    # Joint frames: composed transform from the parent body's frame
    # ------------------------------------------------------------------
    parent = np.full(nb, -1, dtype=np.int32)
    joint_pos = np.zeros((nj, 3))
    joint_rot = np.zeros((nj, 3, 3))
    joint_axis = np.zeros((nj, 3))
    lower = np.zeros(nj)
    upper = np.zeros(nj)
    effort = np.zeros(nj)
    velocity = np.zeros(nj)
    damping = np.zeros(nj)
    for k, j in enumerate(movable):
        owner, R, p = owner_and_xform(j.parent)
        parent[k + 1] = body_index[owner]
        # owner -> parent-link is (R, p); parent-link -> joint/child is (j.rot, j.xyz)
        joint_rot[k] = R @ j.rot
        joint_pos[k] = p + R @ j.xyz
        joint_axis[k] = j.axis
        lower[k], upper[k] = j.lower, j.upper
        effort[k], velocity[k] = j.effort, j.velocity
        damping[k] = j.damping

    # sanity: chains must be topologically ordered
    for k in range(nj):
        assert parent[k + 1] <= k, (
            f"joint_order not topological at {movable[k].name}"
        )

    # zero-pose world orientations (base identity, all q = 0)
    body_zero_rot = np.zeros((nb, 3, 3))
    body_zero_rot[0] = np.eye(3)
    for k in range(nj):
        body_zero_rot[k + 1] = body_zero_rot[parent[k + 1]] @ joint_rot[k]

    foot_bodies = tuple(
        i for i, n in enumerate(body_names) if foot_name in n
    )
    knee_bodies = tuple(i for i, n in enumerate(body_names) if knee_name in n)

    # Foot collision geometry: bounding box of the foot link's mesh (the
    # XBot URDF's hand-written foot box is degenerate — 2 cm fore-aft — while
    # MuJoCo, the sim2sim oracle, collides the actual mesh whose sole is
    # 5.6 cm below the ankle_roll frame). Contact points = 4 corners of the
    # bbox face that points world-down at the zero pose.
    foot_box_size = np.array([0.16, 0.07, 0.02])
    foot_box_offset = np.zeros(3)
    foot_corners = np.zeros((len(foot_bodies), 4, 3))
    for fi, fb in enumerate(foot_bodies):
        link = links[body_names[fb]]
        lo, hi = None, None
        if link.mesh_file is not None:
            mesh_path = os.path.normpath(
                os.path.join(os.path.dirname(path), link.mesh_file)
            )
            if os.path.exists(mesh_path):
                lo, hi = _stl_bounds(mesh_path)
        if lo is None and link.box_size is not None:
            lo = link.box_offset - link.box_size / 2
            hi = link.box_offset + link.box_size / 2
        assert lo is not None, f"no collision geometry for {body_names[fb]}"
        foot_box_size = hi - lo
        foot_box_offset = (hi + lo) / 2
        # link-frame direction pointing world-down at zero pose; the sole is
        # the bbox face maximizing p . down
        down = body_zero_rot[fb].T @ np.array([0.0, 0.0, -1.0])
        ax = int(np.argmax(np.abs(down)))
        others = [a for a in range(3) if a != ax]
        corners = []
        for s0 in (lo[others[0]], hi[others[0]]):
            for s1 in (lo[others[1]], hi[others[1]]):
                c = np.zeros(3)
                c[ax] = hi[ax] if down[ax] > 0 else lo[ax]
                c[others[0]] = s0
                c[others[1]] = s1
                corners.append(c)
        foot_corners[fi] = np.array(corners)

    # termination proxy spheres from the named bodies' collision boxes
    ts_body, ts_off, ts_rad = [], [], []
    for pat in terminate_on:
        for i, n in enumerate(body_names):
            if pat in n:
                l = links.get(n)
                if l is not None and l.box_size is not None:
                    ts_body.append(i)
                    ts_off.append(l.box_offset)
                    ts_rad.append(0.5 * float(np.min(l.box_size)))
                else:
                    ts_body.append(i)
                    ts_off.append(np.zeros(3))
                    ts_rad.append(0.15)

    return RobotModel(
        nb=nb,
        nv=6 + nj,
        nj=nj,
        parent=parent,
        body_names=tuple(body_names),
        joint_names=tuple(j.name for j in movable),
        joint_pos=joint_pos,
        joint_rot=joint_rot,
        joint_axis=joint_axis,
        mass=mass,
        com=com,
        inertia=inertia,
        dof_lower=lower,
        dof_upper=upper,
        dof_effort=effort,
        dof_velocity=velocity,
        dof_armature=np.full(nj, armature),
        dof_damping=damping,
        foot_bodies=foot_bodies,
        knee_bodies=knee_bodies,
        foot_box_size=np.asarray(foot_box_size),
        foot_box_offset=np.asarray(foot_box_offset),
        foot_corners=foot_corners,
        term_sphere_body=np.array(ts_body, dtype=np.int32),
        term_sphere_offset=np.array(ts_off) if ts_off else np.zeros((0, 3)),
        term_sphere_radius=np.array(ts_rad),
        body_zero_rot=body_zero_rot,
    )
