"""Robot assets of the port.

The XBot-L URDF is data that this repository does not ship. Until it does,
the port trains a stand-in that `write_xbot_topology_urdf` writes at run
time from the constants below: XBot-L's topology and widths (a floating
`base_link` and two 6-dof legs whose 12 revolute joints carry XBot-L's names
and order, box collision on both `*_ankle_roll_link`s) with humanoid-scale
masses, inertias and limits. It gives the model the shipping task's full
widths: nj=12, nb=13, nv=18, 47x15 actor and 73x3 critic observations.
Pass the real file with `--urdf PATH` once it is in the repository.
"""
from __future__ import annotations

import os

# Actuated dof order used everywhere (the upstream MuJoCo actuator order).
XBOT_JOINT_ORDER = (
    "left_leg_roll_joint",
    "left_leg_yaw_joint",
    "left_leg_pitch_joint",
    "left_knee_joint",
    "left_ankle_pitch_joint",
    "left_ankle_roll_joint",
    "right_leg_roll_joint",
    "right_leg_yaw_joint",
    "right_leg_pitch_joint",
    "right_knee_joint",
    "right_ankle_pitch_joint",
    "right_ankle_roll_joint",
)

TOPOLOGY_URDF_NAME = "xbot_topology.urdf"

# base: torso with the (fixed) arms folded in
_BASE_MASS = 19.0
_BASE_BOX = (0.22, 0.32, 0.36)            # collision box, centered above the hip line
_BASE_BOX_OFFSET = (0.0, 0.0, 0.16)

# per-leg chain: (link suffix, joint suffix, joint origin in the parent link,
# axis, lower, upper, effort [Nm], velocity [rad/s], link mass [kg],
# link box size for the inertia, link COM)
_LEG = (
    ("leg_roll_link", "leg_roll_joint", (0.0, 0.09, -0.07), (1, 0, 0),
     -0.35, 0.5, 150.0, 12.0, 1.6, (0.10, 0.08, 0.08), (0.0, 0.0, -0.03)),
    ("leg_yaw_link", "leg_yaw_joint", (0.0, 0.0, -0.07), (0, 0, 1),
     -0.6, 0.6, 120.0, 12.0, 1.9, (0.09, 0.09, 0.10), (0.0, 0.0, -0.04)),
    ("leg_pitch_link", "leg_pitch_joint", (0.0, 0.0, -0.06), (0, 1, 0),
     -1.4, 1.4, 250.0, 12.0, 3.6, (0.10, 0.10, 0.31), (0.0, 0.0, -0.13)),
    ("knee_link", "knee_joint", (0.0, 0.0, -0.31), (0, 1, 0),
     -0.1, 2.2, 250.0, 12.0, 2.3, (0.08, 0.08, 0.31), (0.0, 0.0, -0.12)),
    ("ankle_pitch_link", "ankle_pitch_joint", (0.0, 0.0, -0.31), (0, 1, 0),
     -0.9, 0.6, 60.0, 12.0, 0.12, (0.04, 0.04, 0.03), (0.0, 0.0, -0.01)),
    ("ankle_roll_link", "ankle_roll_joint", (0.0, 0.0, -0.02), (1, 0, 0),
     -0.45, 0.45, 40.0, 12.0, 0.75, (0.22, 0.09, 0.04), (0.03, 0.0, -0.035)),
)
# sole box of the feet (link frame of *_ankle_roll_link)
_FOOT_BOX = (0.22, 0.09, 0.03)
_FOOT_BOX_OFFSET = (0.03, 0.0, -0.04)
_JOINT_DAMPING = 0.0


def _box_inertia(mass, size):
    x, y, z = size
    return (mass * (y * y + z * z) / 12.0, mass * (x * x + z * z) / 12.0,
            mass * (x * x + y * y) / 12.0)


def _fmt(v):
    return " ".join(f"{float(x):.6g}" for x in v)


def _link(name, mass, com, size, collision=None):
    ixx, iyy, izz = _box_inertia(mass, size)
    col = ""
    if collision is not None:
        csize, coff = collision
        col = (
            f'    <collision>\n      <origin xyz="{_fmt(coff)}" rpy="0 0 0"/>\n'
            f'      <geometry><box size="{_fmt(csize)}"/></geometry>\n'
            f"    </collision>\n"
        )
    return (
        f'  <link name="{name}">\n    <inertial>\n'
        f'      <origin xyz="{_fmt(com)}" rpy="0 0 0"/>\n'
        f'      <mass value="{mass:.6g}"/>\n'
        f'      <inertia ixx="{ixx:.6g}" ixy="0" ixz="0" iyy="{iyy:.6g}" '
        f'iyz="0" izz="{izz:.6g}"/>\n    </inertial>\n{col}  </link>\n'
    )


def topology_urdf_text() -> str:
    """The stand-in's URDF document. Joints appear in XBOT_JOINT_ORDER, so
    document order and the named order agree."""
    parts = ['<?xml version="1.0"?>\n<robot name="xbot_topology">\n']
    parts.append(_link("base_link", _BASE_MASS, (0.0, 0.0, 0.12),
                       _BASE_BOX, collision=(_BASE_BOX, _BASE_BOX_OFFSET)))
    for side, sign in (("left", 1.0), ("right", -1.0)):
        parent = "base_link"
        for (lname, jname, xyz, axis, lo, hi, eff, vel, mass, size,
             com) in _LEG:
            # roll and yaw limits mirror on the right leg; pitch axes do not
            lo_s, hi_s = (lo, hi) if sign > 0 or axis[1] else (-hi, -lo)
            child = f"{side}_{lname}"
            coll = (_FOOT_BOX, _FOOT_BOX_OFFSET) \
                if lname == "ankle_roll_link" else None
            parts.append(_link(child, mass, com, size, collision=coll))
            j_xyz = (xyz[0], sign * xyz[1], xyz[2])
            parts.append(
                f'  <joint name="{side}_{jname}" type="revolute">\n'
                f'    <origin xyz="{_fmt(j_xyz)}" rpy="0 0 0"/>\n'
                f'    <parent link="{parent}"/>\n    <child link="{child}"/>\n'
                f'    <axis xyz="{_fmt(axis)}"/>\n'
                f'    <limit lower="{lo_s:.6g}" upper="{hi_s:.6g}" '
                f'effort="{eff:.6g}" velocity="{vel:.6g}"/>\n'
                f'    <dynamics damping="{_JOINT_DAMPING:.6g}"/>\n'
                f"  </joint>\n"
            )
            parent = child
    parts.append("</robot>\n")
    return "".join(parts)


def write_xbot_topology_urdf(directory: str) -> str:
    """Write the stand-in URDF into `directory` and return its path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, TOPOLOGY_URDF_NAME)
    tmp = path + f".{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(topology_urdf_text())
    os.replace(tmp, path)
    return path


def load_robot(urdf_path: str, asset_cfg, armature: float):
    """Compile `urdf_path` with the task's asset settings, in document order
    (as the reference does for an explicit `asset.urdf`; the stand-in's
    document order is XBOT_JOINT_ORDER)."""
    from .physics.urdf import load_urdf

    return load_urdf(
        urdf_path,
        foot_name=asset_cfg.foot_name,
        knee_name=asset_cfg.knee_name,
        terminate_on=asset_cfg.terminate_after_contacts_on,
        armature=armature,
    )
