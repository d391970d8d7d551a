"""Robot assets of the port.

The XBot-L URDF is data that this repository does not ship. Until it does,
the port trains a stand-in that `write_xbot_topology_urdf` writes at run
time from the constants below: XBot-L's topology and widths (a floating
`base_link` and two 6-dof legs whose 12 revolute joints carry XBot-L's names
and order, box collision on both `*_ankle_roll_link`s) with humanoid-scale
masses, inertias and limits. It gives the model the shipping task's full
widths: nj=12, nb=13, nv=18, 47x15 actor and 73x3 critic observations.

The 18-dof tasks (d11_ppo, d11_ppo_pgs, d12_ppo) run XBot-L with its six
arm joints re-enabled (shoulder pitch, shoulder roll and elbow pitch per
side), the arms first in the dof order. `write_xbot18_topology_urdf` writes
the stand-in for it: the 12-dof stand-in plus two 3-dof arms on the base,
their masses taken out of the base's, so that the legs carry the same
load: nj=18, nb=19, nv=24, 65x15 actor and 97x3 critic observations.
`make_xbot18_urdf` flips the arm joints of a real XBot-L URDF, where they
are typed `fixed`, to `revolute`.

Pass the real file with `--urdf PATH` once it is in the repository.

The shipped XBot-L MJCFs (`XBot-L.xml`, and `XBot-L-terrain.xml` with its
`uneven.png` hfield) are data this repository does not ship either.
`xbot_mjcf` finds them under the asset root, in the reference package's
layout (`robots/XBot/mjcf/...`): $HUMANOID_TPU_ASSETS, as for the
reference package, else `resources/` at the root of the repository, and
raises FileNotFoundError naming the missing file. Replays of the port's
own robots use the MJCF `physics/mjcf_export.py` writes instead.
"""
from __future__ import annotations

import os
import re
import tempfile

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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

# the 18-dof layout: the six arm dofs first, then the 12 leg dofs
XBOT18_ARM_JOINTS = (
    "left_shoulder_pitch_joint",
    "left_shoulder_roll_joint",
    "left_elbow_pitch_joint",
    "right_shoulder_pitch_joint",
    "right_shoulder_roll_joint",
    "right_elbow_pitch_joint",
)

XBOT18_JOINT_ORDER = XBOT18_ARM_JOINTS + XBOT_JOINT_ORDER

TOPOLOGY_URDF_NAME = "xbot_topology.urdf"
TOPOLOGY18_URDF_NAME = "xbot18_topology.urdf"

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
# per-arm chain of the 18-dof stand-in, rows as in _LEG. The right arm's
# pitch axes are the left's negated and all its limits mirrored, so that
# each right joint angle is its left twin's negated (algo/symmetry.py); the
# elbow's range holds the 18-dof default pose of +-1.0472 rad.
_ARM = (
    ("shoulder_pitch_link", "shoulder_pitch_joint", (0.0, 0.20, 0.30), (0, 1, 0),
     -2.0, 2.0, 60.0, 12.0, 1.0, (0.08, 0.08, 0.08), (0.0, 0.03, 0.0)),
    ("shoulder_roll_link", "shoulder_roll_joint", (0.0, 0.05, 0.0), (1, 0, 0),
     -0.3, 1.5, 60.0, 12.0, 1.2, (0.07, 0.07, 0.26), (0.0, 0.0, -0.12)),
    ("elbow_pitch_link", "elbow_pitch_joint", (0.0, 0.0, -0.26), (0, 1, 0),
     -0.1, 2.0, 40.0, 12.0, 1.0, (0.06, 0.06, 0.24), (0.0, 0.0, -0.11)),
)
_ARM_MASS = sum(row[8] for row in _ARM)
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


def _joint(name, parent, child, xyz, axis, lo, hi, eff, vel):
    return (
        f'  <joint name="{name}" type="revolute">\n'
        f'    <origin xyz="{_fmt(xyz)}" rpy="0 0 0"/>\n'
        f'    <parent link="{parent}"/>\n    <child link="{child}"/>\n'
        f'    <axis xyz="{_fmt(axis)}"/>\n'
        f'    <limit lower="{lo:.6g}" upper="{hi:.6g}" '
        f'effort="{eff:.6g}" velocity="{vel:.6g}"/>\n'
        f'    <dynamics damping="{_JOINT_DAMPING:.6g}"/>\n'
        f"  </joint>\n"
    )


def topology_urdf_text(arms: bool = False) -> str:
    """The stand-in's URDF document: the 12-dof robot, or with `arms` the
    18-dof one. Joints appear in XBOT_JOINT_ORDER (XBOT18_JOINT_ORDER), so
    document order and the named order agree."""
    name = "xbot18_topology" if arms else "xbot_topology"
    parts = [f'<?xml version="1.0"?>\n<robot name="{name}">\n']
    parts.append(_link("base_link", _BASE_MASS - (2 * _ARM_MASS if arms else 0.0),
                       (0.0, 0.0, 0.12), _BASE_BOX, collision=(_BASE_BOX, _BASE_BOX_OFFSET)))
    for side, sign in (("left", 1.0), ("right", -1.0)) if arms else ():
        parent = "base_link"
        for (lname, jname, xyz, axis, lo, hi, eff, vel, mass, size, com) in _ARM:
            # every right arm limit mirrors, and the right pitch axes flip
            lo_s, hi_s = (lo, hi) if sign > 0 else (-hi, -lo)
            ax = (axis[0], sign * axis[1], axis[2])
            child = f"{side}_{lname}"
            parts.append(_link(child, mass, (com[0], sign * com[1], com[2]), size))
            parts.append(_joint(f"{side}_{jname}", parent, child, (xyz[0], sign * xyz[1], xyz[2]),
                                ax, lo_s, hi_s, eff, vel))
            parent = child
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
            parts.append(_joint(f"{side}_{jname}", parent, child, j_xyz, axis, lo_s, hi_s,
                                eff, vel))
            parent = child
    parts.append("</robot>\n")
    return "".join(parts)


def _write_text(path: str, text: str) -> str:
    """Write `text` to `path` atomically (another process may read it)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + f".{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
    return path


def write_xbot_topology_urdf(directory: str) -> str:
    """Write the 12-dof stand-in URDF into `directory` and return its path."""
    return _write_text(os.path.join(directory, TOPOLOGY_URDF_NAME), topology_urdf_text())


def write_xbot18_topology_urdf(directory: str) -> str:
    """Write the 18-dof stand-in URDF into `directory` and return its path."""
    return _write_text(os.path.join(directory, TOPOLOGY18_URDF_NAME),
                       topology_urdf_text(arms=True))


def make_xbot18_urdf(base_urdf: str, directory: str) -> str:
    """The 18-dof variant of a real XBot-L URDF, written into `directory`:
    the six arm joints flipped from `fixed` to `revolute` (their axis and
    limit blocks are already in the source file), beside a `meshes` link to
    the source's mesh directory (the file names its meshes as
    ../meshes/*.STL). Returns the new file's path."""
    with open(base_urdf) as f:
        src = f.read()
    for name in XBOT18_ARM_JOINTS:
        pat = r'(<joint[^>]*?name="%s"[^>]*?type=")fixed(")' % re.escape(name)
        src, n = re.subn(pat, r"\1revolute\2", src, flags=re.S)
        if n != 1:
            raise ValueError(f"joint {name} not found/unique in {base_urdf}")
    root = os.path.join(directory, "xbot18_urdf")
    meshes = os.path.join(root, "meshes")
    target = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(base_urdf))), "meshes")
    os.makedirs(root, exist_ok=True)
    if not os.path.lexists(meshes) or os.readlink(meshes) != target:
        tmp = meshes + f".{os.getpid()}.tmp"
        os.symlink(target, tmp)
        os.replace(tmp, meshes)
    return _write_text(os.path.join(root, "urdf", "XBot-L-18dof.urdf"), src)


def resolve_robot(asset_cfg, directory: str):
    """AssetCfg -> (URDF path, joint order): an explicit `asset_cfg.urdf`
    wins (document dof order, None); otherwise the named robot's stand-in,
    written into `directory`, with its named order."""
    if asset_cfg.urdf:
        return asset_cfg.urdf, None
    if asset_cfg.robot == "xbot18":
        return write_xbot18_topology_urdf(directory), XBOT18_JOINT_ORDER
    if asset_cfg.robot == "xbot12":
        return write_xbot_topology_urdf(directory), XBOT_JOINT_ORDER
    raise ValueError(f"unknown robot {asset_cfg.robot!r} (xbot12 | xbot18)")


def load_robot(urdf_path: str, asset_cfg, armature: float, joint_order=None):
    """Compile `urdf_path` with the task's asset settings, in `joint_order`
    or else in document order (as the reference does for an explicit
    `asset.urdf`; the stand-ins' document orders are their named orders)."""
    from .physics.urdf import load_urdf

    return load_urdf(
        urdf_path,
        joint_order=joint_order,
        foot_name=asset_cfg.foot_name,
        knee_name=asset_cfg.knee_name,
        terminate_on=asset_cfg.terminate_after_contacts_on,
        armature=armature,
    )


def asset_root() -> str:
    """$HUMANOID_TPU_ASSETS, else <repo>/resources."""
    return os.environ.get("HUMANOID_TPU_ASSETS", os.path.join(REPO_ROOT, "resources"))


def xbot_mjcf(terrain: bool = False) -> str:
    """The path of the shipped XBot-L MJCF (with `terrain`, its hfield
    variant) under the asset root; FileNotFoundError where it is missing."""
    name = "XBot-L-terrain.xml" if terrain else "XBot-L.xml"
    path = os.path.join(asset_root(), "robots", "XBot", "mjcf", name)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{path}: the shipped XBot-L MJCF is not in the repository "
                                "(set HUMANOID_TPU_ASSETS to a directory that holds "
                                "robots/XBot/mjcf/)")
    return path


def prepare_mujoco_xml(mjcf_path: str) -> str:
    """A loadable copy of a shipped XBot MJCF: without its MuJoCo-2.x-only
    `sensornoise` flag, written into a new temporary directory beside links
    to the file's `meshes` and `terrain` directories (it names them by
    relative paths)."""
    with open(mjcf_path) as f:
        src = re.sub(r'sensornoise="[^"]*"', "", f.read())
    tmp = tempfile.mkdtemp(prefix="xbot_mjcf_")
    robot_dir = os.path.dirname(os.path.dirname(os.path.abspath(mjcf_path)))
    os.makedirs(os.path.join(tmp, "mjcf"))
    for sub in ("meshes", "terrain"):
        target = os.path.join(robot_dir, sub)
        if os.path.isdir(target):
            os.symlink(target, os.path.join(tmp, sub))
    return _write_text(os.path.join(tmp, "mjcf", os.path.basename(mjcf_path)), src)
