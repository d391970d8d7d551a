"""Emit a minimal MJCF from a compiled RobotModel: the port's copy of the
reference package's physics/mjcf_export.py, so that a machine without JAX
can build the MJCF of the sim2sim gate.

Used for apples-to-apples golden-trajectory tests: the upstream MJCF
deviates from its URDF (merged motor/linkage links, retuned hand masses), so
validating the CRBA/RNEA math requires a MuJoCo model built from the *same*
compiled inertial data. Also the sim2sim deployment gate's model where no
standalone MJCF is available (the 18-dof robot). The joint frames'
quaternions are computed in float32, as the reference computes them.
"""
from __future__ import annotations

import numpy as np
import torch

from .model import RobotModel
from .spatial import mat_to_quat


def _fmt(a) -> str:
    return " ".join(f"{x:.17g}" for x in np.atleast_1d(np.asarray(a)))


def model_to_mjcf(model: RobotModel, with_floor: bool = False,
                  friction: float = 1.0, perturb: float = 0.0,
                  perturb_seed: int = 0) -> str:
    """Render the collapsed tree as MJCF XML (floating base, torque motors).

    `perturb` > 0 emits a deliberately *perturbed* oracle: per-body mass and
    inertia scaled by independent uniform factors in [1-perturb, 1+perturb]
    and COM shifted by up to ±10·perturb cm per axis (deterministic in
    `perturb_seed`). This reproduces the kind of model gap the shipped
    12-dof upstream MJCF has vs its URDF (~10% merged-link inertia
    redistribution, −0.33 kg — VALIDATION.md round-2 bisection), so gates
    on robots without an independently-authored MJCF (e.g. the 18-dof d11
    task, whose D11_X assets are missing upstream, SURVEY.md §0.2) still
    test cross-MODEL robustness rather than only cross-simulator transfer.
    Scalar per-body scaling keeps every inertia physically valid."""
    mass_f = np.ones(model.nb)
    inertia_f = np.ones(model.nb)
    com_d = np.zeros((model.nb, 3))
    if perturb > 0.0:
        rng = np.random.RandomState(perturb_seed)
        mass_f = rng.uniform(1 - perturb, 1 + perturb, model.nb)
        inertia_f = rng.uniform(1 - perturb, 1 + perturb, model.nb)
        com_d = rng.uniform(-0.1 * perturb, 0.1 * perturb, (model.nb, 3))

    children = {i: [] for i in range(-1, model.nb)}
    for b in range(model.nb):
        children[int(model.parent[b])].append(b)

    lines = []

    def emit_body(b: int, indent: str):
        name = model.body_names[b]
        if b == 0:
            pos, quat = np.zeros(3), np.array([1.0, 0, 0, 0])
        else:
            k = b - 1
            pos = model.joint_pos[k]
            quat = mat_to_quat(torch.as_tensor(np.asarray(model.joint_rot[k]),
                                               dtype=torch.float32)).numpy()
        lines.append(
            f'{indent}<body name="{name}" pos="{_fmt(pos)}" quat="{_fmt(quat)}">'
        )
        if b == 0:
            lines.append(f'{indent}  <freejoint name="root"/>')
        else:
            k = b - 1
            lines.append(
                f'{indent}  <joint name="{model.joint_names[k]}" type="hinge" '
                f'axis="{_fmt(model.joint_axis[k])}" '
                f'range="{model.dof_lower[k]:.17g} {model.dof_upper[k]:.17g}" '
                f'damping="{model.dof_damping[k]:.17g}" '
                f'armature="{model.dof_armature[k]:.17g}" limited="false"/>'
            )
        I = np.asarray(model.inertia[b]) * inertia_f[b]
        com = np.asarray(model.com[b]) + com_d[b]
        lines.append(
            f'{indent}  <inertial pos="{_fmt(com)}" '
            f'mass="{model.mass[b] * mass_f[b]:.17g}" '
            f'fullinertia="{I[0,0]:.17g} {I[1,1]:.17g} {I[2,2]:.17g} '
            f'{I[0,1]:.17g} {I[0,2]:.17g} {I[1,2]:.17g}"/>'
        )
        if with_floor and b in model.foot_bodies:
            lines.append(
                f'{indent}  <geom type="box" size="{_fmt(model.foot_box_size/2)}" '
                f'pos="{_fmt(model.foot_box_offset)}" '
                f'friction="{friction:.17g} 0 0" condim="3"/>'
            )
        for c in children[b]:
            emit_body(c, indent + "  ")
        lines.append(f"{indent}</body>")

    emit_body(0, "    ")
    body_xml = "\n".join(lines)

    floor = (
        '    <geom name="floor" type="plane" size="50 50 1" '
        f'friction="{friction:.17g} 0 0" condim="3"/>\n'
        if with_floor
        else ""
    )
    motors = "\n".join(
        f'    <motor name="{n}" joint="{n}" gear="1" '
        f'ctrlrange="-{model.dof_effort[k]:.17g} {model.dof_effort[k]:.17g}"/>'
        for k, n in enumerate(model.joint_names)
    )
    return f"""<mujoco model="humanoid_tpu_export">
  <compiler angle="radian"/>
  <option timestep="0.001" gravity="0 0 {model.gravity:.17g}"/>
  <worldbody>
{floor}{body_xml}
  </worldbody>
  <actuator>
{motors}
  </actuator>
</mujoco>
"""
