"""The control-step kernel: its wrapper, model table, state packing and
plain version.

`ControlStepKernel` runs one 100 Hz control step (`decimation` substeps of
PD, dynamics, contact and Euler) for every env, with block-PGS foot contact
(cold, or warm-started from the previous substep's impulses when
`PGSParams.warm_start` is set) or, built without PGS parameters, the
penalty model on every contact point.
On a CUDA tensor it launches the hand-written kernel csrc/control_step.cu,
the port of humanoid_tpu/ops/physics_kernel.py::_control_kernel; on a CPU
tensor it runs `control_step_plain`: engine.control_step_pgs or
engine.control_step_batch with the kernel's PD law, per-env gains and body,
and ground planes, in plain PyTorch. There is no fallback from one to the
other.

Layouts follow the reference wrapper (_build_kernel_fn): the state pack is
(7 + nj + nv, N) env-last, masses (N, nb), friction (N,), targets (N, nj).
The optional inputs are env-major with the reference's row order
(_extra_rows): gains (N, 3 nj) = [kp_eff | kd_eff | strength], body
(N, 9 nb) = [COM xyz per body | inertia xx xy xz yy yz zz per body], planes
(N, 3 P) = [c0, gx, gy] per contact point (sole corners, then termination
spheres).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from ..physics.contact import ContactParams, Terrain
from ..physics.engine import (EnvPhysParams, PhysDiag, PhysState, control_step_batch,
                              control_step_pgs)
from ..physics.kinematics import RobotTensors
from ..physics.pgs import PGSParams

MAX_NJ, MAX_FPTS, MAX_TERM = 18, 8, 4
MAX_NB = MAX_NJ + 1


class ModelTable(ctypes.Structure):
    """Field-for-field mirror of `struct ModelTable` in csrc/control_step.cu."""
    _fields_ = [
        ("nj", ctypes.c_int), ("n_fpts", ctypes.c_int),
        ("n_term", ctypes.c_int), ("n_feet", ctypes.c_int),
        ("parent", ctypes.c_int * MAX_NB),
        ("anc", ctypes.c_uint * MAX_NB),
        ("fpt_body", ctypes.c_int * MAX_FPTS),
        ("fpt_foot", ctypes.c_int * MAX_FPTS),
        ("term_body", ctypes.c_int * MAX_TERM),
        ("joint_quat", (ctypes.c_float * 4) * MAX_NJ),
        ("joint_axis", (ctypes.c_float * 3) * MAX_NJ),
        ("joint_pos", (ctypes.c_float * 3) * MAX_NJ),
        ("com", (ctypes.c_float * 3) * MAX_NB),
        ("inertia", (ctypes.c_float * 6) * MAX_NB),
        ("armature", ctypes.c_float * MAX_NJ),
        ("damping", ctypes.c_float * MAX_NJ),
        ("kp", ctypes.c_float * MAX_NJ),
        ("kd", ctypes.c_float * MAX_NJ),
        ("tau_lim", ctypes.c_float * MAX_NJ),
        ("fpt_off", (ctypes.c_float * 3) * MAX_FPTS),
        ("term_off", (ctypes.c_float * 3) * MAX_TERM),
        ("term_rad", ctypes.c_float * MAX_TERM),
        ("gravity", ctypes.c_float), ("dt", ctypes.c_float),
        ("kn", ctypes.c_float), ("cn", ctypes.c_float),
        ("v_reg", ctypes.c_float), ("erp", ctypes.c_float),
        ("cfm", ctypes.c_float), ("slop", ctypes.c_float),
    ]


def _mat_to_quat(m):
    w = math.sqrt(max(0.0, 1.0 + m[0][0] + m[1][1] + m[2][2])) / 2.0
    if w <= 1e-6:
        raise ValueError("joint frame rotation of 180 degrees is not supported")
    x = (m[2][1] - m[1][2]) / (4 * w)
    y = (m[0][2] - m[2][0]) / (4 * w)
    z = (m[1][0] - m[0][1]) / (4 * w)
    n = math.sqrt(w * w + x * x + y * y + z * z)
    return (w / n, x / n, y / n, z / n)


def make_model_table(model, kp, kd, tau_lim, contact_params: ContactParams, dt: float,
                     pgs_params: Optional[PGSParams]) -> ModelTable:
    """Pack the robot, the PD gains and the solver constants for the
    kernel: the counterpart of the reference's make_model_consts. Without
    pgs_params (the penalty model) the PGS constants are 0."""
    nj, nb = model.nj, model.nb
    pt_body, pt_off = model.contact_points()
    nt, n_feet = len(model.term_sphere_body), len(model.foot_bodies)
    if nj > MAX_NJ or len(pt_body) > MAX_FPTS or nt > MAX_TERM or n_feet > 2:
        raise ValueError(f"robot too large for the kernel table: nj={nj}, "
                         f"points={len(pt_body)}, spheres={nt}, feet={n_feet}")
    t = ModelTable()
    t.nj, t.n_fpts, t.n_term, t.n_feet = nj, len(pt_body), nt, n_feet
    anc = model.ancestor_matrix()
    for b in range(nb):
        t.parent[b] = int(model.parent[b])
        t.anc[b] = sum(1 << k for k in range(nj) if anc[b, k] > 0)
    feet = list(model.foot_bodies)
    for c, (b, off) in enumerate(zip(pt_body, pt_off)):
        t.fpt_body[c] = int(b)
        t.fpt_foot[c] = feet.index(int(b))
        t.fpt_off[c][:] = [float(x) for x in off]
    for i in range(nt):
        t.term_body[i] = int(model.term_sphere_body[i])
        t.term_off[i][:] = [float(x) for x in model.term_sphere_offset[i]]
        t.term_rad[i] = float(model.term_sphere_radius[i])
    for k in range(nj):
        t.joint_quat[k][:] = _mat_to_quat(np.asarray(model.joint_rot[k]).tolist())
        t.joint_axis[k][:] = [float(x) for x in model.joint_axis[k]]
        t.joint_pos[k][:] = [float(x) for x in model.joint_pos[k]]
        t.armature[k] = float(model.dof_armature[k])
        t.damping[k] = float(model.dof_damping[k])
        t.kp[k], t.kd[k], t.tau_lim[k] = float(kp[k]), float(kd[k]), float(tau_lim[k])
    for b in range(nb):
        t.com[b][:] = [float(x) for x in model.com[b]]
        I = model.inertia[b]
        t.inertia[b][:] = [float(I[0, 0]), float(I[0, 1]), float(I[0, 2]),
                           float(I[1, 1]), float(I[1, 2]), float(I[2, 2])]
    t.gravity = -float(model.gravity)
    t.dt = float(dt)
    t.kn, t.cn, t.v_reg = (float(contact_params.kn), float(contact_params.cn),
                           float(contact_params.v_reg))
    if pgs_params is not None:
        t.erp, t.cfm, t.slop = (float(pgs_params.erp), float(pgs_params.cfm_ratio),
                                float(pgs_params.slop))
    return t


def pack_state(phys: PhysState) -> torch.Tensor:
    """PhysState (batched) -> (n_state, N) env-last pack."""
    return torch.cat([phys.base_pos, phys.base_quat, phys.qj, phys.u], dim=1).T.contiguous()


def unpack_state(pack: torch.Tensor, nj: int) -> PhysState:
    s = pack.T
    return PhysState(base_pos=s[:, 0:3], base_quat=s[:, 3:7], qj=s[:, 7:7 + nj],
                     u=s[:, 7 + nj:])


def diag_rows(model) -> int:
    return model.nb * 10 + len(model.foot_bodies) * 3 + len(model.term_sphere_body) + model.nj


def unpack_diag(diag: torch.Tensor, model) -> PhysDiag:
    """(n_diag, N) kernel diagnostics -> PhysDiag of (N, ...) views."""
    N = diag.shape[1]
    nb, nj = model.nb, model.nj
    n_feet, nt = len(model.foot_bodies), len(model.term_sphere_body)
    d = diag.T
    r = 0

    def take(n, shape):
        nonlocal r
        out = d[:, r:r + n].reshape((N,) + shape)
        r += n
        return out

    return PhysDiag(
        body_pos=take(3 * nb, (nb, 3)), body_quat=take(4 * nb, (nb, 4)),
        body_omega=take(3 * nb, (nb, 3)), foot_forces=take(3 * n_feet, (n_feet, 3)),
        term_force=take(nt, (nt,)), tau=take(nj, (nj,)),
    )


def n_points(model) -> int:
    """Contact points with a ground plane: sole corners, then termination spheres."""
    return len(model.contact_points()[0]) + len(model.term_sphere_body)


def unpack_body(body, nb: int):
    """(N, 9 nb) body rows -> com (N, nb, 3), symmetric inertia (N, nb, 3, 3)."""
    N = body.shape[0]
    com = body[:, :3 * nb].reshape(N, nb, 3)
    xx, xy, xz, yy, yz, zz = body[:, 3 * nb:].reshape(N, nb, 6).unbind(-1)
    inertia = torch.stack([xx, xy, xz, xy, yy, yz, xz, yz, zz], dim=-1).reshape(N, nb, 3, 3)
    return com, inertia


def pack_body(com, inertia):
    """com (N, nb, 3), inertia (N, nb, 3, 3) -> (N, 9 nb) body rows."""
    N, nb = com.shape[:2]
    i6 = inertia.reshape(N, nb, 9)[:, :, (0, 1, 2, 4, 5, 8)]
    return torch.cat([com.reshape(N, -1), i6.reshape(N, -1)], dim=1)


def control_step_plain(rt: RobotTensors, kp, kd, tau_lim, contact_params: ContactParams,
                       pgs_params: Optional[PGSParams], dt: float, state_pack, masses,
                       friction, targets, decimation: int, freeze: bool, freeze_prep: bool,
                       gains=None, body=None, planes=None):
    """The plain PyTorch version of the kernel: engine.control_step_pgs
    (warm-started when pgs_params.warm_start), or engine.control_step_batch
    without pgs_params (the penalty model; no contact prep, so freeze_prep
    has no effect), with the PD torque of the kernel. kp/kd/tau_lim are
    (nj,) tensors on the state's device; gains, body and planes as the
    kernel takes them (None: the table's gains, the model's bodies, the
    flat plane). Its Cholesky factor and solves are the plain versions (the
    engine's default), on the card too: no kernel under test. Returns
    (state pack, PhysDiag)."""
    nj = rt.nj
    if gains is not None:
        kp, kd, strength = gains[:, :nj], gains[:, nj:2 * nj], gains[:, 2 * nj:]

    def torque_fn(s):
        tau = kp * (targets - s.qj) - kd * s.u[:, 6:]
        if gains is not None:
            tau = tau * strength
        return torch.clamp(tau, -tau_lim, tau_lim)

    com = inertia = None
    if body is not None:
        com, inertia = unpack_body(body, rt.nb)
    params = EnvPhysParams(masses=masses, friction=friction, com=com, inertia=inertia)
    state = unpack_state(state_pack, nj)
    if pgs_params is None:
        phys, diag = control_step_batch(rt, params, Terrain.plane(), contact_params, state,
                                        torque_fn, decimation, dt, freeze_mass_matrix=freeze,
                                        planes=planes)
    else:
        phys, diag = control_step_pgs(rt, params, Terrain.plane(), contact_params, pgs_params,
                                      state, torque_fn, decimation, dt,
                                      freeze_mass_matrix=freeze, freeze_prep=freeze_prep,
                                      planes=planes, warm=pgs_params.warm_start)
    return pack_state(phys), diag


class ControlStepKernel:
    """Wrapper of the control-step kernel for one robot and gain set, on
    the PGS contact model (its warm instance when pgs_params.warm_start),
    or the penalty model when pgs_params is None. Each instance runs a team
    of lanes per env (`design()`).

    `launches` counts kernel launches (CUDA calls only). The library is
    built with nvcc at the first CUDA call; `build_info` then holds the
    build seconds and the ptxas report."""

    def __init__(self, model, kp, kd, tau_lim, contact_params: ContactParams,
                 pgs_params: Optional[PGSParams], dt: float):
        self.model = model
        self.contact_params = contact_params
        self.pgs_params = pgs_params
        self.dt = float(dt)
        self.gains = [np.asarray(x, dtype=np.float32) for x in (kp, kd, tau_lim)]
        self.table = make_model_table(model, *self.gains, contact_params, dt, pgs_params)
        self.n_state = 7 + model.nj + model.nv
        self.n_diag = diag_rows(model)
        self.launches = 0
        self.build_info = None
        self._lib = None
        self._per_device = {}

    def _device_consts(self, device):
        key = str(device)
        if key not in self._per_device:
            gains = [torch.as_tensor(g, device=device) for g in self.gains]
            table = torch.frombuffer(bytearray(bytes(self.table)), dtype=torch.uint8).to(device)
            self._per_device[key] = (RobotTensors.from_model(self.model, device), gains, table)
        return self._per_device[key]

    def build(self):
        """Build (or load) the kernel library; returns the ctypes handle."""
        if self._lib is None:
            from .build import build

            info = build("control_step.cu")
            lib = info.lib
            lib.control_step_launch.restype = ctypes.c_int
            lib.control_step_launch.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p] \
                + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            lib.model_table_bytes.restype = ctypes.c_int
            lib.model_table_bytes.argtypes = []
            if lib.model_table_bytes() != ctypes.sizeof(ModelTable):
                raise RuntimeError("ModelTable layout differs between Python and CUDA: "
                                   f"{ctypes.sizeof(ModelTable)} vs {lib.model_table_bytes()} bytes")
            for name in ("pgs_team_lanes", "penalty_team_lanes"):
                getattr(lib, name).restype = ctypes.c_int
                getattr(lib, name).argtypes = []
            self.build_info = info
            self._lib = lib
        return self._lib

    def design(self) -> str:
        """How the built kernel spreads this instance over the card."""
        if self.pgs_params is None:
            return (f"team of {self.build().penalty_team_lanes()} lanes per env, "
                    "tree, factor and state in shared memory")
        return (f"team of {self.build().pgs_team_lanes()} lanes per env, "
                "contact arrays in shared memory")

    def kernel_name(self) -> str:
        """The `__global__` this instance launches, as ptxas names it."""
        if self.pgs_params is None:
            return "penalty_team_kernel"
        return f"pgs_team_kernel<{'true' if self.pgs_params.warm_start else 'false'}>"

    def plain(self, state_pack, masses, friction, targets, decimation: int,
              freeze: bool = True, freeze_prep: bool = True, gains=None, body=None,
              planes=None):
        rt, (kp, kd, lim), _ = self._device_consts(state_pack.device)
        return control_step_plain(rt, kp, kd, lim, self.contact_params, self.pgs_params, self.dt,
                                  state_pack, masses, friction, targets, decimation,
                                  freeze, freeze_prep, gains, body, planes)

    def __call__(self, state_pack, masses, friction, targets, decimation: int,
                 freeze: bool = True, freeze_prep: bool = True, gains=None, body=None,
                 planes=None):
        """One control step. gains (N, 3 nj), body (N, 9 nb) and planes
        (N, 3 P) are optional (see the module docstring). Returns
        (state pack (n_state, N), PhysDiag)."""
        dev = state_pack.device
        if dev.type == "cpu":
            return self.plain(state_pack, masses, friction, targets, decimation,
                              freeze, freeze_prep, gains, body, planes)
        if dev.type != "cuda":
            raise ValueError(f"control step runs on cuda or cpu tensors, not {dev.type}")
        N = state_pack.shape[1]
        m = self.model
        expect = {"state_pack": (self.n_state, N), "masses": (N, m.nb),
                  "friction": (N,), "targets": (N, m.nj), "gains": (N, 3 * m.nj),
                  "body": (N, 9 * m.nb), "planes": (N, 3 * n_points(m))}
        for name, x in zip(expect, (state_pack, masses, friction, targets, gains, body, planes)):
            if x is None and name in ("gains", "body", "planes"):
                continue
            if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous() \
                    or tuple(x.shape) != expect[name]:
                raise ValueError(
                    f"{name}: need a contiguous float32 {expect[name]} tensor on {dev}, got "
                    f"{x.dtype} {tuple(x.shape)} on {x.device} (contiguous={x.is_contiguous()})")
        if decimation < 1:
            raise ValueError("decimation must be >= 1")
        lib = self.build()
        _, _, table = self._device_consts(dev)
        out = torch.empty_like(state_pack)
        diag = torch.empty((self.n_diag, N), device=dev, dtype=torch.float32)
        stream = torch.cuda.current_stream(dev).cuda_stream
        pgs = self.pgs_params is not None
        warm = pgs and self.pgs_params.warm_start
        err = lib.control_step_launch(
            state_pack.data_ptr(), masses.data_ptr(), friction.data_ptr(), targets.data_ptr(),
            *(None if x is None else x.data_ptr() for x in (gains, body, planes)),
            out.data_ptr(), diag.data_ptr(), N, table.data_ptr(), int(decimation), int(pgs),
            int(warm), int(bool(freeze)), int(bool(freeze_prep)),
            int(self.pgs_params.iterations) if pgs else 0, stream)
        if err != 0:
            raise RuntimeError(f"control_step_kernel launch failed: cudaError {err}")
        self.launches += 1
        return out, unpack_diag(diag, m)


# ---------------------------------------------------------------------------
# what one launch must do: the bound's inputs

def launch_bytes(model, N: int, gains: bool = False, body: bool = False,
                 planes: bool = False) -> int:
    """Bytes one launch must move: every input read once (state, masses,
    friction, targets and the optional gains, body and planes), every
    output written once (state, diagnostics). The warm instance moves the
    same: its carried impulses stay on the card, in shared memory."""
    n_state = 7 + model.nj + model.nv
    extras = 3 * model.nj * gains + 9 * model.nb * body + 3 * n_points(model) * planes
    return 4 * N * (2 * n_state + model.nb + 1 + model.nj + diag_rows(model) + extras)


def operations_per_env(model, decimation: int, freeze: bool, freeze_prep: bool,
                       iterations: int, gains: bool = False, body: bool = False,
                       planes: bool = False, pgs: bool = True) -> int:
    """fp32 operations (add, mul, div, compare, sqrt, sin, ...) one env
    needs in one launch, counted from the loops of csrc/control_step.cu, on
    the PGS instance or (pgs=False) the penalty one, which has no contact
    prep and no sweeps (freeze_prep and iterations then count nothing).
    The body input only replaces loads; gains add the strength product,
    planes the plane normals, gaps and the tangent bases. The warm instance
    (PGSParams.warm_start) counts the same: its sweeps start from the
    carried impulses instead of zeros, with the same arithmetic. It counts
    the work, not who does it: the PGS kernel's team of lanes splits it,
    and a frame that three lanes each recompute counts once."""
    nj, nb, nv = model.nj, model.nb, model.nv
    pt_body, _ = model.contact_points()
    K, R = len(pt_body), 3 * len(pt_body)
    anc = model.ancestor_matrix()
    n_anc = anc.sum(axis=1)                          # ancestor joints per body
    cross, dot, qmul, qrot, qmat, iapply = 9, 5, 28, 30, 30, 42
    solve = 2 * nv * nv

    kin = nj * (2 * qmul + 3 + 3 + qrot + 3) + nj * (qrot + 3 + cross) + nb * (qmat + 21 + 90 + dot + 24)
    vel_bias = nj * (12 + 3 * cross + 9) + nb * (2 * iapply + 3 * cross + 9) \
        + 6 * (nb - 1) + nj * (2 * dot + 4)
    chol = sum(2 * j + 2 + (nv - 1 - j) * (2 * j + 1) for j in range(nv))
    own_anc = [int(anc[k + 1].sum()) for k in range(nj)]   # ancestor-or-self joints
    crba = 10 * (nb - 1) + sum(iapply + 11 * a + 1 for a in own_anc) + chol
    normal, gap = 8, 6                               # plane_normal, the plane's height and gap

    def penalty(b):                                  # one point's force and its projection
        return (qrot + 31 + cross + 6 + 12 * int(n_anc[int(b)])
                + planes * (normal + gap + dot + 6 + 2 + 6))

    spheres = sum(penalty(b) for b in model.term_sphere_body)
    feet = sum(penalty(b) + 3 for b in pt_body)
    accel = nj + nv + solve                          # rhs += tau - C, then the solve
    frames = planes * K * (normal + 2 + cross + dot + 2 + 3 + cross)
    prep = sum(qrot + 6 + 3 * (cross + 20 * int(n_anc[int(b)])) for b in pt_body) \
        + frames + R * solve + R * (R + 1) * nv
    sweeps = K * (qrot + 3 + planes * (normal + gap)) + 2 * R * nv \
        + iterations * K * (6 * R + 50) + 2 * R * nv + solve + (6 + 12 * planes) * K
    integrate = cross + nv + 6 + 6 + 3 + 6 + 1 + 2 + 4 + qmul + 9 + 4 + 2 * nj
    if pgs:
        contact = spheres + accel + 2 * nv + sweeps
    else:                                            # the acceleration, then u + dt udot
        contact = feet + spheres + accel + 3 + nv
    substep = (6 + gains) * nj + kin + vel_bias + contact + integrate
    frozen_prep = pgs and freeze and freeze_prep
    if not freeze:
        substep += crba
    if pgs and not frozen_prep:
        substep += prep
    once = (kin + crba + (prep if frozen_prep else 0)) if freeze else 0
    return once + decimation * substep
