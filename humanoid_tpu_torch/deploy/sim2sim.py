"""Sim2sim: replay an exported policy in MuJoCo on the CPU, the transfer
gate of the port (the reference package's deploy/sim2sim.py).

A 1 kHz MuJoCo loop with a 100 Hz policy, observations assembled
independently from MuJoCo's state as the upstream harness does (sin/cos
phase from the low-level counter, the command, scaled q and dq, the last
action, body-frame angular velocity, euler angles; a 15-frame stack), and
1 kHz PD torque control with clamping. Surviving the replay's duration
while tracking the command is the acceptance criterion.

  python -m humanoid_tpu_torch.deploy.sim2sim --load-model policy.npz \
      --task humanoid_ppo [--duration 60] [--cmd 0.5 0 0] [--urdf PATH] \
      [--heading-hold] [--sw-switch] [--joystick] [--native] \
      [--video [PATH]] [--plot [PATH]] [--oracle-perturb F]

`--task` replays on the MJCF that physics/mjcf_export.py writes from the
task's robot (its stand-in, or `--urdf`), on a floor. Without `--task`,
and with `--terrain` or `--hfield-oracle`, the replay needs the shipped
XBot-L MJCFs (assets.xbot_mjcf), which this repository does not ship: it
then raises FileNotFoundError naming the missing file. Headless: returns
and prints the metrics dict (the last line of stdout, which the eval gate
parses).
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import os
from collections import deque
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class Sim2simCfg:
    """The 12-dof XBot values of the upstream harness."""
    mujoco_model_path: str = ""
    sim_duration: float = 60.0
    dt: float = 0.001
    decimation: int = 10
    # joint order: [leg_roll, leg_yaw, leg_pitch, knee, ankle_pitch,
    # ankle_roll] per leg
    kps: tuple = (200, 200, 350, 350, 15, 15, 200, 200, 350, 350, 15, 15)
    kds: tuple = (10,) * 12
    tau_limit = 200.0            # scalar or per-joint tuple
    num_actions: int = 12
    num_single_obs: int = 47
    frame_stack: int = 15
    cycle_time: float = 0.64
    action_scale: object = 0.25  # scalar or per-joint tuple
    clip_observations: float = 18.0
    clip_actions: float = 18.0
    obs_scale_lin_vel: float = 2.0
    obs_scale_ang_vel: float = 1.0
    obs_scale_dof_pos: float = 1.0
    obs_scale_dof_vel: float = 0.05
    default_pos: tuple = (0.0,) * 12
    base_init_z: float = 0.93
    # fall detection for the metric (not in the upstream viewer loop)
    min_base_height: float = 0.45


def cfg_for_task(task: str, duration: float = 60.0, oracle_perturb: float = 0.0,
                 urdf: Optional[str] = None) -> Sim2simCfg:
    """The replay config of a registered task: its control, observation and
    normalization settings, on the MJCF exported from the task's compiled
    robot (`urdf` replaces it, as train's --urdf does) with a floor.
    MuJoCo's own contact and integrator then run against the port's
    training physics. `oracle_perturb` > 0 perturbs the exported model's
    masses, inertias and COMs by up to that fraction (deterministic), a
    model gap like the shipped 12-dof MJCF's against its URDF. The MJCF is
    written into the package's build directory, named by its content."""
    from ..assets import _write_text, load_robot
    from ..physics.mjcf_export import model_to_mjcf
    from ..utils import registry

    env_cfg, _ = registry.get_cfgs(task)
    urdf_path, joint_order = registry.robot(env_cfg, urdf)
    m = load_robot(urdf_path, env_cfg.asset, env_cfg.sim.armature, joint_order)
    xml = model_to_mjcf(m, with_floor=True, perturb=oracle_perturb)
    digest = hashlib.sha1(xml.encode()).hexdigest()[:12]
    mjcf = _write_text(os.path.join(registry.BUILD_DIR, "mjcf", f"sim2sim_{task}_{digest}.xml"),
                       xml)
    cfg = Sim2simCfg(
        mujoco_model_path=mjcf,
        sim_duration=duration,
        dt=env_cfg.sim.dt,
        decimation=env_cfg.control.decimation,
        kps=env_cfg.control.stiffness,
        kds=env_cfg.control.damping,
        num_actions=env_cfg.env.num_actions,
        num_single_obs=env_cfg.env.num_single_obs,
        frame_stack=env_cfg.env.frame_stack,
        cycle_time=env_cfg.rewards.cycle_time,
        action_scale=env_cfg.control.action_scale,
        clip_observations=env_cfg.normalization.clip_observations,
        clip_actions=env_cfg.normalization.clip_actions,
        obs_scale_lin_vel=env_cfg.normalization.obs_scales.lin_vel,
        obs_scale_ang_vel=env_cfg.normalization.obs_scales.ang_vel,
        obs_scale_dof_pos=env_cfg.normalization.obs_scales.dof_pos,
        obs_scale_dof_vel=env_cfg.normalization.obs_scales.dof_vel,
        default_pos=env_cfg.init_state.default_joint_angles,
        base_init_z=env_cfg.init_state.pos[2] - 0.02,
    )
    cfg.tau_limit = tuple(float(e) * env_cfg.safety.torque_limit for e in m.dof_effort)
    return cfg


def _hfield_lookup(model):
    """ground_z(x, y) sampling the model's heightfield (bilinear), or None
    when the model has no hfield (flat replays keep exact absolute
    semantics). MuJoCo normalizes hfield data to [0, 1] and scales it by
    size[2]; without this offset the robot would spawn with its legs
    buried in the local hill (the shipped uneven.png rises to 0.28 m at the
    origin)."""
    import mujoco

    hid = None
    gpos = None
    for g in range(model.ngeom):
        if model.geom_type[g] == mujoco.mjtGeom.mjGEOM_HFIELD:
            hid = int(model.geom_dataid[g])
            gpos = model.geom_pos[g].copy()
            break
    if hid is None:
        return None
    nrow = int(model.hfield_nrow[hid])
    ncol = int(model.hfield_ncol[hid])
    rx, ry, elev, _ = model.hfield_size[hid]
    data = model.hfield_data[
        model.hfield_adr[hid]:model.hfield_adr[hid] + nrow * ncol
    ].reshape(nrow, ncol)

    def ground_z(x, y):
        # row = y axis, col = x axis (MuJoCo hfield convention)
        fx = (x - gpos[0] + rx) / (2 * rx) * (ncol - 1)
        fy = (y - gpos[1] + ry) / (2 * ry) * (nrow - 1)
        fx = min(max(fx, 0.0), ncol - 1.001)
        fy = min(max(fy, 0.0), nrow - 1.001)
        x0, y0 = int(fx), int(fy)
        tx, ty = fx - x0, fy - y0
        h = (
            data[y0, x0] * (1 - tx) * (1 - ty)
            + data[y0, x0 + 1] * tx * (1 - ty)
            + data[y0 + 1, x0] * (1 - tx) * ty
            + data[y0 + 1, x0 + 1] * tx * ty
        )
        return float(h) * elev + gpos[2]

    return ground_z


def _quat_to_euler(quat_wxyz):
    w, x, y, z = quat_wxyz
    roll = math.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = math.asin(max(-1.0, min(1.0, 2 * (w * y - z * x))))
    yaw = math.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return np.array([roll, pitch, yaw])


def run_mujoco(
    policy: Callable[[np.ndarray], np.ndarray],
    cfg: Sim2simCfg,
    command=(0.5, 0.0, 0.0),
    push_schedule: Optional[Callable[[float], np.ndarray]] = None,
    record_states: bool = False,
    command_source: Optional[Callable[[], tuple]] = None,
    sw_switch: bool = False,
    stand_com_threshold: float = 0.05,
    heading_hold: bool = False,
    video_path: Optional[str] = None,
    video_fps: float = 30.0,
    plot_path: Optional[str] = None,
):
    """Replay `policy` (maps (1, frame_stack*K) obs -> (nj,) action).

    Returns a metrics dict: survived seconds, distance, mean speed, final
    base height (and the 100 Hz [qpos, qvel] rows with `record_states`)."""
    import mujoco

    from ..assets import prepare_mujoco_xml, xbot_mjcf

    path = cfg.mujoco_model_path or prepare_mujoco_xml(xbot_mjcf())
    model = mujoco.MjModel.from_xml_path(path)
    model.opt.timestep = cfg.dt
    data = mujoco.MjData(model)
    base_id = mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_BODY, "base_link")
    # initial pose: default joint angles and the base height (qpos base z
    # is relative to the MJCF body offset)
    data.qpos[-cfg.num_actions:] = np.asarray(cfg.default_pos)
    ground = _hfield_lookup(model)
    spawn_gz = ground(0.0, 0.0) if ground is not None else 0.0
    data.qpos[2] = cfg.base_init_z + spawn_gz - model.body_pos[base_id][2]
    mujoco.mj_step(model, data)

    nj = cfg.num_actions
    kps = np.asarray(cfg.kps, dtype=np.float64)
    kds = np.asarray(cfg.kds, dtype=np.float64)
    tau_limit = np.asarray(cfg.tau_limit, dtype=np.float64)
    default_pos = np.asarray(cfg.default_pos, dtype=np.float64)
    hist_obs = deque(
        [np.zeros((1, cfg.num_single_obs), dtype=np.float32)] * cfg.frame_stack,
        maxlen=cfg.frame_stack,
    )
    action = np.zeros(nj, dtype=np.float64)
    target_q = default_pos.copy()
    cmd = np.asarray(command, dtype=np.float64)

    recorder = None
    render_every = 0
    if video_path is not None:
        from .video import VideoRecorder

        recorder = VideoRecorder(video_path, path, fps=video_fps)
        render_every = max(1, int(round(1.0 / (video_fps * cfg.dt))))

    n_steps = int(cfg.sim_duration / cfg.dt)
    start_xy = data.qpos[0:2].copy()
    survived = cfg.sim_duration
    states = []
    count_lowlevel = 0
    time_standing = 0
    # the joint-tracking, velocity and contact dashboard of the replay,
    # accumulated at the 100 Hz policy rate and drawn as a PNG at the end
    eval_logger = None
    foot_geoms = {}
    if plot_path is not None:
        from ..utils.eval_logger import EvalLogger

        eval_logger = EvalLogger(dt=cfg.dt * cfg.decimation)
        for g in range(model.ngeom):
            bname = mujoco.mj_id2name(
                model, mujoco.mjtObj.mjOBJ_BODY, model.geom_bodyid[g]
            ) or ""
            if "ankle_roll" in bname or "foot" in bname:
                foot_geoms[g] = 0 if "left" in bname else 1
    for step in range(n_steps):
        q = data.qpos[-nj:].astype(np.float64)
        dq = data.qvel[-nj:].astype(np.float64)
        quat = data.qpos[3:7].astype(np.float64)        # wxyz
        omega_body = data.qvel[3:6].astype(np.float64)  # free joint: body frame

        if count_lowlevel % cfg.decimation == 0:
            if command_source is not None:
                cmd = np.asarray(command_source(), dtype=np.float64)
            if heading_hold:
                # heading-mode policies are trained with wyaw recomputed
                # from the heading error every step; mirror it so that the
                # replay matches the training command distribution
                eu0 = _quat_to_euler(quat)
                cmd[2] = np.clip(0.5 * (-eu0[2]), -1.0, 1.0)
            # stand/walk phase reset: zero-command episodes freeze the gait
            # clock so that the policy sees no stepping signal
            if sw_switch:
                if np.linalg.norm(cmd) <= stand_com_threshold:
                    time_standing += 1
                    if time_standing > 5:
                        count_lowlevel = 0
                else:
                    time_standing = 0
            obs = np.zeros((1, cfg.num_single_obs), dtype=np.float32)
            eu = _quat_to_euler(quat)
            eu[eu > math.pi] -= 2 * math.pi
            phase = 2 * math.pi * count_lowlevel * cfg.dt / cfg.cycle_time
            obs[0, 0] = math.sin(phase)
            obs[0, 1] = math.cos(phase)
            obs[0, 2] = cmd[0] * cfg.obs_scale_lin_vel
            obs[0, 3] = cmd[1] * cfg.obs_scale_lin_vel
            obs[0, 4] = cmd[2] * cfg.obs_scale_ang_vel
            obs[0, 5 : 5 + nj] = (q - default_pos) * cfg.obs_scale_dof_pos
            obs[0, 5 + nj : 5 + 2 * nj] = dq * cfg.obs_scale_dof_vel
            obs[0, 5 + 2 * nj : 5 + 3 * nj] = action
            obs[0, 5 + 3 * nj : 8 + 3 * nj] = omega_body
            obs[0, 8 + 3 * nj : 11 + 3 * nj] = eu
            obs = np.clip(obs, -cfg.clip_observations, cfg.clip_observations)
            hist_obs.append(obs)
            policy_input = np.concatenate(
                [hist_obs[i] for i in range(cfg.frame_stack)], axis=1
            )
            action = np.asarray(policy(policy_input)).reshape(nj)
            action = np.clip(action, -cfg.clip_actions, cfg.clip_actions)
            target_q = action * np.asarray(cfg.action_scale) + default_pos

        tau = kps * (target_q - q) - kds * dq
        tau = np.clip(tau, -tau_limit, tau_limit)
        data.ctrl[:] = tau

        if push_schedule is not None:
            data.xfrc_applied[base_id][:3] = push_schedule(step * cfg.dt)

        mujoco.mj_step(model, data)
        count_lowlevel += 1
        if recorder is not None and step % render_every == 0:
            recorder.add_qpos(data.qpos)

        base_z = data.qpos[2] + model.body_pos[base_id][2]
        if ground is not None:
            # height above the LOCAL ground (a fallen robot on a 0.3 m hill
            # still reads base_z ~0.55 absolute)
            base_z = base_z - ground(data.qpos[0], data.qpos[1])
        if record_states and count_lowlevel % cfg.decimation == 0:
            states.append(
                np.concatenate([data.qpos.copy(), data.qvel.copy()])
            )
        if eval_logger is not None and count_lowlevel % cfg.decimation == 0:
            fz = np.zeros(2)
            for ci in range(data.ncon):
                c = data.contact[ci]
                side = foot_geoms.get(c.geom1, foot_geoms.get(c.geom2))
                if side is not None:
                    f6 = np.zeros(6)
                    mujoco.mj_contactForce(model, data, ci, f6)
                    fz[side] += abs((f6[0] * c.frame[0:3])[2])
            # free joint: qvel[0:3] world linear, qvel[3:6] body angular
            w, x, y, z = data.qpos[3:7]
            R = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ])
            v_base = R.T @ data.qvel[0:3]
            eval_logger.log_states({
                "dof_pos": data.qpos[-nj:].copy(),
                "dof_pos_target": target_q.copy(),
                "dof_vel": data.qvel[-nj:].copy(),
                "dof_torque": tau.copy(),
                "base_vel_x": v_base[0],
                "base_vel_y": v_base[1],
                "base_vel_z": v_base[2],
                "base_vel_yaw": data.qvel[5],
                "command_x": cmd[0],
                "command_y": cmd[1],
                "command_yaw": cmd[2],
                "contact_forces_z_0": fz[0],
                "contact_forces_z_1": fz[1],
                "base_height": base_z,
            })
        if base_z < cfg.min_base_height or not np.isfinite(data.qpos).all():
            survived = step * cfg.dt
            break

    if recorder is not None:
        print(f"video: {recorder.close()} ({recorder.frames} frames)")
    dist = float(np.linalg.norm(data.qpos[0:2] - start_xy))
    final_z = float(data.qpos[2] + model.body_pos[base_id][2])
    if ground is not None:
        final_z -= ground(data.qpos[0], data.qpos[1])
    out = {
        # plain python floats: the eval gate parses this dict from stdout
        # with ast.literal_eval, which rejects np.float64 reprs
        "survived_s": float(survived),
        "distance_m": float(dist),
        "mean_speed": float(dist / max(survived, 1e-6)),
        "final_base_z": float(final_z),
    }
    if record_states:
        out["states"] = np.array(states)
    if eval_logger is not None:
        dashboard = eval_logger.plot_states(plot_path)
        if dashboard:
            out["dashboard"] = dashboard
    return out


def main(argv=None):
    import argparse

    from .npz_policy import NpzPolicy

    p = argparse.ArgumentParser(description="MuJoCo sim2sim gate")
    p.add_argument("--load-model", "--load_model", dest="load_model",
                   required=True, help=".npz exported policy")
    p.add_argument("--duration", type=float, default=60.0)
    p.add_argument("--task", default="",
                   help="build the replay config from this registered task, on the MJCF "
                        "exported from its robot")
    p.add_argument("--urdf", default=None,
                   help="with --task: the robot URDF the policy was trained on (train's --urdf)")
    p.add_argument("--terrain", action="store_true",
                   help="replay on the shipped terrain MJCF (XBot-L-terrain.xml + uneven.png)")
    p.add_argument("--hfield-oracle", dest="hfield_oracle", default="",
                   metavar="KIND[:DIFF]",
                   help="replay on a synthesized non-flat oracle: the shipped terrain MJCF "
                        "with its hfield replaced by one of the port's terrain primitives "
                        "(stairs, discrete, gap, rough, uneven, ...) at the given difficulty "
                        "(deploy/terrain_oracle.py)")
    p.add_argument("--oracle-perturb", dest="oracle_perturb", type=float, default=0.0,
                   help="with --task: perturb the exported model's masses, inertias and COMs "
                        "by up to this fraction (deterministic), so that the gate crosses a "
                        "model gap like the shipped 12-dof MJCF's ~10%%")
    p.add_argument("--cmd", type=float, nargs=3, default=[0.5, 0.0, 0.0])
    p.add_argument("--joystick", action="store_true",
                   help="drive commands from a gamepad (scripts/joystick.py)")
    p.add_argument("--sw-switch", dest="sw_switch", action="store_true",
                   help="freeze the gait clock on zero command")
    p.add_argument("--heading-hold", dest="heading_hold", action="store_true",
                   help="recompute wyaw from heading error (heading-mode policies)")
    p.add_argument("--video", nargs="?", const="sim2sim.mp4", default=None, metavar="PATH",
                   help="record an offscreen camera-follow mp4")
    p.add_argument("--plot", nargs="?", const="sim2sim_dashboard.png", default=None,
                   metavar="PATH",
                   help="render the 3x3 joint-tracking/velocity/contact dashboard PNG of the "
                        "replay")
    p.add_argument("--native", action="store_true",
                   help="evaluate the policy through the C++ deployment runtime "
                        "(native/policy_runtime.cpp) instead of numpy: the robot-side code "
                        "path")
    args = p.parse_args(argv)

    from ..assets import prepare_mujoco_xml, xbot_mjcf

    if args.task:
        cfg = cfg_for_task(args.task, duration=args.duration,
                           oracle_perturb=args.oracle_perturb, urdf=args.urdf)
        if args.terrain:
            cfg.mujoco_model_path = prepare_mujoco_xml(xbot_mjcf(terrain=True))
    else:
        cfg = Sim2simCfg(sim_duration=args.duration,
                         mujoco_model_path=prepare_mujoco_xml(xbot_mjcf(terrain=args.terrain)))
    if args.hfield_oracle:
        from .terrain_oracle import make_hfield_oracle, parse_oracle_spec

        kind, diff = parse_oracle_spec(args.hfield_oracle)
        cfg.mujoco_model_path = make_hfield_oracle(kind, diff)
    if args.native:
        from ..native.policy_native import NativePolicy

        policy = NativePolicy(args.load_model)
    else:
        policy = NpzPolicy(args.load_model)
    command_source = None
    if args.joystick:
        from ..scripts.joystick import JoystickController

        pad = JoystickController()

        def command_source():
            pad.update_cmd_vel()
            c = pad.get_cmd_vel()
            return (c["vx"], c["vy"], c["wz"])

    metrics = run_mujoco(
        policy, cfg, command=tuple(args.cmd),
        command_source=command_source, sw_switch=args.sw_switch,
        heading_hold=args.heading_hold, video_path=args.video,
        plot_path=args.plot,
    )
    print(metrics)
    return metrics


if __name__ == "__main__":
    main()
