"""Evaluate and export a trained policy of the port (the reference
package's scripts/play.py).

  python -m humanoid_tpu_torch.scripts.play --task humanoid_ppo \
      [--log-root DIR] [--load-run RUN] [--checkpoint IT] [--num-envs 1] \
      [--steps 300] [--cmd 0.5 0.0 0.0] [--out-dir DIR] [--device cuda] [--video]

Loads the checkpoint that `get_load_path` resolves under
<log-root>/<experiment> (the latest run and its highest model_<it> by
default), exports `policy.npz` (with meta_iteration), the TorchScript pair
`policy_1.pt` / `base_lin_vel.pt` and `policy.onnx`, then rolls the actor's
mean at the fixed command `--cmd` for `--steps` control steps on the task's
env with the reference's eval overrides (no observation noise, pushes,
friction, base-mass or dynamic randomization, no action delay). It writes
`openloop_action.npz` (env 0's first 100 actions), the traces of env 0 in
`eval_states.npz` and, where matplotlib imports, the dashboard `eval.png`,
all into --out-dir (default: <run dir>/play). The traces stay on the
device during the rollout and are copied off once at the end. `--video`
also records `play.mp4`: env 0 every 3 control steps, rendered offscreen
(deploy/video.py; MuJoCo, OpenCV and GL, EGL by default) on the MJCF that
physics/mjcf_export.py writes for the played robot (`play_robot.xml`).

Runs on the card unless `--device cpu` is given; without a card it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

TRACE_KEYS = ("dof_pos", "dof_pos_target", "dof_vel", "base_vel_x", "base_vel_y", "base_vel_z",
              "base_vel_yaw", "command_x", "command_y", "command_yaw", "base_height")
TRACED_JOINT = 2
OPENLOOP_STEPS = 100
VIDEO_EVERY = 3             # control steps per video frame: ~33 fps at 100 Hz


def get_args(argv=None):
    p = argparse.ArgumentParser(description="humanoid_tpu_torch eval and export")
    p.add_argument("--task", default="humanoid_ppo")
    p.add_argument("--num-envs", "--num_envs", dest="num_envs", type=int, default=1)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--load-run", "--load_run", dest="load_run", default="-1")
    p.add_argument("--checkpoint", type=int, default=-1)
    p.add_argument("--cmd", type=float, nargs=3, default=[0.5, 0.0, 0.0])
    p.add_argument("--log-root", dest="log_root")
    p.add_argument("--out-dir", dest="out_dir")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--urdf", default=None,
                   help="robot URDF (default: the task's stand-in; on an 18-dof task, a "
                        "URDF with fixed arm joints, which are made revolute)")
    p.add_argument("--video", action="store_true",
                   help="record a camera-follow mp4 of env 0 (an offscreen MuJoCo replay of "
                        "the rollout)")
    return p.parse_args(argv)


def kernel_launches(env) -> dict:
    """Launches so far of each kernel wrapper of `env`."""
    return {"control_step_kernel": env.physics.launches,
            "terrain_sampler_kernel": env.sampler.launches if env.sampler is not None else 0,
            **{f"{k}_kernel": v for k, v in env.cholesky.launches.items()}}


def eval_cfg(env_cfg, num_envs: int):
    """The reference's eval overrides (play.py:49-59)."""
    from ..config.structs import DomainRandCfg, NoiseCfg

    return env_cfg.replace(
        env=dataclasses.replace(env_cfg.env, num_envs=num_envs),
        noise=NoiseCfg(add_noise=False),
        domain_rand=DomainRandCfg(randomize_friction=False, randomize_base_mass=False,
                                  push_robots=False, dynamic_randomization=0.0,
                                  action_delay=False))


def main(argv=None):
    """Export and roll out; returns {"final_z", "npz", "kernel_launches"
    (the control-step kernel's launches in the `--steps` loop), "launches"
    (every kernel's, by name), "steps", "rollout_s", "steps_per_s",
    "finite", "out_dir", "video" (the mp4's path, or None)}."""
    from ..algo.runner import OnPolicyRunner
    from ..deploy.export import export_policy_npz, export_policy_onnx, export_policy_torchscript
    from ..physics.spatial import quat_rotate_inverse
    from ..utils import registry
    from ..utils.checkpoint import get_load_path
    from ..utils.eval_logger import EvalLogger
    from .train import resolve_device

    args = get_args(argv)
    device = resolve_device(args.device)
    env_cfg, train_cfg = registry.get_cfgs(args.task)
    env_cfg = eval_cfg(env_cfg, args.num_envs)
    urdf, joint_order = registry.robot(env_cfg, args.urdf)
    env = registry.build_env(env_cfg, urdf, device, joint_order)
    runner = OnPolicyRunner(env, train_cfg)
    root = os.path.join(args.log_root or registry.LOG_ROOT, train_cfg.runner.experiment_name)
    path = get_load_path(root, args.load_run, args.checkpoint)
    print(f"loading checkpoint: {path}", flush=True)
    runner.load(path)

    out_dir = args.out_dir or os.path.join(os.path.dirname(path), "play")
    os.makedirs(out_dir, exist_ok=True)
    net = runner.net
    npz_path = export_policy_npz(net, os.path.join(out_dir, "policy.npz"),
                                 meta={"iteration": runner.iteration})
    ts = export_policy_torchscript(net, out_dir)
    onnx_path = export_policy_onnx(net, os.path.join(out_dir, "policy.onnx"),
                                   env_cfg.env.num_observations)
    print(f"exported: {npz_path}, {', '.join(ts)}, {os.path.basename(onnx_path)}", flush=True)

    N, T, j = args.num_envs, args.steps, TRACED_JOINT
    policy = runner.inference_policy()
    gen = torch.Generator(device=device).manual_seed(0)
    cmd = torch.tensor(args.cmd + [0.0], device=device).expand(N, 4).contiguous()
    actions = torch.zeros(min(T, OPENLOOP_STEPS), env.nj, device=device)
    traces = torch.zeros(T, len(TRACE_KEYS), device=device)
    # env 0's base position, orientation and joints every VIDEO_EVERY steps
    frames = torch.zeros(-(-T // VIDEO_EVERY) if args.video else 0, 7 + env.nj, device=device)
    with torch.no_grad():
        state = env.initial_state(gen)
        state, out = env.step(state, torch.zeros(N, env.nj, device=device), gen)
        launches0 = kernel_launches(env)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for i in range(T):
            state = state._replace(commands=cmd)
            action = policy(out.obs)
            if i < OPENLOOP_STEPS:
                actions[i] = action[0]
            state, out = env.step(state, action, gen)
            p = state.phys
            v_body = quat_rotate_inverse(p.base_quat[0], p.u[0, 3:6])
            w_body = quat_rotate_inverse(p.base_quat[0], p.u[0, 0:3])
            traces[i] = torch.cat([p.qj[0, j:j + 1], action[0, j:j + 1] * 0.25,
                                   p.u[0, 6 + j:7 + j], v_body, w_body[2:3], cmd[0, 0:3],
                                   p.base_pos[0, 2:3]])
            if args.video and i % VIDEO_EVERY == 0:
                frames[i // VIDEO_EVERY] = torch.cat([p.base_pos[0], p.base_quat[0], p.qj[0]])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rollout_s = time.perf_counter() - t0
    launches = {k: v - launches0[k] for k, v in kernel_launches(env).items()}

    logger = EvalLogger(env.dt)
    for row in traces.cpu().numpy():
        logger.log_states(dict(zip(TRACE_KEYS, row)))
    np.savez(os.path.join(out_dir, "openloop_action.npz"), action=actions.cpu().numpy())
    logger.save_states(os.path.join(out_dir, "eval_states.npz"))
    png = logger.plot_states(os.path.join(out_dir, "eval.png"))
    video = None
    if args.video:
        video = record_video(env, frames.cpu().numpy(), out_dir)
    p = state.phys
    finite = bool(all(torch.isfinite(x).all() for x in p))
    z = float(p.base_pos[0, 2])
    print(f"rollout done: {T} steps of {N} envs in {rollout_s:.3f} s, final base z {z:.3f}, "
          f"finite {finite}, plots: {png}, actions: openloop_action.npz", flush=True)
    return {"final_z": z, "npz": npz_path, "kernel_launches": launches["control_step_kernel"],
            "launches": launches, "steps": T,
            "rollout_s": rollout_s, "steps_per_s": T / rollout_s, "finite": finite,
            "out_dir": out_dir, "video": video}


def record_video(env, frames, out_dir: str) -> str:
    """`play.mp4` of the rows [base_pos, base_quat, qj] of `frames`,
    rendered on the MJCF exported from the env's robot (play_robot.xml)."""
    from ..assets import _write_text
    from ..deploy.video import VideoRecorder
    from ..physics.mjcf_export import model_to_mjcf

    mjcf = _write_text(os.path.join(out_dir, "play_robot.xml"),
                       model_to_mjcf(env.model, with_floor=True))
    recorder = VideoRecorder(os.path.join(out_dir, "play.mp4"), mjcf,
                             fps=1.0 / (VIDEO_EVERY * env.dt))
    for row in frames:
        recorder.add_state(row[0:3], row[3:7], row[7:])
    path = recorder.close()
    print(f"video: {path} ({recorder.frames} frames)", flush=True)
    return path


if __name__ == "__main__":
    main()
