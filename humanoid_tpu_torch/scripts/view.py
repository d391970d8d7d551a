"""Interactive live viewer of the port: the reference package's
scripts/view.py.

The port's physics has no renderer, so the live view mirrors the simulated
generalized coordinates into a MuJoCo model of the robot (the MJCF that
physics/mjcf_export.py writes from the task's robot) inside a
`mujoco.viewer.launch_passive` window with a base-tracking camera, while
the policy and the physics step on the card (1 env, the task's B1 kernel
instance; penalty contact unless told otherwise). Keyboard (besides the
viewer's own ESC to quit):

  V            toggle viewer sync (free-run the sim)
  W/S A/D Q/E  vx +/-, vy +/-, wyaw +/- command increments
  Z            zero the command
  P            push the robot (a random horizontal base velocity kick)
  R            reset the environment

A headless machine (no display) cannot open the window; the CLI then exits
2 with a pointer to `play --video` (an offscreen mp4).

  python -m humanoid_tpu_torch.scripts.view --task humanoid_ppo \
      [--log-root DIR] [--load-run RUN] [--checkpoint IT] | [--policy policy.npz] \
      [--cmd 0.5 0 0] [--device cuda] [--urdf PATH]

Runs on the card unless `--device cpu` is given; without a card it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch


def get_args(argv=None):
    p = argparse.ArgumentParser(description="humanoid_tpu_torch live viewer")
    p.add_argument("--task", default="humanoid_ppo")
    p.add_argument("--load-run", "--load_run", dest="load_run", default="-1")
    p.add_argument("--checkpoint", type=int, default=-1)
    p.add_argument("--log-root", dest="log_root")
    p.add_argument("--cmd", type=float, nargs=3, default=[0.5, 0.0, 0.0])
    p.add_argument("--policy", default="",
                   help="replay an exported .npz policy instead of a checkpoint (no logs "
                        "directory needed)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--urdf", default=None, help="robot URDF (default: the task's stand-in)")
    return p.parse_args(argv)


class ViewerSession:
    """Owns the env and policy stepping and the command, push and reset
    state, apart from the window loop, so that the control logic runs
    headless (tests/test_torch_viewer.py).

    The env is the task's at 1 env with the reference's eval overrides (no
    observation noise, no randomization, no pushes, no action delay), on
    `contact` ("penalty" by default; None keeps the task's own contact
    model), on `device` with an explicit generator seeded 0. `load` is the
    policy, obs tensor -> action tensor (default: zero actions)."""

    def __init__(self, task: str, cmd, load=None, contact="penalty", device="cuda",
                 urdf=None):
        from ..utils import registry
        from .play import eval_cfg
        from .train import resolve_device

        self.device = resolve_device(device)
        env_cfg, train_cfg = registry.get_cfgs(task)
        env_cfg = eval_cfg(env_cfg, 1)
        env_cfg = env_cfg.replace(sim=dataclasses.replace(
            env_cfg.sim, contact_model=contact or env_cfg.sim.contact_model))
        urdf_path, joint_order = registry.robot(env_cfg, urdf)
        self.env = registry.build_env(env_cfg, urdf_path, self.device, joint_order)
        self.train_cfg = train_cfg
        self.cmd = np.asarray(list(cmd) + [0.0], dtype=np.float32)
        self.sync = True
        self.gen = torch.Generator(device=self.device).manual_seed(0)
        self.policy = load if load is not None else (lambda obs: 0 * obs[:, :self.env.nj])
        self.reset()

    # -- control ----------------------------------------------------------

    @torch.no_grad()
    def reset(self) -> None:
        self.state = self.env.initial_state(self.gen)
        self.state, self.out = self.env.step(
            self.state, torch.zeros(1, self.env.nj, device=self.device), self.gen)

    def push(self, magnitude: float = 0.8) -> None:
        """The reference's _push_robots semantics: kick the base velocity."""
        kick = (torch.rand(2, generator=self.gen, device=self.device) * 2 - 1) * magnitude
        phys = self.state.phys
        u = phys.u.clone()
        u[:, 3:5] += kick
        self.state = self.state._replace(phys=phys._replace(u=u))

    def adjust_cmd(self, dvx=0.0, dvy=0.0, dwz=0.0, zero=False) -> None:
        if zero:
            self.cmd[:] = 0.0
        else:
            self.cmd[0] = float(np.clip(self.cmd[0] + dvx, -1.0, 1.5))
            self.cmd[1] = float(np.clip(self.cmd[1] + dvy, -1.0, 1.0))
            self.cmd[2] = float(np.clip(self.cmd[2] + dwz, -1.0, 1.0))

    def handle_key(self, ch: str) -> None:
        """The keyboard's dispatch (see the module's docstring)."""
        ch = ch.upper()
        inc = 0.1
        if ch == "V":
            self.sync = not self.sync
        elif ch == "W":
            self.adjust_cmd(dvx=+inc)
        elif ch == "S":
            self.adjust_cmd(dvx=-inc)
        elif ch == "A":
            self.adjust_cmd(dvy=+inc)
        elif ch == "D":
            self.adjust_cmd(dvy=-inc)
        elif ch == "Q":
            self.adjust_cmd(dwz=+inc)
        elif ch == "E":
            self.adjust_cmd(dwz=-inc)
        elif ch == "Z":
            self.adjust_cmd(zero=True)
        elif ch == "P":
            self.push()
        elif ch == "R":
            self.reset()

    @torch.no_grad()
    def step(self) -> tuple:
        """One control step; returns env 0's (base_pos, base_quat_wxyz, qj)
        as numpy arrays."""
        self.state = self.state._replace(
            commands=torch.as_tensor(self.cmd, device=self.device)[None, :])
        action = self.policy(self.out.obs)
        self.state, self.out = self.env.step(self.state, action, self.gen)
        phys = self.state.phys
        return (phys.base_pos[0].cpu().numpy(), phys.base_quat[0].cpu().numpy(),
                phys.qj[0].cpu().numpy())


class WindowUnavailable(RuntimeError):
    """The viewer window could not be opened: no mujoco.viewer, no display
    or no GL."""


def run_window(session: ViewerSession) -> None:
    """The on-screen loop at wall-clock rate: MuJoCo's passive viewer with
    the key callback, on the MJCF exported from the session's robot. A
    failure to open the window raises WindowUnavailable; an error of the
    session's steps comes through as it is."""
    try:
        import mujoco
        import mujoco.viewer
    except ImportError as e:
        raise WindowUnavailable(repr(e)) from e

    from ..physics.mjcf_export import model_to_mjcf

    model = mujoco.MjModel.from_xml_string(model_to_mjcf(session.env.model, with_floor=True))
    data = mujoco.MjData(model)
    base_id = mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_BODY, "base_link")
    nj = session.env.nj

    def key_cb(keycode):
        try:
            session.handle_key(chr(keycode))
        except ValueError:            # a key code with no character
            pass

    try:
        window = mujoco.viewer.launch_passive(model, data, key_callback=key_cb)
    except Exception as e:       # no display, no GL
        raise WindowUnavailable(repr(e)) from e
    with window as viewer:
        viewer.cam.type = mujoco.mjtCamera.mjCAMERA_TRACKING
        viewer.cam.trackbodyid = base_id
        viewer.cam.distance = 3.0
        dt = session.env.dt
        while viewer.is_running():
            t0 = time.time()
            pos, quat, qj = session.step()
            if session.sync:
                data.qpos[0:3] = pos - model.body_pos[base_id]
                data.qpos[3:7] = quat
                data.qpos[-nj:] = qj
                mujoco.mj_forward(model, data)
                viewer.sync()
            time.sleep(max(0.0, dt - (time.time() - t0)))


def npz_policy(path: str):
    """An exported .npz policy (deploy/npz_policy.py) as obs tensor ->
    action tensor."""
    from ..deploy.npz_policy import NpzPolicy

    npz = NpzPolicy(path)

    def policy(obs):
        return torch.as_tensor(npz(obs.cpu().numpy()), device=obs.device)

    return policy


def view(args) -> None:
    session = ViewerSession(args.task, args.cmd,
                            load=npz_policy(args.policy) if args.policy else None,
                            device=args.device, urdf=args.urdf)
    if not args.policy:
        from ..algo.runner import OnPolicyRunner
        from ..utils import registry
        from ..utils.checkpoint import get_load_path

        runner = OnPolicyRunner(session.env, session.train_cfg)
        root = os.path.join(args.log_root or registry.LOG_ROOT,
                            session.train_cfg.runner.experiment_name)
        path = get_load_path(root, args.load_run, args.checkpoint)
        print(f"loading checkpoint: {path}")
        runner.load(path)
        session.policy = runner.inference_policy()
    try:
        run_window(session)
    except WindowUnavailable as e:       # say what to use instead
        print(f"viewer window unavailable ({e}); this host is headless.\n"
              f"Use `python -m humanoid_tpu_torch.scripts.play --task {args.task} --video` "
              f"for an offscreen mp4 instead.", file=sys.stderr)
        sys.exit(2)


if __name__ == "__main__":
    view(get_args())
