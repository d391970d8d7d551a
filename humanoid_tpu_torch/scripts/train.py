"""Training entry point of the port.

  python -m humanoid_tpu_torch.scripts.train --task humanoid_ppo \
      --max-iterations 3 [--num-envs 4096] [--device cuda] [--urdf PATH] \
      [--log-root DIR] [--experiment-name NAME] [--run-name NAME] [--full-state] \
      [--profile N]
  python -m humanoid_tpu_torch.scripts.train --task humanoid_ppo --resume \
      [--load-run RUN] [--checkpoint IT] --max-iterations 100

Tasks: humanoid_ppo, humanoid_ppo_penalty, humanoid_ppo_terrain,
humanoid_ppo_trimesh, humanoid_ppo_pgs, humanoid_ppo_robust,
humanoid_ppo_transfer, humanoid_ppo_omni, humanoid_ppo_envelope,
humanoid_ppo_8k, humanoid_ppo_sym, and the 18-dof d11_ppo, d11_ppo_pgs and
d12_ppo (utils/registry.py). `--contact penalty|pgs` overrides the task's
contact model, `--terrain` its mesh type. `--urdf PATH` replaces the
task's stand-in robot; on an 18-dof task it takes an XBot-L URDF with
fixed arm joints and makes its six arm joints revolute.

`--profile N` trains one warm-up iteration, then N inside a torch.profiler
trace (utils/profiling.py::device_trace), then the rest; the trace lands in
the run directory as <host>_<pid>.<time>.pt.trace.json, which Perfetto
(ui.perfetto.dev) opens, and TensorBoard with its PyTorch profiler plugin
(`tensorboard --logdir <run dir>`).

A run writes into <log-root>/<experiment>/<%b%d_%H-%M-%S>_<run-name>/
(log root: --log-root, else $HUMANOID_TPU_LOGS, else <repo>/logs):
`model_<it>.pt` every `runner.save_interval` iterations and at the end,
`state_<it>.pt` beside it with --full-state, and `metrics.jsonl` (and
tensorboard events where tensorboard imports). `--resume` continues the
latest run (or --load-run / --checkpoint) for --max-iterations more:
from the exact state when its `state_<it>.pt` exists, else from the model
and optimizer with fresh envs.

Runs on the card unless `--device cpu` is given; without a card it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch


def get_args(argv=None):
    p = argparse.ArgumentParser(description="humanoid_tpu_torch trainer")
    p.add_argument("--task", default="humanoid_ppo")
    p.add_argument("--num-envs", "--num_envs", dest="num_envs", type=int)
    p.add_argument("--seed", type=int)
    p.add_argument("--max-iterations", "--max_iterations", dest="max_iterations", type=int)
    p.add_argument("--experiment-name", "--experiment_name", dest="experiment_name")
    p.add_argument("--run-name", "--run_name", dest="run_name")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--load-run", "--load_run", dest="load_run", default="-1")
    p.add_argument("--checkpoint", type=int, default=-1)
    p.add_argument("--terrain", choices=["plane", "heightfield", "trimesh"])
    p.add_argument("--contact", choices=["penalty", "pgs"],
                   help="contact model override: the block-PGS solve or the penalty model")
    p.add_argument("--log-root", dest="log_root")
    p.add_argument("--full-state", dest="full_state", action="store_true",
                   help="save the whole iteration carry and the generator beside each "
                        "model_<it>, so that --resume repeats the unbroken run")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--urdf", default=None,
                   help="robot URDF (default: the task's stand-in; on an 18-dof task, a "
                        "URDF with fixed arm joints, which are made revolute)")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="trace N iterations with torch.profiler after one warm-up iteration "
                        "(the trace goes into the run directory)")
    return p.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    return torch.device(name)


def main(argv=None, log_fn=None):
    """Train; returns (runner, last iteration carry). log_fn(it, metrics,
    env_steps_per_s) replaces the default one-JSON-line-per-iteration log;
    metrics.jsonl is written either way."""
    from ..utils import registry
    from ..utils.checkpoint import get_load_path, state_path_of
    from ..utils.logging import TrainLogger

    args = get_args(argv)
    device = resolve_device(args.device)
    env, env_cfg, train_cfg = registry.make_env(args.task, args, device=device, urdf=args.urdf)
    if args.full_state:
        train_cfg = train_cfg.replace(runner=dataclasses.replace(train_cfg.runner,
                                                                 save_env_state=True))
    carry = None
    resume_from = None
    if train_cfg.runner.resume:
        # look up the checkpoint before this run's directory exists
        root = os.path.join(args.log_root or registry.LOG_ROOT, train_cfg.runner.experiment_name)
        resume_from = get_load_path(root, args.load_run, args.checkpoint)
    runner = registry.make_alg_runner(env, train_cfg, log_root=args.log_root)
    if resume_from is not None:
        state_path = state_path_of(resume_from)
        if os.path.isfile(state_path + ".pt"):
            print(f"resuming exact state from {state_path}", flush=True)
            carry = runner.load_state(state_path)
        else:
            print(f"resuming from {resume_from}", flush=True)
            runner.load(resume_from)
    total = train_cfg.runner.max_iterations
    logger = TrainLogger(runner.log_dir, env.reward_names, env_cfg, train_cfg)

    def console(it, m, fps):
        print(json.dumps({
            "it": it, "of": total, "env_steps_per_s": fps,
            "rollout_s": m.rollout_s, "update_s": m.update_s,
            "mean_reward": float(m.mean_step_reward),
            "value_loss": float(m.update.value_loss),
            "surrogate_loss": float(m.update.surrogate_loss),
            "sym_loss": float(m.update.sym_loss), "lr": float(m.update.lr),
        }), flush=True)

    def on_iteration(it, m, fps):
        logger.log(it, m, fps, m.rollout_s + m.update_s)
        (log_fn or console)(it, m, fps)

    print(f"task={args.task} envs={env_cfg.env.num_envs} iters={total} device={device} "
          f"log_dir={runner.log_dir}", flush=True)
    try:
        if args.profile:
            from ..utils.profiling import device_trace

            # warm up outside the trace, then trace N iterations, then the rest
            carry = runner.learn(1, log_fn=on_iteration, carry=carry)
            with device_trace(runner.log_dir):
                carry = runner.learn(args.profile, log_fn=on_iteration, carry=carry)
            print(f"trace written under {runner.log_dir}", flush=True)
            if total > 1 + args.profile:
                carry = runner.learn(total - 1 - args.profile, log_fn=on_iteration, carry=carry)
        else:
            carry = runner.learn(total, log_fn=on_iteration, carry=carry)
    finally:
        logger.close()
    return runner, carry


if __name__ == "__main__":
    main()
