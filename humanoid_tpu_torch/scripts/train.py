"""Training entry point of the port.

  python -m humanoid_tpu_torch.scripts.train --task humanoid_ppo \
      --max-iterations 3 [--num-envs 4096] [--device cuda] [--urdf PATH] \
      [--log-root DIR] [--experiment-name NAME] [--run-name NAME] [--full-state] \
      [--profile N] [--mesh [--multihost]] [--eval-gate [SECONDS]] [--wandb] \
      [--iters-per-dispatch K]
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

The runner trains `runner.iters_per_dispatch` iterations per dispatch
(algo/runner.py::OnPolicyRunner.learn; on one card, replays of a CUDA
graph) and pulls their metrics once per dispatch; `--iters-per-dispatch K`
sets it, and K = 1 trains one synchronized iteration at a time, with each
iteration's rollout and update seconds. Rank 0 prints the reference's
console block (utils/logging.py::TrainLogger.console) every
`runner.log_interval` iterations.

`--profile N` trains one warm-up iteration, then N inside a torch.profiler
trace (utils/profiling.py::device_trace), then the rest, all at one
synchronized iteration per dispatch; the trace lands in
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

`--mesh` trains data-parallel over ranks, one process per rank, each on
its share of the envs (parallel/mesh.py), as one process with every env
would: under a launcher (`torchrun --nproc-per-node G -m
humanoid_tpu_torch.scripts.train --mesh ...`) over the launcher's ranks;
launched alone, over one rank per visible card (parallel/dist.py::launch
starts them and the run fails if any rank fails), or, with one card or on
the CPU, in a process group of this process alone. `--num-envs` is the
global count, which the ranks must divide. The backend is `nccl` when
every rank has a card of its own, else `gloo`. Rank 0 alone prints, logs
and saves; `--full-state` saves no exact state over several ranks.
`--multihost` requires the launcher's environment (RANK, WORLD_SIZE,
LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT), for ranks on
several nodes, and raises without it.

`--eval-gate [SECONDS]` replays every saved checkpoint in MuJoCo for
SECONDS of simulated time (default 60) in a CPU subprocess
(deploy/eval_gate.py; MuJoCo must import there), while training goes on;
the verdicts land in <run dir>/eval_gate.jsonl, and the run waits for the
last of them before it returns. `--wandb` mirrors the logged scalars to an
offline wandb run, and goes on without where wandb does not import. Rank 0
alone owns the gate and the logger.

Runs on the card unless `--device cpu` is given; without a card it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch

from ..parallel import dist


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
    p.add_argument("--mesh", action="store_true",
                   help="train data-parallel over ranks, the env axis split over them "
                        "(under a launcher its ranks, else one per visible card)")
    p.add_argument("--multihost", action="store_true",
                   help="take the ranks from the launcher's environment (torchrun), and fail "
                        "without it (use with --mesh)")
    p.add_argument("--eval-gate", dest="eval_gate", nargs="?", const=60.0, type=float,
                   default=None, metavar="SECONDS",
                   help="replay every checkpoint in MuJoCo in a CPU subprocess (the sim2sim "
                        "gate); the optional value is the replay's length in sim seconds")
    p.add_argument("--wandb", action="store_true",
                   help="mirror the logged scalars to an offline wandb run (goes on without "
                        "where wandb does not import)")
    p.add_argument("--iters-per-dispatch", dest="iters_per_dispatch", type=int, metavar="K",
                   help="iterations per dispatch (runner.iters_per_dispatch; 1: one "
                        "synchronized iteration at a time)")
    return p.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    return torch.device(name)


def main(argv=None, log_fn=None):
    """Train; returns (runner, last iteration carry), or (None, None) in
    the process that started the ranks of `--mesh` (see the module's
    docstring). log_fn(it, metrics, env_steps_per_s), called on every
    rank, replaces the console block that rank 0 prints every
    `runner.log_interval` iterations; rank 0 writes metrics.jsonl either
    way."""
    args = get_args(argv)
    if args.multihost and not args.mesh:
        raise ValueError("--multihost takes its ranks for --mesh: pass both")
    if args.multihost and not dist.launched():
        raise RuntimeError("--multihost needs the launcher's environment "
                           f"({', '.join(dist.LAUNCH_VARS)}): start the ranks with torchrun")
    if not args.mesh:
        return _train(args, resolve_device(args.device), log_fn)
    if dist.launched():
        made_group = dist.init_from_env(args.device)
    else:
        ranks = 1
        if args.device == "cuda":
            resolve_device(args.device)
            ranks = torch.cuda.device_count()
        if ranks > 1:
            # one rank per visible card, each this same command under the
            # launcher's variables; rank 0 prints
            dist.launch(ranks, ["-m", "humanoid_tpu_torch.scripts.train",
                                *(sys.argv[1:] if argv is None else argv)],
                        timeout=float("inf"), echo_rank0=True)
            return None, None
        made_group = dist.init_single(args.device)
    try:
        return _train(args, dist.device_for_rank(args.device), log_fn)
    finally:
        if made_group:
            torch.distributed.destroy_process_group()


def _train(args, device, log_fn):
    from ..utils import registry
    from ..utils.checkpoint import get_load_path, state_path_of
    from ..utils.logging import TrainLogger

    env, env_cfg, train_cfg = registry.make_env(args.task, args, device=device, urdf=args.urdf,
                                                sharded=args.mesh)
    main_rank = dist.is_main()
    runner_over = {}
    if args.full_state:
        runner_over["save_env_state"] = True
    if args.iters_per_dispatch is not None:
        if args.iters_per_dispatch < 1 or (args.profile and args.iters_per_dispatch != 1):
            raise ValueError(f"--iters-per-dispatch {args.iters_per_dispatch}: need 1 or more, "
                             "and 1 with --profile")
        runner_over["iters_per_dispatch"] = args.iters_per_dispatch
    if args.profile:
        runner_over["iters_per_dispatch"] = 1     # the trace's rollout spans: eager iterations
    if runner_over:
        train_cfg = train_cfg.replace(runner=dataclasses.replace(train_cfg.runner,
                                                                 **runner_over))
    carry = None
    resume_from = None
    if train_cfg.runner.resume:
        # look up the checkpoint before this run's directory exists
        root = os.path.join(args.log_root or registry.LOG_ROOT, train_cfg.runner.experiment_name)
        resume_from = get_load_path(root, args.load_run, args.checkpoint)
    runner = registry.make_alg_runner(env, train_cfg, log_root=args.log_root)
    if resume_from is not None:
        state_path = state_path_of(resume_from)
        # an exact state holds every env: one rank alone resumes from it
        if os.path.isfile(state_path + ".pt") and dist.process_count() == 1:
            print(f"resuming exact state from {state_path}", flush=True)
            carry = runner.load_state(state_path)
        else:
            if main_rank:
                print(f"resuming from {resume_from}", flush=True)
            runner.load(resume_from)
    total = train_cfg.runner.max_iterations
    # rank 0 alone logs, prints and runs the eval gate
    logger = TrainLogger(runner.log_dir, env.reward_names, env_cfg, train_cfg,
                         use_wandb=args.wandb) if main_rank else None
    gate = None
    if args.eval_gate and runner.log_dir and main_rank:
        from ..deploy.eval_gate import CheckpointEvalGate

        gate = CheckpointEvalGate(runner.log_dir, duration=args.eval_gate, task=args.task,
                                  extra_argv=("--urdf", args.urdf) if args.urdf else ())
        runner.on_checkpoint = gate

    every = train_cfg.runner.log_interval

    def on_iteration(it, m, fps):
        if logger is not None:
            scalars = logger.log(it, m, fps, m.iteration_s)
            if log_fn is None and it % every == 0:
                print(logger.console(it, total, scalars), flush=True)
        if log_fn is not None:
            log_fn(it, m, fps)

    if main_rank:
        print(f"task={args.task} envs={env_cfg.env.num_envs} iters={total} device={device} "
              f"log_dir={runner.log_dir}", flush=True)
    try:
        if args.profile:
            from ..utils.profiling import device_trace

            # warm up outside the trace, then trace N iterations, then the rest
            carry = runner.learn(1, log_fn=on_iteration, carry=carry)
            with device_trace(runner.log_dir):
                carry = runner.learn(args.profile, log_fn=on_iteration, carry=carry)
            if main_rank:
                print(f"trace written under {runner.log_dir}", flush=True)
            if total > 1 + args.profile:
                carry = runner.learn(total - 1 - args.profile, log_fn=on_iteration, carry=carry)
        else:
            carry = runner.learn(total, log_fn=on_iteration, carry=carry)
    finally:
        if gate is not None:
            gate.wait_all()
            n_pass = sum(1 for r in gate.results if r.get("passed"))
            print(f"[eval-gate] {n_pass}/{len(gate.results)} checkpoints passed "
                  f"({gate.jsonl_path})", flush=True)
        if logger is not None:
            logger.close()
    return runner, carry


if __name__ == "__main__":
    main()
