"""Training log of the port: the reference package's TrainLogger
(utils/logging.py) with its scalar names, so that a tool written for the
reference's logs reads the port's.

Each iteration's scalars (`Loss/*`, `Policy/*`, `Train/*`, `Perf/*`, the
terrain curriculum's `Train/terrain_level_*` where levels are non-zero, and
`Episode/rew_<name>`) are appended to `<run>/metrics.jsonl`, and written to
tensorboard where `torch.utils.tensorboard` imports. `console()` formats
the reference's console block. With `use_wandb` (train --wandb) they also
go to a wandb run of the experiment, offline unless WANDB_MODE says
otherwise; where wandb does not import, the run goes on without it.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional


class TrainLogger:
    def __init__(self, log_dir: Optional[str], reward_names, env_cfg, train_cfg,
                 use_wandb: bool = False):
        self.log_dir = log_dir
        self.reward_names = list(reward_names)
        self.episode_length_s = env_cfg.env.episode_length_s
        self.num_envs = env_cfg.env.num_envs
        self.steps_per_env = train_cfg.runner.num_steps_per_env
        self.tot_steps = 0
        self.t_start = time.time()
        self.writer = None
        self.jsonl = None
        self.wandb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self.jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.writer = SummaryWriter(log_dir=log_dir, flush_secs=10)
            except ImportError:       # no tensorboard package: metrics.jsonl only
                pass
            if use_wandb:
                try:
                    import wandb
                except ImportError:
                    print("--wandb: wandb does not import; logging without it", flush=True)
                else:
                    self.wandb = wandb.init(project=train_cfg.runner.experiment_name,
                                            name=os.path.basename(log_dir), dir=log_dir,
                                            mode=os.environ.get("WANDB_MODE", "offline"))

    def log(self, it: int, metrics, fps: float, iter_time: float) -> dict:
        m = metrics
        ep_count = max(1.0, float(m.ep_count))
        ep_rew = m.ep_rew_sums.tolist()
        scalars = {
            "Loss/value_function": float(m.update.value_loss),
            "Loss/surrogate": float(m.update.surrogate_loss),
            "Loss/base_lin_vel": float(m.update.vel_loss),
            "Loss/sym": float(m.update.sym_loss),
            "Loss/learning_rate": float(m.update.lr),
            "Policy/mean_noise_std": float(m.mean_action_std),
            "Policy/kl": float(m.update.kl),
            "Train/mean_reward": sum(ep_rew) / ep_count / self.episode_length_s,
            "Train/mean_episode_length": float(m.ep_len_sum) / ep_count,
            "Train/mean_step_reward": float(m.mean_step_reward),
            "Train/ep_fail_frac": float(m.ep_term_count) / ep_count,
            "Perf/total_fps": fps,
            "Perf/iter_time": iter_time,
        }
        level = float(m.terrain_level_mean)
        if level:
            scalars["Train/terrain_level_mean"] = level
            for i, share in enumerate(m.terrain_level_hist.tolist()):
                scalars[f"Train/terrain_level_occ_{i}"] = share
        for name, v in zip(self.reward_names, ep_rew):
            scalars[f"Episode/rew_{name}"] = v / ep_count / self.episode_length_s
        self.tot_steps += self.num_envs * self.steps_per_env
        if self.writer is not None:
            for k, v in scalars.items():
                self.writer.add_scalar(k, v, it)
        if self.jsonl is not None:
            self.jsonl.write(json.dumps({"it": it, **scalars}) + "\n")
            self.jsonl.flush()
        if self.wandb is not None:
            self.wandb.log(scalars, step=it)
        return scalars

    def console(self, it: int, total_iters: int, scalars: dict) -> str:
        """The reference's console block."""
        elapsed = time.time() - self.t_start
        width = 68
        lines = [
            "#" * width,
            f" Learning iteration {it}/{total_iters} ".center(width, " "),
            "",
            f"{'Computation:':>28} {scalars['Perf/total_fps']:,.0f} steps/s "
            f"({self.num_envs} envs x {self.steps_per_env} steps)",
            f"{'Value function loss:':>28} {scalars['Loss/value_function']:.4f}",
            f"{'Surrogate loss:':>28} {scalars['Loss/surrogate']:.4f}",
            f"{'Vel estimator loss:':>28} {scalars['Loss/base_lin_vel']:.4f}",
            f"{'Learning rate:':>28} {scalars['Loss/learning_rate']:.2e}",
            f"{'Mean action noise std:':>28} {scalars['Policy/mean_noise_std']:.2f}",
            f"{'Mean reward:':>28} {scalars['Train/mean_reward']:.2f}",
            f"{'Mean episode length:':>28} {scalars['Train/mean_episode_length']:.2f}",
            "-" * width,
            f"{'Total timesteps:':>28} {self.tot_steps:,}",
            f"{'Iteration time:':>28} {scalars['Perf/iter_time']:.2f}s",
            f"{'Total time:':>28} {elapsed:.2f}s",
            f"{'ETA:':>28} {elapsed / max(1, it) * (total_iters - it):.1f}s",
        ]
        return "\n".join(lines)

    def close(self):
        if self.writer is not None:
            self.writer.close()
        if self.jsonl is not None:
            self.jsonl.close()
        if self.wandb is not None:
            self.wandb.finish()
