"""Evaluation traces of a `play` rollout: the reference package's
utils/eval_logger.py (its `log_states`, `log_rewards`, `print_rewards` and
the 3x3 dashboard of `plot_states`).

`save_states` always writes the traces to an `.npz`; `plot_states` draws
the PNG only where matplotlib imports, and says so on stdout where it does
not.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional

import numpy as np


class EvalLogger:
    def __init__(self, dt: float):
        self.dt = dt
        self.state_log = defaultdict(list)
        self.rew_log = defaultdict(list)
        self.num_episodes = 0

    def log_state(self, key: str, value):
        self.state_log[key].append(np.asarray(value))

    def log_states(self, d: Dict):
        for k, v in d.items():
            self.log_state(k, v)

    def log_rewards(self, d: Dict, num_episodes: int):
        for k, v in d.items():
            if "rew" in k:
                self.rew_log[k].append(float(v) * num_episodes)
        self.num_episodes += num_episodes

    def print_rewards(self):
        print("Average rewards per second:")
        for k, values in self.rew_log.items():
            print(f" - {k}: {np.sum(np.array(values)) / max(1, self.num_episodes):.4f}")
        print(f"Total number of episodes: {self.num_episodes}")

    def save_states(self, path: str) -> str:
        """Every trace as one array (steps, ...) under its key, and `dt`."""
        np.savez(path, dt=np.asarray(self.dt),
                 **{k: np.asarray(v) for k, v in self.state_log.items()})
        return path

    def plot_states(self, path: Optional[str] = None) -> Optional[str]:
        """The 3x3 dashboard (joint tracking, base velocities, contact
        forces, base height) written to `path`; None without matplotlib."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("plot_states: matplotlib does not import, no dashboard written "
                  "(the traces are in the .npz)")
            return None
        log = {k: np.array(v) for k, v in self.state_log.items()}
        n = len(next(iter(log.values()))) if log else 0
        time = np.arange(n) * self.dt
        fig, axs = plt.subplots(3, 3, figsize=(15, 10))

        def plot(ax, keys, title, ylabel):
            for key, label in keys:
                if key in log and len(log[key]):
                    lines = ax.plot(time[:len(log[key])], log[key])
                    lines[0].set_label(label)
            ax.set(title=title, xlabel="time [s]", ylabel=ylabel)
            ax.legend(fontsize=7)

        plot(axs[0, 0], [("dof_pos", "measured"), ("dof_pos_target", "target")],
             "DOF position", "[rad]")
        plot(axs[0, 1], [("dof_vel", "measured")], "DOF velocity", "[rad/s]")
        plot(axs[0, 2], [("dof_torque", "torque")], "DOF torque", "[Nm]")
        plot(axs[1, 0], [("base_vel_x", "measured"), ("command_x", "command")],
             "Base vel x", "[m/s]")
        plot(axs[1, 1], [("base_vel_y", "measured"), ("command_y", "command")],
             "Base vel y", "[m/s]")
        plot(axs[1, 2], [("base_vel_yaw", "measured"), ("command_yaw", "command")],
             "Base vel yaw", "[rad/s]")
        plot(axs[2, 0], [("base_vel_z", "measured")], "Base vel z", "[m/s]")
        plot(axs[2, 1], [("contact_forces_z_0", "left"), ("contact_forces_z_1", "right")],
             "Contact forces z", "[N]")
        plot(axs[2, 2], [("base_height", "measured")], "Base height", "[m]")
        fig.tight_layout()
        if path:
            fig.savefig(path, dpi=110)
            plt.close(fig)
            return path
        return None
