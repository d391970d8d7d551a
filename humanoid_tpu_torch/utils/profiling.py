"""Profiling: device traces and host-side phase timing; the port of the
reference package's utils/profiling.py.

  * `device_trace(log_dir)`: a torch.profiler trace of the enclosed block,
    the host's PyTorch ops and, on a card, its kernels, copies and memsets,
    written into <log_dir> as <host>_<pid>.<time>.pt.trace.json. The file is
    a Chrome trace: Perfetto (ui.perfetto.dev) and chrome://tracing open it,
    and TensorBoard shows it with its PyTorch profiler plugin
    (`tensorboard --logdir <log_dir>`). The runner marks each iteration's
    rollout in it as a `rollout` span.
  * `PhaseTimer`: cheap named host-side phases with per-phase totals, for
    the collection/learn split the reference logs.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator["torch.profiler.profile"]:
    """Capture a torch.profiler trace of the enclosed block into log_dir;
    yields the profiler (its `key_averages()` sum the ops by name)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


class PhaseTimer:
    """Named wall-clock phases: `with timer("rollout"): ...`; totals in
    `timer.totals`, reference-style fps via `timer.fps(steps)`."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        t0 = time.time()
        try:
            yield
        finally:
            self.totals[name] += time.time() - t0
            self.counts[name] += 1

    def fps(self, steps: int) -> float:
        """steps / total wall-clock across all phases
        (on_policy_runner.py:204-208 formula)."""
        tot = sum(self.totals.values())
        return steps / tot if tot > 0 else 0.0

    def report(self) -> str:
        lines = []
        for k in sorted(self.totals):
            n = max(1, self.counts[k])
            lines.append(
                f"{k:>16}: {self.totals[k]:8.3f}s total, "
                f"{1e3 * self.totals[k] / n:7.2f} ms/call x{self.counts[k]}"
            )
        return "\n".join(lines)
