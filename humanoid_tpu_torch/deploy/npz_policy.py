"""The exported policy (`policy.npz`, deploy/export.py) as a numpy
callable: ELU MLP forward with no torch and no JAX, for a robot or a
MuJoCo replay; the reference package's deploy/npz_policy.py."""
from __future__ import annotations

import numpy as np


def _elu(x):
    return np.where(x > 0, x, np.expm1(x))


class NpzPolicy:
    """obs (B, in) -> (B, out) through the `prefix` layers (`actor`, or
    `vel` for the velocity head)."""

    def __init__(self, path: str, prefix: str = "actor"):
        with np.load(path) as data:
            self.layers = []
            while f"{prefix}_w{len(self.layers)}" in data:
                i = len(self.layers)
                self.layers.append((data[f"{prefix}_w{i}"], data[f"{prefix}_b{i}"]))
        if not self.layers:
            raise ValueError(f"no '{prefix}' layers in {path}")

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        x = np.asarray(obs, dtype=np.float32)
        for k, (w, b) in enumerate(self.layers):
            x = x @ w + b
            if k < len(self.layers) - 1:
                x = _elu(x)
        return x
