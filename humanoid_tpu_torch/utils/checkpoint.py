"""Checkpoint files of the port: save, load and the run/checkpoint lookup
of the reference package's utils/checkpoint.py, with `torch.save` in place
of orbax.

A checkpoint is one `.pt` file written atomically (`<path>.tmp`, then
`os.replace`) and read back with `weights_only=True`, so its payload holds
only tensors, ints, floats, strings, None and nested dicts/lists. Runs live
in `<root>/<datetime>_<run_name>/` as `model_<it>.pt` and, for an
exact-state resume, `state_<it>.pt`.

`load_reference_checkpoint` carries a checkpoint of the reference package
(its `.npz` form, written where orbax is absent) into a runner of the port.
"""
from __future__ import annotations

import copy
import os
import re
from typing import Dict

import numpy as np
import torch

EXT = ".pt"


def save_checkpoint(path: str, payload) -> str:
    """Write `payload` to `path` + ".pt" (the extension is added when
    missing) through a temporary file, so a reader never sees half a file."""
    path = path if path.endswith(EXT) else path + EXT
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, device="cpu"):
    path = path if path.endswith(EXT) else path + EXT
    return torch.load(path, map_location=device, weights_only=True)


def get_load_path(root: str, load_run: str = "-1", checkpoint: int = -1) -> str:
    """The reference's lookup: the latest run directory by sorted name (or
    `load_run`), then its highest `model_<it>` (or `checkpoint`). Returns
    the path without an extension."""
    runs = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    if not runs:
        raise FileNotFoundError(f"no runs in {root}")
    run = runs[-1] if str(load_run) == "-1" else str(load_run)
    run_dir = os.path.join(root, run)
    if checkpoint == -1:
        its = [int(g.group(1)) for g in (re.match(r"model_(\d+)(?:\.pt)?$", f)
                                         for f in os.listdir(run_dir)) if g]
        if not its:
            raise FileNotFoundError(f"no checkpoints in {run_dir}")
        checkpoint = max(its)
    return os.path.join(run_dir, f"model_{checkpoint}")


def state_path_of(model_path: str) -> str:
    """The exact-state checkpoint beside a `model_<it>` path."""
    head, tail = os.path.split(model_path)
    return os.path.join(head, tail.replace("model_", "state_", 1))


# ---------------------------------------------------------------------------
# the reference package's checkpoint

_PARAM = re.compile(r"\['params'\]\['params'\]((?:\['\w+'\])+)$")
_MOMENT = re.compile(r"\['opt_state'\]\[1\]\.(mu|nu)\['params'\]((?:\['\w+'\])+)$")


def _insert(tree: Dict, keys: str, value):
    parts = re.findall(r"\['(\w+)'\]", keys)
    for k in parts[:-1]:
        tree = tree.setdefault(k, {})
    tree[parts[-1]] = value


def load_reference_checkpoint(runner, path: str) -> None:
    """Fill `runner` (its parameters, Adam's moments, count and learning
    rate, and the iteration) from the reference package's `.npz`
    checkpoint, whose keys are `jax.tree_util.keystr` paths of its payload
    {"params", "opt_state": (clip state, Adam state), "lr", "iteration"}.
    Flax kernels are (in, out): the parameters and both moments go through
    `from_jax_params`, which transposes them."""
    from ..algo.networks import from_jax_params

    path = path if path.endswith(".npz") else path + ".npz"
    params, moments = {}, {"mu": {}, "nu": {}}
    with np.load(path) as z:
        for key in z.files:
            if m := _PARAM.match(key):
                _insert(params, m.group(1), z[key])
            elif m := _MOMENT.match(key):
                _insert(moments[m.group(1)], m.group(2), z[key])
        count, lr, iteration = (z["['opt_state'][1].count"], z["['lr']"], z["['iteration']"])
    net, opt = runner.net, runner.opt
    from_jax_params(net, params)
    for name, buffers in (("mu", opt.mu), ("nu", opt.nu)):
        scratch = from_jax_params(copy.deepcopy(net), moments[name])
        for buf, moment in zip(buffers, scratch.parameters()):
            buf.copy_(moment.detach())
    opt.count.fill_(int(count))
    opt.lr.fill_(float(lr))
    runner.iteration = int(iteration)
