"""Ranks of a data-parallel run: counterpart of the reference package's
parallel/dist.py, in PyTorch's idiom of one process per rank.

W processes behave as one trainer:

  * every rank runs the same program on its share of the envs
    (parallel/mesh.py);
  * rank 0 alone owns the side effects: the console, the training log and
    the checkpoints;
  * what is made on the host and must agree over the ranks (the run
    directory's name, from the wall clock) is broadcast from rank 0.

A launcher describes the group in the environment, as `torchrun` does:
RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and
MASTER_PORT. `launch` starts W ranks on this node that way. Without those
variables the world is 1 and no process group is made.

The backend follows one rule, printed once by rank 0 and never switched at
run time: `nccl` when every rank of a node has a card of its own, else
`gloo` (on the CPU, or when ranks share a card: NCCL refuses two ranks on
one GPU).
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
               "MASTER_PORT")
# the directory that holds the package, for the ranks' module path
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def launched() -> bool:
    """Whether a launcher described a process group in the environment."""
    return all(v in os.environ for v in LAUNCH_VARS)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    """True on the one rank that owns logging and checkpoints."""
    return process_index() == 0


def backend_for(device: str, local_world: int) -> Tuple[str, str]:
    """(backend, the reason the rule gives) for `local_world` ranks of a
    node on `device`."""
    if device != "cuda":
        return "gloo", "CPU tensors"
    cards = torch.cuda.device_count()
    if local_world <= cards:
        return "nccl", f"{local_world} rank(s) on this node, each on a card of its own"
    return "gloo", (f"{local_world} ranks share {cards} card(s) on this node "
                    "(NCCL refuses two ranks on one GPU)")


def device_for_rank(device: str) -> torch.device:
    """This rank's device: the CPU when asked for, else
    cuda:(LOCAL_RANK % cards), made the current device. Raises without a card."""
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    index = int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def _init(device: str, rank: int, world: int, local_world: int, address: str) -> None:
    device_for_rank(device)
    backend, why = backend_for(device, local_world)
    dist.init_process_group(backend, init_method=address, rank=rank, world_size=world)
    if rank == 0:
        print(f"[dist] {world} rank(s) over {backend}: {why}", flush=True)


def init_from_env(device: str = "cuda") -> bool:
    """Join the process group the launcher's variables describe. Returns
    whether a group was made here (False without the variables, or when
    this process is already in one)."""
    if not launched() or dist.is_initialized():
        return False
    env = os.environ
    _init(device, int(env["RANK"]), int(env["WORLD_SIZE"]), int(env["LOCAL_WORLD_SIZE"]),
          f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}")
    return True


def init_single(device: str = "cuda") -> bool:
    """A process group of this process alone (world 1), on a free port of
    localhost. Returns whether a group was made here."""
    if dist.is_initialized():
        return False
    _init(device, 0, 1, 1, f"tcp://127.0.0.1:{free_port()}")
    return True


def sync_run_name(name: str) -> str:
    """Rank 0's `name` on every rank; the identity at world 1."""
    if process_count() == 1:
        return name
    box = [name]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: str, lines: int = 30) -> str:
    with open(path, errors="replace") as f:
        return "".join(f.readlines()[-lines:])


def launch(world: int, args: Sequence[str], timeout: float, log_dir: Optional[str] = None,
           env: Optional[Dict[str, str]] = None, echo_rank0: bool = False) -> str:
    """Run `python <args>` as `world` ranks of one node, with the variables
    torchrun sets (a free localhost port as the rendezvous), and wait for
    them all. Each rank's output goes to <log_dir>/rank<r>.log (rank 0's to
    this process's own output with `echo_rank0`). When a rank fails, or at
    `timeout` seconds, every rank still running is killed and RuntimeError
    names the failures with the end of their logs. Returns log_dir."""
    log_dir = log_dir or tempfile.mkdtemp(prefix="ranks_")
    os.makedirs(log_dir, exist_ok=True)
    port = free_port()
    path = os.environ.get("PYTHONPATH")
    procs, logs = [], []
    try:
        for r in range(world):
            rank_env = {**os.environ, **(env or {}), "RANK": str(r), "WORLD_SIZE": str(world),
                        "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": str(world),
                        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                        "PYTHONPATH": ROOT + (os.pathsep + path if path else "")}
            logs.append(os.path.join(log_dir, f"rank{r}.log"))
            out = None if echo_rank0 and r == 0 else open(logs[r], "w")
            procs.append(subprocess.Popen([sys.executable, *args], env=rank_env, stdout=out,
                                          stderr=subprocess.STDOUT if out else None))
            if out is not None:
                out.close()
        deadline = time.monotonic() + timeout
        while True:
            rcs = [p.poll() for p in procs]
            failed = [r for r, rc in enumerate(rcs) if rc not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            if all(rc == 0 for rc in rcs):
                return log_dir
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    what = (f"rank(s) {failed} failed (exit codes {[rcs[r] for r in failed]})" if failed
            else f"the ranks did not end within {timeout} s")
    tails = "\n".join(f"--- rank {r} ---\n{_tail(logs[r])}" for r in range(world)
                      if not (echo_rank0 and r == 0) and (r in failed or not failed))
    raise RuntimeError(f"{what}: {' '.join(args)}\n{tails}")
