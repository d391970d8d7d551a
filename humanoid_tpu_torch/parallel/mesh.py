"""The env axis split over the ranks of a data-parallel run: counterpart of
the reference package's parallel/mesh.py.

The reference shards its env axis over a device mesh and GSPMD inserts the
collectives that make the sharded run compute what the unsharded one does.
Here rank r of W holds rows [offset, offset + n_local) of every per-env
tensor, parameters are replicated, and the few global quantities are
written out:

- `all_reduce_sum`: the gradients, the KL, the iteration's metrics and the
  command curriculum's tallies;
- `global_mean_std`: the advantage normalization (population std, two
  passes: the sum, then the sum of squared deviations);
- `draw`: a per-env random draw made at the global shape from a generator
  that every rank seeds alike, of which a rank keeps its rows, so that the
  generators stay in step and W ranks draw what one process with every
  env draws;
- `minibatch_rows`: the rows of each global minibatch (flat rows t * N + n
  of the (T, N) batch) that this rank holds, as rows
  t * n_local + (n - offset) of its own (T, n_local) batch.

At world 1 every helper is the single-process expression itself: no
collective, the same bits.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist


class EnvShard(NamedTuple):
    rank: int
    world: int
    offset: int       # first global env of this rank
    n_local: int
    n_global: int


def make_shard(n_global: int, rank: int, world: int, shuffle_granule: int = 1) -> EnvShard:
    """Rank `rank`'s share of `n_global` envs. A count that `world` does not
    divide is an error (as for a NamedSharding), and so, over several
    ranks, is a share that is not a multiple of `shuffle_granule`: then
    every tile of the tiled minibatch shuffle lies on one rank."""
    if n_global % world:
        raise ValueError(f"{n_global} envs do not split evenly over {world} ranks")
    n_local = n_global // world
    if world > 1 and shuffle_granule > 1 and n_local % shuffle_granule:
        raise ValueError(f"{n_local} envs per rank is not a multiple of the shuffle granule "
                         f"{shuffle_granule}")
    return EnvShard(rank, world, rank * n_local, n_local, n_global)


def single(shard: Optional[EnvShard]) -> bool:
    return shard is None or shard.world == 1


def all_reduce_sum(x: torch.Tensor, shard: Optional[EnvShard]) -> torch.Tensor:
    """The sum of x over the ranks (a new tensor); x itself at world 1."""
    if single(shard):
        return x
    y = x.detach().clone()
    dist.all_reduce(y)
    return y


def global_mean_std(x: torch.Tensor, shard: Optional[EnvShard]) -> Tuple[torch.Tensor,
                                                                       torch.Tensor]:
    """(mean, population std) of x over every rank's rows (all ranks hold
    as many)."""
    if single(shard):
        return x.mean(), x.std(correction=0)
    n = x.numel() * shard.world
    mean = all_reduce_sum(x.sum(), shard) / n
    var = all_reduce_sum(torch.square(x - mean).sum(), shard) / n
    return mean, torch.sqrt(var)


def draw(shard: Optional[EnvShard], fn, *args, size, **kwargs) -> torch.Tensor:
    """fn(*args, size, **kwargs) for a per-env draw (size[0] the local env
    count): drawn at n_global rows, this rank's rows kept."""
    if single(shard):
        return fn(*args, size, **kwargs)
    if size[0] != shard.n_local:
        raise ValueError(f"a per-env draw of {size[0]} rows on a rank of {shard.n_local} envs")
    full = fn(*args, (shard.n_global, *size[1:]), **kwargs)
    return full[shard.offset:shard.offset + shard.n_local]


def minibatch_rows(idx: torch.Tensor, shard: EnvShard) -> List[torch.Tensor]:
    """For each minibatch idx[j] of global flat rows t * N + n, the rows
    t * n_local + (n - offset) of the ones this rank holds, in the
    minibatch's order (possibly none)."""
    t, n = idx // shard.n_global, idx % shard.n_global
    mine = (n >= shard.offset) & (n < shard.offset + shard.n_local)
    local = t * shard.n_local + (n - shard.offset)
    return list(torch.split(local[mine], mine.sum(dim=1).tolist()))
