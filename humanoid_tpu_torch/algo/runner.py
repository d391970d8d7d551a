"""On-policy training runner: rollout, GAE and the PPO update per
iteration. Port of the reference package's algo/runner.py (`init_carry`,
`_train_iteration`, `learn`).

The rollout runs the actor only; one batched critic pass over the stored
trajectory then gives the values for GAE and the timeout bootstrap.
Advantages are normalized over the whole batch, and `course_gain` is
updated on the device.

`learn` runs the iterations in dispatches of `runner.iters_per_dispatch`
(the reference's superstep; `chunk_schedule`), pulls each dispatch's
metrics to the host once, and logs them while the next dispatch runs. On
a single process on the card with the fused control step, one iteration
is captured in a CUDA graph and replayed back to back (`learn` says where
it is not).

Checkpoints (reference `save`, `save_state`, `load_state`, `load`):
`model_<it>.pt` holds the network, Adam's moments keyed by parameter name,
its step count and learning rate, and the iteration; `state_<it>.pt` adds
the iteration carry field by field and the generator's state, so that a run
resumed from it repeats the unbroken run.

On a sharded env (parallel/mesh.py) each of W ranks runs this runner on its
share of the envs: the action noise, the random episode lengths and the
minibatch permutation are drawn at the global size, the advantages are
normalized over every rank's, and the iteration's metrics are summed over
the ranks, so that every rank logs the global values and takes the update
that one process with every env takes. Rank 0 alone saves; the exact
state is not saved over several ranks (no rank holds the whole carry), as
in the reference.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..config.structs import XBotLCfgPPO
from ..env.xbotl import EnvState, XBotLEnv
from ..parallel.mesh import all_reduce_sum, draw, global_mean_std, single
from ..physics.engine import PhysState
from .gae import compute_gae
from .networks import MIN_STD, ActorCritic, log_prob
from .ppo import Adam, Batch, UpdateMetrics, ppo_update, tile_permutation

TERRAIN_LEVEL_BINS = 10


class IterationCarry(NamedTuple):
    env_state: EnvState
    obs: torch.Tensor
    critic_obs: torch.Tensor


class IterationMetrics(NamedTuple):
    update: UpdateMetrics
    mean_step_reward: torch.Tensor
    ep_rew_sums: torch.Tensor      # (n_rew,) summed over finished episodes
    ep_count: torch.Tensor
    ep_len_sum: torch.Tensor
    ep_term_count: torch.Tensor
    mean_action_std: torch.Tensor
    rew_terms_mean: torch.Tensor   # (n_rew,)
    rollout_s: Optional[float]     # host seconds, synchronized (None under a superstep)
    update_s: Optional[float]
    kernel_launches: int           # control-step kernel launches this iteration
    sampler_launches: int          # heightfield sampler launches this iteration
    factor_launches: int           # Cholesky factor kernel launches (engine path)
    apply_launches: int            # Cholesky apply kernel launches (engine path)
    solve_launches: int            # Cholesky solve kernel launches (engine path)
    terrain_level_mean: torch.Tensor   # mean curriculum row at the iteration's end (0 on plane)
    terrain_level_hist: torch.Tensor   # (10,) share of envs on each row
    # wall seconds per iteration, set by `learn`: its dispatch's over its
    # iteration count
    iteration_s: Optional[float] = None


# the metrics that stay on the device until a dispatch ends, in the order
# of a packed row (UpdateMetrics' fields first)
_DEVICE_FIELDS = ("mean_step_reward", "ep_rew_sums", "ep_count", "ep_len_sum", "ep_term_count",
                  "mean_action_std", "rew_terms_mean", "terrain_level_mean", "terrain_level_hist")
_LAUNCH_FIELDS = ("kernel_launches", "sampler_launches", "factor_launches", "apply_launches",
                  "solve_launches")


def _device_metrics(m: IterationMetrics) -> List[torch.Tensor]:
    return [*m.update, *(getattr(m, f) for f in _DEVICE_FIELDS)]


def pack_metrics(m: IterationMetrics) -> torch.Tensor:
    """The tensor metrics of one iteration as one float32 row."""
    return torch.cat([x.reshape(-1).float() for x in _device_metrics(m)])


def unpack_metrics(row: torch.Tensor, like: IterationMetrics, **host) -> IterationMetrics:
    """The metrics of a packed row (on the row's device), with the shapes
    and dtypes of `like`, its host fields, and `host`'s."""
    tensors = _device_metrics(like)
    parts = torch.split(row, [x.numel() for x in tensors])
    vals = [p.reshape(x.shape).to(x.dtype) for p, x in zip(parts, tensors)]
    n = len(UpdateMetrics._fields)
    return like._replace(update=UpdateMetrics(*vals[:n]), **dict(zip(_DEVICE_FIELDS, vals[n:])),
                         **host)


def chunk_schedule(num_iterations: int, iteration: int, iters_per_dispatch: int,
                   save_interval: int) -> List[Tuple[int, bool]]:
    """The dispatches of `learn` from `iteration` on, as the reference's
    learn makes them: (iterations k, save after it) each. k is at most
    iters_per_dispatch and the iterations left, and a dispatch never
    crosses a save_interval boundary; a save follows each dispatch that
    ends on a boundary, and the last one."""
    K = max(1, min(iters_per_dispatch, num_iterations))
    out, done = [], 0
    while done < num_iterations:
        k = min(K, num_iterations - done)
        if save_interval:
            k = min(k, save_interval - iteration % save_interval)
        iteration += k
        done += k
        out.append((k, bool(save_interval and iteration % save_interval == 0)
                    or done == num_iterations))
    return out


def _tensors(x) -> List[torch.Tensor]:
    """The tensors of a carry (nested NamedTuples; None fields left out), in
    field order."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [] if x is None else [t for f in x for t in _tensors(f)]


def _rebuild(like, tensors):
    """`like` with its tensors taken in order from the iterator `tensors`."""
    if isinstance(like, torch.Tensor):
        return next(tensors)
    if like is None:
        return None
    return type(like)(*(_rebuild(f, tensors) for f in like))


def _copy_carry(dst: List[torch.Tensor], new) -> None:
    """Copy the carry `new` into the tensors `dst` (a carry's, by _tensors).
    A new field that shares memory with another field's tensor of `dst` is
    cloned first, so that no copy reads what an earlier one wrote."""
    src = _tensors(new)
    if len(src) != len(dst):
        raise ValueError(f"the carry has {len(src)} tensors, its static copy {len(dst)}")
    owner = {d.untyped_storage().data_ptr(): i for i, d in enumerate(dst)}
    src = [s.clone() if owner.get(s.untyped_storage().data_ptr(), i) != i else s
           for i, s in enumerate(src)]
    for d, s in zip(dst, src):
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"a carry field changed from {d.dtype} {tuple(d.shape)} to "
                             f"{s.dtype} {tuple(s.shape)}")
        if d.data_ptr() != s.data_ptr():
            d.copy_(s)


class _Graphed(NamedTuple):
    """One captured training iteration: replaying `graph` runs it on the
    static `carry` (in place), writes its packed metrics into `row`, and
    launches `metrics`' kernel counts."""
    graph: "torch.cuda.CUDAGraph"
    carry: IterationCarry
    row: torch.Tensor
    metrics: IterationMetrics


def _as_dict(x):
    """A NamedTuple (nested ones too) as a dict by field name, for a
    payload that `torch.load(weights_only=True)` reads back."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {f: _as_dict(getattr(x, f)) for f in x._fields}
    return x


class OnPolicyRunner:
    def __init__(self, env: XBotLEnv, train_cfg: XBotLCfgPPO, log_dir: Optional[str] = None):
        self.env = env
        self.cfg = train_cfg
        self.log_dir = log_dir
        self.device = env.device
        self.shard = env.shard
        self.n_global = env.n_global
        ecfg = env.cfg.env
        pcfg = train_cfg.policy
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(train_cfg.seed)
        init_gen = torch.Generator()
        init_gen.manual_seed(train_cfg.seed)
        self.net = ActorCritic(
            ecfg.num_observations, ecfg.num_privileged_obs, ecfg.num_actions,
            pcfg.actor_hidden_dims, pcfg.critic_hidden_dims, pcfg.vel_est_hidden_dims,
            pcfg.init_noise_std, pcfg.compute_dtype,
        )
        self.net.reset_parameters(init_gen, pcfg.init_noise_std)
        self.net.to(self.device)
        acfg = train_cfg.algorithm
        self.opt = Adam(list(self.net.parameters()), acfg.max_grad_norm, acfg.learning_rate)
        lo = 5 + 4 * ecfg.num_actions   # base_lin_vel slice of the oldest critic frame
        self.vel_slice = (lo, lo + 3)
        # the mirror matrices of the symmetry loss, built only when it is on
        self.obs_perm = self.act_perm = None
        if acfg.sym_loss:
            from .symmetry import xbot_perm_matrices

            obs_perm, act_perm = xbot_perm_matrices(ecfg.frame_stack, ecfg.num_actions)
            self.obs_perm = torch.as_tensor(obs_perm, device=self.device)
            self.act_perm = torch.as_tensor(act_perm, device=self.device)
        self.iteration = 0
        self.capture_s = None           # host seconds of the last CUDA graph capture
        self._side = None               # the warm-up's and the capture's stream
        # the checkpoint hook: on_checkpoint(runner, checkpoint path, iteration),
        # called by `save` on rank 0 (deploy/eval_gate.py's CheckpointEvalGate)
        self.on_checkpoint = None

    def _launch_counts(self) -> Tuple[int, ...]:
        """The env's kernel launch counts, in _LAUNCH_FIELDS' order."""
        env = self.env
        chol = env.cholesky.launches
        return (env.physics.launches, env.sampler.launches if env.sampler is not None else 0,
                chol["chol_factor"], chol["chol_apply"], chol["chol_solve"])

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def init_carry(self, init_at_random_ep_len: bool = True) -> IterationCarry:
        """Env reset plus the first zero-action step."""
        env = self.env
        state = env.initial_state(self.gen)
        if init_at_random_ep_len:
            state = state._replace(episode_length=draw(
                self.shard, torch.randint, 0, env.max_episode_length,
                size=state.episode_length.shape, generator=self.gen, device=self.device,
                dtype=torch.int32))
        N, nj = env.cfg.env.num_envs, env.cfg.env.num_actions
        state, out = env.step(state, torch.zeros(N, nj, device=self.device), self.gen)
        return IterationCarry(env_state=state, obs=out.obs, critic_obs=out.privileged_obs)

    def train_iteration(self, carry: IterationCarry, sync: bool = True):
        """One iteration: rollout, GAE, PPO update. With `sync` the card is
        synchronized after the rollout and after the update, for their host
        seconds; without, nothing in it waits for the card (as a superstep
        and a captured iteration need), and those fields are None. The
        iteration count is `learn`'s."""
        env, net = self.env, self.net
        acfg = self.cfg.algorithm
        T = self.cfg.runner.num_steps_per_env
        N = env.cfg.env.num_envs
        dev = self.device
        t0 = time.perf_counter()
        launches0 = self._launch_counts()

        es = carry.env_state
        ratio = env.cfg.rewards.course_ratio
        if ratio != 1.0:
            es = es._replace(course_gain=torch.clamp(es.course_gain * ratio, max=20.0))

        store_dt = net.compute_dtype
        with torch.no_grad():
            std = torch.clamp(net.std, min=MIN_STD)
            obs_buf = torch.empty((T, N, carry.obs.shape[1]), device=dev, dtype=store_dt)
            cobs_buf = torch.empty((T, N, carry.critic_obs.shape[1]), device=dev, dtype=store_dt)
            act_buf = torch.empty((T, N, env.nj), device=dev)
            mean_buf = torch.empty_like(act_buf)
            logp_buf = torch.empty((T, N), device=dev)
            rew_buf = torch.empty_like(logp_buf)
            done_buf = torch.empty_like(logp_buf)
            tout_buf = torch.empty_like(logp_buf)
            n_rew = env.n_rew
            ep_rew = torch.zeros(n_rew, device=dev)
            ep_stats = torch.zeros(3, device=dev)    # count, length sum, failures
            rew_terms = torch.zeros(n_rew, device=dev)
            obs, cobs = carry.obs, carry.critic_obs
            with torch.profiler.record_function("rollout"):   # a span for device_trace
                for t in range(T):
                    mean = net.act_mean(obs)
                    action = mean + std * draw(self.shard, torch.randn, size=mean.shape,
                                               generator=self.gen, device=dev)
                    obs_buf[t] = obs
                    cobs_buf[t] = cobs
                    act_buf[t] = action
                    mean_buf[t] = mean
                    logp_buf[t] = log_prob(mean, std, action)
                    es, out = env.step(es, action, self.gen)
                    rew_buf[t] = out.rew
                    done_buf[t] = out.reset.float()
                    tout_buf[t] = out.time_outs.float()
                    ep_rew += out.ep_rew_sums
                    ep_stats += torch.stack([out.ep_count, out.ep_len_sum.float(),
                                             out.ep_term_count])
                    rew_terms += out.rew_terms_mean
                    obs, cobs = out.obs, out.privileged_obs
                if sync:
                    self._sync()
            t1 = time.perf_counter()

            values = net.value(cobs_buf.reshape(T * N, -1)).reshape(T, N)
            last_values = net.value(cobs.to(store_dt))
            rewards = rew_buf + acfg.gamma * values * tout_buf \
                if env.cfg.env.send_timeouts else rew_buf
            advantages, returns = compute_gae(rewards, values, done_buf, last_values,
                                              acfg.gamma, acfg.lam)
            adv_mean, adv_std = global_mean_std(advantages, self.shard)
            norm_adv = (advantages - adv_mean) / (adv_std + 1e-8)
            batch = Batch(
                obs=obs_buf.reshape(T * N, -1), critic_obs=cobs_buf.reshape(T * N, -1),
                actions=act_buf.reshape(T * N, -1), old_logp=logp_buf.reshape(-1),
                old_mu=mean_buf.reshape(T * N, -1),
                old_sigma=std.expand(T * N, -1), target_values=values.reshape(-1),
                advantages=norm_adv.reshape(-1), returns=returns.reshape(-1),
            )
            perm = tile_permutation(T * self.n_global, acfg, self.gen, dev)
        update = ppo_update(net, acfg, self.opt, batch, perm, self.vel_slice, self.obs_perm,
                            self.act_perm, self.shard)
        if sync:
            self._sync()
        t2 = time.perf_counter()
        levels = es.terrain_levels
        hist = (levels[:, None] == torch.arange(TERRAIN_LEVEL_BINS, device=dev,
                                                dtype=levels.dtype)).float()
        if single(self.shard):
            step_reward, rew_terms_mean = rew_buf.mean(), rew_terms / T
            level_mean, level_hist = levels.float().mean(), hist.mean(0)
        else:
            # the global values, in one collective: sums over every rank's envs
            n_rew = ep_rew.shape[0]
            total = all_reduce_sum(torch.cat([
                ep_rew, ep_stats, rew_terms * N, hist.sum(0),
                torch.stack([rew_buf.sum(), levels.float().sum()])]), self.shard)
            ep_rew, ep_stats, rew_terms, hist_sum, rest = torch.split(
                total, [n_rew, 3, n_rew, TERRAIN_LEVEL_BINS, 2])
            Ng = self.n_global
            step_reward, level_mean = rest[0] / (T * Ng), rest[1] / Ng
            level_hist, rew_terms_mean = hist_sum / Ng, rew_terms / (Ng * T)
        metrics = IterationMetrics(
            update=update, mean_step_reward=step_reward, ep_rew_sums=ep_rew,
            ep_count=ep_stats[0], ep_len_sum=ep_stats[1], ep_term_count=ep_stats[2],
            mean_action_std=torch.clamp(net.std.detach(), min=MIN_STD).mean(),
            rew_terms_mean=rew_terms_mean, rollout_s=t1 - t0 if sync else None,
            update_s=t2 - t1 if sync else None,
            **{f: b - a for f, a, b in zip(_LAUNCH_FIELDS, launches0, self._launch_counts())},
            terrain_level_mean=level_mean, terrain_level_hist=level_hist,
        )
        return IterationCarry(env_state=es, obs=obs, critic_obs=cobs), metrics

    def dispatch_mode(self) -> str:
        """How `learn` runs a dispatch, by configuration: "sync" at
        runner.iters_per_dispatch 1; else "graph" on a single process on the
        card with the fused control step, and "eager" elsewhere (see
        `learn`)."""
        if self.cfg.runner.iters_per_dispatch == 1:
            return "sync"
        if self.device.type == "cuda" and single(self.shard) and self.env.use_kernel:
            return "graph"
        return "eager"

    def learn(self, num_iterations: int, init_at_random_ep_len: bool = True,
              log_fn: Optional[Callable] = None,
              carry: Optional[IterationCarry] = None) -> IterationCarry:
        """Train for `num_iterations`, from `carry` or else from a fresh env,
        in the dispatches of `chunk_schedule` (at most
        runner.iters_per_dispatch iterations each, none crossing a
        save_interval boundary). With a log_dir, saves after each dispatch
        that ends on a boundary and at the end (and the exact state beside
        each save when `runner.save_env_state`).

        Each iteration's metrics stay on the device, in a row of the
        dispatch's buffer; after the dispatch one copy brings the rows to
        the host (pinned memory on the card), and they are logged only
        after the next dispatch has been enqueued:
        log_fn(it, metrics, env_steps_per_s) once per iteration, in order,
        with host tensors, `iteration_s` the dispatch's wall seconds over
        its iterations (on the card between two events on its stream) and
        env-steps/s (every rank's envs) from it.

        The dispatch modes (`dispatch_mode`), chosen by configuration:
          * "sync" (iters_per_dispatch 1): each iteration eager, the card
            synchronized after its rollout and its update (`rollout_s`,
            `update_s`), as `train --profile` traces it.
          * "graph" (a single process on the card, the fused control step):
            the first iteration of the call runs eagerly on a side stream,
            the warm-up that autograd and the allocator need; then one
            iteration is captured in a CUDA graph on that stream (its host
            seconds land in `capture_s`; it does not wait for the card) on
            static copies of the carry, which it updates in place, with the
            runner's generator registered so that each replay draws the
            next numbers; the rest of the iterations are replays, each
            followed by the copy of its metrics. Each call
            captures anew, so a call after `load`/`load_state` takes the
            restored state. A failed capture raises. The kernel launch
            counts of a replayed iteration are the captured iteration's.
          * "eager": the CPU; more than one rank (a collective cannot be
            captured); the engine path (use_pallas_substep False). The
            iterations run uncaptured, with no synchronization between
            them.
        `rollout_s` and `update_s` are None outside "sync". Every mode
        gives the same bits for the same seed and iterations."""
        if carry is None:
            carry = self.init_carry(init_at_random_ep_len)
        rcfg = self.cfg.runner
        schedule = chunk_schedule(num_iterations, self.iteration, rcfg.iters_per_dispatch,
                                  rcfg.save_interval)
        if not schedule:
            if self.log_dir:
                self._save_all(carry)
            return carry
        mode = self.dispatch_mode()
        cuda = self.device.type == "cuda"
        K = max(k for k, _ in schedule)
        steps = rcfg.num_steps_per_env * self.n_global
        rows, hosts, graphed, pending = None, [], None, None
        for i, (k, save) in enumerate(schedule):
            t0, start = time.perf_counter(), None
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            like = []
            for j in range(k):
                if mode != "graph":
                    carry, m = self.train_iteration(carry, sync=mode == "sync")
                    row = pack_metrics(m)
                elif i == 0 and j == 0:
                    carry, m, row = self._warm_up(carry)
                else:
                    if graphed is None:
                        graphed = self._capture(carry)
                        carry = graphed.carry
                    graphed.graph.replay()
                    m, row = graphed.metrics, graphed.row
                if rows is None:
                    rows = torch.empty((K, row.numel()), device=self.device)
                    hosts = [torch.empty((K, row.numel()), pin_memory=cuda) for _ in range(2)]
                rows[j].copy_(row)
                like.append(m)
            self.iteration += k
            host = hosts[i % 2]
            host[:k].copy_(rows[:k], non_blocking=cuda)
            end = None
            if cuda:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
            if pending is not None:
                self._flush(log_fn, steps, *pending)
            pending = (self.iteration - k + 1, host[:k], like, start, end,
                       time.perf_counter() - t0)
            if save and self.log_dir:
                self._save_all(carry)
        self._flush(log_fn, steps, *pending)
        return carry

    def _side_stream(self) -> "torch.cuda.Stream":
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    def _warm_up(self, carry: IterationCarry):
        """One eager iteration on the capture's side stream: (carry,
        metrics, packed metrics)."""
        side, current = self._side_stream(), torch.cuda.current_stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            carry, m = self.train_iteration(carry, sync=False)
            row = pack_metrics(m)
        current.wait_stream(side)
        return carry, m, row

    def _capture(self, carry: IterationCarry) -> _Graphed:
        """One iteration from static copies of `carry`, captured in a CUDA
        graph on the side stream, the runner's generator registered."""
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError(
                f"torch {torch.__version__} has no CUDAGraph.register_generator_state, so a "
                "replay cannot advance the runner's generator: train with "
                "runner.iters_per_dispatch 1 (train --iters-per-dispatch 1)")
        t0 = time.perf_counter()
        static = _rebuild(carry, iter([x.clone() for x in _tensors(carry)]))
        dst = _tensors(static)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.gen)
        with torch.cuda.stream(self._side_stream()):
            # capture_begin itself: torch.cuda.graph would first synchronize
            # the card (to empty the allocator's caches), a wait between two
            # iterations of the dispatch
            graph.capture_begin()
            try:
                new, m = self.train_iteration(static, sync=False)
                row = pack_metrics(m)
                _copy_carry(dst, new)
            finally:
                graph.capture_end()
        self.capture_s = time.perf_counter() - t0
        return _Graphed(graph, static, row, m)

    @staticmethod
    def _flush(log_fn, steps, first, host, like, start, end, host_s):
        """Wait for a dispatch's metrics on the host, then log each of its
        iterations."""
        if end is not None:
            end.synchronize()
            host_s = start.elapsed_time(end) / 1e3
        if log_fn is None:
            return
        seconds = host_s / len(like)
        for j, m in enumerate(like):
            log_fn(first + j, unpack_metrics(host[j].clone(), m, iteration_s=seconds),
                   steps / seconds)

    def _save_all(self, carry: IterationCarry):
        if self.shard is not None and self.shard.rank != 0:
            return                      # rank 0 alone writes the run's checkpoints
        self.save()
        if self.cfg.runner.save_env_state:
            self.save_state(carry)

    # ------------------------------------------------------------------
    # checkpoints

    def _payload(self) -> Dict:
        names = [n for n, _ in self.net.named_parameters()]
        opt = self.opt
        return {
            "model": self.net.state_dict(),
            "optimizer": {"mu": dict(zip(names, opt.mu)), "nu": dict(zip(names, opt.nu)),
                          "count": int(opt.count), "lr": opt.lr},
            "iteration": self.iteration,
        }

    def _restore(self, payload: Dict, load_optimizer: bool = True):
        self.net.load_state_dict(payload["model"])
        if load_optimizer:
            o = payload["optimizer"]
            names = [n for n, _ in self.net.named_parameters()]
            for key, buffers in (("mu", self.opt.mu), ("nu", self.opt.nu)):
                if sorted(o[key]) != sorted(names):
                    raise KeyError(f"Adam {key} is keyed by {sorted(o[key])}, the network's "
                                   f"parameters are {sorted(names)}")
                with torch.no_grad():
                    for name, buf in zip(names, buffers):
                        buf.copy_(o[key][name])
            self.opt.count.fill_(int(o["count"]))
            self.opt.lr.copy_(o["lr"])
        self.iteration = int(payload["iteration"])

    def save(self, path: Optional[str] = None) -> str:
        """The model, Adam and the iteration, to `path` (default
        <log_dir>/model_<it>) + ".pt"; then, on rank 0, the checkpoint hook
        `on_checkpoint` where one is set."""
        from ..utils.checkpoint import save_checkpoint

        path = save_checkpoint(path or os.path.join(self.log_dir, f"model_{self.iteration}"),
                               self._payload())
        if self.on_checkpoint is not None and (self.shard is None or self.shard.rank == 0):
            self.on_checkpoint(self, path, self.iteration)
        return path

    def load(self, path: str, load_optimizer: bool = True) -> None:
        from ..utils.checkpoint import load_checkpoint

        self._restore(load_checkpoint(path, self.device), load_optimizer)

    def save_state(self, carry: IterationCarry, path: Optional[str] = None) -> str:
        """Exact state: everything `save` writes, the iteration carry field by
        field (EnvState and PhysState as dicts, None fields kept) and the
        generator's state, to `path` (default <log_dir>/state_<it>) + ".pt"."""
        from ..utils.checkpoint import save_checkpoint

        path = path or os.path.join(self.log_dir, f"state_{self.iteration}")
        if not single(self.shard):
            logging.getLogger(__name__).warning(
                "save_env_state skipped: exact-state checkpoints are single-rank only (the "
                "env axis is split over %d ranks)", self.shard.world)
            return path
        return save_checkpoint(path, {**self._payload(), "carry": _as_dict(carry),
                                      "generator": self.gen.get_state()})

    def load_state(self, path: str) -> IterationCarry:
        """Restore an exact-state checkpoint: the runner's model, Adam,
        iteration and generator, and the carry to continue from."""
        from ..utils.checkpoint import load_checkpoint

        payload = load_checkpoint(path, self.device)
        self._restore(payload)
        self.gen.set_state(payload["generator"].cpu())
        c = payload["carry"]
        es = dict(c["env_state"])
        es["phys"] = PhysState(**es["phys"])
        return IterationCarry(env_state=EnvState(**es), obs=c["obs"], critic_obs=c["critic_obs"])

    def inference_policy(self) -> Callable:
        """The deterministic actor: obs -> act_mean(obs)."""
        net = self.net

        @torch.no_grad()
        def policy(obs):
            return net.act_mean(obs)

        return policy
