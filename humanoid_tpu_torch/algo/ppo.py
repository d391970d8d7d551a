"""Clipped-surrogate PPO update with the adaptive-KL learning rate, clipped
value loss, entropy bonus, the auxiliary velocity-estimator loss and,
when the config asks for it, the mirror-symmetry loss: port of the
reference package's algo/ppo.py.

Gradients are clipped by their global norm, then scaled by Adam (optax's
clip_by_global_norm + scale_by_adam, written out here), then by the
adaptive learning rate, which each minibatch updates from its own KL before
its step. One permutation of tiles of `shuffle_granule` consecutive rows is
drawn per update and reused by every epoch.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from ..config.structs import AlgorithmCfg
from .networks import ActorCritic, entropy, kl_divergence, log_prob


class Batch(NamedTuple):
    """Flattened (B, ...) rollout data, B = T * N."""
    obs: torch.Tensor
    critic_obs: torch.Tensor
    actions: torch.Tensor
    old_logp: torch.Tensor
    old_mu: torch.Tensor
    old_sigma: torch.Tensor
    target_values: torch.Tensor
    advantages: torch.Tensor
    returns: torch.Tensor


class UpdateMetrics(NamedTuple):
    value_loss: torch.Tensor
    surrogate_loss: torch.Tensor
    vel_loss: torch.Tensor
    sym_loss: torch.Tensor
    kl: torch.Tensor
    lr: torch.Tensor


class Adam:
    """Global-norm clip, then Adam (b1 0.9, b2 0.999, eps 1e-8), then an
    external learning rate held as a device tensor."""

    def __init__(self, params: List[torch.Tensor], max_grad_norm: float, lr: float):
        self.params = params
        self.max_grad_norm = max_grad_norm
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0
        self.lr = torch.tensor(float(lr), device=params[0].device)
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]):
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        factor = torch.where(norm < self.max_grad_norm, torch.ones_like(norm),
                             self.max_grad_norm / norm)
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = g * factor
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            p.sub_(self.lr * (mu / c1) / (torch.sqrt(nu / c2) + self.eps))


def tile_permutation(B: int, cfg: AlgorithmCfg, gen: torch.Generator, device) -> torch.Tensor:
    """Permutation of the B rows, drawn as a permutation of tiles of
    `shuffle_granule` consecutive rows where the sizes allow it."""
    g = cfg.shuffle_granule
    mb = B // cfg.num_mini_batches
    if g <= 1 or B % g or mb % g:
        return torch.randperm(B, generator=gen, device=device)
    tiles = torch.randperm(B // g, generator=gen, device=device)
    return (tiles[:, None] * g + torch.arange(g, device=device)).reshape(-1)


def symmetry_loss(net: ActorCritic, obs, mean, obs_perm, act_perm):
    """mean((mu(obs) - mirror(mu(mirror(obs))))^2): the actor's mean action
    against the mirror of its action on the mirrored observation. The
    mirror is exact in the stored dtype (one signed entry per column)."""
    mirrored = net.act_mean(obs.float() @ obs_perm) @ act_perm
    return torch.mean(torch.square(mean - mirrored))


def ppo_update(net: ActorCritic, cfg: AlgorithmCfg, opt: Adam, batch: Batch,
               perm: torch.Tensor, vel_slice: Tuple[int, int],
               obs_perm: Optional[torch.Tensor] = None,
               act_perm: Optional[torch.Tensor] = None) -> UpdateMetrics:
    """num_learning_epochs x num_mini_batches gradient steps over `batch`
    in the row order `perm` (see tile_permutation). With cfg.sym_loss and
    the mirror matrices (algo/symmetry.py: obs_perm over the stacked actor
    obs, act_perm over the actions), the loss adds
    sym_coef * mean((mu(obs) - mirror(mu(mirror(obs))))^2)."""
    B = batch.obs.shape[0]
    nmb = cfg.num_mini_batches
    mb = B // nmb
    idx = perm[: mb * nmb].reshape(nmb, mb)
    vlo, vhi = vel_slice
    params = list(net.parameters())
    sums = torch.zeros(5, device=batch.obs.device)
    for _ in range(cfg.num_learning_epochs):
        for j in range(nmb):
            m = Batch(*(x[idx[j]] for x in batch))
            mean, std, value, vel = net(m.obs, m.critic_obs)
            logp = log_prob(mean, std, m.actions)
            ent = entropy(std)
            kl = torch.mean(kl_divergence(m.old_mu, m.old_sigma, mean, std)).detach()
            ratio = torch.exp(logp - m.old_logp)
            surrogate = -m.advantages * ratio
            surrogate_clipped = -m.advantages * torch.clamp(
                ratio, 1.0 - cfg.clip_param, 1.0 + cfg.clip_param)
            surrogate_loss = torch.mean(torch.maximum(surrogate, surrogate_clipped))
            if cfg.use_clipped_value_loss:
                value_clipped = m.target_values + torch.clamp(
                    value - m.target_values, -cfg.clip_param, cfg.clip_param)
                value_loss = torch.mean(torch.maximum(torch.square(value - m.returns),
                                                      torch.square(value_clipped - m.returns)))
            else:
                value_loss = torch.mean(torch.square(m.returns - value))
            vel_loss = torch.mean(torch.square(vel - m.critic_obs[:, vlo:vhi].float()))
            if cfg.sym_loss and obs_perm is not None:
                sym_loss = symmetry_loss(net, m.obs, mean, obs_perm, act_perm)
            else:
                sym_loss = torch.zeros((), device=mean.device)
            loss = (surrogate_loss + cfg.value_loss_coef * value_loss
                    - cfg.entropy_coef * torch.mean(ent) + cfg.sym_coef * sym_loss
                    + cfg.base_lin_vel_coef * vel_loss)
            grads = torch.autograd.grad(loss, params)
            if cfg.schedule == "adaptive" and cfg.desired_kl is not None:
                lr = opt.lr
                lr = torch.where(
                    kl > cfg.desired_kl * 2.0, torch.clamp(lr / 1.5, min=cfg.min_lr),
                    torch.where((kl < cfg.desired_kl / 2.0) & (kl > 0.0),
                                torch.clamp(lr * 1.5, max=cfg.max_lr), lr))
                opt.lr = lr
            opt.step(grads)
            sums += torch.stack([value_loss.detach(), surrogate_loss.detach(),
                                 vel_loss.detach(), sym_loss.detach(), kl])
    n = cfg.num_learning_epochs * nmb
    v, s, vel, sym, kl = (sums / n).unbind()
    return UpdateMetrics(value_loss=v, surrogate_loss=s, vel_loss=vel, sym_loss=sym, kl=kl,
                         lr=opt.lr)
