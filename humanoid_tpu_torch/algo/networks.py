"""Actor-critic and velocity-estimator networks: port of the reference
package's algo/networks.py.

ELU MLPs: actor obs -> 512 -> 256 -> 128 -> nj, critic priv_obs -> 768 ->
256 -> 128 -> 1, velocity head obs -> 128 -> 128 -> 3, plus a learned,
state-independent action std (a raw parameter floored at MIN_STD).
Parameters stay float32; with compute_dtype "bfloat16" every matmul and
activation runs in bf16 and the output is cast back to float32.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

MIN_STD = 1e-3


def _lecun_normal_(w: torch.Tensor, gen: torch.Generator):
    """Truncated-normal init with variance 1/fan_in (flax's Dense default)."""
    fan_in = w.shape[1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        w.copy_(torch.nn.init.trunc_normal_(torch.empty_like(w), 0.0, 1.0, -2.0, 2.0,
                                            generator=gen) * std)


class MLP(nn.Module):
    def __init__(self, in_dim: int, dims: Sequence[int], out_dim: int):
        super().__init__()
        sizes = [in_dim, *dims, out_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))

    def reset_parameters(self, gen: torch.Generator):
        for layer in self.layers:
            _lecun_normal_(layer.weight, gen)
            nn.init.zeros_(layer.bias)

    def forward(self, x, dtype=torch.float32):
        x = x.to(dtype)
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = F.linear(x, layer.weight.to(dtype), layer.bias.to(dtype))
            if i < last:
                x = F.elu(x)
        return x.float()


class ActorCritic(nn.Module):
    def __init__(self, num_obs: int, num_priv_obs: int, num_actions: int,
                 actor_hidden_dims=(512, 256, 128), critic_hidden_dims=(768, 256, 128),
                 vel_est_hidden_dims=(128, 128), init_noise_std: float = 1.0,
                 compute_dtype: str = "float32"):
        super().__init__()
        self.actor = MLP(num_obs, actor_hidden_dims, num_actions)
        self.critic = MLP(num_priv_obs, critic_hidden_dims, 1)
        self.vel_est = MLP(num_obs, vel_est_hidden_dims, 3)
        self.std = nn.Parameter(torch.full((num_actions,), float(init_noise_std)))
        self.compute_dtype = getattr(torch, compute_dtype)

    def reset_parameters(self, gen: torch.Generator, init_noise_std: float = 1.0):
        for mlp in (self.actor, self.critic, self.vel_est):
            mlp.reset_parameters(gen)
        with torch.no_grad():
            self.std.fill_(init_noise_std)

    def action_std(self):
        return torch.clamp(self.std, min=MIN_STD)

    def act_mean(self, obs):
        return self.actor(obs, self.compute_dtype)

    def value(self, critic_obs):
        return self.critic(critic_obs, self.compute_dtype)[..., 0]

    def estimate_vel(self, obs):
        return self.vel_est(obs, self.compute_dtype)

    def forward(self, obs, critic_obs):
        """(mean, std, value, vel)."""
        return self.act_mean(obs), self.action_std(), self.value(critic_obs), self.estimate_vel(obs)


# ---------------------------------------------------------------------------
# diagonal Gaussian helpers

def log_prob(mean, std, action):
    z = (action - mean) / std
    return torch.sum(-0.5 * z * z - torch.log(std) - 0.5 * math.log(2 * math.pi), dim=-1)


def entropy(std):
    return torch.sum(0.5 + 0.5 * math.log(2 * math.pi) + torch.log(std), dim=-1)


def kl_divergence(old_mean, old_std, mean, std):
    """The reference's KL expression, summed over the action dim."""
    return torch.sum(
        torch.log(std / old_std + 1e-5)
        + (torch.square(old_std) + torch.square(old_mean - mean)) / (2.0 * torch.square(std))
        - 0.5,
        dim=-1,
    )


# ---------------------------------------------------------------------------
# weights carried across from the reference package

def _load_mlp(mlp: MLP, layers):
    """layers: [(kernel (in, out), bias (out,)), ...] in the flax layout."""
    if len(layers) != len(mlp.layers):
        raise ValueError(f"expected {len(mlp.layers)} layers, got {len(layers)}")
    with torch.no_grad():
        for lin, (w, b) in zip(mlp.layers, layers):
            w = np.asarray(w, dtype=np.float32)
            if tuple(w.shape) != tuple(lin.weight.shape[::-1]):
                raise ValueError(f"kernel shape {w.shape} does not fit {tuple(lin.weight.shape)}")
            lin.weight.copy_(torch.from_numpy(w.T.copy()))
            lin.bias.copy_(torch.from_numpy(np.asarray(b, dtype=np.float32)))


def from_jax_params(net: ActorCritic, tree) -> ActorCritic:
    """Copy a flax param tree ({"params": {"actor": {"Dense_i": {"kernel",
    "bias"}}, "critic", "vel_est", "std"}}, leaves as numpy) into `net`.
    Flax kernels are (in, out); nn.Linear weights are (out, in)."""
    p = tree.get("params", tree)
    for name in ("actor", "critic", "vel_est"):
        sub = p[name]
        layers = [(sub[f"Dense_{i}"]["kernel"], sub[f"Dense_{i}"]["bias"])
                  for i in range(len(sub))]
        _load_mlp(getattr(net, name), layers)
    with torch.no_grad():
        net.std.copy_(torch.as_tensor(np.asarray(p["std"], dtype=np.float32)))
    return net


def from_npz(net: ActorCritic, path: str) -> ActorCritic:
    """Load the exported policy layout (actor_w{i}/actor_b{i},
    vel_w{i}/vel_b{i}, std) into the actor, velocity head and std."""
    with np.load(path) as z:
        for prefix, mlp in (("actor", net.actor), ("vel", net.vel_est)):
            layers = []
            while f"{prefix}_w{len(layers)}" in z.files:
                i = len(layers)
                layers.append((z[f"{prefix}_w{i}"], z[f"{prefix}_b{i}"]))
            _load_mlp(mlp, layers)
        with torch.no_grad():
            net.std.copy_(torch.from_numpy(z["std"].astype(np.float32)))
    return net
