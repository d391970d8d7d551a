"""Generalized advantage estimation: port of the reference package's
algo/gae.py. delta = r + gamma V'(1 - done) - V,
A = delta + gamma lam (1 - done) A', returns = A + V. Advantage
normalization is left to the caller."""
from __future__ import annotations

import torch


def compute_gae(rewards, values, dones, last_values, gamma: float, lam: float):
    """rewards/values/dones: (T, N); last_values: (N,).
    Returns (advantages (T, N), returns (T, N))."""
    not_done = 1.0 - dones.to(rewards.dtype)
    advantages = torch.empty_like(rewards)
    adv_next = torch.zeros_like(last_values)
    v_next = last_values
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * v_next * not_done[t] - values[t]
        adv_next = delta + gamma * lam * not_done[t] * adv_next
        advantages[t] = adv_next
        v_next = values[t]
    return advantages, advantages + values
