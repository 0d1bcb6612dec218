"""Generalized Advantage Estimation oracle (plain PyTorch, sequential loop),
the counterpart of the JAX package's origin/gae.py.

Reproduces the reference's denominator-normalized variant:

    delta_t = r_t + gamma*V_{t+1} - V_t
    denom   = 1 + lambda*denom          (denom_T = 0)
    gae     = denom*delta_t + gamma*lambda*gae   (gae_T = 0)
    adv_t   = gae / denom
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class gae_data(NamedTuple):
    value: torch.Tensor   # (T+1, B)
    reward: torch.Tensor  # (T, B)


def gae(data: gae_data, gamma: float = 0.99,
        lambda_: float = 0.97) -> torch.Tensor:
    """Advantages (T, B) from value (T+1, B) and reward (T, B)."""
    value, reward = data
    delta = reward + gamma * value[1:] - value[:-1]
    factor = gamma * lambda_
    gae_item = torch.zeros_like(delta[0])
    denom = torch.zeros((), dtype=delta.dtype, device=delta.device)
    adv = [None] * delta.shape[0]
    for t in range(delta.shape[0] - 1, -1, -1):
        denom = 1.0 + lambda_ * denom
        gae_item = denom * delta[t] + factor * gae_item
        adv[t] = gae_item / denom
    return torch.stack(adv)
