"""TD(lambda) oracle (plain PyTorch), the TD(lambda) part of the JAX
package's origin/td.py.

The lambda-returns are computed without gradient, as the reference computes
them under torch.no_grad; the loss's gradient reaches value[:-1] only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class td_lambda_data(NamedTuple):
    value: torch.Tensor             # (T+1, B)
    reward: torch.Tensor            # (T, B)
    weight: Optional[torch.Tensor]  # (T, B), (B,) or None


def _broadcast(x, like):
    return torch.broadcast_to(
        torch.as_tensor(x, dtype=like.dtype, device=like.device), like.shape)


def multistep_forward_view(bootstrap_values, rewards, gammas, lambda_):
    """Sutton & Barto (12.18), with bootstrap_values (T, B) the values at
    steps 1..T:

        result[T-1] = r[T-1] + gammas[T-1] * V[T]
        result[t]   = r[t] + gammas[t] * (lambdas[t]*result[t+1]
                                          + (1-lambdas[t]) * V[t+1])
    """
    gammas = _broadcast(gammas, rewards)
    discounts = gammas * _broadcast(lambda_, rewards)
    T = rewards.shape[0]
    result = [None] * T
    y = rewards[T - 1] + gammas[T - 1] * bootstrap_values[T - 1]
    result[T - 1] = y
    for t in range(T - 2, -1, -1):
        y = (rewards[t] + discounts[t] * y
             + (gammas[t] - discounts[t]) * bootstrap_values[t])
        result[t] = y
    return torch.stack(result)


def generalized_lambda_returns(bootstrap_values, rewards, gammas, lambda_):
    """Lambda-returns (T, B) from bootstrap_values (T+1, B) and rewards
    (T, B); gammas and lambda_ are floats or (T, B)."""
    return multistep_forward_view(bootstrap_values[1:], rewards, gammas,
                                  lambda_)


def td_lambda_error(data: td_lambda_data, gamma: float = 0.9,
                    lambda_: float = 0.8) -> torch.Tensor:
    """0.5 * mean(weight * (lambda_return - V[:-1])^2)."""
    value, reward, weight = data
    if weight is None:
        weight = torch.ones_like(reward)
    with torch.no_grad():
        return_ = generalized_lambda_returns(value, reward, gamma, lambda_)
    return 0.5 * torch.mean((return_ - value[:-1]) ** 2 * weight)
