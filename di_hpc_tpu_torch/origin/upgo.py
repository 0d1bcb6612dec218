"""UPGO loss oracle (AlphaStar), plain PyTorch; the counterpart of the JAX
package's origin/upgo.py.

UPGO is a lambda-return with data-dependent binary lambdas: the trace
continues (lambda=1) iff r_{t+1} + V_{t+2} >= V_{t+1}.
"""

from __future__ import annotations

import torch

from .ppo import categorical_log_prob
from .td import generalized_lambda_returns

__all__ = ["tb_cross_entropy", "upgo_returns", "upgo_loss"]


def tb_cross_entropy(logit: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """(T, B, N) logits, (T, B) labels -> (T, B) log-prob of the label (the
    reference's -cross_entropy, meaned over a trailing axis of size 1)."""
    assert label.ndim == 2
    return categorical_log_prob(logit, label)


def upgo_returns(rewards: torch.Tensor,
                 bootstrap_values: torch.Tensor) -> torch.Tensor:
    """rewards (T, B), bootstrap_values (T+1, B) -> (T, B) UPGO return
    targets.  lambdas[t] decides whether the trace continues at t, shifted
    forward one step with 1.0 appended; generalized_lambda_returns ignores
    lambdas[-1]."""
    lambdas = ((rewards + bootstrap_values[1:])
               >= bootstrap_values[:-1]).to(rewards.dtype)
    lambdas = torch.cat([lambdas[1:], torch.ones_like(lambdas[-1:])])
    return generalized_lambda_returns(bootstrap_values, rewards, 1.0, lambdas)


def upgo_loss(target_output: torch.Tensor,     # (T, B, N)
              rhos: torch.Tensor,              # (T, B) importance ratios
              action: torch.Tensor,            # (T, B)
              rewards: torch.Tensor,           # (T, B)
              bootstrap_values: torch.Tensor,  # (T+1, B)
              ) -> torch.Tensor:
    with torch.no_grad():
        returns = upgo_returns(rewards, bootstrap_values)
        advantages = rhos * (returns - bootstrap_values[:-1])
    metric = tb_cross_entropy(target_output, action)
    return -torch.mean(advantages * metric)
