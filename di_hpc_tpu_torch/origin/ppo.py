"""Categorical oracles (plain PyTorch), the two functions of the JAX
package's origin/ppo.py that the V-trace oracle uses."""

from __future__ import annotations

import torch


def categorical_log_prob(logit: torch.Tensor,
                         action: torch.Tensor) -> torch.Tensor:
    """log softmax(logit)[action] along the last axis."""
    logp = torch.log_softmax(logit, dim=-1)
    return torch.gather(logp, -1, action.long()[..., None])[..., 0]


def categorical_entropy(logit: torch.Tensor) -> torch.Tensor:
    """Entropy of Categorical(logits=logit) along the last axis."""
    logp = torch.log_softmax(logit, dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)
