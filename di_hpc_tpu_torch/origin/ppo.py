"""PPO loss oracle (plain PyTorch), the counterpart of the JAX package's
origin/ppo.py: policy loss with clip and optional dual clip
(arXiv:1912.09729), optional value clip, entropy loss, and the approx_kl /
clipfrac monitor scalars (detached).  Its two categorical helpers are also
the V-trace oracle's."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class ppo_data(NamedTuple):
    logit_new: torch.Tensor         # (B, N)
    logit_old: torch.Tensor         # (B, N)
    action: torch.Tensor            # (B,) integer
    value_new: torch.Tensor         # (B,)
    value_old: torch.Tensor         # (B,)
    adv: torch.Tensor               # (B,)
    return_: torch.Tensor           # (B,)
    weight: Optional[torch.Tensor]  # (B,) or None


class ppo_loss(NamedTuple):
    policy_loss: torch.Tensor
    value_loss: torch.Tensor
    entropy_loss: torch.Tensor


class ppo_info(NamedTuple):
    approx_kl: torch.Tensor
    clipfrac: torch.Tensor


def categorical_log_prob(logit: torch.Tensor,
                         action: torch.Tensor) -> torch.Tensor:
    """log softmax(logit)[action] along the last axis."""
    logp = torch.log_softmax(logit, dim=-1)
    return torch.gather(logp, -1, action.long()[..., None])[..., 0]


def categorical_entropy(logit: torch.Tensor) -> torch.Tensor:
    """Entropy of Categorical(logits=logit) along the last axis."""
    logp = torch.log_softmax(logit, dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)


def check_dual_clip(dual_clip) -> None:
    """The reference's dual-clip contract, raised as its assertion is (and
    also under python -O)."""
    if dual_clip is not None and not dual_clip > 1.0:
        raise AssertionError(f"dual_clip value must be greater than 1.0, but "
                             f"get value: {dual_clip}")


def ppo_error(data: ppo_data, clip_ratio: float = 0.2,
              use_value_clip: bool = True, dual_clip: Optional[float] = None):
    check_dual_clip(dual_clip)
    logit_new, logit_old, action, value_new, value_old, adv, return_, \
        weight = data
    if weight is None:
        weight = torch.ones_like(adv)

    logp_new = categorical_log_prob(logit_new, action)
    logp_old = categorical_log_prob(logit_old, action)
    entropy_loss = torch.mean(categorical_entropy(logit_new) * weight)

    ratio = torch.exp(logp_new - logp_old)
    surr1 = ratio * adv
    surr2 = torch.clamp(ratio, 1 - clip_ratio, 1 + clip_ratio) * adv
    if dual_clip is not None:
        policy_loss = torch.mean(-torch.maximum(torch.minimum(surr1, surr2),
                                                dual_clip * adv) * weight)
    else:
        policy_loss = torch.mean(-torch.minimum(surr1, surr2) * weight)

    with torch.no_grad():
        approx_kl = torch.mean(logp_old - logp_new)
        clipped = (ratio > 1 + clip_ratio) | (ratio < 1 - clip_ratio)
        clipfrac = torch.mean(clipped.to(adv.dtype))

    if use_value_clip:
        value_clip = value_old + torch.clamp(value_new - value_old,
                                             -clip_ratio, clip_ratio)
        v1 = (return_ - value_new) ** 2
        v2 = (return_ - value_clip) ** 2
        value_loss = 0.5 * torch.mean(torch.maximum(v1, v2) * weight)
    else:
        value_loss = 0.5 * torch.mean((return_ - value_new) ** 2 * weight)

    return (ppo_loss(policy_loss, value_loss, entropy_loss),
            ppo_info(approx_kl, clipfrac))
