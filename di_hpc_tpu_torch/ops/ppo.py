"""PPO loss, the counterpart of the JAX package's ops/ppo.py.

The categorical head (ops.categorical: log-prob and entropy in one pass over
the new logits, with the stash-free recompute backward) feeds plain PyTorch
surrogate, value-clip and monitor arithmetic.  The JAX package leaves that
arithmetic to XLA fusion, with no Pallas kernel, so it stays plain here;
autograd gives the reference's backward, including the dual-clip
subgradients (torch.maximum/minimum split a tie's gradient in half, as
jnp.maximum/minimum do).

`ppo_error_with_logp_old` is the fast path: the old policy's log-prob is
computed once per collected batch (ops.logp) and reused in every epoch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..origin.ppo import check_dual_clip, ppo_data, ppo_info, ppo_loss
from ._validate import check_ppo, check_ppo_fast
from .categorical import logp, logp_entropy

__all__ = ["ppo_error", "ppo_error_with_logp_old", "ppo_data",
           "ppo_fast_data", "ppo_loss", "ppo_info", "PPO"]


class ppo_fast_data(NamedTuple):
    """ppo_data with the old policy's head precomputed: `logp_old`
    (ops.logp(logit_old, action)) replaces `logit_old`."""
    logit_new: torch.Tensor         # (B, N)
    logp_old: torch.Tensor          # (B,)
    action: torch.Tensor            # (B,) integer
    value_new: torch.Tensor         # (B,)
    value_old: torch.Tensor         # (B,)
    adv: torch.Tensor               # (B,)
    return_: torch.Tensor           # (B,)
    weight: Optional[torch.Tensor]  # (B,) or None


def _ppo_core(logp_new, entropy, logp_old, value_new, value_old, adv,
              return_, weight, clip_ratio, use_value_clip, dual_clip):
    """Surrogate, value-clip and entropy losses and the monitor scalars
    from the per-sample heads."""
    if weight is None:
        weight = torch.ones_like(adv)
    entropy_loss = torch.mean(entropy * weight)

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


def ppo_error(data: ppo_data, clip_ratio: float = 0.2,
              use_value_clip: bool = True, dual_clip: Optional[float] = None):
    check_dual_clip(dual_clip)
    logit_new, logit_old, action, value_new, value_old, adv, return_, \
        weight = data
    check_ppo("ppo_error", logit_new, logit_old, action, value_new,
              value_old, adv, return_, weight)
    logp_new, entropy = logp_entropy(logit_new, action)
    logp_old = logp(logit_old, action).detach()
    return _ppo_core(logp_new, entropy, logp_old, value_new, value_old, adv,
                     return_, weight, clip_ratio, use_value_clip, dual_clip)


def ppo_error_with_logp_old(data: ppo_fast_data, clip_ratio: float = 0.2,
                            use_value_clip: bool = True,
                            dual_clip: Optional[float] = None):
    """The PPO loss with the old policy's log-prob precomputed; equal to
    `ppo_error` when logp_old == ops.logp(logit_old, action)."""
    check_dual_clip(dual_clip)
    logit_new, logp_old, action, value_new, value_old, adv, return_, \
        weight = data
    check_ppo_fast("ppo_error_with_logp_old", logit_new, logp_old, action,
                   value_new, value_old, adv, return_, weight)
    logp_new, entropy = logp_entropy(logit_new, action)
    return _ppo_core(logp_new, entropy, logp_old.detach(), value_new,
                     value_old, adv, return_, weight, clip_ratio,
                     use_value_clip, dual_clip)


class PPO:
    """Shape-static wrapper mirroring the reference module API; dual_clip
    None is the no-dual-clip branch (the reference's 0.0 sentinel)."""

    def __init__(self, B: int, N: int):
        self.B, self.N = B, N

    def __call__(self, logit_new, logit_old, action, value_new, value_old,
                 adv, return_, weight=None, clip_ratio: float = 0.2,
                 use_value_clip: bool = True, dual_clip=None):
        if tuple(logit_new.shape) != (self.B, self.N):
            raise ValueError(f"PPO: logit_new must be {(self.B, self.N)}; "
                             f"got {tuple(logit_new.shape)}")
        return ppo_error(
            ppo_data(logit_new, logit_old, action, value_new, value_old, adv,
                     return_, weight),
            clip_ratio, use_value_clip, dual_clip)

    forward = __call__
