"""V-trace (IMPALA, arXiv:1802.01561) oracle in plain PyTorch, the
counterpart of the JAX package's origin/vtrace.py.

Returns and advantages are computed from detached inputs (the reference
wraps them in torch.no_grad); gradients flow only through the target
log-probs, the entropy and the value MSE.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .ppo import categorical_entropy, categorical_log_prob


class vtrace_data(NamedTuple):
    target_output: torch.Tensor     # (T, B, N) logits of the learner policy
    behaviour_output: torch.Tensor  # (T, B, N) logits of the actor policy
    action: torch.Tensor            # (T, B) integer
    value: torch.Tensor             # (T+1, B)
    reward: torch.Tensor            # (T, B)
    weight: Optional[torch.Tensor]  # (T, B), (B,) or None


class vtrace_loss(NamedTuple):
    policy_loss: torch.Tensor
    value_loss: torch.Tensor
    entropy_loss: torch.Tensor


def compute_importance_weights(target_output, behaviour_output, action):
    """IS = exp(logpi_target(a) - logpi_behaviour(a)), shape (T, B)."""
    logp_t = categorical_log_prob(target_output, action)
    logp_b = categorical_log_prob(behaviour_output, action)
    return torch.exp(logp_t - logp_b)


def vtrace_nstep_return(clipped_rhos, clipped_cs, reward, bootstrap_values,
                        gamma=0.99, lambda_=0.95):
    """vs_t = V_t + item_t, item_t = delta_t + gamma*lambda*c_t*item_{t+1}."""
    deltas = clipped_rhos * (reward + gamma * bootstrap_values[1:]
                             - bootstrap_values[:-1])
    factor = gamma * lambda_
    items = []
    item = torch.zeros_like(deltas[0])
    for t in range(deltas.shape[0] - 1, -1, -1):
        item = deltas[t] + factor * clipped_cs[t] * item
        items.append(item)
    return bootstrap_values[:-1] + torch.stack(items[::-1])


def vtrace_advantage(clipped_pg_rhos, reward, return_, bootstrap_values,
                     gamma):
    """adv_t = pg_rho_t * (r_t + gamma*vs_{t+1} - V_t)."""
    return clipped_pg_rhos * (reward + gamma * return_ - bootstrap_values)


def vtrace_error(
    data: vtrace_data,
    gamma: float = 0.99,
    lambda_: float = 0.95,
    rho_clip_ratio: float = 1.0,
    c_clip_ratio: float = 1.0,
    rho_pg_clip_ratio: float = 1.0,
) -> vtrace_loss:
    target_output, behaviour_output, action, value, reward, weight = data

    with torch.no_grad():
        IS = compute_importance_weights(target_output, behaviour_output,
                                        action)
        rhos = torch.clamp(IS, max=rho_clip_ratio)
        cs = torch.clamp(IS, max=c_clip_ratio)
        return_ = vtrace_nstep_return(rhos, cs, reward, value, gamma, lambda_)
        pg_rhos = torch.clamp(IS, max=rho_pg_clip_ratio)
        return_t_plus_1 = torch.cat([return_[1:], value[-1:]], dim=0)
        adv = vtrace_advantage(pg_rhos, reward, return_t_plus_1, value[:-1],
                               gamma)

    if weight is None:
        weight = torch.ones_like(reward)

    logp = categorical_log_prob(target_output, action)
    pg_loss = -torch.mean(logp * adv * weight)
    value_loss = torch.mean((value[:-1] - return_) ** 2 * weight)
    entropy_loss = torch.mean(categorical_entropy(target_output) * weight)
    return vtrace_loss(pg_loss, value_loss, entropy_loss)
