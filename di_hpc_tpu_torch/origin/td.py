"""TD-family oracles (plain PyTorch), the port of the JAX package's
origin/td.py, quirks included (they are the contract the ops are tested
against):

 - the C51 projection drops mass when the projected atom lands exactly on
   the support grid (l == u == b gives both (u - b) and (b - l) = 0);
 - the lambda-returns are computed without gradient, as the reference
   computes them under torch.no_grad; the loss's gradient reaches value[:-1]
   only;
 - the n-step reward reduction is sum_i gamma^i * r_i;
 - QR-DQN broadcasts (B, 1, tau) targets against (B, tau, 1) predictions.

Targets are detached exactly where the JAX package puts stop_gradient.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.constants import VALUE_RESCALE_EPS


# ---------------------------------------------------------------------------
# Value rescale (R2D2)
# ---------------------------------------------------------------------------

def value_transform(x, eps: float = VALUE_RESCALE_EPS):
    """h(x) = sign(x) * (sqrt(|x| + 1) - 1) + eps * x."""
    return torch.sign(x) * (torch.sqrt(torch.abs(x) + 1.0) - 1.0) + eps * x


def value_inv_transform(x, eps: float = VALUE_RESCALE_EPS):
    """h^-1(x) = sign(x) * (((sqrt(1 + 4 eps (|x| + 1 + eps)) - 1) /
    (2 eps))^2 - 1)."""
    inner = (torch.sqrt(1.0 + 4.0 * eps * (torch.abs(x) + 1.0 + eps))
             - 1.0) / (2.0 * eps)
    return torch.sign(x) * (inner * inner - 1.0)


# ---------------------------------------------------------------------------
# n-step return
# ---------------------------------------------------------------------------

class nstep_return_data(NamedTuple):
    reward: torch.Tensor      # (nstep, B)
    next_value: torch.Tensor  # (B,) or broadcastable
    done: torch.Tensor        # (B,)


def _discounted_reward_sum(reward, gamma: float):
    """sum_i gamma^i * reward[i] over the leading axis: (nstep, B) -> (B,)."""
    nstep = reward.shape[0]
    factor = gamma ** torch.arange(nstep, dtype=reward.dtype,
                                   device=reward.device)
    return torch.tensordot(factor, reward, dims=1)


def nstep_return(data: nstep_return_data, gamma: float, nstep: int):
    reward, next_value, done = data
    if reward.shape[0] != nstep:
        raise ValueError(f"nstep_return: reward has {reward.shape[0]} steps, "
                         f"nstep={nstep}")
    r = _discounted_reward_sum(reward, gamma)
    return r + (gamma ** nstep) * next_value * (1.0 - done.to(r.dtype))


# ---------------------------------------------------------------------------
# TD(lambda)
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# Q n-step TD
# ---------------------------------------------------------------------------

class q_nstep_td_data(NamedTuple):
    q: torch.Tensor              # (B, N)
    next_n_q: torch.Tensor       # (B, N)
    action: torch.Tensor         # (B,)
    next_n_action: torch.Tensor  # (B,)
    reward: torch.Tensor         # (nstep, B)
    done: torch.Tensor           # (B,)
    weight: Optional[torch.Tensor]


def _mse(pred, target):
    return (pred - target) ** 2


def _gather_q(q, action):
    """q (B, N) -> q[b, action[b]] (B,)."""
    return torch.gather(q, 1, action.long()[:, None])[:, 0]


def q_nstep_td_error(data: q_nstep_td_data, gamma: float, nstep: int = 1,
                     criterion=_mse):
    """criterion(pred, target) -> per-sample loss; squared error by default
    (the reference's MSELoss(reduction='none'))."""
    q, next_n_q, action, next_n_action, reward, done, weight = data
    if weight is None:
        weight = torch.ones(q.shape[0], dtype=q.dtype, device=q.device)
    q_s_a = _gather_q(q, action)
    target_q_s_a = _gather_q(next_n_q, next_n_action)
    target = nstep_return(nstep_return_data(reward, target_q_s_a, done),
                          gamma, nstep)
    td_error_per_sample = criterion(q_s_a, target.detach())
    return torch.mean(td_error_per_sample * weight), td_error_per_sample


def q_nstep_td_error_with_rescale(data: q_nstep_td_data, gamma: float,
                                  nstep: int = 1, criterion=_mse,
                                  trans_fn=value_transform,
                                  inv_trans_fn=value_inv_transform):
    q, next_n_q, action, next_n_action, reward, done, weight = data
    if weight is None:
        weight = torch.ones(q.shape[0], dtype=q.dtype, device=q.device)
    q_s_a = _gather_q(q, action)
    target_q_s_a = inv_trans_fn(_gather_q(next_n_q, next_n_action))
    target = nstep_return(nstep_return_data(reward, target_q_s_a, done),
                          gamma, nstep)
    target = trans_fn(target)
    td_error_per_sample = criterion(q_s_a, target.detach())
    return torch.mean(td_error_per_sample * weight), td_error_per_sample


# ---------------------------------------------------------------------------
# Distributional (C51) n-step TD
# ---------------------------------------------------------------------------

class dist_nstep_td_data(NamedTuple):
    dist: torch.Tensor         # (B, N, n_atom)
    next_n_dist: torch.Tensor  # (B, N, n_atom)
    act: torch.Tensor          # (B,)
    next_n_act: torch.Tensor   # (B,)
    reward: torch.Tensor       # (nstep, B)
    done: torch.Tensor         # (B,)
    weight: Optional[torch.Tensor]


def _gather_rows(x, idx):
    """x (B, N, A) -> x[b, idx[b], :] (B, A)."""
    index = idx.long()[:, None, None].expand(-1, 1, x.shape[-1])
    return torch.gather(x, 1, index)[:, 0]


def dist_nstep_td_error(data: dist_nstep_td_data, gamma: float, v_min: float,
                        v_max: float, n_atom: int, nstep: int = 1):
    dist, next_n_dist, act, next_n_act, reward, done, weight = data
    B = act.shape[0]
    r = _discounted_reward_sum(reward, gamma)[:, None]        # (B, 1)
    done_f = done.to(dist.dtype)[:, None]                     # (B, 1)
    support = torch.linspace(v_min, v_max, n_atom, dtype=dist.dtype,
                             device=dist.device)
    delta_z = (v_max - v_min) / (n_atom - 1)
    if weight is None:
        weight = torch.ones_like(r)
    if weight.ndim == 1:
        weight = weight[:, None]

    next_dist = _gather_rows(next_n_dist, next_n_act).detach()  # (B, n_atom)
    target_z = r + (1.0 - done_f) * (gamma ** nstep) * support
    target_z = torch.clamp(target_z, v_min, v_max)
    b = (target_z - v_min) / delta_z
    l, u = torch.floor(b).long(), torch.ceil(b).long()

    # The categorical projection by scatter-add onto the support.  When b is
    # integral, l == u and both weights are zero: the mass is dropped, as in
    # the reference.
    offset = (torch.arange(B, device=b.device) * n_atom)[:, None]
    proj = torch.zeros(B * n_atom, dtype=next_dist.dtype, device=b.device)
    proj = proj.index_add(0, (l + offset).reshape(-1),
                          (next_dist * (u.to(b.dtype) - b)).reshape(-1))
    proj = proj.index_add(0, (u + offset).reshape(-1),
                          (next_dist * (b - l.to(b.dtype))).reshape(-1))
    proj = proj.reshape(B, n_atom)

    log_p = torch.log(_gather_rows(dist, act))                # (B, n_atom)
    td_error_per_sample = -torch.sum(log_p * proj, dim=-1)
    loss = -torch.mean(torch.sum(log_p * proj * weight, dim=-1))
    return loss, td_error_per_sample


# ---------------------------------------------------------------------------
# QR-DQN n-step TD
# ---------------------------------------------------------------------------

class qrdqn_nstep_td_data(NamedTuple):
    q: torch.Tensor              # (B, N, tau)
    next_n_q: torch.Tensor       # (B, N, tau)
    action: torch.Tensor         # (B,)
    next_n_action: torch.Tensor  # (B,)
    reward: torch.Tensor         # (nstep, B)
    done: torch.Tensor           # (B,)
    tau: torch.Tensor            # quantiles, broadcastable to (B, tau, tau)
    weight: Optional[torch.Tensor]


def qrdqn_nstep_td_error(data: qrdqn_nstep_td_data, gamma: float,
                         nstep: int = 1, value_gamma=None):
    q, next_n_q, action, next_n_action, reward, done, tau, weight = data
    if weight is None:
        weight = torch.ones(action.shape[0], dtype=q.dtype, device=q.device)
    q_s_a = _gather_rows(q, action)[:, :, None]                   # (B, tau, 1)
    target_q_s_a = _gather_rows(next_n_q, next_n_action)[:, None, :]
    r = _discounted_reward_sum(reward, gamma)[:, None, None]
    done_f = (1.0 - done.to(q.dtype))[:, None, None]
    if value_gamma is None:
        target_q_s_a = r + (gamma ** nstep) * target_q_s_a * done_f
    else:
        target_q_s_a = r + value_gamma[:, None, None] * target_q_s_a * done_f

    diff = target_q_s_a - q_s_a                                   # (B, tau, tau)
    u = torch.where(torch.abs(diff) < 1.0, 0.5 * diff * diff,
                    torch.abs(diff) - 0.5)
    indicator = (diff <= 0.0).to(q.dtype).detach()
    loss_per_sample = torch.mean(
        torch.sum(u * torch.abs(tau - indicator), dim=-1), dim=1)
    return torch.mean(loss_per_sample * weight), loss_per_sample


# ---------------------------------------------------------------------------
# IQN n-step TD
# ---------------------------------------------------------------------------

class iqn_nstep_td_data(NamedTuple):
    q: torch.Tensor                 # (tau, B, N)
    next_n_q: torch.Tensor          # (tau', B, N)
    action: torch.Tensor            # (B,)
    next_n_action: torch.Tensor     # (B,)
    reward: torch.Tensor            # (nstep, B)
    done: torch.Tensor              # (B,)
    replay_quantiles: torch.Tensor  # (tau, B)
    weight: Optional[torch.Tensor]


def _gather_actions(q, action):
    """q (tau, B, N) -> q[:, b, action[b]] (tau, B)."""
    index = action.long()[None, :, None].expand(q.shape[0], -1, 1)
    return torch.gather(q, 2, index)[:, :, 0]


def iqn_nstep_td_error(data: iqn_nstep_td_data, gamma: float, nstep: int = 1,
                       kappa: float = 1.0, value_gamma=None):
    (q, next_n_q, action, next_n_action, reward, done, replay_quantiles,
     weight) = data
    tau, B, _ = q.shape
    tau_prime = next_n_q.shape[0]
    if weight is None:
        weight = torch.ones(B, dtype=q.dtype, device=q.device)

    q_s_a = _gather_actions(q, action).T[:, :, None]              # (B, tau, 1)
    target_q_s_a = _gather_actions(next_n_q, next_n_action).T     # (B, tau')
    r = _discounted_reward_sum(reward, gamma)[:, None]
    not_done = (1.0 - done.to(q.dtype))[:, None]
    if value_gamma is None:
        target_q_s_a = r + (gamma ** nstep) * target_q_s_a * not_done
    else:
        target_q_s_a = r + value_gamma[:, None] * target_q_s_a * not_done

    # (B, tau', tau, 1) pairwise Bellman errors.
    bellman_errors = target_q_s_a[:, :, None, None] - q_s_a[:, None, :, :]
    abs_err = torch.abs(bellman_errors)
    huber = torch.where(abs_err <= kappa, 0.5 * bellman_errors ** 2,
                        kappa * (abs_err - 0.5 * kappa))
    rq = replay_quantiles.reshape(tau, B).T[:, None, :, None]     # (B,1,tau,1)
    rq = rq.expand(B, tau_prime, tau, 1)
    indicator = (bellman_errors < 0).to(q.dtype).detach()
    quantile_huber = torch.abs(rq - indicator) * huber / kappa
    loss_per_sample = torch.mean(torch.sum(quantile_huber, dim=2),
                                 dim=1)[:, 0]                     # (B,)
    return torch.mean(loss_per_sample * weight), loss_per_sample
