"""The TD family, the counterpart of the JAX package's ops/td.py.

TD(lambda) runs on the port's kernels.
With unit weight the loss runs in the loss-fused kernel
(kernels.td_lambda_loss): returns and squared error in one pass, only a
per-column partial leaves the kernel, and its backward recomputes the error
with kernels.td_lambda_err.  With a (B,) or (T, B) weight the returns kernel
(kernels.lambda_returns) writes the returns and the weighted mean runs
outside; the weight broadcasts over time as in the reference's origin
(docs/DESIGN.md:91-92).  Other methods, dtypes and ranks take the scan core.
The returns are detached everywhere: the gradient reaches value[:-1] only.

The batch-bound ops (q_nstep and its rescaled form, C51, QR-DQN, IQN) are
plain PyTorch, as the JAX package leaves them to XLA fusion: a gather, an
n-step reduction and a loss per sample, no recurrence.  Their gathers are
torch.gather, whose backward puts one contribution in each slot, so it is
deterministic.  The C51 projection is built dense (each atom's two weights
compared against the atom index, summed over the source atoms), as the JAX
op builds it: a scatter-add would add with float atomics on the card.
Targets are detached where the JAX package puts stop_gradient; the gradient
reaches q (or dist) only.
"""

from __future__ import annotations

import torch

import math

from ..kernels.rl_scans import lambda_returns, td_lambda_loss
from ..origin import td as _origin_td
from ..origin.td import (
    dist_nstep_td_data,
    iqn_nstep_td_data,
    nstep_return,
    nstep_return_data,
    q_nstep_td_data,
    qrdqn_nstep_td_data,
    td_lambda_data,
    value_inv_transform,
    value_transform,
)
from ._backend import fused_kernels_ok
from ._validate import _fail, check_nstep, check_time_batch
from .scan import Method, linear_recurrence_reverse

__all__ = [
    "td_lambda_error", "generalized_lambda_returns", "multistep_forward_view",
    "q_nstep_td_error", "q_nstep_td_error_with_rescale", "dist_nstep_td_error",
    "qrdqn_nstep_td_error", "iqn_nstep_td_error",
    "TDLambda", "QNStepTD", "QNStepTDRescale", "DistNStepTD",
    "QRDQNNStepTDError", "IQNNStepTDError",
    # the data tuples and helpers, re-exported as the JAX package does
    "td_lambda_data", "q_nstep_td_data", "dist_nstep_td_data",
    "qrdqn_nstep_td_data", "iqn_nstep_td_data",
    "nstep_return", "nstep_return_data", "value_transform",
    "value_inv_transform",
]


def multistep_forward_view(bootstrap_values, rewards, gammas, lambda_,
                           method: Method = "auto"):
    """Scan-core form of origin.multistep_forward_view: the recurrence
        result[t] = [r_t + (g_t - d_t) V_{t+1}] + d_t * result[t+1]
    with d = gammas*lambda_, and d_{T-1} = 0 so that result[T-1] = r + g*V
    (lambda cut off at the horizon)."""
    rewards = torch.as_tensor(rewards)
    like = dict(dtype=rewards.dtype, device=rewards.device)
    gammas = torch.broadcast_to(torch.as_tensor(gammas, **like),
                                rewards.shape)
    lambda_ = torch.broadcast_to(torch.as_tensor(lambda_, **like),
                                 rewards.shape)
    d = gammas * lambda_
    d = torch.cat([d[:-1], torch.zeros_like(d[-1:])])
    a = rewards + (gammas - d) * bootstrap_values
    return linear_recurrence_reverse(a, d, method=method)


def generalized_lambda_returns(bootstrap_values, rewards, gammas, lambda_,
                               method: Method = "auto"):
    return multistep_forward_view(bootstrap_values[1:], rewards, gammas,
                                  lambda_, method=method)


def td_lambda_error(data: td_lambda_data, gamma: float = 0.9,
                    lambda_: float = 0.8,
                    method: Method = "auto") -> torch.Tensor:
    """0.5 * mean(weight * (lambda_return - V[:-1])^2), the returns
    detached; weight (B,) or (T, B) broadcasts as in the origin."""
    value, reward, weight = data
    check_time_batch("td_lambda_error", value, reward, weight)
    fused = fused_kernels_ok(value, reward, method=method)
    if weight is None and fused:
        return td_lambda_loss(value, reward, gamma, lambda_)

    if weight is None:
        weight = torch.ones_like(reward)
    if fused:
        return_ = lambda_returns(value, reward, gamma, lambda_).detach()
    else:
        with torch.no_grad():
            return_ = generalized_lambda_returns(value, reward, gamma,
                                                 lambda_, method=method)
    return 0.5 * torch.mean((return_ - value[:-1]) ** 2 * weight)


# ---------------------------------------------------------------------------
# the batch-bound TD ops
# ---------------------------------------------------------------------------

def q_nstep_td_error(data: q_nstep_td_data, gamma: float, nstep: int = 1,
                     criterion=_origin_td._mse):
    """(mean(weight * criterion(q[a], target)), per-sample errors) with the
    n-step target r + gamma^nstep * next_n_q[a'] * (1 - done), detached."""
    check_nstep("q_nstep_td_error", *data, nstep=nstep)
    return _origin_td.q_nstep_td_error(data, gamma, nstep, criterion)


def q_nstep_td_error_with_rescale(data: q_nstep_td_data, gamma: float,
                                  nstep: int = 1,
                                  criterion=_origin_td._mse,
                                  trans_fn=value_transform,
                                  inv_trans_fn=value_inv_transform):
    """q_nstep_td_error on R2D2's rescaled values: the target is
    trans_fn(n-step return of inv_trans_fn(next_n_q[a']))."""
    check_nstep("q_nstep_td_error_with_rescale", *data, nstep=nstep)
    return _origin_td.q_nstep_td_error_with_rescale(
        data, gamma, nstep, criterion, trans_fn, inv_trans_fn)


def dist_nstep_td_error(data: dist_nstep_td_data, gamma: float, v_min: float,
                        v_max: float, n_atom: int, nstep: int = 1):
    """C51 distributional n-step TD: the origin's math and edge cases (the
    integer-landing mass drop included), with the categorical projection
    built dense and without a scatter:
    proj[b, j] = sum_i (u_i - b_i) * p_i * 1[l_i == j]
               + (b_i - l_i) * p_i * 1[u_i == j]."""
    dist, next_n_dist, act, next_n_act, reward, done, weight = data
    check_nstep("dist_nstep_td_error", dist, next_n_dist, act, next_n_act,
                reward, done, weight, nstep=nstep, q_ndim=3,
                allow_col_weight=True)   # a 1-D weight is expanded below
    if dist.shape[-1] != n_atom:
        _fail("dist_nstep_td_error",
              f"dist's last axis must equal n_atom={n_atom}; got "
              f"{tuple(dist.shape)}")
    r = _origin_td._discounted_reward_sum(reward, gamma)[:, None]  # (B, 1)
    done_f = done.to(dist.dtype)[:, None]
    support = torch.linspace(v_min, v_max, n_atom, dtype=dist.dtype,
                             device=dist.device)
    delta_z = (v_max - v_min) / (n_atom - 1)
    if weight is None:
        weight = torch.ones_like(r)
    if weight.ndim == 1:
        weight = weight[:, None]

    next_dist = _origin_td._gather_rows(next_n_dist, next_n_act).detach()
    target_z = torch.clamp(r + (1.0 - done_f) * (gamma ** nstep) * support,
                           v_min, v_max)
    b = (target_z - v_min) / delta_z
    l, u = torch.floor(b).long(), torch.ceil(b).long()
    j = torch.arange(n_atom, device=b.device)
    wl = (next_dist * (u.to(b.dtype) - b))[:, :, None]
    wu = (next_dist * (b - l.to(b.dtype)))[:, :, None]
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    proj = torch.sum(torch.where(j == l[:, :, None], wl, zero)
                     + torch.where(j == u[:, :, None], wu, zero), dim=1)

    log_p = torch.log(_origin_td._gather_rows(dist, act))       # (B, n_atom)
    td_error_per_sample = -torch.sum(log_p * proj, dim=-1)
    loss = -torch.mean(torch.sum(log_p * proj * weight, dim=-1))
    return loss, td_error_per_sample


def qrdqn_nstep_td_error(data: qrdqn_nstep_td_data, gamma: float,
                         nstep: int = 1, value_gamma=None):
    """QR-DQN n-step TD: the origin's math, the (B, 1, tau) targets against
    the (B, tau, 1) predictions included; value_gamma (B,) replaces
    gamma^nstep when given."""
    check_nstep("qrdqn_nstep_td_error", data.q, data.next_n_q, data.action,
                data.next_n_action, data.reward, data.done, data.weight,
                nstep=nstep, q_ndim=3)
    return _origin_td.qrdqn_nstep_td_error(data, gamma, nstep, value_gamma)


def iqn_nstep_td_error(data: iqn_nstep_td_data, gamma: float, nstep: int = 1,
                       kappa: float = 1.0, value_gamma=None):
    """IQN n-step TD on the (tau, B, N) layout: the origin's math;
    replay_quantiles may have any layout with tau * B elements ((tau, B),
    (tau, B, 1), flat), which the origin reshapes to (tau, B)."""
    check_nstep("iqn_nstep_td_error", data.q, data.next_n_q, data.action,
                data.next_n_action, data.reward, data.done, data.weight,
                nstep=nstep, q_ndim=3, batch_axis=1)
    tau, B = data.q.shape[:2]
    if math.prod(data.replay_quantiles.shape) != tau * B:
        _fail("iqn_nstep_td_error",
              f"replay_quantiles must have tau*B = {tau * B} elements "
              f"(reshaped to {(tau, B)}); got "
              f"{tuple(data.replay_quantiles.shape)}")
    return _origin_td.iqn_nstep_td_error(data, gamma, nstep, kappa,
                                         value_gamma)


# ---------------------------------------------------------------------------
# shape-static wrappers (the reference module API)
# ---------------------------------------------------------------------------

def _check_shapes(op, **named):
    """Raise a ValueError naming `op` for each (tensor, shape) that differs."""
    for name, (x, want) in named.items():
        if tuple(x.shape) != tuple(want):
            raise ValueError(f"{op}: {name} must be {tuple(want)}; got "
                             f"{tuple(x.shape)}")


class TDLambda:
    """Shape-static wrapper mirroring the reference module API."""

    def __init__(self, T: int, B: int):
        self.T, self.B = T, B

    def __call__(self, value, reward, weight=None, gamma: float = 0.9,
                 lambda_: float = 0.8) -> torch.Tensor:
        _check_shapes("TDLambda", value=(value, (self.T + 1, self.B)),
                      reward=(reward, (self.T, self.B)))
        return td_lambda_error(td_lambda_data(value, reward, weight), gamma,
                               lambda_)

    forward = __call__


class QNStepTD:
    """Shape-static n-step TD module.  `T` is the n-step horizon: reward is
    (T, B) and the return a T-step discounted sum, as in the reference
    wrapper; the functional q_nstep_td_error(..., nstep=...) names it."""

    def __init__(self, T: int, B: int, N: int):
        self.T, self.B, self.N = T, B, N

    def __call__(self, q, next_n_q, action, next_n_action, reward, done,
                 weight=None, gamma: float = 0.99):
        _check_shapes("QNStepTD", q=(q, (self.B, self.N)))
        return q_nstep_td_error(
            q_nstep_td_data(q, next_n_q, action, next_n_action, reward, done,
                            weight), gamma, self.T)

    forward = __call__


class QNStepTDRescale:
    """QNStepTD with R2D2's value rescaling; `T` is the n-step horizon."""

    def __init__(self, T: int, B: int, N: int):
        self.T, self.B, self.N = T, B, N

    def __call__(self, q, next_n_q, action, next_n_action, reward, done,
                 weight=None, gamma: float = 0.99):
        _check_shapes("QNStepTDRescale", q=(q, (self.B, self.N)))
        return q_nstep_td_error_with_rescale(
            q_nstep_td_data(q, next_n_q, action, next_n_action, reward, done,
                            weight), gamma, self.T)

    forward = __call__


class DistNStepTD:
    def __init__(self, T: int, B: int, N: int, n_atom: int):
        self.T, self.B, self.N, self.n_atom = T, B, N, n_atom

    def __call__(self, dist, next_n_dist, action, next_n_action, reward, done,
                 weight=None, gamma: float = 0.99, v_min: float = -10.0,
                 v_max: float = 10.0):
        _check_shapes("DistNStepTD",
                      dist=(dist, (self.B, self.N, self.n_atom)))
        return dist_nstep_td_error(
            dist_nstep_td_data(dist, next_n_dist, action, next_n_action,
                               reward, done, weight),
            gamma, v_min, v_max, self.n_atom, self.T)

    forward = __call__


class QRDQNNStepTDError:
    def __init__(self, tau: int, T: int, B: int, N: int):
        self.tau, self.T, self.B, self.N = tau, T, B, N

    def __call__(self, q, next_n_q, action, next_n_action, reward, done,
                 tau=None, weight=None, value_gamma=None,
                 gamma: float = 0.99):
        _check_shapes("QRDQNNStepTDError", q=(q, (self.B, self.N, self.tau)))
        if tau is None:
            tau = self.tau
        if value_gamma is None:
            # The reference wrapper's default: a per-sample gamma^T.
            value_gamma = torch.full((self.B,), gamma ** self.T,
                                     dtype=q.dtype, device=q.device)
        return qrdqn_nstep_td_error(
            qrdqn_nstep_td_data(q, next_n_q, action, next_n_action, reward,
                                done, tau, weight),
            gamma, self.T, value_gamma)

    forward = __call__


class IQNNStepTDError:
    def __init__(self, tau: int, tau_prime: int, T: int, B: int, N: int):
        self.tau, self.tau_prime = tau, tau_prime
        self.T, self.B, self.N = T, B, N

    def __call__(self, q, next_n_q, action, next_n_action, reward, done,
                 replay_quantiles, weight=None, value_gamma=None,
                 gamma: float = 0.99, kappa: float = 1.0):
        _check_shapes("IQNNStepTDError", q=(q, (self.tau, self.B, self.N)),
                      next_n_q=(next_n_q, (self.tau_prime, self.B, self.N)))
        if value_gamma is None:
            value_gamma = torch.full((self.B,), gamma ** self.T,
                                     dtype=q.dtype, device=q.device)
        return iqn_nstep_td_error(
            iqn_nstep_td_data(q, next_n_q, action, next_n_action, reward,
                              done, replay_quantiles, weight),
            gamma, self.T, kappa, value_gamma)

    forward = __call__
