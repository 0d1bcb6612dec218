"""Batch-parallel and time-sharded execution of the op library over a rank
mesh, the counterpart of the JAX package's parallel/api.py.

Every loss in the library is a weighted mean over batch (and time).  Under
GSPMD the same op on batch-sharded inputs yields the global mean; here
`data_parallel` runs the op on this rank's batch shard and reduces each
scalar output over the axis (a mean in rank order, parallel._comm), which
is the global mean because the shards are equal.  The time-sharded
variants of the recurrence ops run their returns on the distributed scan
(parallel.dscan) and their elementwise terms and means on this rank's
block.  Every function takes the global tensors on every rank and returns
the global result.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from ..ops.scan import gae_denominators
from ..origin.ppo import categorical_entropy, categorical_log_prob
from ..origin.rnn import LSTMParams
from ..origin.vtrace import vtrace_loss
from ..utils.checkpoint import tree_flatten
from ._comm import all_gather, axis_split, reduce, shard, window
from .dscan import global_plane, local_plane, reverse_local
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    TIME_AXIS,
    Mesh,
    NamedSharding,
    shard_batch_pytree,
)

__all__ = ["data_parallel", "lambda_returns_time_sharded",
           "td_lambda_error_time_sharded", "lstm_param_shardings",
           "vtrace_error_time_sharded", "upgo_loss_time_sharded",
           "gae_time_sharded"]


def _first_batch_dim(batch_dims) -> int:
    if isinstance(batch_dims, int):
        return batch_dims if batch_dims != -1 else 0
    return next((d for d in tree_flatten(batch_dims)[0] if d != -1), 0)


def data_parallel(fn: Callable, mesh: Mesh, batch_dims, axis: str = DATA_AXIS):
    """Wrap an op so its first (pytree) argument is batch-sharded over `axis`
    before the call.  `batch_dims` mirrors the data pytree (see
    shard_batch_pytree); scalar outputs come back as global means.

        # batch_dims mirrors the data pytree -- None entries (e.g. an absent
        # weight) must be None in both:
        dp_vtrace = data_parallel(ops.vtrace_error, mesh,
                                  vtrace_data(1, 1, 1, 1, 1, None))
        losses = dp_vtrace(vtrace_data(..., weight=None), gamma=0.99)

    A per-sample output (the (B,) TD error of `ops.q_nstep_td_error`) is
    gathered along its batch dimension: dim 0 of a 1-D output, else the
    batch dim of the data's first sharded leaf.  Gradients reach the global
    inputs on every rank.  Raises ValueError for a batch that does not tile
    the axis.
    """
    out_dim = _first_batch_dim(batch_dims)

    def combine(out):
        if not isinstance(out, torch.Tensor):
            return out
        if out.ndim == 0:
            return reduce(out, mesh, axis)
        return all_gather(out, mesh, axis, out_dim if out.ndim > 1 else 0)

    @functools.wraps(fn)
    def wrapped(data, *args, **kwargs):
        local = shard_batch_pytree(mesh, data, batch_dims, axis)
        leaves, rebuild = tree_flatten(fn(local, *args, **kwargs))
        return rebuild([combine(leaf) for leaf in leaves])

    return wrapped


def _is_last(mesh: Mesh, axis: str) -> bool:
    return mesh.axis_index(axis) == mesh.axis_size(axis) - 1


def _rows(x, T, mesh, time_axis, batch_axis, extra):
    """This rank's chunk of T rows of a global tensor, plus the `extra`
    rows past it that its boundary reads (fewer past the tensor's end),
    batch-sharded; gradients reach the global tensor."""
    if batch_axis:
        x = shard(x, mesh, batch_axis, 1)
    _, size = axis_split(T, mesh, time_axis, "T")
    return window(x, mesh, time_axis, size, extra)


def _global_mean(x, mesh, time_axis, batch_axis):
    x = reduce(x, mesh, time_axis)
    return reduce(x, mesh, batch_axis) if batch_axis else x


def _local_weight(weight, reward, mesh, time_axis, batch_axis):
    """This rank's block of `weight` broadcast to reward's (T, B) plane;
    ones without a weight."""
    if weight is None:
        weight = torch.ones((), dtype=reward.dtype, device=reward.device)
    weight = torch.broadcast_to(torch.as_tensor(weight), reward.shape)
    return local_plane(weight, mesh, time_axis, batch_axis)


def _lambda_returns_local(value, reward, mesh, gamma, lambda_, time_axis,
                          batch_axis):
    T = reward.shape[0]
    v = _rows(value, T, mesh, time_axis, batch_axis, 1)
    r = _rows(reward, T, mesh, time_axis, batch_axis, 0)
    d = gamma * lambda_
    g_eff = torch.full((r.shape[0],) + (1,) * (r.ndim - 1), gamma - d,
                       dtype=r.dtype, device=r.device)
    b = torch.full_like(r, d)
    if _is_last(mesh, time_axis):
        g_eff[-1] = gamma
        b[-1] = 0.0
    return reverse_local(r + g_eff * v[1:], b, mesh, time_axis)


def lambda_returns_time_sharded(
    value: torch.Tensor,    # (T+1, B)
    reward: torch.Tensor,   # (T, B)
    mesh: Mesh,
    gamma: float,
    lambda_: float,
    time_axis: str = TIME_AXIS,
    batch_axis: str | None = None,
) -> torch.Tensor:
    """Sequence-parallel generalized lambda-returns (scalar gamma/lambda):
    result[t] = [r_t + (g-d)V_{t+1}] + d*result[t+1], d = g*l, with the T-1
    element cut off -- runs blockwise over the time-sharded mesh axis.
    Gradients reach value and reward, as through JAX's."""
    ret = _lambda_returns_local(value, reward, mesh, gamma, lambda_,
                                time_axis, batch_axis)
    return global_plane(ret, mesh, time_axis, batch_axis)


def td_lambda_error_time_sharded(
    value: torch.Tensor,    # (T+1, B)
    reward: torch.Tensor,   # (T, B)
    weight,
    mesh: Mesh,
    gamma: float = 0.9,
    lambda_: float = 0.8,
    time_axis: str = TIME_AXIS,
    batch_axis: str | None = None,
) -> torch.Tensor:
    """TD(lambda) loss with the return recurrence computed sequence-parallel;
    the final mean is a global reduction over the mesh axes.  The return
    carries no gradient, as JAX's stops it."""
    return_ = _lambda_returns_local(value.detach(), reward.detach(), mesh,
                                    gamma, lambda_, time_axis, batch_axis)
    v_head = local_plane(value[:-1], mesh, time_axis, batch_axis)
    w = _local_weight(weight, reward, mesh, time_axis, batch_axis)
    loss = 0.5 * torch.mean((return_ - v_head) ** 2 * w)
    return _global_mean(loss, mesh, time_axis, batch_axis)


def lstm_param_shardings(mesh: Mesh, num_layers: int,
                         model_axis: str = MODEL_AXIS):
    """Tensor-parallel placements for LSTMParams: the 4H gate dimension is
    sharded over `model_axis` (each rank holds a slice of every gate), as
    the JAX package's P(None, model_axis) specs place it.  Each leaf is a
    NamedSharding whose `placements` are the `torch.distributed.tensor`
    placements for `distribute_tensor`."""

    def ns(*spec):
        return NamedSharding(mesh, spec)

    return LSTMParams(
        wx=tuple(ns(None, model_axis) for _ in range(num_layers)),
        wh=tuple(ns(None, model_axis) for _ in range(num_layers)),
        bias=ns(None, model_axis),
        ln_gamma_x=ns(None, model_axis), ln_beta_x=ns(None, model_axis),
        ln_gamma_h=ns(None, model_axis), ln_beta_h=ns(None, model_axis),
    )


def vtrace_error_time_sharded(
    data,                       # ops.vtrace_data of global tensors
    mesh: Mesh,
    gamma: float = 0.99,
    lambda_: float = 0.95,
    rho_clip_ratio: float = 1.0,
    c_clip_ratio: float = 1.0,
    rho_pg_clip_ratio: float = 1.0,
    time_axis: str = TIME_AXIS,
    batch_axis: str | None = None,
):
    """Sequence-parallel V-trace: the categorical heads and elementwise
    terms run on this rank's block; the return recurrence runs blockwise on
    the distributed scan; the shifted return_{t+1} at the chunk's last row
    is the next chunk's first return (one all-gather of the chunks' first
    rows), V_T after the last chunk.  Gradients reach the global target
    logits, value[:-1] (the value loss) and reward on every rank, as
    through JAX's; the returns' value is detached, as JAX stops it."""
    target_output, behaviour_output, action, value, reward, weight = data
    T = reward.shape[0]
    local = functools.partial(local_plane, mesh=mesh, time_axis=time_axis,
                              batch_axis=batch_axis)
    to, act = local(target_output), local(action)
    logp_target = categorical_log_prob(to, act)
    logp_behaviour = categorical_log_prob(
        local(behaviour_output.detach()), act)
    IS = torch.exp(logp_target - logp_behaviour).detach()
    rhos = torch.clamp(IS, max=rho_clip_ratio)
    cs = torch.clamp(IS, max=c_clip_ratio)
    pg_rhos = torch.clamp(IS, max=rho_pg_clip_ratio)

    v = _rows(value.detach(), T, mesh, time_axis, batch_axis, 1)  # (C+1, ..)
    r = _rows(reward, T, mesh, time_axis, batch_axis, 0)
    deltas = rhos * (r + gamma * v[1:] - v[:-1])
    items = reverse_local(deltas, gamma * lambda_ * cs, mesh, time_axis)
    return_ = v[:-1] + items
    # The next chunk's first return, V_T after the last chunk.  Every rank
    # takes the same autograd graph: a collective in a backward that some
    # ranks skip would stall the others.
    firsts = all_gather(return_[:1], mesh, time_axis, 0, each_own=True)
    v_T = value.detach()[T:]
    if batch_axis:
        v_T = shard(v_T, mesh, batch_axis, 1)
    k = mesh.axis_index(time_axis)
    after = torch.cat([firsts[1:], v_T])[k:k + 1]
    return_tp1 = torch.cat([return_[1:], after])
    adv = pg_rhos * (r + gamma * return_tp1 - v[:-1])

    w = _local_weight(weight, reward, mesh, time_axis, batch_axis)
    v_head = local(value[:-1])
    mean = functools.partial(_global_mean, mesh=mesh, time_axis=time_axis,
                             batch_axis=batch_axis)
    pg_loss = mean(-torch.mean(logp_target * adv * w))
    value_loss = mean(torch.mean((v_head - return_) ** 2 * w))
    entropy_loss = mean(torch.mean(categorical_entropy(to) * w))
    return vtrace_loss(pg_loss, value_loss, entropy_loss)


def upgo_loss_time_sharded(
    target_output, rhos, action, rewards, bootstrap_values,
    mesh: Mesh,
    time_axis: str = TIME_AXIS,
    batch_axis: str | None = None,
):
    """Sequence-parallel UPGO: the binary-lambda return recurrence runs on
    the distributed scan; the cross-entropy head runs on this rank's block.
    The shifted lambdas read one row past the chunk from the global
    rewards and values, both detached, as JAX stops their gradients."""
    T = rewards.shape[0]
    r_ext = _rows(rewards.detach(), T, mesh, time_axis, batch_axis, 1)
    v_ext = _rows(bootstrap_values.detach(), T, mesh, time_axis, batch_axis,
                  2)
    n = r_ext.shape[0]
    lambdas = ((r_ext + v_ext[1:n + 1]) >= v_ext[:n]).to(r_ext.dtype)
    last = _is_last(mesh, time_axis)
    if last:
        lambdas = torch.cat([lambdas, torch.ones_like(lambdas[-1:])])
    # generalized lambda returns with gamma = 1 as a linear recurrence
    d = lambdas[1:].clone()
    if last:
        d[-1] = 0.0
    C = d.shape[0]
    r, v = r_ext[:C], v_ext[:C + 1]
    returns = reverse_local(r + (1.0 - d) * v[1:], d, mesh, time_axis)
    local = functools.partial(local_plane, mesh=mesh, time_axis=time_axis,
                              batch_axis=batch_axis)
    advantages = local(rhos.detach()) * (returns - v[:-1])
    metric = categorical_log_prob(local(target_output), local(action))
    return _global_mean(-torch.mean(advantages * metric), mesh, time_axis,
                        batch_axis)


def gae_time_sharded(
    value: torch.Tensor,    # (T+1, B)
    reward: torch.Tensor,   # (T, B)
    mesh: Mesh,
    gamma: float = 0.99,
    lambda_: float = 0.97,
    time_axis: str = TIME_AXIS,
    batch_axis: str | None = None,
) -> torch.Tensor:
    """Sequence-parallel GAE: the recurrence runs blockwise over a
    time-sharded mesh axis (parallel.dscan) with one tiny boundary
    all-gather.  `value` has T+1 rows, which do not tile the time axis:
    each rank reads its chunk's rows and one more.  The result carries no
    gradient, as JAX's stops it."""
    T = reward.shape[0]
    v = _rows(value.detach(), T, mesh, time_axis, batch_axis, 1)
    r = _rows(reward.detach(), T, mesh, time_axis, batch_axis, 0)
    delta = r + gamma * v[1:] - v[:-1]
    start, size = axis_split(T, mesh, time_axis, "T")
    denom = gae_denominators(T, lambda_, dtype=delta.dtype,
                             device=delta.device)[start:start + size]
    denom_b = denom.reshape((size,) + (1,) * (delta.ndim - 1))
    items = reverse_local(denom_b * delta,
                          torch.full_like(delta, gamma * lambda_), mesh,
                          time_axis)
    return global_plane(items / denom_b, mesh, time_axis, batch_axis)
