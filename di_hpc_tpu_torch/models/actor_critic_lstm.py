"""Flagship model: LN-LSTM actor-critic with a V-trace training step, the
counterpart of the JAX package's models/actor_critic_lstm.py.

`actor_critic_forward` runs the embedding GEMM and relu, the fused LN-LSTM
(whole-layer kernel per layer), and the policy and value heads.
`actor_step` is the serving step: one timestep of that forward and a
categorical sample.  `make_train_step` builds the learner's step: that
forward, `ops.vtrace_error`, the backward (the LSTM's hand-derived
backward kernels, the V-trace loss kernel's recompute backward) and the
optimizer's update; with `compute_dtype=torch.bfloat16` the forward runs in
bf16 (the LSTM kernels' bf16 streams) while the master parameters, the
V-trace loss and the optimizer stay float32.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..network.lstm import LSTMWeights, lstm_fused
from ..ops.vtrace import vtrace_data, vtrace_error
from ..origin.rnn import LSTMParams, init_lstm_params

__all__ = [
    "ActorCriticConfig", "ActorCriticParams", "TrainBatch",
    "init_actor_critic", "actor_critic_forward", "actor_step",
    "make_train_step",
]


class ActorCriticConfig(NamedTuple):
    obs_dim: int
    hidden_size: int
    num_layers: int
    action_dim: int
    norm_type: Optional[str] = "LN"


class ActorCriticParams(nn.Module):
    """The model's parameters, with the field names of the JAX package's
    ActorCriticParams: embed_w (obs_dim, H), embed_b (H,), lstm, policy_w
    (H, A), policy_b (A,), value_w (H, 1), value_b (1,)."""

    def __init__(self, embed_w, embed_b, lstm: LSTMParams, policy_w,
                 policy_b, value_w, value_b):
        super().__init__()
        self.embed_w = nn.Parameter(embed_w)
        self.embed_b = nn.Parameter(embed_b)
        self.lstm = LSTMWeights(lstm)
        self.policy_w = nn.Parameter(policy_w)
        self.policy_b = nn.Parameter(policy_b)
        self.value_w = nn.Parameter(value_w)
        self.value_b = nn.Parameter(value_b)


class TrainBatch(NamedTuple):
    obs: torch.Tensor               # (T+1, B, obs_dim)
    actions: torch.Tensor           # (T, B) integer
    rewards: torch.Tensor           # (T, B)
    behaviour_logits: torch.Tensor  # (T, B, A)


def init_actor_critic(cfg: ActorCriticConfig, generator: torch.Generator,
                      device="cuda") -> ActorCriticParams:
    """Random init with the JAX package's scales.  The numbers are drawn on
    the CPU from `generator` (a CPU generator) and then moved to `device`."""
    H = cfg.hidden_size

    def normal(*shape):
        return torch.randn(shape, generator=generator)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    embed_w = normal(cfg.obs_dim, H) / cfg.obs_dim ** 0.5
    lstm = init_lstm_params(generator, H, H, cfg.num_layers, cfg.norm_type,
                            device=device)
    policy_w = normal(H, cfg.action_dim) / H ** 0.5
    value_w = normal(H, 1) / H ** 0.5
    return ActorCriticParams(
        embed_w.to(device), zeros(H), lstm, policy_w.to(device),
        zeros(cfg.action_dim), value_w.to(device), zeros(1))


def actor_critic_forward(
    params: ActorCriticParams,
    obs: torch.Tensor,                          # (S, B, obs_dim)
    state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    norm_type: Optional[str] = "LN",
):
    """Returns (logits (S, B, A), value (S, B), next_state (h, c), each
    (L, B, H)).  Runs where `params` and `obs` lie, in their dtype (float32,
    or bf16 with bf16 streams in the LSTM kernels); differentiable in the
    parameters on either device.  `params.lstm` is an LSTMWeights module or
    an LSTMParams tuple.  Under torch.no_grad() the LSTM layers skip the
    cell-state stash the backward reads."""
    lstm = params.lstm
    if not isinstance(lstm, LSTMParams):
        lstm = lstm.params()
    x = torch.relu(torch.matmul(obs, params.embed_w) + params.embed_b)
    y, next_state = lstm_fused(lstm, x, state, norm_type)
    logits = torch.matmul(y, params.policy_w) + params.policy_b
    value = torch.matmul(y, params.value_w[:, 0]) + params.value_b[0]
    return logits, value, next_state


def actor_step(
    params: ActorCriticParams,
    obs: torch.Tensor,                          # (B, obs_dim) one timestep
    state: Tuple[torch.Tensor, torch.Tensor],   # (h, c), each (L, B, H)
    generator: torch.Generator,
    norm_type: Optional[str] = "LN",
):
    """Serving-path actor step: one policy forward (the LSTM kernel at S=1)
    and a categorical sample drawn with `generator`, which lives on the
    params' device.  Runs under torch.no_grad(), in the params' dtype; the
    sample is drawn from the float32 softmax of the logits, which come back
    in that dtype.

    The state is NOT updated in place: the caller's (h, c) tensors are left
    as they were and the new state comes back as new tensors.  (The JAX
    version donates the state buffers so XLA can write the new state over
    them; here PyTorch's caching allocator recycles the old state's memory
    once the caller drops it, so the steady state makes no new device
    allocations either.)  Returns (action (B,), behaviour_logits (B, A),
    value (B,), new_state)."""
    with torch.no_grad():
        logits, value, new_state = actor_critic_forward(
            params, obs[None], state, norm_type)
        probs = torch.softmax(logits[0].float(), dim=-1)
        action = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return action, logits[0], value[0], new_state


def _cast_params(params: ActorCriticParams, dtype) -> SimpleNamespace:
    """The parameters cast to `dtype` (differentiable casts), with the
    attributes actor_critic_forward reads; `lstm` an LSTMParams tuple."""
    def cast(t):
        return None if t is None else t.to(dtype)

    lstm = LSTMParams(*(tuple(map(cast, f)) if isinstance(f, tuple)
                        else cast(f) for f in params.lstm.params()))
    return SimpleNamespace(
        lstm=lstm, **{name: cast(getattr(params, name)) for name in (
            "embed_w", "embed_b", "policy_w", "policy_b", "value_w",
            "value_b")})


def make_train_step(
    cfg: ActorCriticConfig,
    optimizer: torch.optim.Optimizer,
    gamma: float = 0.99,
    lambda_: float = 0.95,
    value_coef: float = 0.5,
    entropy_coef: float = 0.01,
    compute_dtype=None,
):
    """Builds the V-trace training step `train_step(params, batch) ->
    metrics`, the counterpart of the JAX package's make_train_step.

    `optimizer` holds `params.parameters()`; `torch.optim.Adam(...,
    lr=1e-3)` with its defaults (betas 0.9, 0.999, eps 1e-8, bias
    correction) computes what `optax.adam(1e-3)` computes.  The loss is the
    JAX package's: the forward over `batch.obs` (T+1 steps), then
    `vtrace_error` on the first T logits, and total = policy_loss +
    value_coef * value_loss - entropy_coef * entropy.

    The step updates `params` and the optimizer's state in place, which
    stands in for the JAX step's donated buffers: no second copy of the
    parameters is made.  It returns the JAX step's metrics, as 0-d float32
    tensors on the params' device: total_loss, policy_loss, value_loss,
    entropy.

    `compute_dtype=torch.bfloat16` is the mixed-precision step of the JAX
    package (its actor_critic_lstm.py:121-151): inside the loss every float
    parameter and `batch.obs` are cast to bf16, so the forward runs in bf16
    (the embedding and head GEMMs and the LSTM kernels' bf16 streams) and
    the gradients reach the float32 parameters through the casts; the
    logits and values go to the float32 V-trace loss as float32, and the
    parameters and Adam stay float32."""

    def loss_fn(params: ActorCriticParams, batch: TrainBatch):
        obs = batch.obs
        if compute_dtype is not None:
            params = _cast_params(params, compute_dtype)
            obs = obs.to(compute_dtype)
        logits, value, _ = actor_critic_forward(params, obs, None,
                                                cfg.norm_type)
        T = batch.actions.shape[0]
        losses = vtrace_error(
            vtrace_data(logits[:T].float(), batch.behaviour_logits.float(),
                        batch.actions, value.float(), batch.rewards.float(),
                        None),
            gamma, lambda_)
        total = (losses.policy_loss + value_coef * losses.value_loss
                 - entropy_coef * losses.entropy_loss)
        return total, losses

    def train_step(params: ActorCriticParams, batch: TrainBatch) -> dict:
        optimizer.zero_grad(set_to_none=True)
        total, losses = loss_fn(params, batch)
        total.backward()
        optimizer.step()
        return {"total_loss": total.detach(),
                "policy_loss": losses.policy_loss.detach(),
                "value_loss": losses.value_loss.detach(),
                "entropy": losses.entropy_loss.detach()}

    return train_step
