"""Flagship model: LN-LSTM actor-critic, the counterpart of the JAX
package's models/actor_critic_lstm.py -- its forward and serving paths.

`actor_critic_forward` runs the embedding GEMM and relu, the fused LN-LSTM
(whole-layer kernel per layer), and the policy and value heads.
`actor_step` is the serving step: one timestep of that forward and a
categorical sample.  The training step (`make_train_step`, with its
backward kernels and Adam) is the next slice of the port (ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..network.lstm import LSTMWeights, lstm_fused
from ..origin.rnn import LSTMParams, init_lstm_params

__all__ = [
    "ActorCriticConfig", "ActorCriticParams", "TrainBatch",
    "init_actor_critic", "actor_critic_forward", "actor_step",
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
    (L, B, H)).  Runs where `params` and `obs` lie; on the card the LSTM
    kernels are forward-only, so call it under torch.no_grad()."""
    x = torch.relu(torch.matmul(obs, params.embed_w) + params.embed_b)
    y, next_state = lstm_fused(params.lstm.params(), x, state, norm_type)
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
    params' device.  Runs under torch.no_grad().

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
        probs = torch.softmax(logits[0], dim=-1)
        action = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return action, logits[0], value[0], new_state
