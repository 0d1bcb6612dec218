"""Entry point of the port, the counterpart of the JAX package's
__graft_entry__.py:entry: the flagship model's forward and its example
arguments at the JAX entry's tiny setup (T=16, B=32, obs 64, hidden 128, 2
layers, 32 actions).  Parameters and the batch come from a seeded
torch.Generator on the CPU and are moved to `device`.
"""

from __future__ import annotations

import torch

from .models import (
    ActorCriticConfig, TrainBatch, actor_critic_forward, init_actor_critic,
)

__all__ = ["entry"]


def _tiny_setup(T=8, B=16, obs_dim=32, hidden=64, layers=2, actions=16,
                device="cuda", seed=0):
    """(cfg, params, TrainBatch) with random weights and batch."""
    cfg = ActorCriticConfig(obs_dim, hidden, layers, actions)
    gen = torch.Generator().manual_seed(seed)
    params = init_actor_critic(cfg, gen, device)
    batch = TrainBatch(
        obs=torch.randn((T + 1, B, obs_dim), generator=gen).to(device),
        actions=torch.randint(0, actions, (T, B), generator=gen).to(device),
        rewards=torch.randn((T, B), generator=gen).to(device),
        behaviour_logits=torch.randn((T, B, actions),
                                     generator=gen).to(device),
    )
    return cfg, params, batch


def entry(device="cuda"):
    """(fn, example_args): the flagship forward `fn(params, obs) -> (logits,
    value)` and (params, obs (17, 32, 64)) on `device`."""
    cfg, params, batch = _tiny_setup(T=16, B=32, obs_dim=64, hidden=128,
                                     layers=2, actions=32, device=device)

    def forward(params, obs):
        logits, value, state = actor_critic_forward(params, obs, None,
                                                    cfg.norm_type)
        return logits, value

    return forward, (params, batch.obs)
