"""Distributional DQN (C51) training on synthetic transitions, the port of
the JAX package's examples/c51_training.py, in its configuration (B=128,
obs 32, hidden 64, 8 actions, 51 atoms on [-10, 10], nstep 3, gamma 0.99,
Adam 1e-3, 30 steps, the target net refreshed after every 10th step).

A tanh-MLP Q-network emits a softmax over the atoms per action; a frozen
target network gives the next-state distribution and its greedy action
(without a gradient); `ops.dist_nstep_td_error` projects the n-step target
onto the support and returns the cross-entropy loss and per-sample TD
errors, with unit importance weights.  The op is plain PyTorch in both
packages: no TPU kernel lies on this path.  Each step's batch is drawn from
a torch.Generator seeded as the JAX example seeds its key.

Run: python -m di_hpc_tpu_torch.examples.c51_training [--steps N]
     [--device cpu]
"""

from __future__ import annotations

import argparse
import copy

import torch

from di_hpc_tpu_torch import ops
from di_hpc_tpu_torch.models import QParams

LR = 1e-3
GAMMA = 0.99
SEED = 0


def init_params(generator: torch.Generator, obs_dim: int, hidden: int,
                actions: int, n_atom: int, device="cuda") -> QParams:
    """The JAX example's init scales (normal / sqrt(fan_in) weights, zero
    biases), drawn on the CPU from `generator`."""
    def normal(*shape):
        return torch.randn(shape, generator=generator) / shape[0] ** 0.5

    return QParams(normal(obs_dim, hidden), torch.zeros(hidden),
                   normal(hidden, actions * n_atom),
                   torch.zeros(actions * n_atom)).to(device)


def q_dist(params: QParams, obs: torch.Tensor, actions: int, n_atom: int):
    """obs (B, obs_dim) -> per-action atom distribution (B, N, n_atom)."""
    h = torch.tanh(obs @ params.w1 + params.b1)
    logits = (h @ params.w2 + params.b2).reshape(-1, actions, n_atom)
    return torch.softmax(logits, dim=-1)


def synthetic_batch(generator: torch.Generator, B: int, obs_dim: int,
                    actions: int, nstep: int, device="cuda") -> dict:
    """The JAX example's transitions: normal observations, the next ones
    0.3 noise away, uniform actions, rewards * 0.1, done with probability
    0.05 and unit importance weights, drawn on the CPU from `generator`
    and moved to `device`."""
    obs = torch.randn((B, obs_dim), generator=generator)
    batch = {"obs": obs,
             "next_obs": obs + torch.randn((B, obs_dim),
                                           generator=generator) * 0.3,
             "act": torch.randint(0, actions, (B,), generator=generator),
             "reward": torch.randn((nstep, B), generator=generator) * 0.1,
             "done": torch.rand((B,), generator=generator) > 0.95,
             "weight": torch.ones(B)}
    return {k: v.to(device) for k, v in batch.items()}


def train_step(params: QParams, target_params: QParams, optimizer, batch,
               n_atom: int, nstep: int, v_min: float, v_max: float,
               gamma: float = GAMMA, next_act=None):
    """One step (examples/c51_training.py:59-84): the target distribution
    and its greedy action (or the given next_act) without a gradient, the
    loss, backward and the optimizer step.  Returns the metrics (loss, td;
    detached), the gradients by parameter name, the target's expected
    values (B, N) and the action taken."""
    actions = params.w2.shape[1] // n_atom
    support = torch.linspace(v_min, v_max, n_atom, device=params.w1.device)
    with torch.no_grad():
        next_dist = q_dist(target_params, batch["next_obs"], actions, n_atom)
        next_q = torch.einsum("bna,a->bn", next_dist, support)
    if next_act is None:
        next_act = next_q.argmax(dim=-1)
    optimizer.zero_grad()
    dist = q_dist(params, batch["obs"], actions, n_atom)
    loss, td = ops.dist_nstep_td_error(
        ops.dist_nstep_td_data(dist, next_dist, batch["act"], next_act,
                               batch["reward"], batch["done"],
                               batch["weight"]),
        gamma=gamma, v_min=v_min, v_max=v_max, n_atom=n_atom, nstep=nstep)
    loss.backward()
    grads = {k: v.grad.clone() for k, v in params.named_parameters()}
    optimizer.step()
    return ({"loss": loss.detach(), "td": td.detach()}, grads, next_q,
            next_act)


def main(steps: int = 30, B: int = 128, obs_dim: int = 32, hidden: int = 64,
         actions: int = 8, n_atom: int = 51, nstep: int = 3,
         v_min: float = -10.0, v_max: float = 10.0,
         target_update_every: int = 10, device="cuda") -> QParams:
    gen = torch.Generator().manual_seed(SEED)
    params = init_params(gen, obs_dim, hidden, actions, n_atom, device)
    # A copy: the optimizer updates params in place.
    target_params = copy.deepcopy(params)
    optimizer = torch.optim.Adam(params.parameters(), lr=LR)
    for i in range(steps):
        batch = synthetic_batch(gen, B, obs_dim, actions, nstep, device)
        metrics, *_ = train_step(params, target_params, optimizer, batch,
                                 n_atom, nstep, v_min, v_max)
        if (i + 1) % target_update_every == 0:
            target_params.load_state_dict(params.state_dict())
        if i % 5 == 0 or i == steps - 1:
            print(f"step {i:3d}  loss={float(metrics['loss']):.4f}  "
                  f"mean|td|={float(metrics['td'].abs().mean()):.4f}",
                  flush=True)
    return params


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.steps, device=args.device)
