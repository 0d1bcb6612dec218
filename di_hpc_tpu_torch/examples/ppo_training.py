"""PPO training on synthetic rollouts, the port of the JAX package's
examples/ppo_training.py, in its configuration (10 iterations x 4 epochs,
T=16, B=64, obs 32, hidden 64, 8 actions, Adam 3e-4).

Each iteration rolls the behaviour policy over synthetic observations
(actions by Gumbel-max, as jax.random.categorical draws them), computes the
GAE advantages with `ops.gae` (on the card TPU kernel 7) and the old
policy's log-prob once per batch (`ops.logp`), then runs the epochs of the
fused clipped surrogate `ops.ppo_error_with_logp_old` (value clipping, no
dual clip; total = policy + 0.5 value - 0.01 entropy) with Adam.  Rollouts
are drawn from a torch.Generator seeded as the JAX example seeds its key.

Run: python -m di_hpc_tpu_torch.examples.ppo_training [--steps N]
     [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from di_hpc_tpu_torch import ops
from di_hpc_tpu_torch.models import PPOParams

LR = 3e-4
SEED = 0


def init_params(generator: torch.Generator, obs_dim: int, hidden: int,
                actions: int, device="cuda") -> PPOParams:
    """The JAX example's init scales (normal / sqrt(fan_in) weights, zero
    biases), drawn on the CPU from `generator`."""
    def normal(*shape):
        return torch.randn(shape, generator=generator) / shape[0] ** 0.5

    return PPOParams(normal(obs_dim, hidden), torch.zeros(hidden),
                     normal(hidden, actions), torch.zeros(actions),
                     normal(hidden, 1), torch.zeros(1)).to(device)


def forward(params: PPOParams, obs: torch.Tensor):
    """obs (..., obs_dim) -> (logits (..., A), value (...))."""
    h = torch.tanh(obs @ params.w1 + params.b1)
    logits = h @ params.policy_w + params.policy_b
    return logits, (h @ params.value_w + params.value_b)[..., 0]


def synthetic_rollout(generator: torch.Generator, T: int, B: int,
                      obs_dim: int, actions: int, device="cuda"):
    """Observations (T+1, B, obs_dim), rewards * 0.1 (T, B) and the Gumbel
    noise (T, B, A) that samples the policy's actions, drawn on the CPU
    from `generator` and moved to `device`."""
    obs = torch.randn((T + 1, B, obs_dim), generator=generator)
    reward = torch.randn((T, B), generator=generator) * 0.1
    gumbel = -torch.log(-torch.log(torch.rand((T, B, actions),
                                              generator=generator)))
    return obs.to(device), reward.to(device), gumbel.to(device)


def collect(params: PPOParams, obs, reward, gumbel) -> dict:
    """Roll the policy over the observations (argmax of logits + Gumbel
    noise) and compute the GAE advantages, the returns and the old policy's
    log-prob, once per batch (examples/ppo_training.py:67-82)."""
    T = reward.shape[0]
    with torch.no_grad():
        logits, value = forward(params, obs)
        action = torch.argmax(logits[:T] + gumbel, dim=-1)
        adv = ops.gae(ops.gae_data(value, reward), gamma=0.99, lambda_=0.95)
        return {"obs": obs[:T], "action": action,
                "logp_old": ops.logp(logits[:T], action),
                "value_old": value[:T], "adv": adv,
                "return_": adv + value[:T]}


def loss_fn(params: PPOParams, batch: dict):
    """One epoch's loss on the flat (T*B, ...) batch
    (examples/ppo_training.py:84-98): (total, metrics)."""
    flat = lambda x: x.reshape((-1,) + x.shape[2:])
    logits, value = forward(params, batch["obs"])
    (pol, vl, ent), (kl, frac) = ops.ppo_error_with_logp_old(
        ops.ppo_fast_data(flat(logits), flat(batch["logp_old"]),
                          flat(batch["action"]), flat(value),
                          flat(batch["value_old"]), flat(batch["adv"]),
                          flat(batch["return_"]), None),
        clip_ratio=0.2, use_value_clip=True, dual_clip=None)
    total = pol + 0.5 * vl - 0.01 * ent
    return total, {"total": total, "policy": pol, "value": vl,
                   "entropy": ent, "approx_kl": kl, "clipfrac": frac}


def update(params: PPOParams, optimizer, batch: dict):
    """One epoch: the loss, backward and the optimizer step.  Returns the
    metrics (detached) and the gradients by parameter name."""
    optimizer.zero_grad()
    total, metrics = loss_fn(params, batch)
    total.backward()
    grads = {k: v.grad.clone() for k, v in params.named_parameters()}
    optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}, grads


def iteration(params: PPOParams, optimizer, rollout, epochs: int) -> list:
    """Collect on one rollout (obs, reward, gumbel), then `epochs` updates
    on its batch: each epoch's (metrics, gradients)."""
    batch = collect(params, *rollout)
    return [update(params, optimizer, batch) for _ in range(epochs)]


def main(steps: int = 10, epochs: int = 4, T: int = 16, B: int = 64,
         obs_dim: int = 32, hidden: int = 64, actions: int = 8,
         device="cuda") -> PPOParams:
    gen = torch.Generator().manual_seed(SEED)
    params = init_params(gen, obs_dim, hidden, actions, device)
    optimizer = torch.optim.Adam(params.parameters(), lr=LR)
    for i in range(steps):
        rollout = synthetic_rollout(gen, T, B, obs_dim, actions, device)
        m, _ = iteration(params, optimizer, rollout, epochs)[-1]
        if i % 2 == 0 or i == steps - 1:
            print(f"iter {i:3d}  total={float(m['total']):+.4f}  "
                  f"policy={float(m['policy']):+.4f}  "
                  f"value={float(m['value']):.4f}  "
                  f"kl={float(m['approx_kl']):+.5f}  "
                  f"clipfrac={float(m['clipfrac']):.3f}", flush=True)
    return params


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.steps, device=args.device)
