"""Episodic A2C with TD(lambda) and ragged-batch bucketing, the port of the
JAX package's examples/episodic_a2c_padding.py, in its configuration (48
episodes of length 8-64, obs 16, hidden 64, 6 actions, group 3, gamma 0.99,
lambda 0.95, Adam 1e-3).

Episodes of random length are sorted by size and split into at most
`group` buckets by the exact min-padded-cost DP (`ops.oracle_split_group`,
the C host core); each bucket is padded dense (T rounded up to a multiple
of 8, B to one of 4) and moved to the device once per field.  Per bucket:
a TD(lambda) value loss through `ops.td_lambda_error` with the padding mask
as its (T, B) weight (on the card the lambda-returns kernel, TPU kernel 8),
and a policy gradient on lambda-return advantages from
`ops.generalized_lambda_returns` without a gradient (on the card the linear
recurrence kernel, TPU kernel 6).  The bucket gradients are combined
weighted by the bucket's share of the episodes, then one Adam step.

Run: python -m di_hpc_tpu_torch.examples.episodic_a2c_padding [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from torch import nn

from di_hpc_tpu_torch import ops


class Params(nn.Module):
    """The example's parameters, with the JAX example's field names."""

    def __init__(self, w1, b1, w_pi, w_v):
        super().__init__()
        self.w1 = nn.Parameter(w1)          # (obs_dim, hidden)
        self.b1 = nn.Parameter(b1)          # (hidden,)
        self.w_pi = nn.Parameter(w_pi)      # (hidden, actions)
        self.w_v = nn.Parameter(w_v)        # (hidden,)


def init_params(generator: torch.Generator, obs_dim, hidden, actions,
                device="cuda") -> Params:
    """The JAX example's init scales, drawn on the CPU from `generator`."""
    def normal(*shape):
        return torch.randn(shape, generator=generator) / shape[0] ** 0.5

    return Params(normal(obs_dim, hidden), torch.zeros(hidden),
                  normal(hidden, actions), normal(hidden)).to(device)


def make_episodes(rng, n_eps, obs_dim, actions, l_min, l_max):
    """Variable-length synthetic episodes: (obs (L+1, D), act (L,), rew (L,))."""
    eps = []
    for _ in range(n_eps):
        L = int(rng.integers(l_min, l_max))
        eps.append((
            rng.standard_normal((L + 1, obs_dim)).astype(np.float32),
            rng.integers(0, actions, size=(L,)).astype(np.int32),
            rng.standard_normal((L,)).astype(np.float32) * 0.1,
        ))
    return eps


def pad_bucket(bucket, T, B, device="cuda"):
    """Stack one bucket's episodes to (T[+1], B, ...) dense + (T, B) mask on
    `device`.  T and B come rounded up (multiples of 8 and 4), so a consumer
    that keeps work per shape sees few shapes; all-zero mask columns
    contribute nothing."""
    obs = np.zeros((T + 1, B, bucket[0][0].shape[-1]), np.float32)
    act = np.zeros((T, B), np.int32)
    rew = np.zeros((T, B), np.float32)
    mask = np.zeros((T, B), np.float32)
    for b, (o, a, r) in enumerate(bucket):
        L = len(r)
        obs[:L + 1, b] = o
        act[:L, b] = a
        rew[:L, b] = r
        mask[:L, b] = 1.0
    return [torch.from_numpy(x).to(device) for x in (obs, act, rew, mask)]


def bucket_loss(p: Params, obs, act, rew, mask, gamma, lambda_):
    """The loss of one padded bucket."""
    h = torch.tanh(obs @ p.w1 + p.b1)                # (T+1, B, hidden)
    value = h @ p.w_v                                # (T+1, B)
    logits = h[:-1] @ p.w_pi                         # (T, B, A)
    # Zero the value at the terminal step and the padded tail: the
    # lambda-return recursion runs over the full padded length, so an
    # unmasked V on padded (all-zero) observations would leak into the
    # return targets of real steps near each episode's end; and these
    # episodes terminate, so V(terminal) = 0 is the right bootstrap.
    value = value * torch.cat([mask, torch.zeros_like(mask[:1])])
    # Mask-weighted TD(lambda): padded steps contribute no loss.
    v_loss = ops.td_lambda_error(ops.td_lambda_data(value, rew, mask),
                                 gamma, lambda_)
    with torch.no_grad():
        returns = ops.generalized_lambda_returns(value, rew, gamma, lambda_)
    adv = returns - value[:-1].detach()
    lp, ent = ops.logp_entropy(logits, act)
    denom = torch.clamp_min(torch.sum(mask), 1.0)
    pg = -torch.sum(lp * adv * mask) / denom
    ent_loss = torch.sum(ent * mask) / denom
    return pg + 0.5 * v_loss - 0.01 * ent_loss


def train_step(p: Params, optimizer, episodes, group, gamma, lambda_,
               device="cuda"):
    """One step: bucket the episodes (oracle DP on length), a loss and
    gradient per bucket, the gradients combined weighted by each bucket's
    share of the episodes, one optimizer step.  Returns (the weighted loss,
    the combined gradients by parameter name, the buckets' (T, count))."""
    episodes = sorted(episodes, key=lambda e: len(e[2]))
    lengths = [np.zeros((len(e[2]),), np.float32) for e in episodes]
    group_shape, group_idx = ops.oracle_split_group(lengths, group)

    names = [name for name, _ in p.named_parameters()]
    grads_acc = [torch.zeros_like(q) for q in p.parameters()]
    losses = []
    for g in range(len(group_shape)):
        bucket = episodes[group_idx[g]:group_idx[g + 1]]
        T = -(-group_shape[g][0] // 8) * 8
        Bq = -(-len(bucket) // 4) * 4
        obs, act, rew, mask = pad_bucket(bucket, T, Bq, device)
        loss = bucket_loss(p, obs, act, rew, mask, gamma, lambda_)
        grads = torch.autograd.grad(loss, list(p.parameters()))
        w = len(bucket) / len(episodes)
        grads_acc = [a + w * b for a, b in zip(grads_acc, grads)]
        losses.append((loss.detach(), w))
    for q, grad in zip(p.parameters(), grads_acc):
        q.grad = grad
    optimizer.step()
    total = sum(float(loss) * w for loss, w in losses)
    sizes = [(group_shape[g][0], group_idx[g + 1] - group_idx[g])
             for g in range(len(group_shape))]
    return total, dict(zip(names, grads_acc)), sizes


def main(steps: int = 10, n_eps: int = 48, obs_dim: int = 16, hidden: int = 64,
         actions: int = 6, l_min: int = 8, l_max: int = 64, group: int = 3,
         gamma: float = 0.99, lambda_: float = 0.95, seed: int = 0,
         device="cuda"):
    rng = np.random.default_rng(seed)
    params = init_params(torch.Generator().manual_seed(seed), obs_dim,
                         hidden, actions, device)
    optimizer = torch.optim.Adam(params.parameters(), lr=1e-3)
    for i in range(steps):
        episodes = make_episodes(rng, n_eps, obs_dim, actions, l_min, l_max)
        total, _, sizes = train_step(params, optimizer, episodes, group,
                                     gamma, lambda_, device)
        if i % 2 == 0 or i == steps - 1:
            print(f"step {i:3d}  loss={total:+.4f}  buckets(TxB)="
                  f"{[f'{t}x{b}' for t, b in sizes]}", flush=True)
    return params


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(steps=args.steps, device=args.device)
