"""R2D2-style recurrent DQN training on synthetic replay samples, the port
of the JAX package's examples/r2d2_training.py, in its configuration
(sequences of S=20 with a burn-in of 4, B=32, obs 16, a 128-wide LN-LSTM
of 1 layer, 8 actions, nstep 3, gamma 0.99, Adam 1e-3, 30 steps, the
target net refreshed before every 10th step).

A recurrent Q-network (`network.lstm_fused`: on the card TPU kernel 1
forward, kernel 5 backward at B < 64) with stored-state replay: both nets
burn in from the sequence's stored LSTM state without a gradient, the
target net and the online net (for double-DQN's argmax) run over the rest
of the sequence, and the loss is the n-step TD with R2D2's value rescaling
(`ops.q_nstep_td_error_with_rescale`) over each step of the learning
window (W = S - burn_in - nstep), rewards past a window's first terminal
masked.  Priorities mix the max and mean of |td| over the window.  Replay
samples are drawn from a torch.Generator seeded as the JAX example seeds
its key.

Run: python -m di_hpc_tpu_torch.examples.r2d2_training [--steps N]
     [--device cpu]
"""

from __future__ import annotations

import argparse
import copy

import torch

from di_hpc_tpu_torch import network, ops
from di_hpc_tpu_torch.models import R2D2Params

LR = 1e-3
SEED = 0


def init_params(generator: torch.Generator, obs_dim: int, hidden: int,
                actions: int, num_layers: int = 1,
                device="cuda") -> R2D2Params:
    """The JAX example's init scales (normal / sqrt(fan_in) embedding and Q
    head, zero biases, a uniform LN-LSTM with LN at identity), drawn on the
    CPU from `generator`."""
    def normal(*shape):
        return (torch.randn(shape, generator=generator)
                / shape[0] ** 0.5).to(device)

    embed_w = normal(obs_dim, hidden)
    lstm = network.LSTMWeights(network.init_lstm_params(
        generator, hidden, hidden, num_layers, "LN", device=device))
    return R2D2Params(embed_w, torch.zeros(hidden, device=device), lstm,
                      normal(hidden, actions),
                      torch.zeros(actions, device=device))


def synthetic_batch(generator: torch.Generator, S, B, obs_dim, hidden,
                    actions, num_layers=1, device="cuda") -> dict:
    """The JAX example's replay sample (:68-78): obs (S+1, B, obs_dim),
    actions, rewards * 0.1 and dones with probability 0.03 (S, B), the
    stored LSTM state (each (L, B, H), * 0.1) and unit importance weights;
    drawn on the CPU from `generator` and moved to `device`."""
    def normal(*shape):
        return torch.randn(shape, generator=generator)

    batch = {"obs": normal(S + 1, B, obs_dim),
             "act": torch.randint(0, actions, (S, B), generator=generator),
             "reward": normal(S, B) * 0.1,
             "done": torch.rand((S, B), generator=generator) > 0.97,
             "stored_h": normal(num_layers, B, hidden) * 0.1,
             "stored_c": normal(num_layers, B, hidden) * 0.1,
             "weight": torch.ones(B)}
    return {k: v.to(device) for k, v in batch.items()}


def q_values(params: R2D2Params, obs, state):
    """obs (S, B, obs_dim), state ((L, B, H), (L, B, H)) -> (q (S, B, A),
    state)."""
    x = torch.tanh(obs @ params.embed_w + params.embed_b)
    y, next_state = network.lstm_fused(params.lstm.params(), x, state, "LN")
    return y @ params.q_w + params.q_b, next_state


def targets(params: R2D2Params, target_params: R2D2Params, batch: dict,
            burn_in: int):
    """Without gradient (:80-91): both nets burn in from the stored state,
    then run over the rest of the sequence.  Returns the online net's
    burnt-in state, the target net's q and the online net's q over
    obs[burn_in:]."""
    with torch.no_grad():
        obs = batch["obs"]
        stored = (batch["stored_h"], batch["stored_c"])
        _, bi_state = q_values(params, obs[:burn_in], stored)
        _, bi_state_t = q_values(target_params, obs[:burn_in], stored)
        q_tgt, _ = q_values(target_params, obs[burn_in:], bi_state_t)
        q_sel, _ = q_values(params, obs[burn_in:], bi_state)
    return bi_state, q_tgt, q_sel


def r2d2_loss(params: R2D2Params, batch: dict, bi_state, q_tgt, next_act,
              burn_in: int, nstep: int, gamma: float):
    """The example's loss_fn (:93-121): q over the W = S - burn_in - nstep
    learning steps, the (W, nstep, B) reward windows masked past the first
    terminal, and ops.q_nstep_td_error_with_rescale for each window (a loop
    over W for the example's vmap).  Returns (mean loss, td (W, B))."""
    reward, done, act = batch["reward"], batch["done"], batch["act"]
    W = act.shape[0] - burn_in - nstep
    q, _ = q_values(params, batch["obs"][burn_in:burn_in + W], bi_state)
    r_wins = torch.stack([reward[burn_in + t:burn_in + t + nstep]
                          for t in range(W)])                  # (W, nstep, B)
    d_raw = torch.stack([done[burn_in + t:burn_in + t + nstep]
                         for t in range(W)])
    d_wins = d_raw.any(dim=1)                                  # (W, B)
    # Rewards past a window's first terminal belong to the next episode.
    alive = torch.cumprod(1.0 - d_raw.to(r_wins.dtype), dim=1)
    alive = torch.cat([torch.ones_like(alive[:, :1]), alive[:, :-1]], dim=1)
    r_wins = r_wins * alive
    losses, td = zip(*(ops.q_nstep_td_error_with_rescale(
        ops.q_nstep_td_data(q[t], q_tgt[nstep + t], act[burn_in + t],
                            next_act[nstep + t], r_wins[t], d_wins[t],
                            batch["weight"]), gamma=gamma, nstep=nstep)
        for t in range(W)))
    return torch.stack(losses).mean(), torch.stack(td)


def train_step(params: R2D2Params, target_params: R2D2Params, optimizer,
               batch: dict, burn_in: int, nstep: int, gamma: float,
               next_act=None):
    """One train step (:80-128): the targets, double-DQN's argmax (or the
    given next_act), the loss, backward, the optimizer step, and the
    priorities 0.9 * max + 0.1 * mean of |td| over the window.  Returns the
    metrics (loss, priorities; detached), the gradients by parameter name,
    the online q over obs[burn_in:] and the argmax taken."""
    bi_state, q_tgt, q_sel = targets(params, target_params, batch, burn_in)
    if next_act is None:
        next_act = q_sel.argmax(dim=-1)
    optimizer.zero_grad()
    loss, td = r2d2_loss(params, batch, bi_state, q_tgt, next_act, burn_in,
                         nstep, gamma)
    loss.backward()
    grads = {k: v.grad.clone() for k, v in params.named_parameters()}
    optimizer.step()
    per_seq = td.detach().abs()
    priorities = 0.9 * per_seq.amax(dim=0) + 0.1 * per_seq.mean(dim=0)
    return ({"loss": loss.detach(), "priorities": priorities}, grads, q_sel,
            next_act)


def main(steps: int = 30, S: int = 20, burn_in: int = 4, B: int = 32,
         obs_dim: int = 16, hidden: int = 128, actions: int = 8,
         nstep: int = 3, num_layers: int = 1, gamma: float = 0.99,
         target_update_every: int = 10, device="cuda") -> R2D2Params:
    if S - burn_in - nstep < 1:
        raise ValueError(f"r2d2: S - burn_in - nstep must be >= 1; got "
                         f"{S} - {burn_in} - {nstep}")
    gen = torch.Generator().manual_seed(SEED)
    params = init_params(gen, obs_dim, hidden, actions, num_layers, device)
    # A copy: the optimizer updates params in place.
    target_params = copy.deepcopy(params)
    optimizer = torch.optim.Adam(params.parameters(), lr=LR)
    for i in range(steps):
        if i % target_update_every == 0:
            target_params.load_state_dict(params.state_dict())
        batch = synthetic_batch(gen, S, B, obs_dim, hidden, actions,
                                num_layers, device)
        m, *_ = train_step(params, target_params, optimizer, batch, burn_in,
                           nstep, gamma)
        if i % 5 == 0 or i == steps - 1:
            print(f"step {i:3d}  loss={float(m['loss']):.4f}  "
                  f"max_priority={float(m['priorities'].max()):.4f}",
                  flush=True)
    return params


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.steps, device=args.device)
