"""IMPALA actor-learner loop on a synthetic environment, the port of the
JAX package's examples/impala_actor_learner.py, in its configuration (obs
16, hidden 64, 1 LN-LSTM layer, 4 actions, unrolls T=16, 32 environments,
learner batch 32, entropy 0.02, Adam 1e-3).

 - The actor thread runs `models.actor_step` with CPU parameters on a toy
   linear-dynamics environment and pushes trajectories into
   `data.TrajectoryBuffer`;
 - the learner pops FIFO batches (time-major, one transfer per field) and
   runs the V-trace train step of `models.make_train_step` on `device`
   (on the card: the LSTM forward with its stash, TPU kernel 1; V-trace,
   kernels 2 and 3; the LSTM backward, kernel 5 below B=64), then
   publishes CPU copies of the parameters, which the actor loads once per
   rollout: the off-policy lag V-trace's importance weights correct for.

The JAX example can also shard the learner batch over a device mesh; that
waits for the port's parallel layer (ROADMAP §1 item 4).

Run: python -m di_hpc_tpu_torch.examples.impala_actor_learner [--device cpu]
"""

from __future__ import annotations

import argparse
import threading

import numpy as np
import torch

from di_hpc_tpu_torch.data import TrajectoryBuffer
from di_hpc_tpu_torch.models import (
    ActorCriticConfig, TrainBatch, actor_step, init_actor_critic,
    make_train_step,
)

CFG = ActorCriticConfig(obs_dim=16, hidden_size=64, num_layers=1,
                        action_dim=4)
ENTROPY_COEF = 0.02
LR = 1e-3
SEED = 0
# How long the learner waits for a batch before it looks for a dead actor.
SAMPLE_TIMEOUT_S = 60.0


class ToyEnv:
    """Vectorized linear-dynamics env: reward peaks when the action matches
    a hidden projection of the state."""

    def __init__(self, batch: int, obs_dim: int, n_actions: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.w = rng.standard_normal((obs_dim,)).astype(np.float32)
        self.a_mix = rng.standard_normal((obs_dim, obs_dim)).astype(np.float32) * 0.1
        self.n_actions = n_actions
        self.batch = batch
        self.obs_dim = obs_dim
        self.state = rng.standard_normal((batch, obs_dim)).astype(np.float32)
        self.rng = rng

    def step(self, actions: np.ndarray):
        target = (self.state @ self.w > 0).astype(np.int32) * (self.n_actions - 1)
        reward = (actions == target).astype(np.float32) - 0.1
        noise = self.rng.standard_normal(self.state.shape).astype(np.float32) * 0.3
        self.state = np.tanh(self.state @ self.a_mix + noise)
        return self.state.copy(), reward


def init_learner(device="cuda"):
    """The learner's parameters (from a generator seeded with SEED), its
    Adam and its train step."""
    params = init_actor_critic(CFG, torch.Generator().manual_seed(SEED),
                               device)
    optimizer = torch.optim.Adam(params.parameters(), lr=LR)
    train = make_train_step(CFG, optimizer, entropy_coef=ENTROPY_COEF)
    return params, optimizer, train


def _host_state(params) -> dict:
    """CPU copies of the parameters, for the actor to load."""
    return {k: v.detach().to("cpu", copy=True)
            for k, v in params.state_dict().items()}


def run(steps: int = 30, T: int = 16, env_batch: int = 32,
        learn_batch: int = 32, device="cuda", on_step=None):
    """`steps` learner steps; returns the learner's parameters.  After each
    step `on_step(i, params, batch, metrics)` is called where given (the
    parameters' .grad hold that step's gradients)."""
    params, _, train = init_learner(device)
    buf = TrajectoryBuffer(capacity=256)
    stop = threading.Event()
    actor_exc = []
    # Only the learner thread touches `device`; it publishes CPU copies of
    # the parameters here, a new dict each step, for the actor to load.
    shared = {"params": _host_state(params)}

    def actor_loop():
        env = ToyEnv(env_batch, CFG.obs_dim, CFG.action_dim)
        gen = torch.Generator().manual_seed(SEED + 1)
        actor_params = init_actor_critic(CFG, torch.Generator(), "cpu")
        zeros = torch.zeros(CFG.num_layers, env_batch, CFG.hidden_size)
        state = (zeros, zeros)
        obs = env.state.copy()
        while not stop.is_set():
            actor_params.load_state_dict(shared["params"])   # per rollout
            obs_seq, act_seq, rew_seq, logit_seq = [obs], [], [], []
            for _ in range(T):
                if stop.is_set():
                    return
                a, logits, _v, state = actor_step(
                    actor_params, torch.from_numpy(obs), state, gen,
                    CFG.norm_type)
                a_np = a.numpy()
                obs, r = env.step(a_np)
                obs_seq.append(obs)
                act_seq.append(a_np)
                rew_seq.append(r)
                logit_seq.append(logits.numpy())
            for b in range(env_batch):
                buf.add({
                    "obs": np.stack([o[b] for o in obs_seq]),        # (T+1, obs)
                    "action": np.stack([a[b] for a in act_seq]),     # (T,)
                    "reward": np.stack([r[b] for r in rew_seq]),     # (T,)
                    "behaviour_logits": np.stack([l[b] for l in logit_seq]),
                })

    def actor_main():
        try:
            actor_loop()
        except Exception as e:  # surfaced by the learner on its next sample
            actor_exc.append(e)

    actor = threading.Thread(target=actor_main, daemon=True)
    actor.start()
    try:
        for i in range(steps):
            try:
                batch = buf.sample_batch(learn_batch,
                                         timeout=SAMPLE_TIMEOUT_S,
                                         device=device)
            except TimeoutError:
                if actor_exc:
                    raise RuntimeError("actor thread died") from actor_exc[0]
                raise
            tb = TrainBatch(
                obs=batch["obs"],
                actions=batch["action"],
                rewards=batch["reward"],
                behaviour_logits=batch["behaviour_logits"],
            )
            metrics = train(params, tb)
            shared["params"] = _host_state(params)           # publish
            if on_step is not None:
                on_step(i, params, tb, metrics)
            if i % 5 == 0 or i == steps - 1:
                print(f"step {i:3d}  total={float(metrics['total_loss']):+.4f}  "
                      f"entropy={float(metrics['entropy']):.3f}  "
                      f"buffer={len(buf)}", flush=True)
    finally:
        stop.set()
        actor.join(timeout=30)
    return params


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    run(steps=args.steps, device=args.device)
