"""Quantile-family distributional DQN training on synthetic transitions,
QR-DQN and IQN: the port of the JAX package's
examples/quantile_dqn_training.py, in its configuration (B=64, obs 24,
hidden 64, 8 actions, tau = tau' = 32, 64 cosine features, nstep 3, gamma
0.99, kappa 1, Adam 1e-3, 20 steps each, the target net refreshed before
every 10th step).

 - QR-DQN: a Q-network emitting a fixed fan of tau quantiles per action
   (B, N, tau) at the midpoints tau_hat = (i + 0.5) / tau, trained with
   `ops.qrdqn_nstep_td_error`;
 - IQN: quantile levels sampled each step, embedded as cos(pi * level * i)
   for i = 1..n_cos, the network evaluated at them (tau, B, N) and trained
   with `ops.iqn_nstep_td_error` weighted by the sampled levels.

Both take the next action greedily on the target net's mean over the
quantiles.  The ops are plain PyTorch in both packages: no TPU kernel lies
on this path.  Each step's batch is drawn from a torch.Generator seeded as
the JAX example seeds its key (QR-DQN 0, IQN 1).

Run: python -m di_hpc_tpu_torch.examples.quantile_dqn_training
     [--algo both|qrdqn|iqn] [--steps N] [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import math

import torch

from di_hpc_tpu_torch import ops
from di_hpc_tpu_torch.models import IQNParams, QParams

QRParams = QParams          # the JAX example's name for the QR-DQN network
LR = 1e-3
QR_SEED, IQN_SEED = 0, 1


def _normal(generator, *shape):
    return torch.randn(shape, generator=generator) / shape[0] ** 0.5


def init_qr(generator: torch.Generator, obs_dim, hidden, actions, n_tau,
            device="cuda") -> QRParams:
    """The JAX example's init scales, drawn on the CPU from `generator`."""
    return QRParams(_normal(generator, obs_dim, hidden), torch.zeros(hidden),
                    _normal(generator, hidden, actions * n_tau),
                    torch.zeros(actions * n_tau)).to(device)


def init_iqn(generator: torch.Generator, obs_dim, hidden, actions, n_cos,
             device="cuda") -> IQNParams:
    """The JAX example's init scales, drawn on the CPU from `generator`."""
    return IQNParams(_normal(generator, obs_dim, hidden), torch.zeros(hidden),
                     _normal(generator, n_cos, hidden), torch.zeros(hidden),
                     _normal(generator, hidden, actions),
                     torch.zeros(actions)).to(device)


def qr_quantiles(p: QRParams, obs, actions, n_tau):
    """obs (B, obs_dim) -> quantile estimates (B, N, tau) (QR-DQN layout)."""
    h = torch.tanh(obs @ p.w1 + p.b1)
    return (h @ p.w2 + p.b2).reshape(-1, actions, n_tau)


def iqn_quantiles(p: IQNParams, obs, levels, n_cos):
    """obs (B, obs_dim), levels (tau, B) -> values (tau, B, N) (IQN layout):
    state features modulated by the cosine embedding of each level."""
    h = torch.tanh(obs @ p.w1 + p.b1)                       # (B, hidden)
    i = torch.arange(1, n_cos + 1, dtype=h.dtype, device=h.device)
    cos_feat = torch.cos(math.pi * levels[..., None] * i)   # (tau, B, n_cos)
    phi = torch.relu(cos_feat @ p.w_cos + p.b_cos)          # (tau, B, hidden)
    return (h[None] * phi) @ p.w2 + p.b2                    # (tau, B, N)


def synthetic_batch(generator: torch.Generator, B, obs_dim, actions, nstep,
                    n_tau=None, n_tau_prime=None, device="cuda") -> dict:
    """The JAX example's transitions (normal observations, the next ones
    0.3 noise away, uniform actions, rewards * 0.1, done with probability
    0.05) and, for IQN (n_tau given), the sampled levels (tau, B) and
    (tau', B); drawn on the CPU from `generator`, moved to `device`."""
    obs = torch.randn((B, obs_dim), generator=generator)
    batch = {"obs": obs,
             "next_obs": obs + 0.3 * torch.randn((B, obs_dim),
                                                 generator=generator),
             "act": torch.randint(0, actions, (B,), generator=generator),
             "reward": 0.1 * torch.randn((nstep, B), generator=generator),
             "done": torch.rand((B,), generator=generator) > 0.95}
    if n_tau is not None:
        batch["levels"] = torch.rand((n_tau, B), generator=generator)
        batch["levels_prime"] = torch.rand((n_tau_prime, B),
                                           generator=generator)
    return {k: v.to(device) for k, v in batch.items()}


def _finish(params, optimizer, loss, td):
    loss.backward()
    grads = {k: v.grad.clone() for k, v in params.named_parameters()}
    optimizer.step()
    return {"loss": loss.detach(), "td": td.detach()}, grads


def qrdqn_step(params: QRParams, target_params: QRParams, optimizer, batch,
               n_tau: int, nstep: int, gamma: float, next_act=None):
    """One QR-DQN step (examples/quantile_dqn_training.py:96-117): the
    target quantiles and their greedy action on the mean (or the given
    next_act) without a gradient, the loss, backward and the optimizer
    step.  Returns the metrics (loss, td; detached), the gradients by
    parameter name, the target's mean values (B, N) and the action
    taken."""
    actions = params.w2.shape[1] // n_tau
    dev = params.w1.device
    tau_hat = (torch.arange(n_tau, device=dev) + 0.5) / n_tau
    with torch.no_grad():
        next_q = qr_quantiles(target_params, batch["next_obs"], actions,
                              n_tau)
        next_mean = next_q.mean(dim=-1)
    if next_act is None:
        next_act = next_mean.argmax(dim=-1)
    optimizer.zero_grad()
    q = qr_quantiles(params, batch["obs"], actions, n_tau)
    loss, td = ops.qrdqn_nstep_td_error(
        ops.qrdqn_nstep_td_data(q, next_q, batch["act"], next_act,
                                batch["reward"], batch["done"], tau_hat,
                                None),
        gamma=gamma, nstep=nstep)
    return (*_finish(params, optimizer, loss, td), next_mean, next_act)


def iqn_step(params: IQNParams, target_params: IQNParams, optimizer, batch,
             n_cos: int, nstep: int, gamma: float, kappa: float,
             next_act=None):
    """One IQN step (examples/quantile_dqn_training.py:138-164), as
    qrdqn_step: the target net at the levels tau', its greedy action on the
    mean over tau', the net at the levels tau, `ops.iqn_nstep_td_error`
    weighted by them."""
    with torch.no_grad():
        next_q = iqn_quantiles(target_params, batch["next_obs"],
                               batch["levels_prime"], n_cos)
        next_mean = next_q.mean(dim=0)
    if next_act is None:
        next_act = next_mean.argmax(dim=-1)
    optimizer.zero_grad()
    q = iqn_quantiles(params, batch["obs"], batch["levels"], n_cos)
    loss, td = ops.iqn_nstep_td_error(
        ops.iqn_nstep_td_data(q, next_q, batch["act"], next_act,
                              batch["reward"], batch["done"],
                              batch["levels"], None),
        gamma=gamma, nstep=nstep, kappa=kappa)
    return (*_finish(params, optimizer, loss, td), next_mean, next_act)


def _train(tag, params, step, draw, steps, target_update_every):
    """The JAX example's loop: the target refreshed (a copy) before step i
    when i % target_update_every == 0."""
    target_params = copy.deepcopy(params)
    optimizer = torch.optim.Adam(params.parameters(), lr=LR)
    for i in range(steps):
        if i % target_update_every == 0:
            target_params.load_state_dict(params.state_dict())
        metrics, *_ = step(params, target_params, optimizer, draw())
        if i % 5 == 0 or i == steps - 1:
            print(f"[{tag}] step {i:3d}  loss={float(metrics['loss']):.4f}  "
                  f"mean|td|={float(metrics['td'].abs().mean()):.4f}",
                  flush=True)
    return params


def train_qrdqn(steps, B, obs_dim, hidden, actions, n_tau, nstep, gamma,
                target_update_every, device="cuda") -> QRParams:
    gen = torch.Generator().manual_seed(QR_SEED)
    params = init_qr(gen, obs_dim, hidden, actions, n_tau, device)
    return _train(
        "qrdqn", params,
        lambda p, t, opt, batch: qrdqn_step(p, t, opt, batch, n_tau, nstep,
                                            gamma),
        lambda: synthetic_batch(gen, B, obs_dim, actions, nstep,
                                device=device),
        steps, target_update_every)


def train_iqn(steps, B, obs_dim, hidden, actions, n_tau, n_tau_prime, n_cos,
              nstep, gamma, kappa, target_update_every,
              device="cuda") -> IQNParams:
    gen = torch.Generator().manual_seed(IQN_SEED)
    params = init_iqn(gen, obs_dim, hidden, actions, n_cos, device)
    return _train(
        "iqn", params,
        lambda p, t, opt, batch: iqn_step(p, t, opt, batch, n_cos, nstep,
                                          gamma, kappa),
        lambda: synthetic_batch(gen, B, obs_dim, actions, nstep, n_tau,
                                n_tau_prime, device),
        steps, target_update_every)


def main(steps: int = 20, B: int = 64, obs_dim: int = 24, hidden: int = 64,
         actions: int = 8, n_tau: int = 32, n_tau_prime: int = 32,
         n_cos: int = 64, nstep: int = 3, gamma: float = 0.99,
         kappa: float = 1.0, target_update_every: int = 10,
         algo: str = "both", device="cuda") -> dict:
    out = {}
    if algo in ("both", "qrdqn"):
        out["qrdqn"] = train_qrdqn(steps, B, obs_dim, hidden, actions, n_tau,
                                   nstep, gamma, target_update_every, device)
    if algo in ("both", "iqn"):
        out["iqn"] = train_iqn(steps, B, obs_dim, hidden, actions, n_tau,
                               n_tau_prime, n_cos, nstep, gamma, kappa,
                               target_update_every, device)
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--algo", default="both",
                        choices=("both", "qrdqn", "iqn"))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.steps, algo=args.algo, device=args.device)
