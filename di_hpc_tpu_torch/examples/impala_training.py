"""IMPALA-style training on synthetic trajectories, the port of the JAX
package's examples/impala_training.py, in its configuration (obs 64, hidden
128, 2 LN-LSTM layers, 16 actions, T=32, B=64, Adam 3e-4; `--bf16` for
mixed precision).

Each step draws a synthetic batch (from a torch.Generator, where the JAX
example splits a key) and runs the V-trace train step: in a world of one
`models.make_train_step` on `device` (on the card: the LSTM forward with
its stash, TPU kernel 1; V-trace, kernels 2 and 3; the LSTM backward,
kernel 4 at B=64); in a world of several ranks (parallel.initialize) the
data-parallel `models.make_sharded_train_step` over `parallel.make_mesh()`,
each rank taking its shard of the global batch, as the JAX example shards
it over its devices.

Run: python -m di_hpc_tpu_torch.examples.impala_training [--bf16]
     [--steps N] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch
import torch.distributed as dist

from di_hpc_tpu_torch import parallel
from di_hpc_tpu_torch.models import (
    ActorCriticConfig, ActorCriticParams, TrainBatch, actor_critic_shardings,
    init_actor_critic, make_sharded_train_step, make_train_step,
)

CFG = ActorCriticConfig(obs_dim=64, hidden_size=128, num_layers=2,
                        action_dim=16)
LR = 3e-4
SEED = 0


def synthetic_batch(generator: torch.Generator, T: int, B: int, obs_dim: int,
                    actions: int, device="cuda") -> TrainBatch:
    """The JAX example's synthetic batch: normal observations, uniform
    actions, rewards * 0.1 and behaviour logits * 0.5, drawn on the CPU
    from `generator` and moved to `device`."""
    def normal(*shape):
        return torch.randn(shape, generator=generator)

    batch = TrainBatch(
        obs=normal(T + 1, B, obs_dim),
        actions=torch.randint(0, actions, (T, B), generator=generator),
        rewards=normal(T, B) * 0.1,
        behaviour_logits=normal(T, B, actions) * 0.5)
    return TrainBatch(*(t.to(device) for t in batch))


def make_step(params: ActorCriticParams, bf16: bool, mesh=None):
    """(params, step): the train step of the example's configuration over
    `params` (the global parameters; with a mesh, each rank's copy of them
    is placed by actor_critic_shardings) with Adam(LR); mixed precision
    when `bf16` (bf16 model compute, float32 master parameters, loss and
    Adam)."""
    dtype = torch.bfloat16 if bf16 else None
    if mesh is None:
        opt = torch.optim.Adam(params.parameters(), lr=LR)
        return params, make_train_step(CFG, opt, compute_dtype=dtype)
    params = ActorCriticParams(*parallel.shard_params(
        params.params(), actor_critic_shardings(mesh, CFG.num_layers)))
    opt = torch.optim.Adam(params.parameters(), lr=LR)
    return params, make_sharded_train_step(CFG, opt, mesh,
                                           compute_dtype=dtype)


def main(steps: int = 20, T: int = 32, B: int = 64, bf16: bool = False,
         device="cuda"):
    """`steps` train steps; returns (params, the last step's metrics).
    The mesh is None in a world of one, else every rank of the process
    group on one data axis (the ranks' devices: make_mesh's, or `device`
    for the CPU)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = None
    if world > 1:
        mesh = parallel.make_mesh(
            devices=None if str(device) != "cpu" else ["cpu"] * world)
        device = mesh.device
        print(f"data-parallel over {world} ranks")
    gen = torch.Generator().manual_seed(SEED)
    params, step = make_step(init_actor_critic(CFG, gen, device), bf16, mesh)
    metrics = None
    for i in range(steps):
        batch = synthetic_batch(gen, T, B, CFG.obs_dim, CFG.action_dim,
                                device)
        if mesh is not None:
            batch = parallel.shard_batch_pytree(mesh, batch,
                                                TrainBatch(1, 1, 1, 1))
        metrics = step(params, batch)
        if i % 5 == 0 or i == steps - 1:
            print(f"step {i:3d}  total={float(metrics['total_loss']):+.4f}  "
                  f"policy={float(metrics['policy_loss']):+.4f}  "
                  f"value={float(metrics['value_loss']):.4f}  "
                  f"entropy={float(metrics['entropy']):.4f}", flush=True)
    return params, metrics


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.steps, bf16=args.bf16, device=args.device)
