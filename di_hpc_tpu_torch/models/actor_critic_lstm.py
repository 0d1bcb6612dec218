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
V-trace loss and the optimizer stay float32.  `make_sharded_train_step` is
the same step over a data x model mesh of ranks (the placement of
`actor_critic_shardings`), with its collectives in parallel._comm.

While a profiler runs, `make_train_step`'s step is the spans
`dihpc.train.{zero_grad,forward,backward,optimizer}` and the forward's
embedding and heads `dihpc.gemm.embed`, `dihpc.gemm.heads`
(utils.profiling).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..network.lstm import LSTMWeights, lstm_fused
from ..ops.vtrace import vtrace_data, vtrace_error
from ..origin.rnn import LSTMParams, init_lstm_params
from ..parallel._comm import all_gather, fan_out, reduce
from ..parallel.api import lstm_param_shardings
from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, NamedSharding,
                             gather_params, replicated)
from ..utils.checkpoint import tree_flatten
from ..utils.profiling import span

__all__ = [
    "ActorCriticConfig", "ActorCriticArrays", "ActorCriticParams",
    "TrainBatch", "init_actor_critic", "actor_critic_forward", "actor_step",
    "make_train_step", "actor_critic_shardings", "make_sharded_train_step",
]


class ActorCriticConfig(NamedTuple):
    obs_dim: int
    hidden_size: int
    num_layers: int
    action_dim: int
    norm_type: Optional[str] = "LN"


class ActorCriticArrays(NamedTuple):
    """ActorCriticParams as a tuple, field for field the JAX package's
    ActorCriticParams (`lstm` an LSTMParams): numpy arrays
    (models.to_numpy_params), the module's tensors
    (ActorCriticParams.params()), or a NamedSharding per leaf
    (actor_critic_shardings)."""
    embed_w: Any
    embed_b: Any
    lstm: LSTMParams
    policy_w: Any
    policy_b: Any
    value_w: Any
    value_b: Any


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

    def params(self) -> ActorCriticArrays:
        """The module's parameters in the JAX tuple's order."""
        return ActorCriticArrays(self.embed_w, self.embed_b,
                                 self.lstm.params(), self.policy_w,
                                 self.policy_b, self.value_w, self.value_b)


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
    parameters on either device.  `params` is an ActorCriticParams or an
    ActorCriticArrays of tensors.  Under torch.no_grad() the LSTM layers
    skip the cell-state stash the backward reads."""
    lstm = params.lstm
    if not isinstance(lstm, LSTMParams):
        lstm = lstm.params()
    with span("dihpc.gemm.embed"):
        x = torch.relu(torch.matmul(obs, params.embed_w) + params.embed_b)
    y, next_state = lstm_fused(lstm, x, state, norm_type)
    with span("dihpc.gemm.heads"):
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


def _cast_params(params: ActorCriticArrays, dtype) -> ActorCriticArrays:
    """The parameters cast to `dtype` (differentiable casts)."""
    leaves, rebuild = tree_flatten(params)
    return rebuild([t.to(dtype) for t in leaves])


def _vtrace_losses(logits, value, batch, gamma, lambda_):
    """ops.vtrace_error on the first T logits and the values, as float32."""
    T = batch.actions.shape[0]
    return vtrace_error(
        vtrace_data(logits[:T].float(), batch.behaviour_logits.float(),
                    batch.actions, value.float(), batch.rewards.float(),
                    None),
        gamma, lambda_)


def _metrics(total, losses) -> dict:
    return {"total_loss": total.detach(),
            "policy_loss": losses.policy_loss.detach(),
            "value_loss": losses.value_loss.detach(),
            "entropy": losses.entropy_loss.detach()}


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
            params = _cast_params(params.params(), compute_dtype)
            obs = obs.to(compute_dtype)
        logits, value, _ = actor_critic_forward(params, obs, None,
                                                cfg.norm_type)
        losses = _vtrace_losses(logits, value, batch, gamma, lambda_)
        total = (losses.policy_loss + value_coef * losses.value_loss
                 - entropy_coef * losses.entropy_loss)
        return total, losses

    def train_step(params: ActorCriticParams, batch: TrainBatch) -> dict:
        with span("dihpc.train.zero_grad"):
            optimizer.zero_grad(set_to_none=True)
        with span("dihpc.train.forward"):
            total, losses = loss_fn(params, batch)
        with span("dihpc.train.backward"):
            total.backward()
        with span("dihpc.train.optimizer"):
            optimizer.step()
        return _metrics(total, losses)

    return train_step


def actor_critic_shardings(mesh, num_layers: int) -> ActorCriticArrays:
    """The JAX dryrun's placement of the parameters (__graft_entry__.py:
    98-103), a NamedSharding per leaf: the LSTM's gate matrices, bias and
    LayerNorm parameters sharded on the 4H gate dimension over the "model"
    axis (parallel.lstm_param_shardings), the policy head on the actions
    (policy_w (None, "model"), policy_b ("model",)), the embedding and the
    value head replicated.  On a mesh without a "model" axis every leaf is
    replicated.  `parallel.shard_params(params.params(), shardings)` gives
    this rank's shards, as `jax.device_put(params, shardings)` places them;
    `parallel.gather_params` the global tree back."""
    model = MODEL_AXIS if MODEL_AXIS in mesh.shape else None
    rep = replicated(mesh)
    return ActorCriticArrays(
        rep, rep, lstm_param_shardings(mesh, num_layers, model),
        NamedSharding(mesh, (None, model)), NamedSharding(mesh, (model,)),
        rep, rep)


def make_sharded_train_step(
    cfg: ActorCriticConfig,
    optimizer: torch.optim.Optimizer,
    mesh,
    gamma: float = 0.99,
    lambda_: float = 0.95,
    value_coef: float = 0.5,
    entropy_coef: float = 0.01,
    compute_dtype=None,
):
    """The V-trace training step over a data x model mesh of ranks,
    `train_step(params, batch) -> metrics`: the counterpart of the JAX
    package's make_train_step jitted with __graft_entry__.py's shardings
    (:81-110), where GSPMD places the collectives; here they are explicit,
    all in parallel._comm.  It gives the unsharded step's result, up to
    the order of the sums.

    `params` is an ActorCriticParams of this rank's shards, placed by
    `actor_critic_shardings(mesh, cfg.num_layers)` (from the
    global parameters: `ActorCriticParams(*parallel.shard_params(
    global_params.params(), shardings))`).  `optimizer` holds
    `params.parameters()`, so each rank keeps and updates its own shards;
    Adam is elementwise, so this is optax.adam on the whole tensors.
    `batch` is this rank's shard of the global TrainBatch, dim 1 over the
    "data" axis (`parallel.shard_batch_pytree(mesh, batch,
    TrainBatch(1, 1, 1, 1))`, or `TrajectoryBuffer.sample_batch(mesh=)`'s
    fields).  The step returns the JAX step's four metrics as global means,
    bitwise equal on every rank.

    Forward: each layer's sharded LSTM leaves are all-gathered over the
    model axis before `network.lstm_fused`, so every layer takes the
    unsharded step's route (the kernels run the whole recurrence in one
    launch, which cannot be split over processes); each gather's backward
    hands a rank its slice of the gate columns.  The policy head computes
    this rank's slice of the logits, gathered along the actions before the
    categorical head (its input's gradient summed over the model axis,
    `_comm.fan_out`); the embedding and the value head are replicated.
    Loss: `ops.vtrace_error` on this rank's batch shard, its three losses
    taken to global means over the data axis (`_comm.reduce`, whose
    backward gives each rank 1/K of the gradient).  Backward: every
    gradient is summed over the data axis in rank order (one gather of all
    of them, then a sum); the model ranks of one data group compute the
    same replicated parts, so nothing is summed over the model axis.  With
    `compute_dtype` the casts follow the gathers, so the gradients reach
    the float32 masters through them.  On a mesh without a "model" axis
    this is the data-parallel step (every leaf replicated)."""
    model = MODEL_AXIS if MODEL_AXIS in mesh.shape else None
    shardings = actor_critic_shardings(mesh, cfg.num_layers)

    def loss_fn(params: ActorCriticParams, batch: TrainBatch):
        local = params.params()
        p = local._replace(lstm=gather_params(local.lstm, shardings.lstm))
        obs = batch.obs
        if compute_dtype is not None:
            p = _cast_params(p, compute_dtype)
            obs = obs.to(compute_dtype)
        x = torch.relu(torch.matmul(obs, p.embed_w) + p.embed_b)
        y, _ = lstm_fused(p.lstm, x, None, cfg.norm_type)
        y_policy = fan_out(y, mesh, model) if model else y
        logits = (torch.matmul(y_policy, p.policy_w) + p.policy_b).float()
        if model:
            logits = all_gather(logits, mesh, model, logits.ndim - 1)
        value = torch.matmul(y, p.value_w[:, 0]) + p.value_b[0]
        losses = _vtrace_losses(logits, value, batch, gamma, lambda_)
        losses = type(losses)(*(reduce(l, mesh, DATA_AXIS) for l in losses))
        total = (losses.policy_loss + value_coef * losses.value_loss
                 - entropy_coef * losses.entropy_loss)
        return total, losses

    def train_step(params: ActorCriticParams, batch: TrainBatch) -> dict:
        optimizer.zero_grad(set_to_none=True)
        total, losses = loss_fn(params, batch)
        total.backward()
        with torch.no_grad():
            grads = [p.grad for p in params.parameters()]
            summed = reduce(torch.cat([g.reshape(-1) for g in grads]), mesh,
                            DATA_AXIS, "sum")
            for g, s in zip(grads, summed.split([g.numel() for g in grads])):
                g.copy_(s.view_as(g))
        optimizer.step()
        return _metrics(total, losses)

    return train_step
