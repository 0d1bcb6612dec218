"""The flagship LN-LSTM actor-critic on the port's kernels, the counterpart
of di_hpc_tpu.models: forward, serving step and V-trace training step."""

from .actor_critic_lstm import (
    ActorCriticConfig,
    ActorCriticParams,
    TrainBatch,
    actor_critic_forward,
    actor_step,
    init_actor_critic,
    make_train_step,
)
from .convert import ActorCriticArrays, from_jax_params, to_numpy_params
