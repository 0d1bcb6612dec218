"""The port's models, the counterpart of di_hpc_tpu.models: the flagship
LN-LSTM actor-critic (forward, serving step and V-trace training step), the
AlphaStar policy-head helpers and the autoregressive entity-selection head,
and the weight carry-over from the JAX package."""

from .actor_critic import lstm_activation, pre_sample, update_ae
from .actor_critic_lstm import (
    ActorCriticConfig,
    ActorCriticParams,
    TrainBatch,
    actor_critic_forward,
    actor_step,
    init_actor_critic,
    make_train_step,
)
from .convert import (
    ActorCriticArrays,
    AlphaStarArrays,
    AlphaStarParams,
    EntitySelectionArrays,
    from_jax_params,
    to_numpy_params,
)
from .entity_selection import (
    EntitySelectionParams,
    init_entity_selection,
    select_entities,
)
