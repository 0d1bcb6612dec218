"""The port's models, the counterpart of di_hpc_tpu.models: the flagship
LN-LSTM actor-critic (forward, serving step and V-trace training step,
unsharded and over a data x model mesh of ranks), the
AlphaStar policy-head helpers and the autoregressive entity-selection head,
the parameter modules of the examples (AlphaStar, R2D2, the C51/QR-DQN,
IQN and PPO networks), and the weight carry-over from the JAX package."""

from .actor_critic import lstm_activation, pre_sample, update_ae
from .actor_critic_lstm import (
    ActorCriticArrays,
    ActorCriticConfig,
    ActorCriticParams,
    TrainBatch,
    actor_critic_forward,
    actor_critic_shardings,
    actor_step,
    init_actor_critic,
    make_sharded_train_step,
    make_train_step,
)
from .convert import (
    AlphaStarArrays,
    AlphaStarParams,
    EntitySelectionArrays,
    IQNArrays,
    IQNParams,
    PPOArrays,
    PPOParams,
    QArrays,
    QParams,
    R2D2Arrays,
    R2D2Params,
    from_jax_params,
    to_numpy_params,
)
from .entity_selection import (
    EntitySelectionParams,
    init_entity_selection,
    select_entities,
)
