"""Plain-PyTorch oracles (the ground truth the fused ops match), the
counterpart of di_hpc_tpu.origin for the modules ported so far."""

from .gae import gae, gae_data
from .ppo import (
    categorical_entropy,
    categorical_log_prob,
    ppo_data,
    ppo_error,
    ppo_info,
    ppo_loss,
)
from .rnn import (
    LSTMParams,
    get_lstm,
    init_lstm_params,
    layer_norm,
    lstm,
    sequence_mask,
)
from .td import (
    generalized_lambda_returns,
    multistep_forward_view,
    td_lambda_data,
    td_lambda_error,
)
from .vtrace import (
    compute_importance_weights,
    vtrace_advantage,
    vtrace_data,
    vtrace_error,
    vtrace_loss,
    vtrace_nstep_return,
)
