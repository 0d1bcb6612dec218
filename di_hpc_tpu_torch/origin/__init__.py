"""Plain-PyTorch oracles (the ground truth the fused ops match), the
counterpart of di_hpc_tpu.origin for the modules ported so far."""

from .ppo import categorical_entropy, categorical_log_prob
from .rnn import (
    LSTMParams,
    get_lstm,
    init_lstm_params,
    layer_norm,
    lstm,
    sequence_mask,
)
from .vtrace import (
    compute_importance_weights,
    vtrace_advantage,
    vtrace_data,
    vtrace_error,
    vtrace_loss,
    vtrace_nstep_return,
)
