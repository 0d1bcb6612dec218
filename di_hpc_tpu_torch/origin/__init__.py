"""Plain-PyTorch oracles (the ground truth the fused ops match), the
counterpart of di_hpc_tpu.origin."""

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
from .padding import (
    Padding1D,
    Padding2D,
    Padding3D,
    UnPadding1D,
    UnPadding2D,
    UnPadding3D,
    oracle_split_group,
)
from .scatter_connection import ScatterConnection, scatter_connection
from .td import (
    value_transform,
    value_inv_transform,
    nstep_return,
    nstep_return_data,
    td_lambda_data,
    td_lambda_error,
    generalized_lambda_returns,
    multistep_forward_view,
    q_nstep_td_data,
    q_nstep_td_error,
    q_nstep_td_error_with_rescale,
    dist_nstep_td_data,
    dist_nstep_td_error,
    qrdqn_nstep_td_data,
    qrdqn_nstep_td_error,
    iqn_nstep_td_data,
    iqn_nstep_td_error,
)
from .upgo import tb_cross_entropy, upgo_loss, upgo_returns
from .vtrace import (
    compute_importance_weights,
    vtrace_advantage,
    vtrace_data,
    vtrace_error,
    vtrace_loss,
    vtrace_nstep_return,
)
