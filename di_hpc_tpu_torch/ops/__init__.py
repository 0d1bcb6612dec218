"""Fused RL ops on the port's kernels and ragged-batch padding, the
counterpart of di_hpc_tpu.ops."""

from .scan import (
    gae_denominators,
    linear_recurrence_forward,
    linear_recurrence_reverse,
)
from .gae import GAE, gae, gae_data
from .td import (
    DistNStepTD,
    IQNNStepTDError,
    QNStepTD,
    QNStepTDRescale,
    QRDQNNStepTDError,
    TDLambda,
    dist_nstep_td_data,
    dist_nstep_td_error,
    generalized_lambda_returns,
    iqn_nstep_td_data,
    iqn_nstep_td_error,
    multistep_forward_view,
    nstep_return,
    nstep_return_data,
    q_nstep_td_data,
    q_nstep_td_error,
    q_nstep_td_error_with_rescale,
    qrdqn_nstep_td_data,
    qrdqn_nstep_td_error,
    td_lambda_data,
    td_lambda_error,
    value_inv_transform,
    value_transform,
)
from .categorical import logp, logp_entropy
from .ppo import (
    PPO,
    ppo_data,
    ppo_error,
    ppo_error_with_logp_old,
    ppo_fast_data,
    ppo_info,
    ppo_loss,
)
from .upgo import UPGO, upgo_loss, upgo_returns
from .vtrace import VTrace, vtrace_data, vtrace_error, vtrace_loss
from .padding import (
    Padding1D,
    Padding2D,
    Padding3D,
    UnPadding1D,
    UnPadding2D,
    UnPadding3D,
    oracle_split_group,
    sample_split_group,
)
