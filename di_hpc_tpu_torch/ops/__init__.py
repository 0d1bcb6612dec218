"""Fused RL ops on the port's kernels, the counterpart of di_hpc_tpu.ops
for the ops ported so far."""

from .scan import (
    gae_denominators,
    linear_recurrence_forward,
    linear_recurrence_reverse,
)
from .gae import GAE, gae, gae_data
from .td import (
    TDLambda,
    generalized_lambda_returns,
    multistep_forward_view,
    td_lambda_data,
    td_lambda_error,
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
