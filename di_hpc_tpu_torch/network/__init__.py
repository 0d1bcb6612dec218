"""Fused network ops on the port's kernels, the counterpart of
di_hpc_tpu.network for the modules ported so far."""

from .lstm import (
    LSTM,
    LSTMParams,
    LSTMWeights,
    flatten_lstm_params,
    init_lstm_params,
    layer_route,
    lstm_fused,
    reset_route_counts,
    unflatten_lstm_params,
)
from .scatter_connection import ScatterConnection, scatter_connection
