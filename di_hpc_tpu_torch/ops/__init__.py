"""Fused RL ops on the port's kernels, the counterpart of di_hpc_tpu.ops
for the ops ported so far."""

from .categorical import logp, logp_entropy
from .vtrace import VTrace, vtrace_data, vtrace_error, vtrace_loss
