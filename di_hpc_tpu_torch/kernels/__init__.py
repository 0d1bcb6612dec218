"""Hand-written Hopper kernels (CUDA C++ in ../csrc, built on first use)
and their plain PyTorch versions; the counterpart of
di_hpc_tpu.pallas_kernels, all 12 of its kernels: the LSTM layer and its
backwards, V-trace, GAE, the lambda-returns, the TD(lambda) loss, UPGO and
the generic linear recurrence.

Each wrapper runs its plain version when every tensor lies on the CPU,
launches its kernel for CUDA tensors, and raises on what the kernel cannot
take.  `wrapper.launches` counts the kernel's launches (the forward layer
kernel counts on `lstm_layer_fused`, with or without its stash; both
directions of the linear recurrence count on `linear_scan`).  The three
LSTM kernels also take bf16 streams: their bf16 launches count apart, in
`wrapper.launches_bf16`, and `launch_counts` reports them as
"<name>_bf16".
"""

from .linear_scan import (
    linear_scan,
    linear_scan_forward,
    linear_scan_launch_shape,
    linear_scan_plain,
    linear_scan_reverse,
)
from .lstm_cell import (
    V2_MIN_BATCH,
    layer_launch_shape,
    lstm_layer_bwd_v1,
    lstm_layer_bwd_v1_plain,
    lstm_layer_bwd_v1_streams,
    lstm_layer_bwd_v2,
    lstm_layer_bwd_v2_plain,
    lstm_layer_fused,
    lstm_layer_plain,
    lstm_layer_stash,
    lstm_layer_stash_plain,
    v1_launch_shape,
    v2_launch_shape,
)
from .rl_scans import (
    gae,
    gae_launch_shape,
    gae_plain,
    lambda_returns,
    lambda_returns_launch_shape,
    lambda_returns_plain,
    td_lambda_err,
    td_lambda_err_launch_shape,
    td_lambda_err_plain,
    td_lambda_launch_shape,
    td_lambda_loss,
    td_lambda_loss_plain,
    upgo_advantages,
    upgo_advantages_launch_shape,
    upgo_advantages_plain,
    upgo_loss,
    upgo_loss_launch_shape,
    upgo_loss_plain,
    vtrace_launch_shape,
    vtrace_losses,
    vtrace_losses_plain,
    vtrace_returns_adv,
    vtrace_returns_adv_plain,
)

KERNEL_WRAPPERS = (lstm_layer_fused, lstm_layer_bwd_v2, lstm_layer_bwd_v1,
                   vtrace_losses, vtrace_returns_adv, gae, lambda_returns,
                   td_lambda_loss, td_lambda_err, linear_scan,
                   upgo_advantages, upgo_loss)
BF16_WRAPPERS = (lstm_layer_fused, lstm_layer_bwd_v2, lstm_layer_bwd_v1)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    for fn in BF16_WRAPPERS:
        fn.launches_bf16 = 0


def launch_counts() -> dict:
    return {**{fn.__name__: fn.launches for fn in KERNEL_WRAPPERS},
            **{fn.__name__ + "_bf16": fn.launches_bf16
               for fn in BF16_WRAPPERS}}
