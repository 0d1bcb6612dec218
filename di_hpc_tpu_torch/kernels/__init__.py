"""Hand-written Hopper kernels (CUDA C++ in ../csrc, built on first use)
and their plain PyTorch versions; the counterpart of
di_hpc_tpu.pallas_kernels for the kernels ported so far.

Each wrapper runs its plain version when every tensor lies on the CPU,
launches its kernel for CUDA tensors, and raises on what the kernel cannot
take.  `wrapper.launches` counts the kernel's launches.
"""

from .lstm_cell import lstm_layer_fused, lstm_layer_plain
from .rl_scans import (
    vtrace_losses,
    vtrace_losses_plain,
    vtrace_returns_adv,
    vtrace_returns_adv_plain,
)

KERNEL_WRAPPERS = (lstm_layer_fused, vtrace_losses, vtrace_returns_adv)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
