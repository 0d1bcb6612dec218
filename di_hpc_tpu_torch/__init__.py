"""di_hpc_tpu_torch -- the PyTorch/CUDA port of di_hpc_tpu for one NVIDIA
H100 (Hopper, sm_90a).

The JAX package di_hpc_tpu stays the reference; this package imports
nothing of it and no JAX.  Plain tensor code is PyTorch; every TPU kernel
on a ported path is a hand-written CUDA C++ kernel (csrc/), built with nvcc
on first use and loaded with ctypes.  Entry points run on "cuda" unless the
caller passes device="cpu"; CPU tensors run each kernel's plain PyTorch
version.

 - `di_hpc_tpu_torch.origin`  -- plain-PyTorch oracles
 - `di_hpc_tpu_torch.ops`     -- categorical head, V-trace loss
 - `di_hpc_tpu_torch.network` -- fused LayerNorm-LSTM
 - `di_hpc_tpu_torch.models`  -- LN-LSTM actor-critic forward and serving
 - `di_hpc_tpu_torch.kernels` -- the CUDA kernels' wrappers, plain versions
                                 and launch counts
 - `di_hpc_tpu_torch.utils`   -- constants
"""

__version__ = "0.1.0"

from di_hpc_tpu_torch import (  # noqa: F401
    kernels, models, network, ops, origin, utils,
)
