"""di_hpc_tpu_torch -- the PyTorch/CUDA port of di_hpc_tpu for one NVIDIA
H100 (Hopper, sm_90a).

The JAX package di_hpc_tpu stays the reference; this package imports
nothing of it and no JAX.  Plain tensor code is PyTorch; every TPU kernel
on a ported path is a hand-written CUDA C++ kernel (csrc/), built with nvcc
on first use and loaded with ctypes.  Entry points run on "cuda" unless the
caller passes device="cpu"; CPU tensors run each kernel's plain PyTorch
version.

 - `di_hpc_tpu_torch.origin`  -- plain-PyTorch oracles
 - `di_hpc_tpu_torch.ops`     -- scan core, GAE, TD family, PPO, UPGO,
                                 categorical head, V-trace loss, ragged
                                 padding
 - `di_hpc_tpu_torch.data`    -- trajectory buffer and batch stacking for
                                 the actor-learner loop
 - `di_hpc_tpu_torch.parallel` -- rank meshes on torch.distributed,
                                 data-parallel losses, time-sharded scans
 - `di_hpc_tpu_torch.network` -- fused LayerNorm-LSTM
 - `di_hpc_tpu_torch.models`  -- LN-LSTM actor-critic forward and serving
 - `di_hpc_tpu_torch.kernels` -- the CUDA kernels' wrappers, plain versions
                                 and launch counts
 - `di_hpc_tpu_torch.utils`   -- constants, checkpointing, profiling,
                                 the C host core (csrc/host)
 - `di_hpc_tpu_torch.entry`   -- the flagship forward and its arguments
 - `di_hpc_tpu_torch.examples` -- the JAX package's examples, ported
"""

__version__ = "0.1.0"

from di_hpc_tpu_torch import (  # noqa: F401
    data, kernels, models, network, ops, origin, parallel, utils,
)
