"""When an op takes its fused kernel, the counterpart of the JAX package's
ops/_backend.py.

The JAX gate also asks for a TPU (or Pallas interpret mode) and for a
block that fits VMEM; neither is a fact of this port.  Here a CPU tensor
runs the kernel's plain version, a CUDA tensor launches the kernel, and the
kernels take any T and B, so only the method, rank and dtype decide.
"""

from __future__ import annotations

import torch


def fused_kernels_ok(*tensors, method: str = "auto") -> bool:
    """True when the fused kernel path applies: method is auto/pallas and
    every tensor is float32 with a 2-D (T, B) layout."""
    if method not in ("auto", "pallas"):
        return False
    return all(t.ndim == 2 and t.dtype == torch.float32 for t in tensors)
