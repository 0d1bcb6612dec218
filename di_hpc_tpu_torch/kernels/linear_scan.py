"""First-order linear recurrence over full (T, B) planes: the hand-written
Hopper kernel (csrc/linear_scan.cu, chunked over T; its launch
`linear_scan_launch_shape(T, B)`) and its plain PyTorch version.

Counterpart of di_hpc_tpu/pallas_kernels/linear_scan.py, the scan core's
method="pallas":

  - `linear_scan_reverse` ~ `linear_scan_reverse_pallas`: y_t = a_t + b_t *
    y_{t+1}, t = T-1 .. 0, y_T = y_last;
  - `linear_scan_forward` ~ `linear_scan_forward_pallas`: y_t = a_t + b_t *
    y_{t-1}, t = 0 .. T-1, y_{-1} = y_first.

Both take a (T, B) float32 `a`, a `b` broadcastable to it and a boundary
value (a scalar or anything broadcastable to (B,)), and go through
`linear_scan`, the counted wrapper: it makes `b` a contiguous full plane (the
scan core hands it broadcast views) and passes a non-zero boundary as a (B,)
vector that seeds the walk, where the JAX wrapper folds it into a[T-1] or
a[0].  The kernel is forward-only, as the Pallas kernel is: jax.grad through
it fails to linearize, and the scan core refuses it for inputs that need a
gradient.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.profiling import span
from . import _build
from .rl_scans import _sms, chunked_launch_shape

__all__ = ["linear_scan", "linear_scan_plain", "linear_scan_reverse",
           "linear_scan_forward", "linear_scan_launch_shape"]


def linear_scan_launch_shape(T: int, B: int, sms: int = 132, cols=None,
                             chunks=None) -> dict:
    """The kernel's launch at (T, B) on a card with `sms` SMs
    (kernels.rl_scans.chunked_launch_shape): `cols` columns x `chunks`
    chunks of 8 steps per CTA, walked from the last super-tile (reverse) or
    the first (forward).  The dynamic shared memory holds two buffers of
    the chunks' (A, D) pairs.  `cols` and `chunks` override the choice."""
    return chunked_launch_shape("linear_scan", T, B, sms, cols, chunks, 4)


def linear_scan_plain(a, b, boundary: Optional[torch.Tensor] = None,
                      reverse: bool = True):
    """The kernel's walk in plain PyTorch: y (T, B) from a and b (T, B) and
    a (B,) boundary (None: zero)."""
    T = a.shape[0]
    y = torch.zeros_like(a[0]) if boundary is None else boundary
    out = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        y = a[t] + b[t] * y
        out[t] = y
    return torch.stack(out)


def linear_scan(a, b, boundary: Optional[torch.Tensor] = None,
                reverse: bool = True):
    """y (T, B) of the recurrence for a (T, B), b broadcastable to a, and a
    boundary that is None (zero) or broadcastable to (B,).  CPU tensors run
    the plain version; CUDA tensors launch the kernel or raise."""
    return _linear_scan(a, b, boundary, reverse)


def _linear_scan(a, b, boundary, reverse, cols=None, chunks=None):
    """linear_scan; `cols` and `chunks` override linear_scan_launch_shape's
    choice, to measure the candidates."""
    if a.ndim != 2:
        raise ValueError(f"linear_scan: a must be (T, B); got "
                         f"{tuple(a.shape)}")
    T, B = a.shape
    b = torch.broadcast_to(b, a.shape)
    if boundary is not None:
        boundary = torch.broadcast_to(boundary, (B,))
    tensors = {"a": a, "b": b}
    if boundary is not None:
        tensors["boundary"] = boundary
    if _build.on_cpu(*tensors.values()):
        return linear_scan_plain(a, b, boundary, reverse)
    # The kernel reads full, dense planes: a broadcast b (and boundary) is
    # copied here, and the copy is part of the call's time.
    tensors = {k: t.contiguous() for k, t in tensors.items()}
    name = "linear_scan"
    _build.check_kernel_inputs(name, tensors)
    if T < 1 or B < 1:
        raise ValueError(f"{name}: T and B must be >= 1; got T={T}, B={B}")
    shape = linear_scan_launch_shape(T, B, _sms(a.device), cols, chunks)
    y = torch.empty((T, B), dtype=torch.float32, device=a.device)
    bound = tensors.get("boundary")
    with torch.cuda.device(a.device):
        entry = _build.library().cdll.linear_scan_f32
        stream = torch.cuda.current_stream().cuda_stream
        with span("dihpc.kernel." + name):
            status = entry(tensors["a"].data_ptr(), tensors["b"].data_ptr(),
                           None if bound is None else bound.data_ptr(),
                           y.data_ptr(), T, B, int(reverse), shape["cols"],
                           shape["chunks"], stream)
    _build.check_status(name, status)
    linear_scan.launches += 1
    return y


linear_scan.launches = 0


def _boundary(y_end, a) -> Optional[torch.Tensor]:
    """None for a zero scalar (nothing to seed), else the boundary as a
    tensor on a's device and dtype."""
    if isinstance(y_end, (int, float)) and y_end == 0.0:
        return None
    return torch.as_tensor(y_end, dtype=a.dtype, device=a.device)


def linear_scan_reverse(a, b, y_last=0.0):
    """y_t = a_t + b_t * y_{t+1}, t = T-1..0, for (T, B) float32 a."""
    return linear_scan(a, torch.as_tensor(b, dtype=a.dtype, device=a.device),
                       _boundary(y_last, a), reverse=True)


def linear_scan_forward(a, b, y_first=0.0):
    """y_t = a_t + b_t * y_{t-1}, t = 0..T-1, for (T, B) float32 a."""
    return linear_scan(a, torch.as_tensor(b, dtype=a.dtype, device=a.device),
                       _boundary(y_first, a), reverse=False)
