"""First-order linear recurrences, the scan core of the RL ops; the
counterpart of the JAX package's ops/scan.py.

Every reverse-time recurrence of the op library is an instance of

    y_t = a_t + b_t * y_{t+1},        t = T-1 .. 0,   y_T given (usually 0)

(GAE, the TD(lambda) returns, V-trace, UPGO).  Three methods:

 - "scan": a sequential loop over T (the baseline), plain PyTorch;
 - "associative": log-depth doubling over T, plain PyTorch.  The affine maps
   f_t(y) = a_t + b_t*y compose associatively, (f @ g)(y) = (a_f + b_f*a_g)
   + (b_f*b_g)*y, so after step k every row holds the composition of the
   next 2^k maps;
 - "pallas": the hand-written kernel of TPU kernel 6
   (kernels.linear_scan, csrc/linear_scan.cu) for (T, B) inputs; its plain
   version on CPU tensors.  It is forward-only, as the JAX package's Pallas
   method is, and raises for inputs that need a gradient.

"auto" resolves to "pallas" for float32 (T, B) CUDA inputs when no gradient
is needed through the result, else to "associative" (differentiable by
autograd).  JAX's TPU thresholds (T >= 32, B >= 128, the VMEM test) are
facts about the TPU and are not carried over.

`gae_denominators` solves the reference's coupled denominator recurrence in
closed form; the GAE kernel divides by it.
"""

from __future__ import annotations

from typing import Literal

import torch

from ..kernels.linear_scan import linear_scan_forward, linear_scan_reverse

__all__ = ["Method", "linear_recurrence_reverse", "linear_recurrence_forward",
           "gae_denominators"]

Method = Literal["auto", "associative", "scan", "pallas"]


def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in xs)


def _resolve(method: str, a, b, y_end) -> str:
    if method == "auto":
        a = torch.as_tensor(a)
        if (a.device.type == "cuda" and a.ndim == 2
                and a.dtype == torch.float32 and not _needs_grad(a, b, y_end)):
            return "pallas"
        return "associative"
    if method not in ("associative", "scan", "pallas"):
        raise ValueError(f"unknown method: {method}")
    if method == "pallas" and _needs_grad(a, b, y_end):
        raise ValueError(
            "method='pallas' runs the forward-only kernel of TPU kernel 6 "
            "(kernels.linear_scan), which has no gradient, as the JAX "
            "package's Pallas method has none; use 'associative' or 'scan' "
            "for inputs that need a gradient")
    return method


def _operands(a, b, y_end):
    """a as a tensor; b and the boundary value y_end broadcast to a's
    dtype, device and shape (b to a.shape, y_end to a[0].shape)."""
    a = torch.as_tensor(a)
    like = dict(dtype=a.dtype, device=a.device)
    b = torch.broadcast_to(torch.as_tensor(b, **like), a.shape)
    y = torch.broadcast_to(torch.as_tensor(y_end, **like), a.shape[1:])
    return a, b, y


def _is_zero(y_end) -> bool:
    return isinstance(y_end, (int, float)) and y_end == 0.0


def _doubling(a, b, reverse: bool):
    """Log-depth composition: row t ends as y_t with a zero boundary."""
    T = a.shape[0]
    k = 1
    while k < T:
        if reverse:     # row t composes with row t + k
            a_sh = torch.cat([a[k:], torch.zeros_like(a[:k])])
            b_sh = torch.cat([b[k:], torch.ones_like(b[:k])])
        else:           # row t composes with row t - k
            a_sh = torch.cat([torch.zeros_like(a[:k]), a[:-k]])
            b_sh = torch.cat([torch.ones_like(b[:k]), b[:-k]])
        a = a + b * a_sh
        b = b * b_sh
        k *= 2
    return a


def _sequential(a, b, y, order):
    ys = [None] * a.shape[0]
    for t in order:
        y = a[t] + b[t] * y
        ys[t] = y
    return torch.stack(ys)


def linear_recurrence_reverse(a, b, y_last=0.0,
                              method: Method = "auto") -> torch.Tensor:
    """Solve y_t = a_t + b_t * y_{t+1} backwards in time.

    a: (T, ...) additive terms; b: coefficients broadcastable to a; y_last:
    the terminal value y_T (scalar or broadcastable to a[0]).  Returns
    y_0..y_{T-1}, shaped like a."""
    method = _resolve(method, a, b, y_last)
    a, b, y = _operands(a, b, y_last)
    if method == "pallas":
        return linear_scan_reverse(a, b, y_last)
    if method == "scan":
        return _sequential(a, b, y, range(a.shape[0] - 1, -1, -1))
    if not _is_zero(y_last):    # fold the terminal value into a[T-1]
        a = torch.cat([a[:-1], (a[-1] + b[-1] * y)[None]])
    return _doubling(a, b, reverse=True)


def linear_recurrence_forward(a, b, y_first=0.0,
                              method: Method = "auto") -> torch.Tensor:
    """Solve y_t = a_t + b_t * y_{t-1} forwards in time, y_{-1} = y_first
    (the dual of the reverse recurrence; also n-step discounted sums)."""
    method = _resolve(method, a, b, y_first)
    a, b, y = _operands(a, b, y_first)
    if method == "pallas":
        return linear_scan_forward(a, b, y_first)
    if method == "scan":
        return _sequential(a, b, y, range(a.shape[0]))
    if not _is_zero(y_first):   # fold the initial value into a[0]
        a = torch.cat([(a[0] + b[0] * y)[None], a[1:]])
    return _doubling(a, b, reverse=False)


def gae_denominators(T: int, lambda_: float, dtype=torch.float32,
                     device="cuda") -> torch.Tensor:
    """Closed form of the reference's coupled denominator recurrence.

    The reference updates `denom = 1 + lambda*denom` once per backward step,
    starting from 0, so at output index t the denominator has been updated
    T - t times: denom_t = sum_{k=0}^{T-t-1} lambda^k.  Cumulative products
    and sums keep it right at lambda = 1, where a geometric closed form
    divides by 1 - lambda.  Returns (T,) on `device`."""
    ones = torch.ones(1, dtype=dtype, device=device)
    if T > 1:
        lam = torch.full((T - 1,), lambda_, dtype=dtype, device=device)
        powers = torch.cat([ones, torch.cumprod(lam, 0)])
    else:
        powers = ones
    return torch.cumsum(powers, 0).flip(0)
