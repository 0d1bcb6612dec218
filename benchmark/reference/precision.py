"""Matrix products of the reference at a stated precision.

"float32" is a plain float32 product (the reference turns TF32 off).  The
lower precisions, which the controls use, round both operands of every
product, forward and backward, before a float32 product: "tf32" to 10
mantissa bits, "bfloat16" to 7.  "float8" is the usual fp8 recipe:
weights and activations in e4m3, the gradients that flow backward in
e5m2, each tensor under a scale that maps its largest magnitude to the
format's largest number.  The rounding is done by bit arithmetic or
PyTorch's casts, so the CPU and the card give the same result.
"""

from __future__ import annotations

import torch

MANTISSA_BITS = {"tf32": 10, "bfloat16": 7}
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """float32 `x` rounded to `bits` mantissa bits, to nearest even."""
    drop = 23 - bits
    i = x.float().contiguous().view(torch.int32)
    lsb = (i >> drop) & 1
    i = (i + ((1 << (drop - 1)) - 1) + lsb) & ~((1 << drop) - 1)
    return i.view(torch.float32)


def round_float8(x: torch.Tensor, fmt=torch.float8_e4m3fn) -> torch.Tensor:
    """float32 `x` through the float8 format `fmt` under a per-tensor
    scale."""
    x = x.float()
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax / FP8_MAX[fmt], torch.ones_like(amax))
    return (x / scale).to(fmt).float() * scale


def rounders(precision: str):
    """(rounding of the forward's operands, of the backward's gradients),
    or None for plain float32."""
    if precision == "float32":
        return None
    if precision == "float8":
        return round_float8, lambda g: round_float8(g, torch.float8_e5m2)
    if precision in MANTISSA_BITS:
        bits = MANTISSA_BITS[precision]
        rnd = lambda x: round_mantissa(x, bits)
        return rnd, rnd
    raise ValueError(f"unknown precision {precision!r}")


class _RoundedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, rnd, rnd_grad):
        ctx.save_for_backward(a, b)
        ctx.rnd, ctx.rnd_grad = rnd, rnd_grad
        return rnd(a) @ rnd(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        rnd = ctx.rnd
        g = ctx.rnd_grad(g)
        return (g @ rnd(b).transpose(-1, -2), rnd(a).transpose(-1, -2) @ g,
                None, None)


def matmul(precision: str):
    """`mm(a, b)`: a (..., K) @ b (K, N) at `precision`."""
    rnd = rounders(precision)
    if rnd is None:
        return torch.matmul

    def mm(a, b):
        lead = a.shape[:-1]
        out = _RoundedMatmul.apply(a.reshape(-1, a.shape[-1]), b, *rnd)
        return out.reshape(*lead, b.shape[-1])
    return mm


def no_tf32() -> None:
    """Plain float32 products on the card: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
