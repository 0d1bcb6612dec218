"""Whole-layer LN-LSTM forward: the hand-written Hopper kernel
(csrc/lstm_layer.cu) and its plain PyTorch version.

Counterpart of the forward of di_hpc_tpu/pallas_kernels/lstm_cell.py
(`lstm_layer_fused`, `_layer_kernel`), same arguments and the same function:
the x-side LayerNorm and the bias act on the RAW x @ Wx projection, and both
LayerNorms take one-pass statistics clamped at zero variance.  The TPU
kernel's dispatch gates (VMEM budget, H % 128, S >= 8) are facts about the
TPU and are not carried over: the CUDA kernel takes any S >= 1 -- S = 1 is
the serving step -- and any H whose shared-memory plan fits one CTA.

This slice is forward-only: the c_seq stash, bf16 streams and the backward
kernels come with the training slice (ROADMAP.md).
"""

from __future__ import annotations

import torch

from ..utils.constants import LAYERNORM_EPS
from . import _build

__all__ = ["lstm_layer_fused", "lstm_layer_plain"]


def _ln_stats(x: torch.Tensor):
    """One-pass statistics, var clamped at 0 (lstm_cell.py:_ln_stats)."""
    m = x.mean(dim=-1, keepdim=True)
    m2 = (x * x).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(torch.clamp_min(m2 - m * m, 0.0) + LAYERNORM_EPS)
    return m, rstd


def _ln(x, gamma, beta):
    mean, rstd = _ln_stats(x)
    return (x - mean) * rstd * gamma + beta


def lstm_layer_plain(gxp, wh, glnx, blnx, gln, bln, bias, h0, c0,
                     norm: bool = True):
    """The kernel's function in plain PyTorch (ordinary autograd).
    Returns (y (S, B, H), h_n (B, H), c_n (B, H))."""
    H = wh.shape[0]
    h, c = h0, c0
    ys = []
    for t in range(gxp.shape[0]):
        gx = _ln(gxp[t], glnx, blnx) + bias if norm else gxp[t] + bias
        gh = h @ wh
        if norm:
            gh = _ln(gh, gln, bln)
        gate = gx + gh
        sfo = torch.sigmoid(gate[:, :3 * H])
        u = torch.tanh(gate[:, 3 * H:])
        c = sfo[:, H:2 * H] * c + sfo[:, :H] * u
        h = sfo[:, 2 * H:3 * H] * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys), h, c


def lstm_layer_fused(gxp, wh, glnx, blnx, gln, bln, bias, h0, c0,
                     norm: bool = True):
    """One LSTM layer over a full sequence, the time loop inside one kernel.

    Args:
      gxp: (S, B, 4H) RAW input projection x @ Wx.
      wh: (H, 4H) recurrent weights.
      glnx, blnx: (4H,) LayerNorm params for the x-projection.
      gln, bln: (4H,) LayerNorm params for the h-projection.
        (All four are ignored when norm=False -- pass ones/zeros.)
      bias: (4H,) gate bias.
      h0, c0: (B, H) initial state.

    CPU tensors run `lstm_layer_plain`; CUDA tensors launch the kernel
    (float32, contiguous) or raise.  Returns (y (S, B, H), h_n, c_n).
    """
    args = (gxp, wh, glnx, blnx, gln, bln, bias, h0, c0)
    if _build.on_cpu(*args):
        return lstm_layer_plain(*args, norm=norm)
    return _lstm_layer_cuda(*args, norm=norm)


lstm_layer_fused.launches = 0


def _lstm_layer_cuda(gxp, wh, glnx, blnx, gln, bln, bias, h0, c0, norm):
    name = "lstm_layer_fused"
    names = ("gxp", "wh", "glnx", "blnx", "gln", "bln", "bias", "h0", "c0")
    args = (gxp, wh, glnx, blnx, gln, bln, bias, h0, c0)
    _build.check_kernel_inputs(name, dict(zip(names, args)),
                               aligned=("gxp", "wh"))
    _build.forward_only(name, *args)
    if gxp.ndim != 3 or wh.ndim != 2:
        raise ValueError(f"{name}: gxp must be (S, B, 4H) and wh (H, 4H); got "
                         f"{tuple(gxp.shape)} and {tuple(wh.shape)}")
    S, B, G = gxp.shape
    H = wh.shape[0]
    if G != 4 * H or tuple(wh.shape) != (H, G) or S < 1 or B < 1:
        raise ValueError(f"{name}: gxp {tuple(gxp.shape)} and wh "
                         f"{tuple(wh.shape)} must be (S>=1, B>=1, 4H) and "
                         f"(H, 4H)")
    for arg, t in zip(names[2:7], args[2:7]):
        if tuple(t.shape) != (G,):
            raise ValueError(f"{name}: {arg} must be ({G},); got "
                             f"{tuple(t.shape)}")
    for arg, t in (("h0", h0), ("c0", c0)):
        if tuple(t.shape) != (B, H):
            raise ValueError(f"{name}: {arg} must be ({B}, {H}); got "
                             f"{tuple(t.shape)}")
    lib = _build.library().cdll
    smem = lib.lstm_layer_smem_bytes(H)
    props = torch.cuda.get_device_properties(gxp.device)
    limit = getattr(props, "shared_memory_per_block_optin", 232448)
    if smem > limit:
        raise ValueError(f"{name}: H={H} needs {smem} bytes of shared memory "
                         f"per CTA, over this card's {limit}")

    y = torch.empty((S, B, H), dtype=gxp.dtype, device=gxp.device)
    hn = torch.empty((B, H), dtype=gxp.dtype, device=gxp.device)
    cn = torch.empty_like(hn)
    with torch.cuda.device(gxp.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.lstm_layer_fwd_f32(
            *(t.data_ptr() for t in args), y.data_ptr(), hn.data_ptr(),
            cn.data_ptr(), S, B, H, int(bool(norm)), stream)
    _build.check_status(name, status)
    lstm_layer_fused.launches += 1
    return y, hn, cn
