"""Fused LayerNorm-LSTM, the counterpart of the JAX package's
network/lstm.py.

Per layer: the input projection x @ Wx for the WHOLE sequence is one large
`torch.matmul` (the same hoist the JAX package leaves to XLA), and the
sequential part -- h @ Wh, both LayerNorms, the bias, the gate activations
and the state update -- runs in the whole-layer kernel
(kernels.lstm_layer_fused), on the card for CUDA tensors and as its plain
version on the CPU.  Gate order (i, f, o, u), the (in, 4H) weight layout and
the parameter tuple are shared with the oracle (origin.rnn).

As in the JAX package, a layer takes the recurrent path instead -- the
two-pass LayerNorm and the bias over the whole gx, then a per-step loop of
h @ Wh, LayerNorm, the gates and the state update in the stream dtype --
wherever the kernel cannot take it, so that the op gives an answer for any
H and any float dtype:
  - `remat=True` (each step then runs under torch.utils.checkpoint, so the
    backward recomputes the cell activations instead of keeping them);
  - Wh's dtype differs from the projection's;
  - streams other than float32 and bf16 (float16, say), on either device,
    as the JAX op routes them;
  - and, for CUDA tensors, wherever the kernel library cannot launch the
    layer (`layer_route`): the forward's shared memory beyond the card's
    per-CTA limit, and, when a gradient is needed, H % 4 != 0 or the
    backward that B selects (V2 from kernels.V2_MIN_BATCH rows up, else
    V1) beyond that limit.
The rule reads the library's own sizing exports, by shape and dtype; the
TPU kernel's gates (H % 128, VMEM, S >= 8) are the TPU's and are not
carried over.  Any other CPU call takes the kernel wrapper, which runs its
plain version there: the same function as the recurrent path, up to
rounding.  The kernel wrappers themselves never fall back: called
directly, they raise on what they cannot take.  `lstm_fused.routes`
counts the layers that took each path ({"kernel": n, "recurrent": n};
`reset_route_counts` zeroes it).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels import _build
from ..kernels.lstm_cell import (STREAM_DTYPES, V2_MIN_BATCH,
                                 lstm_layer_fused, v1_launch_shape)
from ..ops._validate import _fail
from ..origin.rnn import (LSTMParams, dropout_mask, init_lstm_params,
                          layer_norm)

__all__ = [
    "lstm_fused", "LSTM", "LSTMWeights", "LSTMParams", "init_lstm_params",
    "flatten_lstm_params", "unflatten_lstm_params", "layer_route",
    "reset_route_counts",
]

_LN_FIELDS = ("ln_gamma_x", "ln_beta_x", "ln_gamma_h", "ln_beta_h")


def flatten_lstm_params(params: LSTMParams):
    """Export params to the reference's flattened layout: wx/wh/bias are
    flat 1-D concatenations over layers; LN params are (L, 8H) packing
    [x-norm 4H | h-norm 4H].  Returns (wx, wh, bias, ln_gamma, ln_beta); LN
    entries are None for no-norm params."""
    wx = torch.cat([w.reshape(-1) for w in params.wx])
    wh = torch.cat([w.reshape(-1) for w in params.wh])
    bias = params.bias.reshape(-1)
    if params.ln_gamma_x is None:
        return wx, wh, bias, None, None
    ln_gamma = torch.cat([params.ln_gamma_x, params.ln_gamma_h], dim=1)
    ln_beta = torch.cat([params.ln_beta_x, params.ln_beta_h], dim=1)
    return wx, wh, bias, ln_gamma, ln_beta


def unflatten_lstm_params(wx, wh, bias, ln_gamma, ln_beta,
                          input_size: int, hidden_size: int,
                          num_layers: int) -> LSTMParams:
    """Import params from the reference's flattened layout (inverse of
    flatten_lstm_params)."""
    H = hidden_size
    dims = [input_size] + [H] * num_layers
    wx_l, off = [], 0
    for l in range(num_layers):
        n = dims[l] * 4 * H
        wx_l.append(wx[off:off + n].reshape(dims[l], 4 * H))
        off += n
    wh_l = [wh[l * H * 4 * H:(l + 1) * H * 4 * H].reshape(H, 4 * H)
            for l in range(num_layers)]
    bias_a = bias.reshape(num_layers, 4 * H)
    if ln_gamma is None:
        return LSTMParams(tuple(wx_l), tuple(wh_l), bias_a,
                          None, None, None, None)
    return LSTMParams(tuple(wx_l), tuple(wh_l), bias_a,
                      ln_gamma[:, :4 * H], ln_beta[:, :4 * H],
                      ln_gamma[:, 4 * H:], ln_beta[:, 4 * H:])


def _matmul(a, b, out_dtype):
    """a @ b computed in the two operands' promoted dtype and returned in
    out_dtype, as jnp.einsum(..., preferred_element_type=out_dtype) on
    mixed inputs (torch.matmul takes one dtype).  Matching dtypes skip the
    casts: the serving step is host-bound, and each cast is a call."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    y = torch.matmul(a, b)
    return y if y.dtype == out_dtype else y.to(out_dtype)


def _step(h, c, gx_t, wh, g_h, b_h):
    """One step of the recurrent path (di_hpc_tpu/network/lstm.py:159-172):
    returns (h, c)."""
    gh = _matmul(h, wh, torch.promote_types(h.dtype, wh.dtype))
    if g_h is not None:
        gh = layer_norm(gh, g_h, b_h)
    i, f, o, u = torch.chunk(gx_t + gh, 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(u)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def _recurrent_layer(gxp, wh, g_x, b_x, g_h, b_h, bias, h, c, remat):
    """The JAX package's scan path for one layer (its network/lstm.py:
    154-179): the two-pass LayerNorm and the bias over the whole gx, then
    the per-step loop, each step under torch.utils.checkpoint with remat.
    Every op runs in the promoted dtype of its operands, as JAX promotes
    them (bf16 when all are bf16).  Returns (y (S, B, H), h_n, c_n)."""
    gx = gxp if g_x is None else layer_norm(gxp, g_x, b_x)
    gx = gx + bias
    ys = []
    for gx_t in gx:
        if remat:
            h, c = checkpoint(_step, h, c, gx_t, wh, g_h, b_h,
                              use_reentrant=False)
        else:
            h, c = _step(h, c, gx_t, wh, g_h, b_h)
        ys.append(h)
    return torch.stack(ys), h, c


def layer_route(B: int, H: int, dtype: torch.dtype, grad: bool,
                smem_limit: int) -> str:
    """"kernel" where the kernel library can launch a layer of batch B,
    hidden size H and stream dtype `dtype` on a card whose CTAs may take
    `smem_limit` bytes of shared memory -- the forward, and with `grad` the
    backward that B selects -- else "recurrent".  Reads the library's sizing
    exports: the forward's least plan (lstm_layer_smem_bytes), V2's
    (lstm_layer_bwd_v2_smem_bytes) and V1's (v1_launch_shape)."""
    if dtype not in STREAM_DTYPES:
        return "recurrent"
    item = torch.finfo(dtype).bits // 8
    lib = _build.library().cdll
    if lib.lstm_layer_smem_bytes(H, item) > smem_limit:
        return "recurrent"
    if grad:
        if H % 4:
            return "recurrent"
        need = (lib.lstm_layer_bwd_v2_smem_bytes(H, item)
                if B >= V2_MIN_BATCH
                else v1_launch_shape(B, H, item)["smem_bytes"])
        if need > smem_limit:
            return "recurrent"
    return "kernel"


def _route(remat, gxp, wh, layer_args) -> str:
    """The path of one layer (module docstring)."""
    if remat or wh.dtype != gxp.dtype or gxp.dtype not in STREAM_DTYPES:
        return "recurrent"
    if _build.on_cpu(gxp, wh):
        return "kernel"
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in layer_args)
    props = torch.cuda.get_device_properties(gxp.device)
    return layer_route(gxp.shape[1], wh.shape[0], gxp.dtype, grad,
                       getattr(props, "shared_memory_per_block_optin",
                               232448))


def lstm_fused(
    params: LSTMParams,
    inputs: torch.Tensor,                                    # (S, B, in)
    prev_state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    norm_type: Optional[str] = "LN",
    dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,
    remat: bool = False,
):
    """Returns (output (S, B, H), (h (L, B, H), c (L, B, H))).

    Inter-layer dropout draws from `generator`, which must live on the
    inputs' device.  Each layer takes the kernel or the recurrent path by
    the module docstring's rule: `remat=True`, Wh in another dtype than the
    input projection, a stream dtype other than float32 and bf16, or (CUDA)
    a shape that the kernel library cannot launch takes the recurrent
    path."""
    if inputs.ndim != 3:
        _fail("lstm_fused",
              f"inputs must be (S, B, input_size); got {tuple(inputs.shape)}")
    S, B = inputs.shape[:2]
    L = len(params.wx)
    H = params.wh[0].shape[0]
    if inputs.shape[2] != params.wx[0].shape[0]:
        _fail("lstm_fused",
              f"inputs feature dim {inputs.shape[2]} != layer-0 wx input dim "
              f"{params.wx[0].shape[0]}")
    if prev_state is None:
        zeros = torch.zeros((L, B, H), dtype=inputs.dtype,
                            device=inputs.device)
        prev_state = (zeros, zeros)
    H0, C0 = prev_state
    if tuple(H0.shape) != (L, B, H) or tuple(C0.shape) != (L, B, H):
        _fail("lstm_fused",
              f"prev_state tensors must have shape (L, B, H) = {(L, B, H)}; "
              f"got {tuple(H0.shape)} and {tuple(C0.shape)}")

    x = inputs
    hs, cs = [], []
    for l in range(L):
        gxp = _matmul(x, params.wx[l], x.dtype)      # (S, B, 4H), hoisted
        wh = params.wh[l]
        if norm_type == "LN":
            g_x, b_x = params.ln_gamma_x[l], params.ln_beta_x[l]
            g_h, b_h = params.ln_gamma_h[l], params.ln_beta_h[l]
        else:
            g_x = b_x = g_h = b_h = None
        route = _route(remat, gxp, wh, (gxp, wh, g_x, b_x, g_h, b_h,
                                        params.bias[l], H0[l], C0[l]))
        lstm_fused.routes[route] += 1
        if route == "recurrent":
            x, h_l, c_l = _recurrent_layer(gxp, wh, g_x, b_x, g_h, b_h,
                                           params.bias[l], H0[l], C0[l],
                                           remat)
        else:
            if g_x is None:
                g_x = g_h = torch.ones_like(params.bias[l])
                b_x = b_h = torch.zeros_like(params.bias[l])
            x, h_l, c_l = lstm_layer_fused(
                gxp, wh, g_x, b_x, g_h, b_h, params.bias[l],
                H0[l].to(gxp.dtype).contiguous(),
                C0[l].to(gxp.dtype).contiguous(), norm_type == "LN")
        hs.append(h_l)
        cs.append(c_l)
        if dropout > 0.0 and l != L - 1:
            x = dropout_mask(x, dropout, generator)
    return x, (torch.stack(hs), torch.stack(cs))


lstm_fused.routes = {"kernel": 0, "recurrent": 0}


def reset_route_counts() -> None:
    lstm_fused.routes = {"kernel": 0, "recurrent": 0}


class LSTMWeights(nn.Module):
    """The LSTM's parameters as an nn.Module, field for field the
    LSTMParams tuple (LN fields are None without LayerNorm)."""

    def __init__(self, params: LSTMParams):
        super().__init__()
        self.wx = nn.ParameterList([nn.Parameter(w) for w in params.wx])
        self.wh = nn.ParameterList([nn.Parameter(w) for w in params.wh])
        self.bias = nn.Parameter(params.bias)
        for name in _LN_FIELDS:
            value = getattr(params, name)
            self.register_parameter(
                name, None if value is None else nn.Parameter(value))

    def params(self) -> LSTMParams:
        return LSTMParams(tuple(self.wx), tuple(self.wh), self.bias,
                          *(getattr(self, name) for name in _LN_FIELDS))


class LSTM(LSTMWeights):
    """Shape-static module mirroring the reference module API: constructed
    with (seq_len, batch_size, input_size, hidden_size, num_layers); the
    weights are drawn from `generator` (a CPU generator) and placed on
    `device`."""

    def __init__(self, seq_len: int, batch_size: int, input_size: int,
                 hidden_size: int, num_layers: int,
                 norm_type: Optional[str] = "LN", dropout: float = 0.0, *,
                 generator: torch.Generator, device="cuda"):
        super().__init__(init_lstm_params(generator, input_size, hidden_size,
                                          num_layers, norm_type,
                                          device=device))
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.norm_type = norm_type
        self.dropout = dropout

    def forward(self, inputs, prev_state=None, generator=None):
        want = (self.seq_len, self.batch_size, self.input_size)
        if tuple(inputs.shape) != want:
            _fail("LSTM", f"inputs must be {want}; got {tuple(inputs.shape)}")
        return lstm_fused(self.params(), inputs, prev_state, self.norm_type,
                          self.dropout if self.training else 0.0, generator)
