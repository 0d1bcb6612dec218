"""Fused LayerNorm-LSTM, the counterpart of the JAX package's
network/lstm.py.

Per layer: the input projection x @ Wx for the WHOLE sequence is one large
`torch.matmul` (the same hoist the JAX package leaves to XLA), and the
sequential part -- h @ Wh, both LayerNorms, the bias, the gate activations
and the state update -- runs in the whole-layer kernel
(kernels.lstm_layer_fused), on the card for CUDA tensors and as its plain
version on the CPU.  Gate order (i, f, o, u), the (in, 4H) weight layout and
the parameter tuple are shared with the oracle (origin.rnn).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..kernels.lstm_cell import lstm_layer_fused
from ..ops._validate import _fail
from ..origin.rnn import LSTMParams, dropout_mask, init_lstm_params

__all__ = [
    "lstm_fused", "LSTM", "LSTMWeights", "LSTMParams", "init_lstm_params",
    "flatten_lstm_params", "unflatten_lstm_params",
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


def lstm_fused(
    params: LSTMParams,
    inputs: torch.Tensor,                                    # (S, B, in)
    prev_state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    norm_type: Optional[str] = "LN",
    dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,
):
    """Returns (output (S, B, H), (h (L, B, H), c (L, B, H))).

    Inter-layer dropout draws from `generator`, which must live on the
    inputs' device."""
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
        gxp = torch.matmul(x, params.wx[l])          # (S, B, 4H), hoisted
        if norm_type == "LN":
            g_x, b_x = params.ln_gamma_x[l], params.ln_beta_x[l]
            g_h, b_h = params.ln_gamma_h[l], params.ln_beta_h[l]
        else:
            g_x = g_h = torch.ones_like(params.bias[l])
            b_x = b_h = torch.zeros_like(params.bias[l])
        x, h_l, c_l = lstm_layer_fused(
            gxp, params.wh[l], g_x, b_x, g_h, b_h, params.bias[l],
            H0[l].contiguous(), C0[l].contiguous(), norm_type == "LN")
        hs.append(h_l)
        cs.append(c_l)
        if dropout > 0.0 and l != L - 1:
            x = dropout_mask(x, dropout, generator)
    return x, (torch.stack(hs), torch.stack(cs))


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
