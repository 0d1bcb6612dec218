"""LayerNorm-LSTM oracle in plain PyTorch (naive per-step formulation), the
counterpart of the JAX package's origin/rnn.py.

Each step of each layer computes

    gate = LN_x(x_t @ Wx) + LN_h(h @ Wh) + bias
    i, f, o, u = split(gate, 4); i,f,o = sigmoid; u = tanh
    c = f*c + i*u;  h = o*tanh(c)

Gate order is i, f, o, u, and weights are laid out (in, 4H) -- not
torch.nn.Linear's (out, in) -- so that parameters exported from the JAX
package load unchanged.  LayerNorm statistics here use two passes; the
fused kernel (kernels/lstm_cell.py) uses one clamped pass, as its TPU
counterpart does.

This module owns the parameter tuple shared with network/lstm.py.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.constants import LAYERNORM_EPS


class LSTMParams(NamedTuple):
    """Per-layer weight tuples; LN params are None when norm_type is None."""
    wx: Tuple[torch.Tensor, ...]        # layer l: (dims[l], 4H)
    wh: Tuple[torch.Tensor, ...]        # layer l: (H, 4H)
    bias: torch.Tensor                  # (L, 4H)
    ln_gamma_x: Optional[torch.Tensor]  # (L, 4H)
    ln_beta_x: Optional[torch.Tensor]   # (L, 4H)
    ln_gamma_h: Optional[torch.Tensor]  # (L, 4H)
    ln_beta_h: Optional[torch.Tensor]   # (L, 4H)


def init_lstm_params(
    generator: torch.Generator,
    input_size: int,
    hidden_size: int,
    num_layers: int,
    norm_type: Optional[str] = "LN",
    dtype=torch.float32,
    device="cuda",
) -> LSTMParams:
    """uniform(-g, g) init with g = sqrt(1/hidden_size), LN at identity.

    The numbers are drawn on the CPU from `generator` (a CPU generator) and
    then moved to `device`, so a seed gives the same weights on any device.
    """
    assert norm_type in (None, "LN")
    gain = math.sqrt(1.0 / hidden_size)
    dims = [input_size] + [hidden_size] * num_layers

    def uniform(*shape):
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return (u * (2 * gain) - gain).to(device=device, dtype=dtype)

    wx = tuple(uniform(dims[l], 4 * hidden_size) for l in range(num_layers))
    wh = tuple(uniform(hidden_size, 4 * hidden_size)
               for _ in range(num_layers))
    bias = uniform(num_layers, 4 * hidden_size)
    if norm_type == "LN":
        def full(v):
            return torch.full((num_layers, 4 * hidden_size), v, dtype=dtype,
                              device=device)

        return LSTMParams(wx, wh, bias, full(1.0), full(0.0), full(1.0),
                          full(0.0))
    return LSTMParams(wx, wh, bias, None, None, None, None)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = LAYERNORM_EPS) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


def _cell_activation(gate: torch.Tensor, c: torch.Tensor):
    """Gate order i, f, o, u."""
    i, f, o, u = torch.chunk(gate, 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(u)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def dropout_mask(x: torch.Tensor, dropout: float,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - dropout and
    scale it by 1/(1 - dropout).  `generator` lives on x's device."""
    if generator is None:
        raise ValueError("dropout > 0 requires a torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=torch.float32) >= dropout
    return torch.where(keep, x / (1.0 - dropout), torch.zeros_like(x))


def lstm(
    params: LSTMParams,
    inputs: torch.Tensor,                                    # (S, B, in)
    prev_state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    norm_type: Optional[str] = "LN",
    dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,
):
    """Naive oracle forward: python loops over layers and time with
    per-step matmuls.  Returns (output (S, B, H), (h (L, B, H), c (L, B, H)))."""
    S, B = inputs.shape[:2]
    L = len(params.wx)
    H = params.wh[0].shape[0]
    if prev_state is None:
        zeros = torch.zeros((L, B, H), dtype=inputs.dtype,
                            device=inputs.device)
        prev_state = (zeros, zeros)
    H0, C0 = prev_state

    x = inputs
    hs, cs = [], []
    for l in range(L):
        h, c = H0[l], C0[l]
        ys = []
        for t in range(S):
            gx = x[t] @ params.wx[l]
            gh = h @ params.wh[l]
            if norm_type == "LN":
                gx = layer_norm(gx, params.ln_gamma_x[l], params.ln_beta_x[l])
                gh = layer_norm(gh, params.ln_gamma_h[l], params.ln_beta_h[l])
            h, c = _cell_activation(gx + gh + params.bias[l], c)
            ys.append(h)
        x = torch.stack(ys)
        hs.append(h)
        cs.append(c)
        if dropout > 0.0 and l != L - 1:
            x = dropout_mask(x, dropout, generator)
    return x, (torch.stack(hs), torch.stack(cs))


def get_lstm(lstm_type: str, input_size: int, hidden_size: int,
             num_layers: int = 1, norm_type: Optional[str] = "LN",
             dropout: float = 0.0):
    """Factory mirroring the reference get_lstm.

    Returns (init_fn(generator, device) -> params,
    apply_fn(params, inputs, prev_state, generator)) where 'normal' is this
    naive oracle and 'pytorch' a plain (no-LN) LSTM.
    """
    assert lstm_type in ("normal", "pytorch")
    nt = norm_type if lstm_type == "normal" else None

    def init_fn(generator, device="cuda"):
        return init_lstm_params(generator, input_size, hidden_size,
                                num_layers, nt, device=device)

    def apply_fn(params, inputs, prev_state=None, generator=None):
        return lstm(params, inputs, prev_state, nt, dropout, generator)

    return init_fn, apply_fn


def sequence_mask(lengths: torch.Tensor,
                  max_len: Optional[int] = None) -> torch.Tensor:
    """(B,) lengths -> (B, max_len) bool mask."""
    lengths = lengths.reshape(-1)
    if max_len is None:
        max_len = int(lengths.max())
    return (torch.arange(max_len, device=lengths.device)[None, :]
            < lengths[:, None])
