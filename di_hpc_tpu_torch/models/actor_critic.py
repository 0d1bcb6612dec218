"""AlphaStar autoregressive policy-head helpers in plain PyTorch, the
counterpart of the JAX package's models/actor_critic.py.  Like the JAX
versions, every op returns new tensors instead of mutating the caller's."""

from __future__ import annotations

import torch

from ..utils.constants import PRE_SAMPLE_DIV_FACTOR, PRE_SAMPLE_MASK_VALUE

__all__ = ["update_ae", "lstm_activation", "pre_sample"]


def update_ae(autoregressive_embedding: torch.Tensor,  # (B, D)
              key_embeddings: torch.Tensor,            # (B, M, D)
              sample_entity: torch.Tensor,             # (B,) int
              entity_num: torch.Tensor,                # (B,) int
              ) -> torch.Tensor:
    """ae[b] + key_embeddings[b, sample_entity[b]], unless the sampled entity
    equals entity_num[b] (the end flag).  An index that matches no row adds
    nothing, as the JAX package's iota-compare gather does."""
    rows = torch.arange(key_embeddings.shape[1],
                        device=key_embeddings.device)
    hit = ((rows == sample_entity[:, None])
           & (sample_entity != entity_num)[:, None])
    ke = torch.where(hit[..., None], key_embeddings,
                     torch.zeros((), dtype=key_embeddings.dtype,
                                 device=key_embeddings.device)).sum(dim=1)
    return autoregressive_embedding + ke


def lstm_activation(in_x: torch.Tensor,   # (B, 4H) precomputed x @ W_ih
                    in_h: torch.Tensor,   # (B, 4H) precomputed h @ W_hh
                    bias: torch.Tensor,   # (4H,)   b_ih + b_hh
                    h: torch.Tensor,      # (B, H)  unused; kept for the API
                    c: torch.Tensor):     # (B, H)
    """One LSTM cell activation in torch.nn.LSTM's gate order i, f, g, o
    (not the network LSTM's i, f, o, u).  Returns (h_new, c_new)."""
    i, f, g, o = torch.chunk(in_x + in_h + bias, 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def pre_sample(mat: torch.Tensor,    # (B, M, H) entity keys
               vec: torch.Tensor,    # (B, H) query
               mask: torch.Tensor,   # (B, M) bool
               mask_value: float = PRE_SAMPLE_MASK_VALUE,
               div_factor: float = PRE_SAMPLE_DIV_FACTOR) -> torch.Tensor:
    """Masked scaled dot-product logits: out[b, m] = <mat[b, m], vec[b]> /
    div where mask, else mask_value / div."""
    logits = torch.bmm(mat, vec[..., None])[..., 0] / div_factor
    return torch.where(mask, logits,
                       torch.full((), mask_value / div_factor,
                                  dtype=logits.dtype, device=logits.device))
