"""Autoregressive entity-selection head (AlphaStar selected-units style), the
counterpart of the JAX package's models/entity_selection.py.

At each step the head attends over the entity keys from the current
autoregressive embedding (pre_sample), picks an entity, folds its key back
into the embedding (update_ae) and advances a single LSTM cell
(lstm_activation).  Selection ends when the policy picks the sentinel index
`entity_num` (the "end" token).  The JAX package's `lax.scan` over a static
number of selections, with masking after termination, is a Python loop
here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .actor_critic import lstm_activation, pre_sample, update_ae

__all__ = ["EntitySelectionParams", "init_entity_selection",
           "select_entities"]


class EntitySelectionParams(nn.Module):
    """The head's parameters, with the JAX tuple's field names: w_ih (D, 4H)
    and w_hh (H, 4H) for the LSTM cell (torch gate order i, f, g, o), bias
    (4H,), w_query (H, Hk) from the cell's output to the attention query."""

    def __init__(self, w_ih, w_hh, bias, w_query):
        super().__init__()
        self.w_ih = nn.Parameter(w_ih)
        self.w_hh = nn.Parameter(w_hh)
        self.bias = nn.Parameter(bias)
        self.w_query = nn.Parameter(w_query)


def init_entity_selection(generator: torch.Generator, input_dim: int,
                          hidden: int, key_dim: int,
                          device="cuda") -> EntitySelectionParams:
    """Random init with the JAX package's scales.  The numbers are drawn on
    the CPU from `generator` (a CPU generator) and then moved to
    `device`."""
    def normal(*shape):
        return torch.randn(shape, generator=generator)

    s = 1.0 / hidden ** 0.5
    return EntitySelectionParams(
        (normal(input_dim, 4 * hidden) / input_dim ** 0.5).to(device),
        (normal(hidden, 4 * hidden) * s).to(device),
        torch.zeros(4 * hidden, device=device),
        (normal(hidden, key_dim) * s).to(device))


def select_entities(
    params: EntitySelectionParams,
    key_embeddings: torch.Tensor,      # (B, M, Dk)
    entity_mask: torch.Tensor,         # (B, M) bool: selectable entities
    entity_num: torch.Tensor,          # (B,) int: the end sentinel's index
    init_ae: torch.Tensor,             # (B, D) initial embedding
    lstm_state: Tuple[torch.Tensor, torch.Tensor],   # (h, c), each (B, H)
    max_selections: int,
    generator: Optional[torch.Generator] = None,     # sample if given
):
    """Returns (selected (S, B) int32, where entity_num[b] marks 'end';
    logits (S, B, M+1); the new LSTM state (h, c); the final autoregressive
    embedding (B, D)).  Greedy (argmax, first index on ties) without a
    generator; with one, each step samples from the softmax of its logits
    with that generator, which lives on the inputs' device.

    Column entity_num[b] is row b's end sentinel (a zero key): choosing it
    ends the row's selection, and every later step repeats it.  Padding
    entities at columns >= entity_num[b] are masked out and their keys
    zeroed; an entity is selected at most once, and the sentinel stays
    available at every step."""
    B, M, Dk = key_embeddings.shape
    dev = key_embeddings.device
    col = torch.arange(M + 1, device=dev).expand(B, M + 1)
    is_real = col < entity_num[:, None]
    is_sentinel = col == entity_num[:, None]
    keys_ext = torch.cat([key_embeddings,
                          key_embeddings.new_zeros((B, 1, Dk))], dim=1)
    keys_ext = torch.where(is_real[..., None], keys_ext,
                           keys_ext.new_zeros(()))
    mask_pad = torch.cat([entity_mask,
                          torch.ones((B, 1), dtype=torch.bool, device=dev)],
                         dim=1)
    avail = (is_real & mask_pad) | is_sentinel

    ae, (h, c) = init_ae, lstm_state
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    entity_num = entity_num.to(torch.int32)
    selected, logits_seq = [], []
    for _ in range(max_selections):
        h_new, c_new = lstm_activation(ae @ params.w_ih, h @ params.w_hh,
                                       params.bias, h, c)
        logits = pre_sample(keys_ext, h_new @ params.w_query, avail)
        if generator is None:
            choice = torch.argmax(logits, dim=-1)
        else:
            choice = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                       generator=generator)[:, 0]
        choice = torch.where(done, entity_num, choice.to(torch.int32))
        ae = update_ae(ae, key_embeddings, choice, entity_num)
        avail = avail & ((col != choice[:, None])
                         | (col == entity_num[:, None]))
        h = torch.where(done[:, None], h, h_new)
        c = torch.where(done[:, None], c, c_new)
        done = done | (choice == entity_num)
        selected.append(choice)
        logits_seq.append(logits)
    return torch.stack(selected), torch.stack(logits_seq), (h, c), ae
