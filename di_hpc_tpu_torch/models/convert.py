"""Weight carry-over between the JAX package and the port.

The JAX package keeps its parameters as NamedTuples of arrays
(ActorCriticParams, LSTMParams, EntitySelectionParams, the AlphaStar
example's Params in examples/alphastar_policy_training.py:35-43 and the
R2D2 example's R2D2Params in examples/r2d2_training.py:33-38).
Converted to numpy (for example `jax.tree.map(np.asarray, params)`, which
keeps the tuples), they load into the port's modules unchanged: both keep
the (in, out) weight layout and the gate orders (i, f, o, u in the LSTM
layers, torch's i, f, g, o in the selection head's cell).  This module
reads the tuples by field name and imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..network.lstm import LSTMWeights
from ..origin.rnn import LSTMParams
from .actor_critic_lstm import ActorCriticParams
from .entity_selection import EntitySelectionParams

__all__ = ["ActorCriticArrays", "EntitySelectionArrays", "AlphaStarArrays",
           "AlphaStarParams", "R2D2Arrays", "R2D2Params", "from_jax_params",
           "to_numpy_params"]

_AC_FIELDS = ("embed_w", "embed_b", "lstm", "policy_w", "policy_b",
              "value_w", "value_b")
_SEL_FIELDS = ("w_ih", "w_hh", "bias", "w_query")
_AS_FIELDS = ("ent_w", "ent_b", "spatial_w", "core", "act_w", "val_w",
              "ae_w", "sel")
_R2D2_FIELDS = ("embed_w", "embed_b", "lstm", "q_w", "q_b")


class ActorCriticArrays(NamedTuple):
    """ActorCriticParams as numpy arrays, field for field the JAX tuple."""
    embed_w: np.ndarray
    embed_b: np.ndarray
    lstm: LSTMParams
    policy_w: np.ndarray
    policy_b: np.ndarray
    value_w: np.ndarray
    value_b: np.ndarray


class EntitySelectionArrays(NamedTuple):
    """EntitySelectionParams as numpy arrays, field for field the JAX
    tuple."""
    w_ih: np.ndarray
    w_hh: np.ndarray
    bias: np.ndarray
    w_query: np.ndarray


class AlphaStarArrays(NamedTuple):
    """The AlphaStar example's Params as numpy arrays, field for field."""
    ent_w: np.ndarray               # (De, N) entity encoder
    ent_b: np.ndarray               # (N,)
    spatial_w: np.ndarray           # (N*H*W, F) spatial summary
    core: LSTMParams                # one LN-LSTM layer, N+F -> Hc
    act_w: np.ndarray               # (Hc, A) action-type head
    val_w: np.ndarray               # (Hc,)
    ae_w: np.ndarray                # (Hc, N) core output -> initial embedding
    sel: EntitySelectionArrays


class AlphaStarParams(nn.Module):
    """The AlphaStar example's Params as an nn.Module, with its field names:
    the tensors are parameters, `core` an LSTMWeights, `sel` an
    EntitySelectionParams."""

    def __init__(self, ent_w, ent_b, spatial_w, core: LSTMWeights, act_w,
                 val_w, ae_w, sel: EntitySelectionParams):
        super().__init__()
        self.ent_w = nn.Parameter(ent_w)
        self.ent_b = nn.Parameter(ent_b)
        self.spatial_w = nn.Parameter(spatial_w)
        self.core = core
        self.act_w = nn.Parameter(act_w)
        self.val_w = nn.Parameter(val_w)
        self.ae_w = nn.Parameter(ae_w)
        self.sel = sel


class R2D2Arrays(NamedTuple):
    """The R2D2 example's R2D2Params as numpy arrays, field for field."""
    embed_w: np.ndarray             # (obs_dim, hidden)
    embed_b: np.ndarray             # (hidden,)
    lstm: LSTMParams                # the LN-LSTM core, hidden -> hidden
    q_w: np.ndarray                 # (hidden, actions)
    q_b: np.ndarray                 # (actions,)


class R2D2Params(nn.Module):
    """The R2D2 example's R2D2Params as an nn.Module, with its field names:
    the tensors are parameters, `lstm` an LSTMWeights."""

    def __init__(self, embed_w, embed_b, lstm: LSTMWeights, q_w, q_b):
        super().__init__()
        self.embed_w = nn.Parameter(embed_w)
        self.embed_b = nn.Parameter(embed_b)
        self.lstm = lstm
        self.q_w = nn.Parameter(q_w)
        self.q_b = nn.Parameter(q_b)


def _tensor(a, device):
    """A float32 tensor, or a bfloat16 one for a bf16 array: numpy has no
    bfloat16 of its own (JAX's arrays come out as ml_dtypes.bfloat16), so
    its bits are carried over through a uint16 view."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(a.view(np.uint16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.tensor(a, dtype=torch.float32, device=device)


def _lstm_from(tree, device) -> LSTMParams:
    def opt(a):
        return None if a is None else _tensor(a, device)

    return LSTMParams(tuple(_tensor(w, device) for w in tree.wx),
                      tuple(_tensor(w, device) for w in tree.wh),
                      _tensor(tree.bias, device),
                      opt(tree.ln_gamma_x), opt(tree.ln_beta_x),
                      opt(tree.ln_gamma_h), opt(tree.ln_beta_h))


def from_jax_params(tree, device="cuda"):
    """numpy ActorCriticParams -> ActorCriticParams module; the AlphaStar
    example's Params -> AlphaStarParams; R2D2Params -> R2D2Params module;
    EntitySelectionParams -> EntitySelectionParams module; LSTMParams ->
    LSTMWeights module.  Float32 on `device`, bf16 where the array is
    bf16."""
    if hasattr(tree, "q_w"):
        return R2D2Params(
            *(from_jax_params(tree.lstm, device) if f == "lstm"
              else _tensor(getattr(tree, f), device) for f in _R2D2_FIELDS))
    if hasattr(tree, "embed_w"):
        return ActorCriticParams(
            *(_lstm_from(tree.lstm, device) if f == "lstm"
              else _tensor(getattr(tree, f), device) for f in _AC_FIELDS))
    if hasattr(tree, "ent_w"):
        return AlphaStarParams(
            *(from_jax_params(getattr(tree, f), device) if f in ("core", "sel")
              else _tensor(getattr(tree, f), device) for f in _AS_FIELDS))
    if hasattr(tree, "w_query"):
        return EntitySelectionParams(
            *(_tensor(getattr(tree, f), device) for f in _SEL_FIELDS))
    return LSTMWeights(_lstm_from(tree, device))


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def to_numpy_params(module):
    """The inverse of from_jax_params: ActorCriticParams ->
    ActorCriticArrays, AlphaStarParams -> AlphaStarArrays, R2D2Params ->
    R2D2Arrays, EntitySelectionParams -> EntitySelectionArrays, LSTMWeights ->
    LSTMParams of numpy arrays (None kept for absent LN fields)."""
    if isinstance(module, ActorCriticParams):
        return ActorCriticArrays(
            *(to_numpy_params(module.lstm) if f == "lstm"
              else _np(getattr(module, f)) for f in _AC_FIELDS))
    if isinstance(module, AlphaStarParams):
        return AlphaStarArrays(
            *(to_numpy_params(getattr(module, f)) if f in ("core", "sel")
              else _np(getattr(module, f)) for f in _AS_FIELDS))
    if isinstance(module, R2D2Params):
        return R2D2Arrays(
            *(to_numpy_params(module.lstm) if f == "lstm"
              else _np(getattr(module, f)) for f in _R2D2_FIELDS))
    if isinstance(module, EntitySelectionParams):
        return EntitySelectionArrays(
            *(_np(getattr(module, f)) for f in _SEL_FIELDS))
    p = module.params()
    return LSTMParams(tuple(_np(w) for w in p.wx), tuple(_np(w) for w in p.wh),
                      _np(p.bias), *(_np(x) for x in p[3:]))
