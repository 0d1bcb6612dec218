"""Weight carry-over between the JAX package and the port.

The JAX package keeps its parameters as NamedTuples of arrays
(ActorCriticParams, LSTMParams).  Converted to numpy (for example
`jax.tree.map(np.asarray, params)`, which keeps the tuples), they load into
the port's modules unchanged: both keep the (in, out) weight layout and the
i, f, o, u gate order.  This module reads the tuples by field name and
imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..network.lstm import LSTMWeights
from ..origin.rnn import LSTMParams
from .actor_critic_lstm import ActorCriticParams

__all__ = ["ActorCriticArrays", "from_jax_params", "to_numpy_params"]

_AC_FIELDS = ("embed_w", "embed_b", "lstm", "policy_w", "policy_b",
              "value_w", "value_b")


class ActorCriticArrays(NamedTuple):
    """ActorCriticParams as numpy arrays, field for field the JAX tuple."""
    embed_w: np.ndarray
    embed_b: np.ndarray
    lstm: LSTMParams
    policy_w: np.ndarray
    policy_b: np.ndarray
    value_w: np.ndarray
    value_b: np.ndarray


def _tensor(a, device):
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)


def _lstm_from(tree, device) -> LSTMParams:
    def opt(a):
        return None if a is None else _tensor(a, device)

    return LSTMParams(tuple(_tensor(w, device) for w in tree.wx),
                      tuple(_tensor(w, device) for w in tree.wh),
                      _tensor(tree.bias, device),
                      opt(tree.ln_gamma_x), opt(tree.ln_beta_x),
                      opt(tree.ln_gamma_h), opt(tree.ln_beta_h))


def from_jax_params(tree, device="cuda"):
    """numpy ActorCriticParams -> ActorCriticParams module; numpy
    LSTMParams -> LSTMWeights module.  Float32 on `device`."""
    if hasattr(tree, "embed_w"):
        return ActorCriticParams(
            *(_lstm_from(tree.lstm, device) if f == "lstm"
              else _tensor(getattr(tree, f), device) for f in _AC_FIELDS))
    return LSTMWeights(_lstm_from(tree, device))


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def to_numpy_params(module):
    """ActorCriticParams -> ActorCriticArrays; LSTMWeights -> LSTMParams of
    numpy arrays (None kept for absent LN fields)."""
    if isinstance(module, ActorCriticParams):
        return ActorCriticArrays(
            *(to_numpy_params(module.lstm) if f == "lstm"
              else _np(getattr(module, f)) for f in _AC_FIELDS))
    p = module.params()
    return LSTMParams(tuple(_np(w) for w in p.wx), tuple(_np(w) for w in p.wh),
                      _np(p.bias), *(_np(x) for x in p[3:]))
