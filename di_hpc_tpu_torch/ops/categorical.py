"""Categorical head: log-prob of the taken action and entropy, in plain
PyTorch.

The JAX package leaves this head to XLA fusion and has no Pallas kernel for
it (di_hpc_tpu/ops/categorical.py records why), so the port computes it with
ordinary tensor ops; a hand-written kernel comes only if a measurement shows
it pays.  Gradients are PyTorch's autograd through these ops; the JAX
package's stash-free backward is part of the training slice (ROADMAP.md).

Masked-logit contract (the same as the JAX package's): logits <= -1e9,
-inf included, are masked-invalid.  Data is clamped at -1e9 before the
reduction, so a masked logit has probability exactly 0 in every statistic,
and a masked TAKEN action's logp is finite (about -1e9 - lse), never -inf.
"""

from __future__ import annotations

import torch

from ..utils.constants import MASKED_LOGIT

__all__ = ["logp_entropy", "logp"]


def _stats(logits: torch.Tensor, actions: torch.Tensor, with_ent: bool):
    x = torch.clamp_min(logits.float(), MASKED_LOGIT)
    m = x.amax(dim=-1, keepdim=True)
    e = torch.exp(x - m)
    s = e.sum(dim=-1)
    lse = m[..., 0] + torch.log(s)
    xa = torch.gather(x, -1, actions.long()[..., None])[..., 0]
    if not with_ent:
        return xa - lse, None
    ent = lse - (e * x).sum(dim=-1) / s
    return xa - lse, ent


def logp_entropy(logits: torch.Tensor, actions: torch.Tensor):
    """(..., N) logits + (...) integer actions -> (logp_action, entropy),
    each shaped (...), float32."""
    return _stats(logits, actions, with_ent=True)


def logp(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """Log-prob of the taken action only (the behaviour policy's side of
    V-trace, whose entropy is never needed)."""
    return _stats(logits, actions, with_ent=False)[0]
