"""Categorical head: log-prob of the taken action and entropy, in plain
PyTorch.

The JAX package leaves this head to XLA fusion and has no Pallas kernel for
it (di_hpc_tpu/ops/categorical.py records why), so the port computes it with
ordinary tensor ops; a hand-written kernel comes only if a measurement shows
it pays.  Both functions are torch.autograd.Functions with the JAX package's
stash-free backward (ops/categorical.py:137-206): it saves the logits, the
actions and the per-row log-sum-exp (and entropy), nothing of size (..., N),
and recomputes the softmax from them.  While a profiler runs, each
forward is the span `dihpc.categorical.logp_entropy` or
`dihpc.categorical.logp`, and each backward the same name with `.bwd`
(utils.profiling.span).

Masked-logit contract (the same as the JAX package's): logits <= -1e9,
-inf included, are masked-invalid.  Data is clamped at -1e9 before the
reduction, so a masked logit has probability exactly 0 in every statistic,
and a masked TAKEN action's logp is finite (about -1e9 - lse), never -inf.
The gradient's one-hot term is zero where the taken logit is strictly below
-1e9 (the true derivative through the clamp), and logp is clamped at -88 in
the entropy term, where exp already underflows to 0, so a -inf logit gives
a zero gradient rather than 0 * inf.
"""

from __future__ import annotations

import torch

from ..utils.constants import MASKED_LOGIT
from ..utils.profiling import span

__all__ = ["logp_entropy", "logp"]

# Below this, float32 exp underflows to exactly 0 (ops/categorical.py:152).
_LOGP_FLOOR = -88.0


def _stats(logits: torch.Tensor, actions: torch.Tensor, with_ent: bool):
    """Per row: (logp of the taken action, entropy or None, log-sum-exp)."""
    x = torch.clamp_min(logits.float(), MASKED_LOGIT)
    m = x.amax(dim=-1, keepdim=True)
    e = torch.exp(x - m)
    s = e.sum(dim=-1)
    lse = m[..., 0] + torch.log(s)
    xa = torch.gather(x, -1, actions.long()[..., None])[..., 0]
    ent = lse - (e * x).sum(dim=-1) / s if with_ent else None
    return xa - lse, ent, lse


def _onehot_grad(x, actions, glp):
    """glp at the taken action, where its logit is not below the clamp."""
    cols = torch.arange(x.shape[-1], device=x.device)
    take = (cols == actions.long()[..., None]) & (x >= MASKED_LOGIT)
    return torch.where(take, glp, torch.zeros((), device=x.device))


class _LogpEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, actions):
        with span("dihpc.categorical.logp_entropy"):
            lp, ent, lse = _stats(logits, actions, with_ent=True)
        ctx.save_for_backward(logits, actions, lse, ent)
        return lp, ent

    @staticmethod
    def backward(ctx, glp, gent):
        logits, actions, lse, ent = ctx.saved_tensors
        with span("dihpc.categorical.logp_entropy.bwd"):
            x = logits.float()
            logp_all = x - lse[..., None]
            p = torch.exp(logp_all)
            glp, gent = glp[..., None].float(), gent[..., None].float()
            # d logp_a / dx = onehot - p;  dH / dx_j = -p_j (logp_j + H).
            dx = _onehot_grad(x, actions, glp) - p * (
                glp + gent * (torch.clamp_min(logp_all, _LOGP_FLOOR)
                              + ent[..., None]))
            return dx.to(logits.dtype), None


class _Logp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, actions):
        with span("dihpc.categorical.logp"):
            lp, _, lse = _stats(logits, actions, with_ent=False)
        ctx.save_for_backward(logits, actions, lse)
        return lp

    @staticmethod
    def backward(ctx, glp):
        logits, actions, lse = ctx.saved_tensors
        with span("dihpc.categorical.logp.bwd"):
            x = logits.float()
            glp = glp[..., None].float()
            dx = (_onehot_grad(x, actions, glp)
                  - torch.exp(x - lse[..., None]) * glp)
            return dx.to(logits.dtype), None


def logp_entropy(logits: torch.Tensor, actions: torch.Tensor):
    """(..., N) logits + (...) integer actions -> (logp_action, entropy),
    each shaped (...), float32.  Differentiable in the logits."""
    return _LogpEntropy.apply(logits, actions)


def logp(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """Log-prob of the taken action only (the behaviour policy's side of
    V-trace, whose entropy is never needed).  Differentiable in the
    logits."""
    return _Logp.apply(logits, actions)
