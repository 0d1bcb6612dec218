"""Categorical head: log-prob of the taken action and entropy.

The JAX package leaves this head to XLA fusion and has no Pallas kernel for
it (di_hpc_tpu/ops/categorical.py records why).  The route depends on the
device alone.  CPU tensors run the plain PyTorch body
(kernels.categorical_fwd_plain and categorical_bwd_plain).  CUDA tensors
run two hand-written kernels (kernels.categorical_fwd and categorical_bwd,
csrc/categorical.cu): the forward reads each logits tensor once, the
backward reads the logits once and writes their gradient once.  Before a
launch, logits other than float32 or bfloat16 are cast to float32 (the
plain body computes in float32 too), strided logits are made contiguous and
actions of another dtype become int64; the gradient is cast back to the
logits' dtype.  `kernels.launch_counts()` counts the launches.

Both functions are torch.autograd.Functions with the JAX package's
stash-free backward (ops/categorical.py:137-206): it saves the logits, the
actions and the per-row log-sum-exp (and entropy), nothing of size (..., N),
and recomputes the softmax from them.  While a profiler runs, each
forward is the span `dihpc.categorical.logp_entropy` or
`dihpc.categorical.logp`, and each backward the same name with `.bwd`
(utils.profiling.span).

Masked-logit contract (the same as the JAX package's, on both routes):
logits <= -1e9, -inf included, are masked-invalid.  Data is clamped at -1e9
before the reduction, so a masked logit has probability exactly 0 in every
statistic, and a masked TAKEN action's logp is finite (about -1e9 - lse),
never -inf.  The gradient's one-hot term is zero where the taken logit is
strictly below -1e9 (the true derivative through the clamp), and logp is
clamped at -88 in the entropy term, where exp already underflows to 0, so
a -inf logit gives a zero gradient rather than 0 * inf.
"""

from __future__ import annotations

import torch

from ..kernels.categorical import (categorical_bwd, categorical_bwd_plain,
                                   categorical_fwd, categorical_fwd_plain)
from ..utils.profiling import span

__all__ = ["logp_entropy", "logp"]

_KERNEL_LOGITS = (torch.float32, torch.bfloat16)
_KERNEL_ACTIONS = (torch.int32, torch.int64)


def _kernel_inputs(logits, actions):
    """CUDA logits and actions as the kernels take them: float32 or
    bfloat16 contiguous logits, int32 or int64 actions."""
    if logits.dtype not in _KERNEL_LOGITS:
        logits = logits.float()
    if actions.dtype not in _KERNEL_ACTIONS:
        actions = actions.long()
    return logits.contiguous(), actions


def _forward(logits, actions, with_ent: bool):
    if not logits.is_cuda:
        return categorical_fwd_plain(logits, actions, with_ent)
    return categorical_fwd(*_kernel_inputs(logits, actions), with_ent)


def _backward(logits, actions, lse, ent, glp, gent):
    if not logits.is_cuda:
        return categorical_bwd_plain(logits, actions, lse, ent, glp, gent)
    x, a = _kernel_inputs(logits, actions)
    return categorical_bwd(x, a, lse, ent, glp, gent).to(logits.dtype)


class _LogpEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, actions):
        with span("dihpc.categorical.logp_entropy"):
            lp, ent, lse = _forward(logits, actions, with_ent=True)
        ctx.save_for_backward(logits, actions, lse, ent)
        return lp, ent

    @staticmethod
    def backward(ctx, glp, gent):
        logits, actions, lse, ent = ctx.saved_tensors
        with span("dihpc.categorical.logp_entropy.bwd"):
            return _backward(logits, actions, lse, ent, glp, gent), None


class _Logp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, actions):
        with span("dihpc.categorical.logp"):
            lp, _, lse = _forward(logits, actions, with_ent=False)
        ctx.save_for_backward(logits, actions, lse)
        return lp

    @staticmethod
    def backward(ctx, glp):
        logits, actions, lse = ctx.saved_tensors
        with span("dihpc.categorical.logp.bwd"):
            return _backward(logits, actions, lse, None, glp, None), None


def logp_entropy(logits: torch.Tensor, actions: torch.Tensor):
    """(..., N) logits + (...) integer actions -> (logp_action, entropy),
    each shaped (...), float32.  Differentiable in the logits."""
    return _LogpEntropy.apply(logits, actions)


def logp(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """Log-prob of the taken action only (the behaviour policy's side of
    V-trace, whose entropy is never needed).  Differentiable in the
    logits."""
    return _Logp.apply(logits, actions)
