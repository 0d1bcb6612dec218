"""V-trace loss on the port's kernels, the counterpart of the JAX package's
ops/vtrace.py.

The categorical head yields the target log-prob and entropy in one pass;
the importance weights are detached.  With unit weight, the recurrence,
clips, advantage and both loss sums run in the loss-fused kernel
(kernels.vtrace_losses) and the (T, B) returns/advantage planes never reach
memory.  With a weight, the returns/advantage kernel writes the planes and
the weighted means run outside.  The entropy mean stays outside the kernel
in both cases, as in the JAX package.  The kernels take float32 (T, B)
planes under method "auto" or "pallas" (ops._backend.fused_kernels_ok);
any other input or method composes the returns from the scan core
(ops.scan.linear_recurrence_reverse with that method), as the JAX package
does.  Stop-gradient boundaries follow the reference: gradients reach the
target logits and value[:-1] only.
"""

from __future__ import annotations

import torch

from ..kernels.rl_scans import vtrace_losses, vtrace_returns_adv
from ..origin.vtrace import vtrace_data, vtrace_loss
from ._backend import fused_kernels_ok
from ._validate import check_vtrace
from .categorical import logp, logp_entropy
from .scan import Method, linear_recurrence_reverse

__all__ = ["vtrace_error", "vtrace_data", "vtrace_loss", "VTrace"]


def vtrace_error(
    data: vtrace_data,
    gamma: float = 0.99,
    lambda_: float = 0.95,
    rho_clip_ratio: float = 1.0,
    c_clip_ratio: float = 1.0,
    rho_pg_clip_ratio: float = 1.0,
    method: Method = "auto",
) -> vtrace_loss:
    target_output, behaviour_output, action, value, reward, weight = data
    check_vtrace("vtrace_error", target_output, behaviour_output, action,
                 value, reward, weight)

    logp_target, entropy = logp_entropy(target_output, action)    # (T, B)
    logp_behaviour = logp(behaviour_output, action).detach()
    IS = torch.exp(logp_target - logp_behaviour).detach()

    v = value.detach()
    fused = fused_kernels_ok(v, reward, IS, method=method)
    if weight is None and fused:
        pg_loss, value_loss = vtrace_losses(
            IS, logp_target, reward, value, gamma, lambda_,
            rho_clip_ratio, c_clip_ratio, rho_pg_clip_ratio)
        return vtrace_loss(pg_loss, value_loss, entropy.mean())

    if fused:
        return_, adv = vtrace_returns_adv(
            IS, reward, v, gamma, lambda_,
            rho_clip_ratio, c_clip_ratio, rho_pg_clip_ratio)
    else:
        rhos = torch.clamp(IS, max=rho_clip_ratio)
        cs = torch.clamp(IS, max=c_clip_ratio)
        pg_rhos = torch.clamp(IS, max=rho_pg_clip_ratio)
        deltas = rhos * (reward + gamma * v[1:] - v[:-1])
        items = linear_recurrence_reverse(deltas, gamma * lambda_ * cs,
                                          method=method)
        return_ = v[:-1] + items                                  # vs_t
        return_tp1 = torch.cat([return_[1:], v[-1:]])
        adv = pg_rhos * (reward + gamma * return_tp1 - v[:-1])

    if weight is None:
        weight = torch.ones_like(reward)
    pg_loss = -torch.mean(logp_target * adv * weight)
    value_loss = torch.mean((value[:-1] - return_) ** 2 * weight)
    entropy_loss = torch.mean(entropy * weight)
    return vtrace_loss(pg_loss, value_loss, entropy_loss)


class VTrace:
    """Shape-static wrapper mirroring the reference's VTrace module."""

    def __init__(self, T: int, B: int, N: int):
        self.T, self.B, self.N = T, B, N

    def __call__(self, target_output, behaviour_output, action, value, reward,
                 weight=None, gamma: float = 0.99, lambda_: float = 0.95,
                 rho_clip_ratio: float = 1.0, c_clip_ratio: float = 1.0,
                 rho_pg_clip_ratio: float = 1.0) -> vtrace_loss:
        if tuple(target_output.shape) != (self.T, self.B, self.N):
            raise ValueError(f"VTrace: target_output must be "
                             f"{(self.T, self.B, self.N)}; got "
                             f"{tuple(target_output.shape)}")
        if tuple(value.shape) != (self.T + 1, self.B):
            raise ValueError(f"VTrace: value must be {(self.T + 1, self.B)}; "
                             f"got {tuple(value.shape)}")
        return vtrace_error(
            vtrace_data(target_output, behaviour_output, action, value,
                        reward, weight),
            gamma, lambda_, rho_clip_ratio, c_clip_ratio, rho_pg_clip_ratio,
        )

    forward = __call__
