"""UPGO loss on the port's kernels, the counterpart of the JAX package's
ops/upgo.py.

Float32 (T, B) inputs under method "auto" (or "pallas") take the loss-fused
kernel (kernels.upgo_loss): the categorical head gives logp, then one pass
derives the binary lambdas, the gamma=1 return recurrence, the advantage and
the loss sum; its backward recomputes the advantage with
kernels.upgo_advantages.  Other methods, dtypes and ranks compose the
returns on the scan core, the advantage and -mean(adv * logp).  The rhos,
rewards and values are detached: gradients reach the target logits only.
"""

from __future__ import annotations

import torch

from ..kernels.rl_scans import upgo_loss as upgo_loss_kernel
from ._backend import fused_kernels_ok
from ._validate import check_upgo
from .categorical import logp
from .scan import Method
from .td import generalized_lambda_returns

__all__ = ["upgo_loss", "upgo_returns", "UPGO"]


def upgo_returns(rewards, bootstrap_values, method: Method = "auto"):
    """UPGO return targets: lambda-returns with gamma=1 and binary lambdas
    (the trace continues iff r_{t+1} + V_{t+2} >= V_{t+1}).  On the scan
    core, so float32 (T, B) CUDA inputs under "auto" take its kernel."""
    lambdas = ((rewards + bootstrap_values[1:])
               >= bootstrap_values[:-1]).to(rewards.dtype)
    lambdas = torch.cat([lambdas[1:], torch.ones_like(lambdas[-1:])])
    return generalized_lambda_returns(bootstrap_values, rewards, 1.0, lambdas,
                                      method=method)


def upgo_loss(target_output, rhos, action, rewards, bootstrap_values,
              method: Method = "auto") -> torch.Tensor:
    """-mean(rhos * (upgo_returns - V[:-1]) * logp(target_output, action))
    for target_output (T, B, N), rhos, action, rewards (T, B) and
    bootstrap_values (T+1, B)."""
    check_upgo("upgo_loss", target_output, rhos, action, rewards,
               bootstrap_values)
    v, r, rh = (x.detach() for x in (bootstrap_values, rewards, rhos))
    if fused_kernels_ok(v, r, rh, method=method):
        return upgo_loss_kernel(rh, logp(target_output, action), r, v)
    returns = upgo_returns(r, v, method=method)
    advantages = rh * (returns - v[:-1])
    return -torch.mean(advantages * logp(target_output, action))


class UPGO:
    """Shape-static wrapper mirroring the reference module API."""

    def __init__(self, T: int, B: int, N: int):
        self.T, self.B, self.N = T, B, N

    def __call__(self, target_output, rhos, action, rewards,
                 bootstrap_values) -> torch.Tensor:
        for name, x, want in (
                ("target_output", target_output, (self.T, self.B, self.N)),
                ("bootstrap_values", bootstrap_values, (self.T + 1, self.B))):
            if tuple(x.shape) != want:
                raise ValueError(f"UPGO: {name} must be {want}; got "
                                 f"{tuple(x.shape)}")
        return upgo_loss(target_output, rhos, action, rewards,
                         bootstrap_values)

    forward = __call__
