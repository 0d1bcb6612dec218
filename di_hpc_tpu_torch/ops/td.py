"""TD(lambda) on the port's kernels, the TD(lambda) part of the JAX
package's ops/td.py.

With unit weight the loss runs in the loss-fused kernel
(kernels.td_lambda_loss): returns and squared error in one pass, only a
per-column partial leaves the kernel, and its backward recomputes the error
with kernels.td_lambda_err.  With a (B,) or (T, B) weight the returns kernel
(kernels.lambda_returns) writes the returns and the weighted mean runs
outside; the weight broadcasts over time as in the reference's origin
(docs/DESIGN.md:91-92).  Other methods, dtypes and ranks take the scan core.
The returns are detached everywhere: the gradient reaches value[:-1] only.
"""

from __future__ import annotations

import torch

from ..kernels.rl_scans import lambda_returns, td_lambda_loss
from ..origin.td import td_lambda_data
from ._backend import fused_kernels_ok
from ._validate import check_time_batch
from .scan import Method, linear_recurrence_reverse

__all__ = ["td_lambda_error", "generalized_lambda_returns",
           "multistep_forward_view", "TDLambda", "td_lambda_data"]


def multistep_forward_view(bootstrap_values, rewards, gammas, lambda_,
                           method: Method = "auto"):
    """Scan-core form of origin.multistep_forward_view: the recurrence
        result[t] = [r_t + (g_t - d_t) V_{t+1}] + d_t * result[t+1]
    with d = gammas*lambda_, and d_{T-1} = 0 so that result[T-1] = r + g*V
    (lambda cut off at the horizon)."""
    rewards = torch.as_tensor(rewards)
    like = dict(dtype=rewards.dtype, device=rewards.device)
    gammas = torch.broadcast_to(torch.as_tensor(gammas, **like),
                                rewards.shape)
    lambda_ = torch.broadcast_to(torch.as_tensor(lambda_, **like),
                                 rewards.shape)
    d = gammas * lambda_
    d = torch.cat([d[:-1], torch.zeros_like(d[-1:])])
    a = rewards + (gammas - d) * bootstrap_values
    return linear_recurrence_reverse(a, d, method=method)


def generalized_lambda_returns(bootstrap_values, rewards, gammas, lambda_,
                               method: Method = "auto"):
    return multistep_forward_view(bootstrap_values[1:], rewards, gammas,
                                  lambda_, method=method)


def td_lambda_error(data: td_lambda_data, gamma: float = 0.9,
                    lambda_: float = 0.8,
                    method: Method = "auto") -> torch.Tensor:
    """0.5 * mean(weight * (lambda_return - V[:-1])^2), the returns
    detached; weight (B,) or (T, B) broadcasts as in the origin."""
    value, reward, weight = data
    check_time_batch("td_lambda_error", value, reward, weight)
    fused = fused_kernels_ok(value, reward, method=method)
    if weight is None and fused:
        return td_lambda_loss(value, reward, gamma, lambda_)

    if weight is None:
        weight = torch.ones_like(reward)
    if fused:
        return_ = lambda_returns(value, reward, gamma, lambda_).detach()
    else:
        with torch.no_grad():
            return_ = generalized_lambda_returns(value, reward, gamma,
                                                 lambda_, method=method)
    return 0.5 * torch.mean((return_ - value[:-1]) ** 2 * weight)


class TDLambda:
    """Shape-static wrapper mirroring the reference module API."""

    def __init__(self, T: int, B: int):
        self.T, self.B = T, B

    def __call__(self, value, reward, weight=None, gamma: float = 0.9,
                 lambda_: float = 0.8) -> torch.Tensor:
        for name, x, want in (("value", value, (self.T + 1, self.B)),
                              ("reward", reward, (self.T, self.B))):
            if tuple(x.shape) != want:
                raise ValueError(f"TDLambda: {name} must be {want}; got "
                                 f"{tuple(x.shape)}")
        return td_lambda_error(td_lambda_data(value, reward, weight), gamma,
                               lambda_)

    forward = __call__
