"""V-trace recurrence kernels: the hand-written Hopper kernels
(csrc/vtrace.cu) and their plain PyTorch versions.

Counterparts of the V-trace part of di_hpc_tpu/pallas_kernels/rl_scans.py:

  - `vtrace_losses` ~ `vtrace_losses_pallas` / `_vtrace_losses_impl`: the
    clipped recurrence, the advantage and both loss sums in one pass; the
    (T, B) returns/advantage planes never reach device memory.  Returns
    (pg_loss, value_loss) = (-sum(logp*adv)/TB, sum((V - vs)^2)/TB).
  - `vtrace_returns_adv` ~ `vtrace_returns_adv_pallas`: the same recurrence,
    writing the vs and advantage planes (the weighted path of
    ops.vtrace_error).

The kernels are forward-only.  The plain versions keep ordinary autograd
with the V-trace stop-gradient contract: returns and advantages come from
detached inputs, so gradients reach only logp and value[:-1].
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["vtrace_losses", "vtrace_losses_plain", "vtrace_returns_adv",
           "vtrace_returns_adv_plain"]


def vtrace_returns_adv_plain(is_weights, reward, value, gamma=0.99,
                             lambda_=0.95, rho_clip=1.0, c_clip=1.0,
                             pg_clip=1.0):
    """The kernels' reverse loop in plain PyTorch: (vs, adv), each (T, B),
    computed from detached inputs."""
    is_weights, reward, value = (x.detach() for x in
                                 (is_weights, reward, value))
    T = reward.shape[0]
    gl = gamma * lambda_
    v_next = value[T]
    vs_next = v_next
    item = torch.zeros_like(v_next)
    ret, adv = [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        rho = torch.clamp(is_weights[t], max=rho_clip)
        c = torch.clamp(is_weights[t], max=c_clip)
        pg = torch.clamp(is_weights[t], max=pg_clip)
        delta = rho * (reward[t] + gamma * v_next - value[t])
        item = delta + (gl * c) * item
        ret[t] = value[t] + item
        adv[t] = pg * (reward[t] + gamma * vs_next - value[t])
        v_next, vs_next = value[t], ret[t]
    return torch.stack(ret), torch.stack(adv)


def vtrace_losses_plain(is_weights, lp, reward, value, gamma=0.99,
                        lambda_=0.95, rho_clip=1.0, c_clip=1.0, pg_clip=1.0):
    """(pg_loss, value_loss) in plain PyTorch; differentiable in lp and
    value[:-1] only."""
    T, B = reward.shape
    ret, adv = vtrace_returns_adv_plain(is_weights, reward, value, gamma,
                                        lambda_, rho_clip, c_clip, pg_clip)
    pg_loss = -torch.sum(lp * adv) / (T * B)
    value_loss = torch.sum((value[:-1] - ret) ** 2) / (T * B)
    return pg_loss, value_loss


def _check(name, tensors: dict, T, B):
    _build.check_kernel_inputs(name, tensors)
    for arg, t in tensors.items():
        want = (T + 1, B) if arg == "value" else (T, B)
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {arg} must be {want}; got "
                             f"{tuple(t.shape)}")
    if T < 1 or B < 1:
        raise ValueError(f"{name}: T and B must be >= 1; got T={T}, B={B}")
    _build.forward_only(name, *tensors.values())


def _scalars(gamma, lambda_, rho_clip, c_clip, pg_clip):
    return (float(gamma), float(gamma * lambda_), float(rho_clip),
            float(c_clip), float(pg_clip))


def vtrace_losses(is_weights, lp, reward, value, gamma: float = 0.99,
                  lambda_: float = 0.95, rho_clip: float = 1.0,
                  c_clip: float = 1.0, pg_clip: float = 1.0):
    """Unit-weight V-trace losses (pg_loss, value_loss), recurrence, clips,
    advantage and both sums in one kernel pass.  IS, lp, reward (T, B) and
    value (T+1, B).  CPU tensors run the plain version; CUDA tensors launch
    the kernel or raise."""
    if _build.on_cpu(is_weights, lp, reward, value):
        return vtrace_losses_plain(is_weights, lp, reward, value, gamma,
                                   lambda_, rho_clip, c_clip, pg_clip)
    name = "vtrace_losses"
    T, B = reward.shape if reward.ndim == 2 else (0, 0)
    _check(name, {"is_weights": is_weights, "lp": lp, "reward": reward,
                  "value": value}, T, B)
    parts = torch.empty((2, B), dtype=torch.float32, device=reward.device)
    with torch.cuda.device(reward.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _build.library().cdll.vtrace_losses_f32(
            is_weights.data_ptr(), lp.data_ptr(), reward.data_ptr(),
            value.data_ptr(), parts.data_ptr(), T, B,
            *_scalars(gamma, lambda_, rho_clip, c_clip, pg_clip), stream)
    _build.check_status(name, status)
    vtrace_losses.launches += 1
    # torch.sum on the card reduces in a fixed order: no float atomics, so
    # repeated runs are bitwise equal (docs/DESIGN.md section 3).
    sums = parts.sum(dim=1)
    return -sums[0] / (T * B), sums[1] / (T * B)


vtrace_losses.launches = 0


def vtrace_returns_adv(is_weights, reward, value, gamma: float = 0.99,
                       lambda_: float = 0.95, rho_clip: float = 1.0,
                       c_clip: float = 1.0, pg_clip: float = 1.0):
    """V-trace (vs, advantages), each (T, B), the three min(IS, clip)
    planes derived in-kernel.  CPU tensors run the plain version; CUDA
    tensors launch the kernel or raise."""
    if _build.on_cpu(is_weights, reward, value):
        return vtrace_returns_adv_plain(is_weights, reward, value, gamma,
                                        lambda_, rho_clip, c_clip, pg_clip)
    name = "vtrace_returns_adv"
    T, B = reward.shape if reward.ndim == 2 else (0, 0)
    _check(name, {"is_weights": is_weights, "reward": reward,
                  "value": value}, T, B)
    ret = torch.empty((T, B), dtype=torch.float32, device=reward.device)
    adv = torch.empty_like(ret)
    with torch.cuda.device(reward.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _build.library().cdll.vtrace_returns_adv_f32(
            is_weights.data_ptr(), reward.data_ptr(), value.data_ptr(),
            ret.data_ptr(), adv.data_ptr(), T, B,
            *_scalars(gamma, lambda_, rho_clip, c_clip, pg_clip), stream)
    _build.check_status(name, status)
    vtrace_returns_adv.launches += 1
    return ret, adv


vtrace_returns_adv.launches = 0
