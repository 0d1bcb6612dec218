"""The categorical head: two hand-written Hopper kernels
(csrc/categorical.cu) and their plain PyTorch versions.

  - `categorical_fwd(logits, actions, with_ent)` -> (logp, entropy or None,
    lse): per row of (..., N) logits, the log-prob of the taken action, the
    entropy (where `with_ent`) and the log-sum-exp, each (...) float32.  It
    reads each logit once.
  - `categorical_bwd(logits, actions, lse, ent, glp, gent)` -> the logits'
    gradient in their dtype, from the saved logits and actions, the
    forward's per-row lse and entropy (None: the gradient of logp alone)
    and the incoming gradients of logp and of the entropy: the stash-free
    backward.  It reads each logit once and writes each gradient once.

The JAX package has no kernel for this head (XLA fuses it,
di_hpc_tpu/ops/categorical.py:37-43), so these replace plain PyTorch, not a
Pallas kernel; `ops.categorical` routes a call to them or to the plain
versions (`categorical_fwd_plain`, `categorical_bwd_plain`).  The kernels
take contiguous float32 or bfloat16 logits with N >= 1 and int32 or int64
actions shaped like the logits' rows; a lane reads 4 neighbouring logits
where N % 4 == 0 and the logits' start is aligned to 4 elements, one
otherwise (`load_width`).  An incoming gradient that is one value broadcast
over every row (a sum's) is read in place; any other is made a dense (...)
plane.

Each wrapper runs its plain version when every tensor lies on the CPU and
raises on a shape or (on the card) a dtype or layout it does not take.
"""

from __future__ import annotations

import torch

from ..utils.constants import MASKED_LOGIT
from ..utils.profiling import span
from . import _build

__all__ = ["categorical_fwd", "categorical_fwd_plain", "categorical_bwd",
           "categorical_bwd_plain", "load_width"]

# Below this, float32 exp underflows to exactly 0 (ops/categorical.py:152 of
# the JAX package).
_LOGP_FLOOR = -88.0
_TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ACTIONS = (torch.int32, torch.int64)


def categorical_fwd_plain(logits, actions, with_ent: bool):
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


def categorical_bwd_plain(logits, actions, lse, ent, glp, gent):
    """The logits' gradient; `ent` and `gent` None for logp alone."""
    x = logits.float()
    glp = glp[..., None].float()
    if ent is None:
        dx = (_onehot_grad(x, actions, glp)
              - torch.exp(x - lse[..., None]) * glp)
        return dx.to(logits.dtype)
    logp_all = x - lse[..., None]
    p = torch.exp(logp_all)
    gent = gent[..., None].float()
    # d logp_a / dx = onehot - p;  dH / dx_j = -p_j (logp_j + H).
    dx = _onehot_grad(x, actions, glp) - p * (
        glp + gent * (torch.clamp_min(logp_all, _LOGP_FLOOR)
                      + ent[..., None]))
    return dx.to(logits.dtype)


def load_width(N: int, data_ptr: int, itemsize: int) -> int:
    """Logits a lane reads at once: 4 (16 bytes of float32, 8 of bf16)
    where every row starts aligned to that, else 1."""
    return 4 if N % 4 == 0 and data_ptr % (4 * itemsize) == 0 else 1


def _check_shapes(name, logits, actions) -> tuple:
    """(rows, N) of a call the kernels can take; raises on other shapes."""
    if logits.ndim < 1 or logits.shape[-1] < 1 or logits.numel() == 0:
        raise ValueError(f"{name}: logits must be (..., N) with N >= 1 and "
                         f"at least one row; got {tuple(logits.shape)}")
    if tuple(actions.shape) != tuple(logits.shape[:-1]):
        raise ValueError(f"{name}: actions must be the logits' rows "
                         f"{tuple(logits.shape[:-1])}; got "
                         f"{tuple(actions.shape)}")
    N = logits.shape[-1]
    return logits.numel() // N, N


def _check_dtypes(name, logits, actions) -> None:
    if logits.dtype not in _TAG:
        raise TypeError(f"{name}: the CUDA kernel takes float32 or bfloat16 "
                        f"logits; got {logits.dtype}")
    if actions.dtype not in _ACTIONS:
        raise TypeError(f"{name}: the CUDA kernel takes int32 or int64 "
                        f"actions; got {actions.dtype}")
    _build.check_kernel_inputs(name, {"logits": logits, "actions": actions},
                               dtypes={"logits": logits.dtype,
                                       "actions": actions.dtype})


def row_gradient(name, arg, g, logits):
    """(float32 tensor, step) of an incoming per-row gradient: one value
    broadcast over every row is read in place (step 0), anything else as a
    dense plane of the logits' rows (step 1)."""
    rows_shape = logits.shape[:-1]
    if g.device != logits.device:
        raise ValueError(f"{name}: {arg} is on {g.device}, the logits on "
                         f"{logits.device}")
    g = torch.broadcast_to(g.float(), rows_shape)
    if all(st == 0 or n == 1 for st, n in zip(g.stride(), g.shape)):
        return g, 0
    return g.contiguous(), 1


def _launch(name, entry_name, device, args) -> None:
    with torch.cuda.device(device):
        entry = getattr(_build.library().cdll, entry_name)
        stream = torch.cuda.current_stream().cuda_stream
        with span("dihpc.kernel." + name):
            status = entry(*args, stream)
    _build.check_status(name, status)


def categorical_fwd(logits, actions, with_ent: bool = True):
    """(logp, entropy or None, lse), each (...) float32, of (..., N) logits
    and (...) actions.  CPU tensors run the plain version; CUDA tensors
    launch the kernel or raise."""
    name = "categorical_fwd"
    rows, N = _check_shapes(name, logits, actions)
    if _build.on_cpu(logits, actions):
        return categorical_fwd_plain(logits, actions, with_ent)
    actions = actions.contiguous()
    _check_dtypes(name, logits, actions)
    out = lambda: torch.empty(logits.shape[:-1], dtype=torch.float32,
                              device=logits.device)
    lp, lse = out(), out()
    ent = out() if with_ent else None
    _launch(name, f"{name}_{_TAG[logits.dtype]}", logits.device, (
        logits.data_ptr(), actions.data_ptr(),
        int(actions.dtype == torch.int64), rows, N,
        load_width(N, logits.data_ptr(), logits.element_size()),
        lp.data_ptr(), lse.data_ptr(), None if ent is None else ent.data_ptr()))
    categorical_fwd.launches += 1
    return lp, ent, lse


categorical_fwd.launches = 0


def categorical_bwd(logits, actions, lse, ent, glp, gent):
    """The gradient of (..., N) logits, their dtype, from the forward's
    (...) lse and entropy (None, with gent None: logp alone) and the
    incoming gradients glp and gent, each broadcastable to (...).  CPU
    tensors run the plain version; CUDA tensors launch the kernel or
    raise."""
    name = "categorical_bwd"
    rows, N = _check_shapes(name, logits, actions)
    if (ent is None) != (gent is None):
        raise ValueError(f"{name}: ent and gent come together; got ent "
                         f"{'None' if ent is None else 'a tensor'}, gent "
                         f"{'None' if gent is None else 'a tensor'}")
    if _build.on_cpu(logits, actions, lse, glp):
        return categorical_bwd_plain(logits, actions, lse, ent, glp, gent)
    actions = actions.contiguous()
    _check_dtypes(name, logits, actions)
    stats = {"lse": lse} if ent is None else {"lse": lse, "ent": ent}
    _build.check_kernel_inputs(name, {"logits": logits, **stats},
                               dtypes={"logits": logits.dtype})
    for arg, t in stats.items():
        if tuple(t.shape) != tuple(logits.shape[:-1]):
            raise ValueError(f"{name}: {arg} must be the logits' rows "
                             f"{tuple(logits.shape[:-1])}; got "
                             f"{tuple(t.shape)}")
    glp, glp_step = row_gradient(name, "glp", glp, logits)
    gent, gent_step = (None, 0) if gent is None else \
        row_gradient(name, "gent", gent, logits)
    dx = torch.empty_like(logits)
    _launch(name, f"{name}_{_TAG[logits.dtype]}", logits.device, (
        logits.data_ptr(), actions.data_ptr(),
        int(actions.dtype == torch.int64), lse.data_ptr(),
        None if ent is None else ent.data_ptr(), glp.data_ptr(), glp_step,
        None if gent is None else gent.data_ptr(), gent_step, rows, N,
        load_width(N, logits.data_ptr(), logits.element_size()),
        dx.data_ptr()))
    categorical_bwd.launches += 1
    return dx


categorical_bwd.launches = 0
