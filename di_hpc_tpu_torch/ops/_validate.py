"""Input validation for the public op functions.

Same contract as the JAX package's ops/_validate.py: only relative shape
relations are asserted, and a bad shape raises a ValueError that names the
op at the call site instead of a broadcast error deep inside it.
"""

from __future__ import annotations

import torch


def _fail(op: str, msg: str):
    raise ValueError(f"{op}: {msg}")


def _is_int(x) -> bool:
    return not torch.is_floating_point(x) and not torch.is_complex(x) \
        and x.dtype != torch.bool


def check_time_batch(op: str, value, reward, weight=None,
                     value_name: str = "value", reward_name: str = "reward"):
    """value (T+1, *B) against reward (T, *B); optional weight (T, *B)/(*B)."""
    if value.ndim != reward.ndim or value.ndim < 1:
        _fail(op, f"{value_name} must be (T+1, B) and {reward_name} (T, B); "
                  f"got {tuple(value.shape)} and {tuple(reward.shape)}")
    if (value.shape[0] != reward.shape[0] + 1
            or value.shape[1:] != reward.shape[1:]):
        _fail(op, f"{value_name} must have shape (T+1, B) = "
                  f"({reward.shape[0] + 1}, "
                  f"{', '.join(map(str, reward.shape[1:]))}) to match "
                  f"{reward_name} {tuple(reward.shape)}; "
                  f"got {tuple(value.shape)}")
    if weight is not None and tuple(weight.shape) not in (
            tuple(reward.shape), tuple(reward.shape[1:])):
        _fail(op, f"weight must have shape {tuple(reward.shape)} or "
                  f"{tuple(reward.shape[1:])}; got {tuple(weight.shape)}")


def check_categorical(op: str, logits, action, name: str = "logits"):
    """logits (*R, N) against int action (*R)."""
    if logits.ndim < 1 or logits.shape[:-1] != action.shape:
        _fail(op, f"{name} must be action.shape + (N,); got {name} "
                  f"{tuple(logits.shape)} for action {tuple(action.shape)}")
    if not _is_int(action):
        _fail(op, f"action must be an integer tensor; got dtype "
                  f"{action.dtype}")


def check_vtrace(op, target_output, behaviour_output, action, value, reward,
                 weight):
    if behaviour_output.shape != target_output.shape:
        _fail(op, f"behaviour_output {tuple(behaviour_output.shape)} must "
                  f"match target_output {tuple(target_output.shape)}")
    check_categorical(op, target_output, action, "target_output")
    if reward.shape != target_output.shape[:-1]:
        _fail(op, f"reward must have shape {tuple(target_output.shape[:-1])}; "
                  f"got {tuple(reward.shape)}")
    check_time_batch(op, value, reward, weight)
