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


def check_upgo(op, target_output, rhos, action, rewards, bootstrap_values):
    check_categorical(op, target_output, action, "target_output")
    for nm, x in (("rhos", rhos), ("rewards", rewards)):
        if x.shape != target_output.shape[:-1]:
            _fail(op, f"{nm} must have shape "
                      f"{tuple(target_output.shape[:-1])}; got "
                      f"{tuple(x.shape)}")
    check_time_batch(op, bootstrap_values, rewards, None, "bootstrap_values",
                     "rewards")


def _check_per_sample(op, B, named, weight):
    for nm, x in named:
        if x.shape != B:
            _fail(op, f"{nm} must have shape {tuple(B)}; got "
                      f"{tuple(x.shape)}")
    if weight is not None and weight.shape != B:
        _fail(op, f"weight must have shape {tuple(B)}; got "
                  f"{tuple(weight.shape)}")


def check_ppo(op, logit_new, logit_old, action, value_new, value_old, adv,
              return_, weight):
    if logit_old.shape != logit_new.shape:
        _fail(op, f"logit_old {tuple(logit_old.shape)} must match logit_new "
                  f"{tuple(logit_new.shape)}")
    check_categorical(op, logit_new, action, "logit_new")
    _check_per_sample(op, logit_new.shape[:-1],
                      (("value_new", value_new), ("value_old", value_old),
                       ("adv", adv), ("return_", return_)), weight)


def check_ppo_fast(op, logit_new, logp_old, action, value_new, value_old,
                   adv, return_, weight):
    check_categorical(op, logit_new, action, "logit_new")
    _check_per_sample(op, logit_new.shape[:-1],
                      (("logp_old", logp_old), ("value_new", value_new),
                       ("value_old", value_old), ("adv", adv),
                       ("return_", return_)), weight)
