"""Checkpoint / resume for op and model parameters, the counterpart of the
JAX package's utils/checkpoint.py.

A tree is nested NamedTuples, tuples, lists and dicts whose leaves are
tensors (or plain numbers, as in an optimizer's state_dict()); None is an
empty subtree.  An nn.Module (ActorCriticParams with its LSTMWeights, say)
is a node whose leaves are its state_dict() values, in order.
`save_pytree` writes the leaves to one file with torch.save; `load_pytree`
reads them back (torch.load with weights_only=True, so loading runs no
pickled code) into the structure of `like`.
"""

from __future__ import annotations

import copy
from pathlib import Path

import torch
from torch import nn

__all__ = ["save_pytree", "load_pytree"]

SUFFIX = ".pt"


def _norm(path: str | Path) -> str:
    """One on-disk name for both ends of the round trip: the suffix is
    added where the path lacks it."""
    p = str(path)
    return p if p.endswith(SUFFIX) else p + SUFFIX


def tree_flatten(tree):
    """(leaves, rebuild): the tree's leaves in order, and a function that
    builds a tree of the same structure from a list of new leaves.  An
    nn.Module is rebuilt as a deep copy with the new leaves loaded into its
    state_dict; dicts keep their key order."""
    if tree is None:
        return [], lambda leaves: None
    if isinstance(tree, nn.Module):
        state = tree.state_dict()

        def rebuild_module(leaves):
            module = copy.deepcopy(tree)
            module.load_state_dict(dict(zip(state, leaves)))
            return module
        return list(state.values()), rebuild_module
    if isinstance(tree, dict):
        children = list(tree.values())
        make = lambda values: type(tree)(zip(tree.keys(), values))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        children = list(tree)
        make = lambda values: type(tree)(*values)
    elif isinstance(tree, (tuple, list)):
        children = list(tree)
        make = lambda values: type(tree)(values)
    else:
        return [tree], lambda leaves: leaves[0]
    flat = [tree_flatten(child) for child in children]
    leaves = [leaf for child_leaves, _ in flat for leaf in child_leaves]

    def rebuild(new_leaves):
        values, i = [], 0
        for child_leaves, child_rebuild in flat:
            values.append(child_rebuild(new_leaves[i:i + len(child_leaves)]))
            i += len(child_leaves)
        return make(values)
    return leaves, rebuild


def save_pytree(path: str | Path, tree) -> None:
    """Save a tree's leaves to one file (tensors as host copies)."""
    leaves, _ = tree_flatten(tree)
    torch.save({"leaves": [x.detach().cpu() if isinstance(x, torch.Tensor)
                           else x for x in leaves]}, _norm(path))


def load_pytree(path: str | Path, like):
    """Load leaves saved by save_pytree into the structure of `like` (a tree
    of the same topology, e.g. freshly initialized params).  Raises
    ValueError when the leaf count or a tensor's shape differs from
    `like`'s.  Tensors land on the device of `like`'s leaf."""
    leaves = torch.load(_norm(path), map_location="cpu",
                        weights_only=True)["leaves"]
    like_leaves, rebuild = tree_flatten(like)
    if len(like_leaves) != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, structure "
                         f"expects {len(like_leaves)}")
    out = []
    for i, (got, want) in enumerate(zip(leaves, like_leaves)):
        if isinstance(want, torch.Tensor):
            if not isinstance(got, torch.Tensor) or got.shape != want.shape:
                raise ValueError(f"checkpoint leaf {i}: shape "
                                 f"{tuple(getattr(got, 'shape', ()))}, "
                                 f"structure expects {tuple(want.shape)}")
            got = got.to(want.device)
        out.append(got)
    return rebuild(out)
