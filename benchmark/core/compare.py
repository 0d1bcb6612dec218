"""The numbers that decide `correct` for a learner: gaps between the
program's readings and the reference's.

Norms are taken by leaf, and a gap is |program's norm - reference's norm|
measured against the reference's norm of that leaf or of the median leaf,
whichever is larger (some leaves' gradients are all but zero).  The
parameters' change leaves out the leaves whose reference gradient is under
a thousandth of the median leaf's: Adam moves those by round-off alone.
"""

from __future__ import annotations

import statistics

NEGLIGIBLE_GRAD = 1e-3


def leaf_norms(tensors: dict) -> dict:
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def norm_gap(got: dict, want: dict, leaves=None) -> tuple:
    """(largest gap, its leaf) over `leaves` (default all of `want`)."""
    leaves = list(want) if leaves is None else list(leaves)
    floor = statistics.median(want[n] for n in leaves)
    worst, where = 0.0, None
    for n in leaves:
        gap = abs(got[n] - want[n]) / max(want[n], floor)
        if not gap <= worst:        # NaN counts as worst
            worst, where = gap, n
    return worst, where


def moved_leaves(ref_grad_norms: dict) -> list:
    """Leaves whose reference gradient is not negligible."""
    median = statistics.median(ref_grad_norms.values())
    return [n for n, g in ref_grad_norms.items()
            if g >= NEGLIGIBLE_GRAD * median]


def learner_gaps(prog: dict, ref: dict) -> dict:
    """prog, ref: {"losses": [...], "grad_norms": {...},
    "delta_norms": {...}}.  Returns loss_gap (the first step's loss: the
    later steps' losses turn on the signs of near-zero gradient entries,
    which Adam's first steps move by about lr whatever their size, and
    rounding flips), grad_gap, delta_gap, each step's loss gap and the
    leaves where the norm gaps were largest."""
    steps = [abs(a - b) / abs(b)
             for a, b in zip(prog["losses"], ref["losses"])]
    if len(steps) != len(ref["losses"]) or any(g != g for g in steps):
        steps.append(float("nan"))
    grad_gap, grad_leaf = norm_gap(prog["grad_norms"], ref["grad_norms"])
    moved = moved_leaves(ref["grad_norms"])
    delta_gap, delta_leaf = norm_gap(prog["delta_norms"], ref["delta_norms"],
                                     moved)
    return {"loss_gap": steps[0], "grad_gap": grad_gap,
            "delta_gap": delta_gap, "step_loss_gaps": steps,
            "grad_leaf": grad_leaf, "delta_leaf": delta_leaf,
            "left_out": sorted(set(ref["grad_norms"]) - set(moved))}


def reference_readings(out: dict) -> dict:
    """reference.impala.train's output as readings."""
    return {"losses": out["losses"], "grad_norms": leaf_norms(out["grad"]),
            "delta_norms": leaf_norms(out["delta"])}
