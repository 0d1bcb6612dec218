"""The run's result: its checks on standard error, then one JSON line, the
last of standard output."""

from __future__ import annotations

import json
import math
import sys


def _finite(x):
    """The line's numbers with NaN and infinities as strings (JSON has
    none)."""
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def metric(value: float, unit: str) -> dict:
    return {"value": value, "unit": unit}


def emit(correct: bool, attempted: int, failed: int, metrics: dict,
         device: dict, checks: dict, breakdown=None) -> None:
    """Prints each compared number beside its limit as the last lines of
    standard error and the result as the last line of standard output;
    `checks` comes last in the line."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    print(json.dumps(_finite(line)), flush=True)
