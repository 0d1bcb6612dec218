"""The timed window: a closed loop of steps, each timed from its start to
the moment its loss reaches the host.

A learner that logs every step reads its loss each step, so each step ends
with that read, which waits for the card.  The window runs for `seconds`
of the host clock, or for a fixed number of steps where every rank of a
world must run the same count; every step of it is counted.
"""

from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Callable, Optional

from torch.profiler import record_function

STEP_SPAN = "bm.step"


def run_window(step: Callable[[int], object], seconds: float,
               first: int = 0, steps: Optional[int] = None) -> dict:
    """Calls `step(i)` for i = first, first + 1, ...; each returns a 0-d
    tensor, read to the host (`float`) before the next step starts, with
    Python's garbage collector held off so that no collection lands inside
    a step.  Stops once `seconds` have passed, or after `steps` steps when
    given.  Each step is one `STEP_SPAN` range for the trace.  Returns the step times,
    the losses read and the window's length (first start to last end)."""
    gc.collect()
    gc.disable()
    times, losses = [], []
    i = first
    start = end = time.perf_counter()
    try:
        while True:
            t = time.perf_counter()
            with record_function(STEP_SPAN):
                loss = float(step(i))
            end = time.perf_counter()
            times.append(end - t)
            losses.append(loss)
            i += 1
            if (i - first >= steps if steps is not None
                    else end - start >= seconds):
                break
    finally:
        gc.enable()
    return {"step_s": times, "losses": losses, "window_s": end - start,
            "steps": len(times)}


def merge(a: dict, b: dict) -> dict:
    """Two windows run back to back, as one for the check."""
    return {"step_s": a["step_s"] + b["step_s"],
            "losses": a["losses"] + b["losses"],
            "window_s": a["window_s"] + b["window_s"],
            "steps": a["steps"] + b["steps"]}


def percentile(values: list, q: float) -> float:
    """The q-th percentile, by the nearest rank of the sorted values."""
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100 * len(ordered)))
    return ordered[rank - 1]


def summarize(window: dict, samples_per_step: int) -> dict:
    """End-to-end numbers of a window: samples per second over the whole
    window, the 95th percentile and the median step in ms."""
    return {"samples_per_s": window["steps"] * samples_per_step
            / window["window_s"],
            "step_ms_p95": percentile(window["step_s"], 95) * 1e3,
            "step_ms_p50": statistics.median(window["step_s"]) * 1e3}
