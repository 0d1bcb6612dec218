"""Tracing, timing and roofline utilities, the counterpart of the JAX
package's utils/profiling.py:

 - `trace(log_dir)`: a context manager around torch.profiler that writes a
   Chrome trace (view in Perfetto or chrome://tracing) into `log_dir`;
 - `bench_fn`: per-call time as the difference between k2 and k1
   back-to-back calls, which cancels the fixed cost around a run;
 - `roofline`: the measured time against the card's HBM speed of light for
   the call's memory traffic, from a data-sheet table of cards.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from .checkpoint import tree_flatten

__all__ = ["trace", "bench_fn", "Roofline", "roofline", "HBM_BYTES_PER_S"]

# Peak HBM bandwidth in bytes/s, by torch.cuda.get_device_name(), from
# NVIDIA's data sheets (at the card's full power limit).
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,      # H100 SXM5
    "NVIDIA H100 PCIe": 2.0e12,
}

DEFAULT_TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "trace"


@contextlib.contextmanager
def trace(log_dir: str | Path = DEFAULT_TRACE_DIR):
    """Profile a block: `with trace(d): f()`, then open the Chrome trace
    written into d.  Traces the card too where one is present."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield str(log_dir)
    prof.export_chrome_trace(
        os.path.join(str(log_dir), f"trace_{time.time_ns()}.json"))


def _first_tensor(out) -> torch.Tensor:
    leaves, _ = tree_flatten(out)
    return next(x for x in leaves if isinstance(x, torch.Tensor))


def bench_fn(fn, *args, k1: int = 10, k2: int = 110, reps: int = 4,
             method: str = "barrier") -> float:
    """Seconds per application of fn(*args): the best of `reps` runs of k2
    back-to-back calls, less the best of k1, over k2 - k1.  On CUDA
    arguments each run is timed by CUDA events, so it is the card's time
    for the calls; otherwise by the host clock.

    method="barrier" (default) is plain repetition: eager PyTorch hoists
    nothing out of the loop, so each call does the op's full work on
    untouched inputs (the JAX version needs an optimization barrier for
    this).  method="perturb" keeps the JAX package's legacy scheme: every
    floating tensor of args[0] gets the previous call's output sum times
    1e-12, in the tensor's own dtype, before each call.  It chains the calls
    but costs an extra pass over the inputs per call; kept for A/B checks.
    """
    if method not in ("barrier", "perturb"):
        raise ValueError(f"bench_fn: unknown method {method!r}")
    leaves, _ = tree_flatten(args)
    cuda = any(isinstance(x, torch.Tensor) and x.device.type == "cuda"
               for x in leaves)

    def run(K):
        if method == "barrier":
            for _ in range(K):
                fn(*args)
            return
        first_leaves, first_rebuild = tree_flatten(args[0])
        carry = None
        for _ in range(K):
            dep0 = args[0]
            if carry is not None:
                dep0 = first_rebuild([
                    x + (carry * 1e-12).to(x.dtype)
                    if isinstance(x, torch.Tensor) and x.is_floating_point()
                    else x for x in first_leaves])
            out = fn(dep0, *args[1:])
            carry = _first_tensor(out).detach().float().sum() * 1e-12 + 1.0

    def timed(K) -> float:
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(K)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t = time.perf_counter()
        run(K)
        return time.perf_counter() - t

    times = []
    for K in (k1, k2):
        run(K)                       # warm-up: first-call builds, caches
        times.append(min(timed(K) for _ in range(reps)))
    return max((times[1] - times[0]) / (k2 - k1), 1e-12)


@dataclass
class Roofline:
    seconds: float
    bytes_accessed: int
    achieved_gbps: float
    sol_seconds: float
    sol_fraction: float

    def __str__(self):
        return (f"{self.seconds*1e6:.1f}us, {self.achieved_gbps/1e9:.0f}GB/s "
                f"({self.sol_fraction*100:.0f}% of HBM speed-of-light, "
                f"floor {self.sol_seconds*1e6:.1f}us)")


def roofline(seconds: float, bytes_accessed: int,
             chip: str | None = None) -> Roofline:
    """The call's time against bytes_accessed / the peak HBM bandwidth of
    `chip` (a torch.cuda.get_device_name(); None: this process's card).
    Raises for a card the table does not hold."""
    if chip is None:
        if not torch.cuda.is_available():
            raise RuntimeError("roofline: no card visible; name the chip")
        chip = torch.cuda.get_device_name()
    if chip not in HBM_BYTES_PER_S:
        raise ValueError(f"roofline: no HBM bandwidth on record for "
                         f"{chip!r}; known: {sorted(HBM_BYTES_PER_S)}")
    sol = bytes_accessed / HBM_BYTES_PER_S[chip]
    return Roofline(
        seconds=seconds,
        bytes_accessed=bytes_accessed,
        achieved_gbps=bytes_accessed / seconds,
        sol_seconds=sol,
        sol_fraction=sol / seconds,
    )
