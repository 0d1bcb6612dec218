"""What a driver provides to the harness, and the run's context."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from .window import run_window


@dataclass
class Context:
    """One run: its seed, window length, trace switch, cell, configuration
    and device (`cuda:0`, or the CPU when a test drives the harness)."""
    seed: int
    seconds: float
    trace: bool
    cell: dict
    config: dict
    device: torch.device
    card: Optional[dict] = None      # peaks of the card (core.peaks)
    extra: dict = field(default_factory=dict)
    t0: float = field(default_factory=time.perf_counter)
    phases: list = field(default_factory=list)

    def mark(self, phase: str) -> None:
        """Records that set-up `phase` ended now (seconds since start)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.phases.append((phase, time.perf_counter() - self.t0))

    @property
    def traffic(self) -> dict:
        return self.cell["traffic_params"]

    @property
    def chips(self) -> int:
        return self.cell["chips"]


class Session:
    """A driver's set-up, timed path and check.  The constructor does the
    set-up: it builds the program's objects from the seed, runs the steps
    that the check follows through the window's own call, and warms up.
    `step(i)` is the window's call; it returns the step's loss as a 0-d
    tensor."""

    samples_per_step: int = 0
    first_step: int = 0

    def __init__(self, ctx: Context):
        self.ctx = ctx

    def step(self, i: int):
        raise NotImplementedError

    def window(self, seconds: float, steps: Optional[int] = None,
               first: Optional[int] = None) -> dict:
        """The timed window from step `first` (default: the first after
        set-up)."""
        return run_window(self.step, seconds,
                          first=self.first_step if first is None else first,
                          steps=steps)

    def memory_peak(self) -> int:
        if self.ctx.device.type != "cuda":
            return 0
        return torch.cuda.max_memory_allocated(self.ctx.device)

    def free(self) -> None:
        """Drops the program's state before the reference runs."""

    def check(self, window: dict) -> tuple:
        """({name: {"value", "limit"}}, failed steps) against the
        reference."""
        raise NotImplementedError

    def impostor(self, kind: str) -> dict:
        """The compared numbers with the reference put in the program's
        place: "control" computes it one precision below the cell's
        (the cell's `control`), other kinds plant that fault in it."""
        raise NotImplementedError

    def busy_s(self, trace) -> float:
        """Device busy seconds, averaged over the cards the run uses."""
        return trace.busy_s

    def close(self) -> None:
        """Stops whatever the session started."""


def limit_checks(values: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for each compared number."""
    return {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
