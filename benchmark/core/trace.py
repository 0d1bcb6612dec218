"""The device trace of a window: `torch.profiler` over every step of it,
reduced to what the per-layer readers need.

Device busy time is the union of every interval in which a kernel, copy or
set ran on the card, within the traced window, which runs from the start of
the first step's span to the end of the last one's (host and device times
share the profiler's clock).  Kernels are matched to the host range that
launched them through the runtime call's correlation id.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Iterable

from .window import STEP_SPAN

TOP = 10


@dataclass
class Trace:
    """Events in ns of the profiler's clock.  `kernels`: (name, start, end,
    correlation) of every device event in the window; `host`: (name, start,
    end) of every host op, range and runtime call on the stepping thread;
    `launch_at`: correlation -> start of the runtime call that launched
    it; `steps`: number of step spans; `window`: (start, end)."""
    kernels: list
    host: list
    launch_at: dict
    steps: int
    window: tuple
    busy_ns: int = 0
    gaps: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        return self.busy_ns * 1e-9

    def kernel_s(self, match) -> float:
        """Seconds of device time of the events whose name `match` accepts."""
        return sum(e - s for n, s, e, _ in self.kernels if match(n)) * 1e-9

    def kernel_count(self, match) -> int:
        return sum(1 for k in self.kernels if match(k[0]))

    def ranges(self, name: str) -> list:
        """(start, end) of every host range or op called `name`."""
        return [(s, e) for n, s, e in self.host if n == name]

    def launched_within(self, ranges: list) -> list:
        """The device events launched by a runtime call that lies inside
        one of `ranges`."""
        ranges = sorted(ranges)
        starts = [r[0] for r in ranges]
        out = []
        for k in self.kernels:
            t = self.launch_at.get(k[3])
            if t is None:
                continue
            j = bisect.bisect_right(starts, t) - 1
            if j >= 0 and t <= ranges[j][1]:
                out.append(k)
        return out


def profiler():
    """`torch.profiler` over the host and the card."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _union(intervals: Iterable[tuple]) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _on_card(ev) -> bool:
    return str(ev.device_type()).endswith("CUDA")


def reduce_profile(prof) -> Trace:
    """The profile's events reduced to a Trace over its step spans.  The
    profiler mirrors each host range (a step span, Adam's range) on the
    card's timeline as an annotation; those are ranges, not work, and are
    left out of the card's events."""
    events = prof.profiler.kineto_results.events()
    spans, host, device, launch_at = [], [], [], {}
    ranges, thread = set(), None
    for ev in events:
        if _on_card(ev) or not ev.is_user_annotation():
            continue
        ranges.add(ev.name())
        if ev.name() == STEP_SPAN:
            spans.append((ev.start_ns(), ev.end_ns()))
            thread = ev.start_thread_id()
    if not spans:
        raise RuntimeError("the profile holds no step spans")
    spans.sort()
    w0, w1 = spans[0][0], spans[-1][1]
    for ev in events:
        s, e = ev.start_ns(), ev.end_ns()
        if _on_card(ev):
            if ev.is_user_annotation() or ev.name() in ranges:
                continue
            if e > w0 and s < w1:
                device.append((ev.name(), max(s, w0), min(e, w1),
                               ev.correlation_id()))
            continue
        if ev.start_thread_id() != thread or e < w0 or s > w1:
            continue
        if ev.name().startswith(("cuda", "cu")):      # runtime, driver
            launch_at[ev.correlation_id()] = s
        host.append((ev.name(), s, e))
    return with_busy(Trace(device, host, launch_at, len(spans), (w0, w1)))


def with_busy(trace: Trace) -> Trace:
    """`trace` with its busy time and idle gaps worked out from its device
    events."""
    w0, w1 = trace.window
    busy = _union((s, e) for _, s, e, _ in trace.kernels)
    trace.busy_ns = sum(e - s for s, e in busy)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    trace.gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                  if edges[i + 1] > edges[i]]
    return trace


def short_name(name: str, limit: int = 120) -> str:
    """A kernel's name without `void ` and its argument list."""
    name = name.removeprefix("void ")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "(" and i > 0 and depth == 0 and name[i - 1] not in " :<,":
            cut = i
            break
        depth += ch == "<"
        depth -= ch == ">"
    return name[:cut][:limit]


def breakdown(trace: Trace) -> dict:
    """The device events that took most time, by name, and the idle gaps
    summed by the innermost host event open at each gap's middle."""
    ops = {}
    for n, s, e, _ in trace.kernels:
        key = short_name(n)
        ops[key] = ops.get(key, 0) + (e - s)
    host = sorted(trace.host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    idle = {}
    for s, e in trace.gaps:
        mid = (s + e) // 2
        j = bisect.bisect_right(starts, mid) - 1
        name = "host: no event open"
        for k in range(j, max(j - 512, -1), -1):
            if host[k][2] >= mid:
                name = "host: " + host[k][0]
                break
        idle[name] = idle.get(name, 0) + (e - s)
    top = lambda d: [[k, v * 1e-9] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"device_ops": top(ops), "idle_gaps": top(idle)}


def port_kernel(name: str, *stems: str) -> bool:
    """Whether `name` is one of the port's kernels with one of `stems` (the
    port's kernels live in anonymous namespaces)."""
    name = name.removeprefix("void ")
    return name.startswith("(anonymous namespace)::") and any(
        name[len("(anonymous namespace)::"):].startswith(s) for s in stems)
