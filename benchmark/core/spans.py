"""The port's own ranges in a window's trace: `dihpc.` spans
(`di_hpc_tpu_torch.utils.profiling`), which the program opens only while a
profiler runs.

`core.trace.Trace` keeps the host events of the stepping thread, so a
reader sees the spans the step opens there: the step's phases
(`dihpc.train.*`), the forward's layers, and each forward kernel's launch.
The backward's spans (`*.bwd`, the backward kernels' launches) lie on the
autograd engine's thread; `all_threads` reads them from the profile itself,
for the span report (`benchmark/spans.py`).  A trace of a program without
spans holds none, and `device_ms` then gives None.

Both rules here are `core.trace`'s own: `Trace.launched_within` (the
ranges of one call must not nest, as the spans of one name do not) and
`breakdown`'s innermost open host event.
"""

from __future__ import annotations

import dataclasses

from .trace import breakdown

PREFIX = "dihpc."


def host_spans(trace) -> list:
    """(name, start, end) of every `dihpc.` range on the stepping thread."""
    return [h for h in trace.host if h[0].startswith(PREFIX)]


def device_ms(trace, names, spans=None, launch_at=None):
    """Device ms per step of the kernels launched inside the spans called
    one of `names` (the stepping thread's, or `spans` with `launch_at`
    where given); None where no such span is in the trace."""
    spans = host_spans(trace) if spans is None else spans
    ranges = [(s[1], s[2]) for s in spans if s[0] in names]
    if not ranges or trace.steps == 0:
        return None
    if launch_at is not None:
        trace = dataclasses.replace(trace, launch_at=launch_at)
    kernels = trace.launched_within(ranges)
    return sum(e - s for _, s, e, _ in kernels) * 1e-6 / trace.steps


def idle_by_span(trace, spans) -> list:
    """[`host: <name>`, idle s] of the window's idle gaps by the innermost
    of `spans` ((name, start, end, ...)) open at each gap's middle, largest
    first, as `breakdown` lists them by host event."""
    return breakdown(dataclasses.replace(trace, host=spans,
                                         kernels=[]))["idle_gaps"]


def all_threads(prof, window: tuple) -> tuple:
    """From a `torch.profiler` profile, over `window` (start, end) of the
    profiler's clock: (spans, launch_at), where spans are (name, start,
    end, thread) of every `dihpc.` range on every thread of the process,
    and launch_at maps the correlation id of every runtime or driver call
    on every thread to its start."""
    w0, w1 = window
    spans, launch_at = [], {}
    for ev in prof.profiler.kineto_results.events():
        if str(ev.device_type()).endswith("CUDA"):
            continue
        s, e, name = ev.start_ns(), ev.end_ns(), ev.name()
        if e < w0 or s > w1:
            continue
        if name.startswith(PREFIX):
            spans.append((name, s, e, ev.start_thread_id()))
        elif name.startswith(("cuda", "cu")):
            launch_at[ev.correlation_id()] = s
    spans.sort(key=lambda x: x[1])
    return spans, launch_at
