"""adam_ms (ms): device time per step of the kernels that Adam's update
launches: those whose runtime launch lies inside the profiler's
`Optimizer.step#Adam.step` range."""

RANGE = "Optimizer.step#Adam.step"


def read(trace, ctx):
    ranges = trace.ranges(RANGE)
    if not ranges or trace.steps == 0:
        return None
    kernels = trace.launched_within(ranges)
    if not kernels:
        return None
    return sum(e - s for _, s, e, _ in kernels) * 1e-6 / trace.steps
