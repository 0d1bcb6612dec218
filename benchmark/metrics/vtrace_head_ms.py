"""vtrace_head_ms (ms): device time per call of `ops.vtrace_error` (forward
and backward) outside kernels 2 and 3 (`vtrace_chunked_kernel`): the
categorical head, the importance weights and the loss's small kernels."""

from benchmark.core.trace import port_kernel


def read(trace, ctx):
    if trace.steps == 0:
        return None
    scans = lambda n: port_kernel(n, "vtrace_chunked_kernel")
    if trace.kernel_count(scans) == 0:
        return None
    rest = trace.kernel_s(lambda n: True) - trace.kernel_s(scans)
    return rest * 1e3 / trace.steps
