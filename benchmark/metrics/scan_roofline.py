"""scan_roofline (%): kernels 2 (`vtrace_chunked_kernel<true>`, the losses)
and 3 (`vtrace_chunked_kernel<false>`, returns and advantages) against their
bounds: the sum of their bounds over the sum of their device time.

Counts at (T, B), each input read once and each output written once:
kernel 2 reads the importance weights, log-probs and rewards (T, B) and
the values (T+1, B) and writes two partial sums per column, 20 float32
operations per element; kernel 3 reads the weights and rewards and the
values and writes the returns and advantages (T, B), 15 per element.  The
operations run outside the tensor cores (the `simt` peak).
"""

from benchmark.core.peaks import bound_s
from benchmark.core.trace import port_kernel


def losses_counts(T, B):
    return 4 * (3 * T * B + (T + 1) * B + 2 * B), 20 * T * B


def returns_counts(T, B):
    return 4 * (2 * T * B + (T + 1) * B + 2 * T * B), 15 * T * B


KINDS = (("vtrace_chunked_kernel<true", losses_counts),
         ("vtrace_chunked_kernel<false", returns_counts))


def read(trace, ctx):
    if ctx.card is None:
        return None
    T, B = ctx.config["unroll"], ctx.config["batch"]
    bound, spent = 0.0, 0.0
    for stem, counts in KINDS:
        match = lambda n, stem=stem: port_kernel(n, stem)
        launches = trace.kernel_count(match)
        if launches:
            bound += launches * bound_s(*counts(T, B), ctx.card,
                                        "simt_float32")
            spent += trace.kernel_s(match)
    if spent <= 0:
        return None
    return 100.0 * bound / spent
