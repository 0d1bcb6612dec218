"""device_idle_share (%): the share of the traced window in which nothing
ran on the card: 1 - (union of kernel, copy and set intervals) / (first
step's start to last step's end).  In a run over several cards, rank 0's.
"""


def read(trace, ctx):
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
