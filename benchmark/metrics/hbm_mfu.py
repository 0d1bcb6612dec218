"""hbm_mfu (%): the whole V-trace call's share of the card's memory peak:
its least bytes over the HBM bandwidth, over the call's time (the run's
untraced window over its steps; the traced window pays the profiler's
host cost).  The call is bound by memory, so this share, and not one of
FLOPs, bounds the gain of any of its kernels.

Least bytes: every input read once (target and behaviour logits (T, B, N)
float32, int32 actions, values (T+1, B), rewards), every output written
once (the gradients of the target logits and of the values).
"""


def call_bytes(cfg: dict) -> int:
    T, B, N = cfg["unroll"], cfg["batch"], cfg["action_dim"]
    logits = 4 * T * B * N
    return 3 * logits + 4 * (2 * (T + 1) * B + 2 * T * B)


def read(trace, ctx):
    if ctx.card is None:
        return None
    window = ctx.extra["window"]
    step_s = window["window_s"] / window["steps"]
    return 100.0 * call_bytes(ctx.config) / ctx.card["hbm_bytes_per_s"] \
        / step_s
