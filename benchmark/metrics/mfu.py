"""mfu (%): the learner step's model FLOPs over its time over the peak of
the configuration's dtype on the cards used.

Model FLOPs of the LN-LSTM actor-critic at S = T + 1 steps, B rows
(global), obs O, hidden H, L layers, A actions, counting each multiply-add
as 2 and the matrix products only: the forward is
2 S B (O H + L 8 H^2 + H A + H) (embedding, x @ Wx and h @ Wh per layer,
policy and value heads); the backward is twice each product except the
embedding's input gradient, which no one needs.  Work recomputed to save
memory is not counted.  Step time is the run's untraced window over its
steps (the traced window pays the profiler's host cost per operation).
Peak: the dense tensor-core rate of the dtype (TF32 for float32), times the
cards.
"""


def model_flops(cfg: dict, unroll: int, batch: int) -> float:
    S, B = unroll + 1, batch
    O, H, L, A = (cfg[k] for k in ("obs_dim", "hidden_size", "num_layers",
                                   "action_dim"))
    products = O * H + L * 8 * H * H + H * A + H
    forward = 2 * S * B * products
    backward = 2 * forward - 2 * S * B * O * H
    return forward + backward


def read(trace, ctx):
    if ctx.card is None:
        return None
    traffic = ctx.traffic
    flops = model_flops(ctx.config, traffic["unroll"], traffic["batch"])
    window = ctx.extra["window"]
    step_s = window["window_s"] / window["steps"]
    peak = ctx.card["flop_per_s"][traffic["dtype"]] * ctx.chips
    return 100.0 * flops / step_s / peak
