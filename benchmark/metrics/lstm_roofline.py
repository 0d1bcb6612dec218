"""lstm_roofline (%): the LSTM kernels' share of their roofline: the sum of
their bounds over the sum of their device time, over every launch of
kernels 1 (forward, `lstm_layer_cluster_kernel` or `lstm_layer_fwd_kernel`),
4 (backward V2, `lstm_layer_bwd_v2_kernel`) and 5 (backward V1,
`lstm_layer_bwd_v1_kernel`) in the traced window, found by name.

A launch's bound is the larger of its bytes over the HBM bandwidth and its
operations over the dtype's tensor-core peak (TF32 for float32): each input
read once, each output written once; the operations are the products with
Wh (one per step forward, two per step backward in V2, which recomputes
h @ Wh, one in V1).  LayerNorm and the gate math, a few per cent of the
operations, are not counted.  Every layer of the step runs at S = T + 1,
the cell's B rows per card and H, so every launch of a kind has one bound.
"""

from benchmark.core.peaks import bound_s
from benchmark.core.trace import port_kernel

ITEM = {"float32": 4, "bfloat16": 2}


def forward_counts(S, B, H, item, stash=True):
    """(bytes, ops) of kernel 1: gx (S, B, 4H), Wh, five gate vectors, h0,
    c0 in; y (S, B, H), h_n, c_n and, with the stash, c (S, B, H) out."""
    G = 4 * H
    nbytes = item * (S * B * G + H * G + 5 * G + 2 * B * H
                     + S * B * H * (2 if stash else 1) + 2 * B * H)
    return nbytes, 2 * S * B * H * G


def backward_counts(variant, S, B, H, item):
    """(bytes, ops) of kernels 4 (V2) and 5 (V1) with `item`-byte streams:
    each input read once (V2 reads y and c at steps 0..S-2 only), each
    output written once; the parameter sums of V2 ((3, 4H)) and V1's
    gh_pre are float32 whatever the streams."""
    G = 4 * H
    if variant == "v2":
        return (item * (S * B * G + 2 * (S - 1) * B * H + S * B * H + H * G
                        + 5 * G + 4 * B * H + 2 * S * B * G + 2 * B * H)
                + 4 * 3 * G, 4 * S * B * H * G)
    return (item * (S * B * G + 3 * S * B * H + H * G + 2 * G + 2 * B * H
                    + 2 * S * B * G + 2 * B * H) + 4 * S * B * G,
            2 * S * B * H * G)


KINDS = {
    "forward": (("lstm_layer_cluster_kernel", "lstm_layer_fwd_kernel"),
                lambda S, B, H, it: forward_counts(S, B, H, it)),
    "v2": (("lstm_layer_bwd_v2_kernel",),
           lambda S, B, H, it: backward_counts("v2", S, B, H, it)),
    "v1": (("lstm_layer_bwd_v1_kernel",),
           lambda S, B, H, it: backward_counts("v1", S, B, H, it)),
}


def read(trace, ctx):
    if ctx.card is None:
        return None
    traffic = ctx.traffic
    dtype = traffic["dtype"]
    S = traffic["unroll"] + 1
    B = traffic["batch"] // ctx.chips
    H = ctx.config["hidden_size"]
    bound, spent = 0.0, 0.0
    for stems, counts in KINDS.values():
        match = lambda n, stems=stems: port_kernel(n, *stems)
        launches = trace.kernel_count(match)
        if launches:
            nbytes, flops = counts(S, B, H, ITEM[dtype])
            bound += launches * bound_s(nbytes, flops, ctx.card, dtype)
            spent += trace.kernel_s(match)
    if spent <= 0:
        return None
    return 100.0 * bound / spent
