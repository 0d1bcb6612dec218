"""Published peaks of the cards the benchmark knows (NVIDIA's data sheets,
dense rates without sparsity, at the full power limit).

Float32 matrix products are bounded at the TF32 tensor-core rate: it is
the fastest way the card offers to multiply float32 operands, so no
float32 kernel can beat it, however it reaches float32 accuracy.
Elementwise float32 work outside the tensor cores is bounded at the
`simt` rate.
"""

from __future__ import annotations

from typing import Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "flop_per_s": {"float32": 495e12, "bfloat16": 989e12,
                       "simt_float32": 67e12},
    },
}


def peak(device_name: str) -> Optional[dict]:
    """The card's peaks, or None for a card not in the table (its metrics
    of a peak are then left out)."""
    return PEAKS.get(device_name)


def bound_s(nbytes: float, flops: float, card: dict, rate: str) -> float:
    """The least time of a piece of work: the larger of its bytes over the
    memory bandwidth and its operations over the `rate` peak."""
    return max(nbytes / card["hbm_bytes_per_s"],
               flops / card["flop_per_s"][rate])
