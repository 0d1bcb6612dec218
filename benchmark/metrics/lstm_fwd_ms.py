"""lstm_fwd_ms (ms): device time per step of the LSTM forward kernel: the
kernels launched inside the program's `dihpc.kernel.lstm_layer_fused`
spans (`..._bf16` for bf16 streams), one per counted launch of kernel 1,
found by the span and not by the kernel's name.  None where the program
opens no such span."""

from benchmark.core.spans import device_ms

SPANS = ("dihpc.kernel.lstm_layer_fused", "dihpc.kernel.lstm_layer_fused_bf16")


def read(trace, ctx):
    return device_ms(trace, SPANS)
