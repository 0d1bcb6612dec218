"""The program's spans in one traced window of a cell, on every thread of
the process (a report; the benchmark's own runs do not run it).  It lives
until `core/trace.py` keeps every thread's spans and launches itself;
then its numbers become readers under `metrics/` and this file and
`core/spans.py:all_threads` go.

    python3 benchmark/spans.py --workload <cell> --seed <n> --seconds <s> \
        [--out spans.jsonl]

Set-up and an untraced window as `run.py` makes them, then a second window
under `torch.profiler`.  One JSON line, every time in ms per step:
`window_ms` and `untraced_window_ms`, the step's time in the two windows;
`span_ms`, the device time of the kernels launched inside each `dihpc.`
span name (nested spans count in each that holds them; the backward's
spans, on the autograd engine's thread, included); `idle_ms`, the
window's idle time by the innermost span open at each gap's middle on any
thread (the ten largest), and `idle_ms_stepping_thread`, the same over the
stepping thread's spans alone; `by_name`, the device time of kernels 1, 4
and 5 and of the GEMMs found by kernel name, to hold the spans against;
`metrics`, the cell's per-layer metrics as `run.py` reads them from the
same trace; and the span-based numbers that need the other threads
(`lstm_bwd_ms`, `categorical_head_ms`) or group spans: `gemm_fwd_ms`, the
forward's GEMMs outside the LSTM kernels (their backward is not spanned;
the recurrent weight gradient is `span_ms`'s `dihpc.gemm.lstm_dwh`).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import run  # noqa: E402
from benchmark.core import spans as sp, spec as specs  # noqa: E402
from benchmark.core.trace import port_kernel, reduce_profile  # noqa: E402

GEMM_STEMS = ("cutlass", "sm80_xmma", "sm90_xmma", "cublasLt", "gemm")
KERNEL_STEMS = {"lstm_fwd": ("lstm_layer_cluster_kernel",
                             "lstm_layer_fwd_kernel"),
                "lstm_bwd": ("lstm_layer_bwd_v2_kernel",
                             "lstm_layer_bwd_v1_kernel")}
GROUPS = {
    "lstm_bwd_ms": ("dihpc.kernel.lstm_layer_bwd_v2",
                    "dihpc.kernel.lstm_layer_bwd_v2_bf16",
                    "dihpc.kernel.lstm_layer_bwd_v1",
                    "dihpc.kernel.lstm_layer_bwd_v1_bf16"),
    "gemm_fwd_ms": ("dihpc.gemm.embed", "dihpc.gemm.heads",
                    "dihpc.gemm.lstm_input"),
    "categorical_head_ms": tuple(f"dihpc.categorical.{n}{d}"
                                 for n in ("logp_entropy", "logp")
                                 for d in ("", ".bwd")),
}


def _ms(ns: float, steps: int) -> float:
    return ns * 1e-6 / steps


def report(trace, spans: list, launch_at: dict, ctx, spec) -> dict:
    """The line's numbers from a reduced trace and the spans and launches
    of every thread (core.spans.all_threads)."""
    steps = trace.steps
    per_name = {name: sp.device_ms(trace, (name,), spans, launch_at)
                for name in sorted({s[0] for s in spans})}
    device = lambda match: _ms(sum(e - s for n, s, e, _ in trace.kernels
                                   if match(n)), steps)
    by_name = {k: device(lambda n, st=stems: port_kernel(n, *st))
               for k, stems in KERNEL_STEMS.items()}
    by_name["gemm"] = device(lambda n: any(s in n for s in GEMM_STEMS))
    by_name["all"] = device(lambda n: True)
    idle = lambda ss: {k: _ms(v * 1e9, steps)
                       for k, v in sp.idle_by_span(trace, ss)}
    metrics = {}
    for m in specs.cell_metrics(spec, "per_layer", ctx.cell["name"]):
        value = specs.load_module("metrics", m["name"]).read(trace, ctx)
        if value is not None:
            metrics[m["name"]] = value
    out = {"cell": ctx.cell["name"], "seed": ctx.seed, "steps": steps,
           "busy_ms": _ms(trace.busy_ns, steps),
           "window_ms": trace.window_s * 1e3 / steps,
           "untraced_window_ms": ctx.extra["window"]["window_s"] * 1e3
           / ctx.extra["window"]["steps"],
           "metrics": metrics,
           **{k: sp.device_ms(trace, names, spans, launch_at)
              for k, names in GROUPS.items()},
           "by_name": by_name, "span_ms": per_name,
           "span_counts": {n: sum(1 for s in spans if s[0] == n)
                           for n in per_name},
           "idle_ms": idle(spans),
           "idle_ms_stepping_thread": idle(sp.host_spans(trace))}
    return out


def traced(workload: str, seed: int, seconds: float, device=None,
           overrides=None) -> dict:
    """Set-up, an untraced window and a traced one; the report of the
    traced one."""
    from torch.profiler import ProfilerActivity, profile

    args = run.parse(["--workload", workload, "--seed", str(seed),
                      "--seconds", str(seconds), "--trace", "1"])
    spec, ctx = run.build_context(args, device, overrides)
    session = specs.load_module("drivers", ctx.cell["driver"]).Session(ctx)
    activities = [ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    try:
        window = session.window(seconds)
        with profile(activities=activities) as prof:
            session.window(seconds,
                           first=session.first_step + window["steps"])
        trace = reduce_profile(prof)
        spans, launch_at = sp.all_threads(prof, trace.window)
        ctx.extra["window"] = window
        return report(trace, spans, launch_at, ctx, spec)
    finally:
        session.close()


def main(argv=None, device=None, overrides=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    if device is None and not torch.cuda.is_available():
        print("spans: no CUDA device", file=sys.stderr)
        return 2
    line = json.dumps(traced(args.workload, args.seed, args.seconds, device,
                             overrides))
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            print(line, file=f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
