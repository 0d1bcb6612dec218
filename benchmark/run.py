"""Runs one cell of the benchmark of `di_hpc_tpu_torch` and prints its
result as the last line of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, the kernel library's load or first build, weights and
batches made on the card from the seed, the checked steps and warm-up)
runs first and is `setup_s`; then the window runs for `--seconds`.  With
`--trace 0` the line holds the cell's end-to-end metrics.  With `--trace 1`
a second window of `--seconds` follows under the profiler, and the line
holds the cell's per-layer metrics, read from its device trace (and, for
shares of a peak, the first window's step time, which the profiler's host
cost does not slow).  After the
window the program's state is freed and the plain reference decides
`correct`.  The run exits non-zero without a result where the card or the
cards the cell asks for are missing, or where JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark.core import guard, peaks, report, spec as specs  # noqa: E402
from benchmark.core.session import Context  # noqa: E402
from benchmark.core.trace import breakdown, profiler, reduce_profile  # noqa
from benchmark.core.window import merge, summarize  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(message: str) -> int:
    print(f"benchmark: {message}", file=sys.stderr)
    return 2


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def end_to_end(name: str, window: dict, setup_s: float,
               samples_per_step: int):
    """An end-to-end metric by its name; the part after a dot names the
    kind of cell it is kept for (`samples_per_s.train`)."""
    base = name.split(".", 1)[0]
    if base == "setup_s":
        return setup_s
    return summarize(window, samples_per_step)[base]


def build_context(args, device=None, overrides=None, t0: float = T0):
    spec = specs.benchmark_spec()
    cell = specs.load_cell(args.workload, spec)
    config = specs.load_config(cell["config"], spec)
    for key, value in (overrides or {}).items():
        target = config if key in config else cell["traffic_params"]
        target[key] = value
    if device is None:
        device = torch.device("cuda", 0)
    card = (peaks.peak(torch.cuda.get_device_name(device))
            if device.type == "cuda" else None)
    return spec, Context(args.seed, args.seconds, bool(args.trace), cell,
                         config, device, card,
                         extra={"overrides": dict(overrides or {})}, t0=t0)


def main(argv=None, device=None, overrides=None, t0: float = T0) -> int:
    """One run.  `device` and `overrides` (sizes of the configuration or
    the traffic) are for tests, which drive the harness on the CPU; a run
    from the command line looks for the cards the cell asks for."""
    args = parse(argv)
    if device is None:
        if not torch.cuda.is_available():
            return fail("no CUDA device: torch.cuda.is_available() is false")
        chips = specs.load_cell(args.workload,
                                specs.benchmark_spec())["chips"]
        if torch.cuda.device_count() < chips:
            return fail(f"the cell asks for {chips} cards; "
                        f"{torch.cuda.device_count()} found")
    spec, ctx = build_context(args, device, overrides, t0)
    ctx.mark("imports and context")
    driver = specs.load_module("drivers", ctx.cell["driver"])
    session = driver.Session(ctx)
    try:
        setup_s = time.perf_counter() - t0
        window = checked = session.window(ctx.seconds)
        trace = None
        if ctx.trace:
            with profiler() as prof:
                traced = session.window(
                    ctx.seconds, first=session.first_step + window["steps"])
            trace = reduce_profile(prof)
            checked = merge(window, traced)
        peak = session.memory_peak()
        session.free()
        checks, failed = session.check(checked)
        busy = session.busy_s(trace) if trace is not None else None
    finally:
        session.close()
    found = guard.forbidden_modules()
    if found:
        return fail(f"modules of JAX or the JAX package were loaded: "
                    f"{', '.join(found)}")
    cell = ctx.cell["name"]
    metrics, extra = {}, None
    if trace is None:
        for m in specs.cell_metrics(spec, "end_to_end", cell):
            metrics[m["name"]] = report.metric(
                end_to_end(m["name"], window, setup_s,
                           session.samples_per_step), m["unit"])
    else:
        if trace.busy_ns <= 0:
            return fail("the trace holds no device activity")
        ctx.extra["window"] = window
        for m in specs.cell_metrics(spec, "per_layer", cell):
            value = specs.load_module("metrics", m["name"]).read(trace, ctx)
            if value is not None:
                metrics[m["name"]] = report.metric(value, m["unit"])
        extra = breakdown(trace)
    device_info = {
        "platform": "gpu" if ctx.device.type == "cuda" else "cpu",
        "kind": (torch.cuda.get_device_name(ctx.device)
                 if ctx.device.type == "cuda" else "cpu"),
        "count": ctx.chips, "memory_peak_bytes": peak}
    if trace is not None:
        device_info.update(busy_s=busy, window_s=trace.window_s)
    if ctx.device.type == "cuda":
        device_info["card"] = power_limit()
    for phase, at in ctx.phases:
        print(f"set-up {phase}: ends at {at:.3f} s", file=sys.stderr)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    report.emit(correct, checked["steps"], failed, metrics, device_info,
                checks, extra)
    return 0


if __name__ == "__main__":
    sys.exit(main())
