"""Per-layer metrics, one reader per file: `read(trace, ctx)` returns the
metric's value from the window's device trace (core.trace.Trace) and the
run's context, or None where the trace holds nothing to read."""
