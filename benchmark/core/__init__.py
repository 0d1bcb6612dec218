"""The harness's shared parts: finding cells, configurations and metrics by
name, the timed window, the device trace, the guard against JAX, and the
result line."""
