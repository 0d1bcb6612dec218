"""Benchmark of `di_hpc_tpu_torch` on NVIDIA GPUs (see README.md)."""
