"""The JAX package's examples, ported: each runs with
`python -m di_hpc_tpu_torch.examples.<name>` on the card (`--device cpu`
for the CPU)."""
