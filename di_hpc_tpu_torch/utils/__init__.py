"""Constants, checkpointing, profiling and the C host core of the port; the
names the JAX package's utils exports."""

from . import constants  # noqa: F401
from .constants import (
    LAYERNORM_EPS,
    VALUE_RESCALE_EPS,
    PRE_SAMPLE_MASK_VALUE,
    PRE_SAMPLE_DIV_FACTOR,
    DEFAULT_KAPPA,
)
from .checkpoint import save_pytree, load_pytree
from .profiling import bench_fn, roofline, trace
