"""Framework-wide numeric constants (the port's own copy of
di_hpc_tpu/utils/constants.py; the port imports nothing from the JAX
package)."""

# LayerNorm epsilon (reference: EPSILON=1e-5; torch.nn.LayerNorm default).
LAYERNORM_EPS = 1e-5

# Value-rescale epsilon for h(x)/h^-1(x).
VALUE_RESCALE_EPS = 1e-2

# Masked-attention constants for models.pre_sample.
PRE_SAMPLE_MASK_VALUE = -1e9
PRE_SAMPLE_DIV_FACTOR = 0.8

# Default Huber threshold for quantile-regression losses.
DEFAULT_KAPPA = 1.0

# Logits at or below this value are masked-invalid in the categorical head.
MASKED_LOGIT = -1e9
