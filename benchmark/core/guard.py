"""The check that nothing in the process loaded JAX or the JAX package.

Module names are compared by their top-level name (before the first dot)
whole: the port's package, `di_hpc_tpu_torch`, begins with the JAX
package's name, `di_hpc_tpu`, and is not that package.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "di_hpc_tpu"})


def forbidden_modules(modules=None) -> list:
    """Top-level names of loaded modules that are JAX or the JAX package."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
