"""What may not be loaded in a process of the benchmark: JAX and the JAX
package, by top-level module name compared whole (the port's `nbx_torch` is
not `nbx`)."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "nbx")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))
