"""The check that the measured process loaded neither JAX nor the JAX
package: top-level module names, compared whole (the port's name begins
with the JAX package's)."""

from __future__ import annotations

import sys

BANNED = ("jax", "jaxlib", "flax", "sagnn_tpu")


def banned_modules() -> list:
    """The banned top-level names present in sys.modules."""
    loaded = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(loaded.intersection(BANNED))
