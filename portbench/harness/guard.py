"""The whole-name import check: the benchmark's process may not hold JAX or
the JAX package ``repro`` (``repro_torch`` is another name: the part of a
module's name before its first dot is compared whole)."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
