"""What the benchmark's process may not hold: JAX and the JAX package.

Names are compared by whole top-level module name (the part before the
first dot): ``seqrec_tpu_torch`` is the port and passes, ``seqrec_tpu`` is
the JAX package and does not.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "seqrec_tpu"})


def top_level(module_name: str) -> str:
    return module_name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list[str]:
    """Sorted names in ``modules`` (default ``sys.modules``) whose top-level
    name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top_level(n) in FORBIDDEN)
