"""Keep JAX and the JAX package out of a benchmark process.

Names are compared by their top-level part, the text before the first dot,
whole: `saprobe_alac_tpu_torch` is not `saprobe_alac_tpu`.  Standard library
only, so `run.py` can install the block before it imports anything else.
"""

from __future__ import annotations

import importlib.abc
import sys

#: Top-level module names that may never load in a benchmark process.
BLOCKED = ("jax", "jaxlib", "flax", "saprobe_alac_tpu")


def top_level(name: str) -> str:
    return name.partition(".")[0]


def is_blocked(name: str) -> bool:
    return top_level(name) in BLOCKED


class _Block(importlib.abc.MetaPathFinder):
    """Refuses to find a blocked module, whoever imports it."""

    def find_spec(self, name, path=None, target=None):
        if is_blocked(name):
            raise ImportError(f"the benchmark blocks the import of {name!r}")
        return None


def install() -> None:
    """Put the block first on the import path (once)."""
    if not any(isinstance(f, _Block) for f in sys.meta_path):
        sys.meta_path.insert(0, _Block())


def loaded(modules=None) -> list[str]:
    """The blocked top-level names present in ``modules`` (default
    `sys.modules`)."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(m) for m in names if is_blocked(m)})
