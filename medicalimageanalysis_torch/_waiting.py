"""Stand-ins for the JAX package's public names that a later slice ports.

Each stand-in keeps the name the JAX package has, so code written against
that package finds it, and raises NotImplementedError naming the
ROADMAP.md queue 1 item that brings it, instead of an AttributeError.
"""

from __future__ import annotations

__all__ = ["waiting"]


def waiting(name, item):
    """A callable standing in for ``name``: calling it (as a function, a
    method or a classmethod) raises NotImplementedError naming ``item``.
    The item is also its ``roadmap_item`` attribute."""
    def stub(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP.md queue 1, {item})")

    stub.__name__ = name.rsplit(".", 1)[-1]
    stub.__qualname__ = name
    stub.roadmap_item = item
    return stub
