"""Frozen dataclasses registered as JAX pytrees.

Fields are pytree leaves unless declared with :func:`static_field`, which
makes them part of the tree structure (hashable, compile-time constants).
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(default):
    """A dataclass field kept out of the pytree's leaves."""
    return dataclasses.field(default=default, metadata=dict(static=True))


def pytree_dataclass(cls):
    """Frozen dataclass + ``jax.tree_util.register_dataclass`` + ``replace``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return jax.tree_util.register_dataclass(cls)
