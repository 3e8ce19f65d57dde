"""Frozen dataclasses registered as JAX pytrees.

`@pytree.dataclass` makes a frozen dataclass whose fields are pytree leaves,
except those declared with `static_field()`: those are treedef metadata
(hashable compile-time constants, part of every jit cache key).
`obj.replace(**changes)` returns an updated copy (`dataclasses.replace`).
"""
from __future__ import annotations

import dataclasses

import jax

_STATIC = "static"


def static_field(**kwargs):
    """A dataclass field carried in the treedef instead of as a leaf."""
    return dataclasses.field(metadata={_STATIC: True}, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get(_STATIC)],
        meta_fields=[f.name for f in fields if f.metadata.get(_STATIC)])
    cls.replace = _replace
    return cls
