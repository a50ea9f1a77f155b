"""Frozen pytree dataclasses: ``@struct.dataclass`` with ``.replace``.

Every field is a pytree leaf (or subtree); ``field`` is
``dataclasses.field``, so ``field(default_factory=dict)`` works as usual.
"""

from __future__ import annotations

import dataclasses

import jax

field = dataclasses.field


def _replace(self, **changes):
    """A copy with ``changes`` applied (``dataclasses.replace``)."""
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Make ``cls`` a frozen dataclass registered as a JAX pytree."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = _replace
    names = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=names, meta_fields=[])
