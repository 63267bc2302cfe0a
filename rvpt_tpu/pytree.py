"""Pytree dataclass helper.

The reference framework passes scene/camera/settings state to its device kernel
through Vulkan descriptor bindings (reference: src/rvpt/rvpt.cpp:646-655).  The
equivalent here is a pytree: every struct that crosses the host->device
boundary here is a registered dataclass whose array leaves flow through
``jax.jit``/``jax.grad`` and whose static fields participate in the jit cache
key.
"""

from __future__ import annotations

import dataclasses
from typing import TypeVar

from jax.tree_util import register_dataclass

_T = TypeVar("_T")


def static_field(**kwargs):
    """Dataclass field treated as jit-static metadata (not a traced leaf)."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata["static"] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def pytree_dataclass(cls: type[_T]) -> type[_T]:
    """Decorator: frozen dataclass registered as a JAX pytree.

    Fields declared with :func:`static_field` become hashable aux data; all
    other fields are traced leaves.
    """
    cls = dataclasses.dataclass(frozen=True)(cls)
    data_fields = []
    meta_fields = []
    for f in dataclasses.fields(cls):
        if f.metadata.get("static", False):
            meta_fields.append(f.name)
        else:
            data_fields.append(f.name)
    register_dataclass(cls, data_fields=data_fields, meta_fields=meta_fields)
    return cls
