"""Frozen dataclasses registered as JAX pytrees.

``@dataclass`` makes a frozen dataclass whose fields are pytree children,
except fields declared ``field(pytree_node=False)``, which are static
metadata (hashed into the jit cache key).  Instances get a ``replace``
method.  Plain JAX (``jax.tree_util.register_dataclass``), so the package
needs no library beyond JAX, NumPy and SciPy.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """dataclasses.field with a pytree_node flag (False = static)."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields
                     if f.metadata.get("pytree_node", True)],
        meta_fields=[f.name for f in fields
                     if not f.metadata.get("pytree_node", True)])
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return cls
