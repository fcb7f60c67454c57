"""Checkpoint / resume for built systems and simulation outputs.

The reference checkpoints only via .mat artifacts between workflow stages
(reference: README.md:266,294-295; SURVEY.md section 5.4).  Here any
pytree (the built System, scenario batches, telemetry) round-trips through
one NumPy ``.npz`` of its leaves; static metadata (configs) goes alongside
as JSON.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from typing import Any

import jax
import numpy as np


def save(path: str, pytree: Any, config=None,
         overwrite: bool = False) -> None:
    """Save an array pytree (+ optional dataclass config) to ``path``.

    ``overwrite=True`` replaces an existing checkpoint atomically (written
    beside it, then renamed over it) -- the periodic-checkpoint pattern
    (benchmarks/montecarlo_100k.py persists per-chunk summaries + cursor
    after every chunk)."""
    path = os.path.abspath(path)
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(f"checkpoint exists: {path}")
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".ckpt-", dir=parent)
    try:
        leaves = jax.tree.leaves(pytree)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)})
        if config is not None:
            with open(os.path.join(tmp, "config.json"), "w") as f:
                json.dump(dataclasses.asdict(config), f, indent=2,
                          default=str)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)


def restore(path: str, like: Any) -> Any:
    """Restore a pytree saved by `save`, matching ``like``'s structure."""
    leaves, treedef = jax.tree.flatten(like)
    with np.load(os.path.join(os.path.abspath(path), "arrays.npz")) as z:
        if len(z.files) != len(leaves):
            raise ValueError(f"checkpoint has {len(z.files)} leaves, "
                             f"expected {len(leaves)}")
        arrays = [jax.numpy.asarray(z[f"leaf_{i}"])
                  for i in range(len(leaves))]
    return jax.tree.unflatten(treedef, arrays)


def load_config_dict(path: str) -> dict:
    with open(os.path.join(os.path.abspath(path), "config.json")) as f:
        return json.load(f)
