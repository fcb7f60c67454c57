"""Run set-up computation on the host CPU backend.

Set-up work (model linearization, operator precomputes, the
identification pre-pass) happens once per build.  It runs on the host CPU
on purpose: there float32 matmuls are exact float32 (an accelerator may
run them in TF32), and the float64 NumPy conditioning steps sit beside
it.  Only the closed loop compiles for the accelerator.  A process whose
JAX has no CPU backend cannot build a system: cpu_device() raises.
"""

from __future__ import annotations

from contextlib import contextmanager

import jax


def cpu_device():
    """The host CPU device; RuntimeError if JAX has no CPU backend
    (e.g. JAX_PLATFORMS lists only an accelerator)."""
    try:
        return jax.local_devices(backend="cpu")[0]
    except RuntimeError as e:
        raise RuntimeError(
            "set-up runs on the host CPU backend, which this process does "
            "not have; include 'cpu' in JAX_PLATFORMS (e.g. 'cuda,cpu')"
        ) from e


@contextmanager
def on_cpu():
    """Context: computations default to the CPU backend."""
    with jax.default_device(cpu_device()):
        yield


def to_default(tree):
    """Move a pytree of arrays to the default (accelerator) device.

    Uses the first ADDRESSABLE device: under jax.distributed,
    jax.devices()[0] can belong to another process and device_put onto
    it fails with "non-addressable device"."""
    dev = jax.local_devices()[0]
    return jax.tree.map(lambda a: jax.device_put(a, dev), tree)
