"""Entry-point smoke tests (bitrot guard for __graft_entry__):
`dryrun_multichip(N)` on the conftest 8-device virtual CPU mesh, and the
device check that never turns an accelerator process into a CPU one.
"""

import sys

sys.path.insert(0, ".")


def test_dryrun_multichip_8():
    import __graft_entry__ as graft

    graft.dryrun_multichip(8)


def test_ensure_devices_refuses_to_switch_accelerator(monkeypatch):
    """Too few GPU devices: an error, not a silent CPU re-platforming."""
    import pytest
    import jax

    import __graft_entry__ as graft

    class FakeGpu:
        platform = "gpu"

    updates = []
    monkeypatch.setattr(jax, "devices", lambda *a: [FakeGpu()])
    monkeypatch.setattr(jax.config, "update", lambda *a: updates.append(a))
    with pytest.raises(RuntimeError, match="needs 4 gpu devices"):
        graft._ensure_devices(4)
    assert updates == []
