"""Aux subsystems: metrics, logbook, profiling, compile cache, host
set-up, checkpoint."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from mpc_sensorlessao_tpu.models.closed_loop import StepOutputs
from mpc_sensorlessao_tpu.utils import checkpoint, logbook, metrics, profiling
from mpc_sensorlessao_tpu.utils.config import SystemConfig


def _fake_outputs(S=3, T=10):
    rng = np.random.default_rng(0)
    f = lambda *shape: jnp.asarray(rng.uniform(0.1, 1.0, shape), jnp.float32)
    return StepOutputs(
        u=f(S, T, 4), du=f(S, T, 4), volts=f(S, T, 4), x_est=f(S, T, 5),
        x_est_norm=f(S, T), x_pred_norm=f(S, T), cost=f(S, T),
        rms_res=f(S, T) * 0.2, rms_turb=f(S, T), strehl=f(S, T),
    )


def test_metrics_summarize():
    out = _fake_outputs()
    s = metrics.summarize(out)
    d = metrics.to_dict(s)
    assert 0 < d["mean_rms_res"] < 0.3
    assert d["rejection"] > 1.0
    assert set(d) == set(metrics.LoopSummary._fields)


def test_logbook_capture():
    with logbook.capture() as entries:
        logbook.add("turb", "screen synthesized")
        logbook.add("solver", "1 newton step", level="debug")
    tail = entries()
    assert len(tail) == 2
    assert tail[0][2] == "turb"


def test_device_peaks_h100():
    """The H100's published peaks, looked up by its device_kind string."""
    p = profiling.device_peaks("NVIDIA H100 80GB HBM3")
    assert p["f32_flops"] == 67e12 and p["tf32_flops"] == 495e12
    assert p["bf16_flops"] == 989e12 and p["hbm_bytes"] == 3.35e12
    assert "data sheet" in p["source"]


def test_device_peaks_unknown_device_raises():
    """No silent default: a device without published peaks is an error
    (this CPU backend included)."""
    import pytest
    with pytest.raises(KeyError):
        profiling.device_peaks("Unlisted Accelerator 9000")
    with pytest.raises(KeyError):
        profiling.roofline(lambda x: x @ x, jnp.ones((16, 16)), repeats=1)


def test_compile_cache_follows_env(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR set: that directory, nothing set in
    code."""
    from mpc_sensorlessao_tpu.utils import compile_cache
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert compile_cache.enable() == "/some/where"
    assert calls == []


def test_compile_cache_default_in_checkout(monkeypatch):
    """Unset: a fixed, git-ignored directory inside the checkout."""
    import os
    from mpc_sensorlessao_tpu.utils import compile_cache
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    d = compile_cache.enable()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert d == os.path.join(repo, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", d)]
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_hostcompute_raises_without_cpu_backend(monkeypatch):
    """Set-up never moves silently to an accelerator."""
    import pytest
    from mpc_sensorlessao_tpu.utils import hostcompute

    def no_cpu(backend=None, **kw):
        raise RuntimeError(f"Unknown backend {backend}")

    monkeypatch.setattr(jax, "local_devices", no_cpu)
    with pytest.raises(RuntimeError, match="host CPU backend"):
        hostcompute.cpu_device()


def test_checkpoint_round_trip(tmp_path):
    tree = {"a": jnp.arange(5.0), "b": {"c": jnp.ones((3, 3))}}
    cfg = SystemConfig()
    checkpoint.save(str(tmp_path / "ck"), tree, config=cfg)
    restored = checkpoint.restore(str(tmp_path / "ck"), tree)
    np.testing.assert_array_equal(np.asarray(restored["a"]),
                                  np.arange(5.0))
    d = checkpoint.load_config_dict(str(tmp_path / "ck"))
    assert d["mpc"]["horizon"] == 2


# ------------------ gridtools (utilities.m grab-bag parity) ---------------

def test_gridtools_roundtrips_and_formulas():
    import numpy as np
    import jax.numpy as jnp
    from mpc_sensorlessao_tpu.utils import gridtools as gt

    # mean_sub: zero in-mask mean, outside untouched
    rng = np.random.default_rng(0)
    d = jnp.asarray(rng.normal(size=(3, 8, 8)), jnp.float32)
    m = np.zeros((8, 8), bool); m[2:6, 2:6] = True
    out = np.asarray(gt.mean_sub(d, m))
    assert np.abs(out[:, m].mean(axis=1)).max() < 1e-6
    np.testing.assert_allclose(out[:, ~m], np.asarray(d)[:, ~m])

    # toggle_frame roundtrip
    cube = jnp.asarray(rng.normal(size=(6, 6, 4)), jnp.float32)
    flat = gt.toggle_frame(cube, 2)
    assert flat.shape == (36, 4)
    np.testing.assert_allclose(np.asarray(gt.toggle_frame(flat, 3)),
                               np.asarray(cube))

    # rearrange covers every index exactly once
    idx = gt.rearrange((8, 8), (4, 4))
    assert idx.shape == (16, 4)
    assert sorted(idx.ravel().tolist()) == list(range(64))

    # defocus distance <-> focus coefficient inverse pair
    a4 = 3.0
    dz = gt.defocus_distance(a4, 0.2, 0.01, 532e-9)
    back = gt.out_of_focus(dz, 0.2, 0.01, 532e-9)
    assert abs(back - a4) < 1e-9 * abs(a4) + 1e-12

    # fitting error decreases with actuator count, scales (D/r0)^(5/3)
    f1 = gt.fitting_error_variance(1.0, 0.2, 42.0, 100)
    f2 = gt.fitting_error_variance(1.0, 0.2, 42.0, 400)
    assert f2 < f1
    r = (gt.fitting_error_variance(1.0, 0.1, 42.0, 100) / f1)
    assert abs(r - 2 ** (5.0 / 3.0)) < 1e-6

    # gram_schmidt orthonormal
    Q = gt.gram_schmidt(rng.normal(size=(10, 4)))
    np.testing.assert_allclose(Q.T @ Q, np.eye(4), atol=1e-10)

    # point-ahead angle ~ 2 v_orb h / c, tiny positive
    pa = gt.point_ahead_angle(90e3)
    assert 0 < pa < 1e-3
