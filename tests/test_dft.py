"""Partial centered DFT vs FFT reference path."""

import numpy as np
import jax
import jax.numpy as jnp

from mpc_sensorlessao_tpu.ops import dft, psf


def test_partial_dft_equals_fftshift_fft2():
    rng = np.random.default_rng(0)
    N, half = 64, 7
    X = (rng.normal(size=(N, N)) + 1j * rng.normal(size=(N, N))).astype(
        np.complex64)
    A = dft.centered_partial_dft(N, half)
    ours = np.asarray(dft.partial_centered_fft2(jnp.asarray(X), A))
    full = np.fft.fftshift(np.fft.fft2(np.fft.fftshift(X)))
    c = N // 2
    ref = full[c - half:c + half + 1, c - half:c + half + 1]
    np.testing.assert_allclose(ours, ref, rtol=2e-3, atol=2e-2)


def test_diversity_measurements_dft_matches_fft_path():
    rng = np.random.default_rng(1)
    R, half = 64, 7
    pupil = psf.pupil_mask(R)
    phase = jnp.asarray(rng.normal(size=(R, R)) * 0.3, jnp.float32)
    div = jnp.asarray(rng.normal(size=(3, R, R)) * 0.1, jnp.float32)
    scale = 1e-3
    y_fft = psf.diversity_measurements(phase, div, pupil, scale, half)
    A = dft.centered_partial_dft(R, half)
    y_dft = psf.diversity_measurements(phase, div, pupil, scale, half,
                                       dft_op=A)
    np.testing.assert_allclose(np.asarray(y_dft), np.asarray(y_fft),
                               rtol=1e-3, atol=1e-4)


def test_partial_dft_batched():
    rng = np.random.default_rng(2)
    X = jnp.asarray(rng.normal(size=(5, 3, 32, 32)), jnp.complex64)
    A = dft.centered_partial_dft(32, 4)
    out = dft.partial_centered_fft2(X, A)
    assert out.shape == (5, 3, 9, 9)


def test_bf16_measurement_path_accuracy():
    """bfloat16 DFT operands: ~sub-percent measurement error, far below
    the 10 dB noise floor (EstimatorConfig.dft_dtype)."""
    import dataclasses
    from mpc_sensorlessao_tpu.models import estimator
    from mpc_sensorlessao_tpu.ops import zernike
    from mpc_sensorlessao_tpu.utils.config import EstimatorConfig

    basis = zernike.make_basis(6, 64)
    m32 = estimator.build(EstimatorConfig(resolution=64), basis)
    m16 = estimator.build(
        EstimatorConfig(resolution=64, dft_dtype="bfloat16"), basis)
    rng = np.random.default_rng(0)
    x = jnp.asarray(0.3 * rng.normal(size=27), jnp.float32)
    phase = jnp.einsum("k,kij->ij", x, basis.stack[1:])
    y32 = np.asarray(estimator.measure(m32, phase))
    y16 = np.asarray(estimator.measure(m16, phase))
    rel = np.linalg.norm(y16 - y32) / np.linalg.norm(y32)
    assert rel < 0.02, rel
    # and the estimate built on it barely moves
    x32 = np.asarray(estimator.estimate(m32, jnp.asarray(y32)))
    x16 = np.asarray(estimator.estimate(m16, jnp.asarray(y16)))
    assert np.linalg.norm(x16 - x32) < 0.1 * np.linalg.norm(x32)


def test_packed_operator_layout():
    """[real; 0; imag; 0] halves of a power-of-two height (>= 16)."""
    op = dft.centered_partial_dft(32, 5)                 # w = 11
    packed = np.asarray(dft.packed_operator(op))
    h = dft.packed_half(11)
    assert h == 16 and packed.shape == (32, 32)
    np.testing.assert_array_equal(packed[:11], np.asarray(op[0]))
    np.testing.assert_array_equal(packed[h:h + 11], np.asarray(op[1]))
    assert not packed[11:h].any() and not packed[h + 11:].any()
