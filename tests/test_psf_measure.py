"""Symmetric-triple PSF measure: plain jnp path, GPU kernel (interpret
mode here, compiled on the card), and the wrapper's padding and tiles."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mpc_sensorlessao_tpu.ops import dft, psf, psf_kernel


def _inputs(R, B, crop_half, seed=0, a=3.0):
    rng = np.random.default_rng(seed)
    phase = jnp.asarray(rng.normal(size=(B, R, R)) * 0.4, jnp.float32)
    zmap = jnp.asarray(rng.normal(size=(R, R)) * 0.5, jnp.float32)
    pupil = psf.pupil_mask(R)
    op = dft.centered_partial_dft(R, crop_half)
    return (phase, pupil, pupil * jnp.cos(a * zmap),
            pupil * jnp.sin(a * zmap), op, jnp.stack([-a * zmap, 0 * zmap,
                                                      a * zmap]))


@pytest.mark.parametrize("R", [32, 64])
@pytest.mark.parametrize("B", [1, 3])
def test_sym3_plain_matches_full_fft_crop(R, B):
    """The plain sym3 path (cos/sin once, +/- after the first matmul)
    equals the reference's full FFT2 + crop on the same diversity stack."""
    phase, pupil, pcd, psd, op, div = _inputs(R, B, crop_half=7)
    y_ref = np.asarray(psf.diversity_measurements(phase, div, pupil, 2.0, 7))
    y = np.asarray(psf.sym3_measurements(phase, pupil, pcd, psd, op, 2.0))
    assert y.shape == (B, 3 * 15 * 15)
    np.testing.assert_allclose(y, y_ref, rtol=1e-4,
                               atol=1e-5 * np.abs(y_ref).max())


def test_sym3_leading_axes_and_vmap():
    """(…, R, R) leading axes and vmap give the per-phase result."""
    phase, pupil, pcd, psd, op, _ = _inputs(32, 4, crop_half=5)
    f = lambda p: psf.sym3_measurements(p, pupil, pcd, psd, op, 1.0)
    y = np.asarray(f(phase))
    y2 = np.asarray(f(phase.reshape(2, 2, 32, 32))).reshape(4, -1)
    yv = np.asarray(jax.jit(jax.vmap(f))(phase))
    np.testing.assert_allclose(y2, y, rtol=1e-6, atol=0)
    np.testing.assert_allclose(yv, y, rtol=1e-5,
                               atol=1e-6 * np.abs(y).max())


@pytest.mark.parametrize("R,crop_half", [(32, 7), (64, 9)])
def test_kernel_interpret_matches_plain_rows(R, crop_half):
    """The Triton kernel (interpret mode) computes the plain path's thin
    rows, diversities ordered (-a, 0, +a)."""
    phase, pupil, pcd, psd, op, _ = _inputs(R, 2, crop_half, seed=1)
    a2 = dft.packed_operator(op)
    ref = np.asarray(psf.thin_rows_reference(phase, pupil, pcd, psd, a2))
    out = np.asarray(psf_kernel.thin_rows(phase, pupil, pcd, psd, a2,
                                          interpret=True))
    assert out.shape == ref.shape == (2, 3, R, 2 * dft.packed_half(
        2 * crop_half + 1))
    np.testing.assert_allclose(out, ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())


def test_kernel_interpret_bf16_operands():
    """bfloat16 matmul operands with float32 accumulation stay within the
    bf16 rounding of the float32 rows."""
    phase, pupil, pcd, psd, op, _ = _inputs(32, 1, 7, seed=2)
    a2 = dft.packed_operator(op)
    ref = np.asarray(psf.thin_rows_reference(phase, pupil, pcd, psd, a2))
    out = np.asarray(psf_kernel.thin_rows(
        phase, pupil, pcd, psd, a2, compute_dtype=jnp.bfloat16,
        interpret=True))
    assert np.abs(out - ref).max() < 2e-2 * np.abs(ref).max()


@pytest.mark.parametrize("w,h", [(9, 16), (15, 16), (19, 32), (31, 32),
                                 (33, 64)])
def test_packed_half_padding(w, h):
    """Each operator half is padded to a power of two >= 16: 2w=62 -> 64
    for the reference's 31 x 31 crop."""
    assert dft.packed_half(w) == h


@pytest.mark.parametrize("R,tiles,ok", [(512, (64, 16), True),
                                        (128, (64, 16), True),
                                        (32, (32, 16), True),
                                        (16, (16, 16), True),
                                        (48, None, False),
                                        (8, None, False)])
def test_kernel_tiles_and_support(R, tiles, ok):
    """Power-of-two grids take the kernel with tiles clipped to the grid;
    other grids fall back to the plain path."""
    assert psf_kernel.supports(R) is ok
    if ok:
        assert psf_kernel.tiles(R) == tiles
    else:
        with pytest.raises(ValueError):
            phase, pupil, pcd, psd, op, _ = _inputs(R, 1, 3)
            psf_kernel.thin_rows(phase, pupil, pcd, psd,
                                 dft.packed_operator(op), interpret=True)


@pytest.mark.parametrize("B,R,kernel", [(1, 512, False), (16, 512, False),
                                        (17, 512, True), (256, 512, True),
                                        (65, 128, False), (66, 128, True),
                                        (4096, 128, True),
                                        (4096, 48, False)])
def test_kernel_chosen_by_batch_size(B, R, kernel):
    """The kernel only when its grid gives every SM a program: B=1 at
    R=512 (8 row tiles) stays on the plain path, B=256 takes the kernel."""
    assert psf.uses_kernel(B, R) is kernel


def test_vmap_folds_scenarios_into_one_batch(monkeypatch):
    """Under (nested) vmap the choice and the kernel's grid see every
    scenario: lowered for CUDA, 2 x 3 mapped single-phase calls become
    one Triton kernel over a grid of 6 phases, while one unmapped phase
    stays on the plain path.  On this backend the rows equal the
    per-phase plain rows."""
    monkeypatch.setattr(psf, "KERNEL_MIN_PROGRAMS", 4)
    phase, pupil, pcd, psd, op, _ = _inputs(32, 6, crop_half=5, seed=4)
    a2 = dft.packed_operator(op)

    def one(p):                                    # (R, R) -> (3, R, 2h)
        return psf.thin_rows(p[None], pupil, pcd, psd, a2)[0]

    nested = jax.jit(jax.vmap(jax.vmap(one)))
    grid = phase.reshape(2, 3, 32, 32)
    cuda = nested.trace(grid).lower(lowering_platforms=("cuda",)).as_text()
    assert cuda.count("xla.gpu.triton") == 1 and "grid_x = 6 :" in cuda
    single = jax.jit(one).trace(phase[0]).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "triton" not in single
    ref = psf.thin_rows_reference(phase, pupil, pcd, psd, a2)
    np.testing.assert_allclose(np.asarray(nested(grid)).reshape(ref.shape),
                               np.asarray(ref), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(ref)).max())


@pytest.mark.parametrize("R,B", [(512, 256), (128, 4096)])
def test_measure_lowers_kernel_for_cuda_at_reference_widths(R, B):
    """The loop's batched measure at the cells' widths lowers, for CUDA,
    to one Triton kernel over a (B, R/64) grid (Pallas emits the Triton
    IR while lowering, so its errors show here without a card)."""
    pupil = psf.pupil_mask(R)
    op = dft.centered_partial_dft(R, 15)
    measure = jax.jit(jax.vmap(
        lambda p: psf.sym3_measurements(p, pupil, pupil, pupil, op, 1.0)))
    spec = jax.ShapeDtypeStruct((B, R, R), jnp.float32)
    cuda = measure.trace(spec).lower(lowering_platforms=("cuda",)).as_text()
    assert cuda.count("xla.gpu.triton") == 1
    assert f"grid_x = {B} :" in cuda and f"grid_y = {R // 64} :" in cuda


def test_vmap_over_pupil_maps_takes_plain_path():
    """Mapped pupil maps (no shared kernel operand) fall back to the
    mapped plain path, same rows."""
    phase, pupil, pcd, psd, op, _ = _inputs(32, 2, crop_half=5, seed=5)
    a2 = dft.packed_operator(op)
    pcds = jnp.stack([pcd, 0.5 * pcd])
    out = jax.vmap(lambda c: psf.thin_rows(phase, pupil, c, psd, a2))(pcds)
    for i in range(2):
        ref = psf.thin_rows_reference(phase, pupil, pcds[i], psd, a2)
        np.testing.assert_allclose(np.asarray(out[i]), np.asarray(ref),
                                   rtol=1e-6, atol=1e-6)


def test_sym3_non_power_of_two_grid_uses_plain_path():
    """R=48 (no kernel tiling) still measures correctly."""
    phase, pupil, pcd, psd, op, div = _inputs(48, 2, crop_half=7)
    y_ref = np.asarray(psf.diversity_measurements(phase, div, pupil, 1.0, 7))
    y = np.asarray(psf.sym3_measurements(phase, pupil, pcd, psd, op, 1.0))
    np.testing.assert_allclose(y, y_ref, rtol=1e-4,
                               atol=1e-5 * np.abs(y_ref).max())


@pytest.mark.gpu
@pytest.mark.parametrize("R,B", [(512, 4), (128, 16)])
def test_kernel_compiled_matches_float64_crop(gpu, R, B):
    """On the card: the compiled kernel's measure at the reference widths
    against the float64 full-FFT crop, to 1e-3 of max intensity (TF32
    first stage; the SNR-10 dB noise floor is ~1e-2 of max)."""
    phase, pupil, pcd, psd, op, div = _inputs(R, B, crop_half=15, seed=3)
    a2 = dft.packed_operator(op)
    rows = jax.jit(psf_kernel.thin_rows)(phase, pupil, pcd, psd, a2)
    y = np.asarray(psf.measurement_vector(
        psf.crops_from_rows(rows, a2, 31, 1.0)), np.float64)
    ph = np.asarray(phase, np.float64)[:, None] + np.asarray(div, np.float64)
    field = np.asarray(pupil, np.float64) * np.exp(1j * ph)
    full = np.fft.fftshift(np.fft.fft2(np.fft.fftshift(
        field, axes=(-2, -1))), axes=(-2, -1))
    c = R // 2
    crop = np.abs(full[..., c - 15:c + 16, c - 15:c + 16]) ** 2
    y_ref = np.swapaxes(crop, -1, -2).reshape(B, -1)
    assert np.abs(y - y_ref).max() < 1e-3 * np.abs(y_ref).max()
