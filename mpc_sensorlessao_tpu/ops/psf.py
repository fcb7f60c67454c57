"""Phase-diversity PSF formation.

Equivalent of the reference's estimator measurement path
(reference: README.md:366-397,457-475): for each defocus diversity zd in
{-zd, 0, +zd} form  P = pupil .* exp(1i (phi_res + zd Z_defocus)),
I = |fftshift(fft2(fftshift(P))) dx^2|^2, crop the central (2c+1)^2 window,
scale by AU and stack.

Two forms of the same map:

* ``diversity_measurements`` -- any diversity stack, by full FFT2 + crop
  (the reference's own recipe) or by the partial centered DFT;
* ``sym3_measurements`` -- the closed loop's hot path for the symmetric
  triple (-a, 0, +a) that the estimator always builds: cos/sin of the
  residual phase once per pixel, the three fields as +/- combinations of
  four products with the constant maps pupil cos(aZ) / pupil sin(aZ),
  and only the (2c+1)^2 window computed, by partial-DFT matmuls.

Measurement vectors use MATLAB column-major flattening of each crop
(reference: README.md:471 `reshape(v_im, diff^2, 1)`) so that regenerated
A_s/b_s match the shipped model_approx.mat layout.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from . import dft, psf_kernel

# Matmul precision of the measure's DFT stages.  TF32 tensor-core passes
# keep ~1e-4 of max|b_s|, three orders below the SNR-10 dB noise floor
# (~0.3 mean|b_s|); see EstimatorConfig for the whole precision policy.
MEASURE_PRECISION = jax.lax.Precision.DEFAULT


@lru_cache(maxsize=8)
def pupil_mask_np(resolution: int) -> np.ndarray:
    """Circular pin-hole pupil on the centered frequency grid.

    Reference: README.md:383-391 -- fxaxis=((-len/2):(len/2-1))*df,
    pupil = (FX^2+FY^2 <= ((len/2-1)*df)^2).  In pixel units: disc of
    radius R/2-1 centered at index R/2.
    """
    R = resolution
    ax = np.arange(R) - R // 2
    FX, FY = np.meshgrid(ax, -ax)
    return (FX * FX + FY * FY) <= (R // 2 - 1) ** 2


def pupil_mask(resolution: int, dtype=jnp.float32) -> jnp.ndarray:
    return jnp.asarray(pupil_mask_np(resolution), dtype=dtype)


def psf_intensity(
    phase: jnp.ndarray,
    pupil: jnp.ndarray,
    scale: float,
) -> jnp.ndarray:
    """|fftshift(fft2(fftshift(pupil e^{i phase})))|^2 * scale.

    phase: (..., R, R).  ``scale`` folds dx^4 * AU (README.md:468-470).
    """
    field = pupil * jnp.exp(1j * phase.astype(jnp.float32))
    shifted = jnp.fft.fftshift(
        jnp.fft.fft2(jnp.fft.fftshift(field, axes=(-2, -1))), axes=(-2, -1))
    return (shifted.real ** 2 + shifted.imag ** 2) * scale


def crop_center(im: jnp.ndarray, half: int) -> jnp.ndarray:
    """Central (2*half+1)^2 window around pixel R//2 (README.md:378-380)."""
    R = im.shape[-1]
    c = R // 2
    return im[..., c - half:c + half + 1, c - half:c + half + 1]


def measurement_vector(crops: jnp.ndarray) -> jnp.ndarray:
    """Stack diversity crops into the measurement vector y.

    crops: (..., n_div, w, w) -> (..., n_div*w*w), each crop flattened
    column-major (MATLAB reshape convention, README.md:471).
    """
    w = crops.shape[-1]
    nd = crops.shape[-3]
    colmajor = jnp.swapaxes(crops, -1, -2)  # transpose each crop
    return colmajor.reshape(*crops.shape[:-3], nd * w * w)


def cropped_psf_intensity_dft(
    phase: jnp.ndarray,
    pupil: jnp.ndarray,
    dft_op: jnp.ndarray,
    scale: float,
) -> jnp.ndarray:
    """PSF crop via partial centered DFT matmuls (ops.dft): only the
    (2c+1)^2 window the estimator consumes is computed (vs the
    reference's full 512^2 FFT, README.md:468)."""
    field = pupil * jnp.exp(1j * phase.astype(jnp.float32))
    spec = dft.partial_centered_fft2(field, dft_op)
    return (spec.real ** 2 + spec.imag ** 2) * scale


def diversity_measurements(
    phase_res: jnp.ndarray,
    diversity_phases: jnp.ndarray,
    pupil: jnp.ndarray,
    scale: float,
    crop_half: int,
    dft_op: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Full measurement path: residual phase(s) -> stacked PSF vector(s).

    phase_res: (..., R, R); diversity_phases: (n_div, R, R) precomputed
    zd * Z_defocus maps (README.md:462-464).  Returns (..., p).

    With ``dft_op`` (from ops.dft.centered_partial_dft) the crop is
    computed directly by partial-DFT matmuls; otherwise via full FFT2 +
    crop (the reference's recipe).  Both agree up to float roundoff
    (tested).
    """
    total = phase_res[..., None, :, :] + diversity_phases
    if dft_op is not None:
        crops = cropped_psf_intensity_dft(total, pupil, dft_op, scale)
    else:
        crops = crop_center(psf_intensity(total, pupil, scale), crop_half)
    return measurement_vector(crops)


def thin_rows_reference(phase, pupil, pcd, psd, a_packed,
                        precision=MEASURE_PRECISION, compute_dtype=None):
    """First DFT stage of the symmetric-triple measure in plain jnp.

    phase: (B, R, R); pupil/pcd/psd: (R, R); a_packed: (2h, R) from
    dft.packed_operator.  Returns G: (B, 3, R, 2h) with, per diversity
    (-a, 0, +a), G[..., :h] = Re(field A^T) and G[..., h:] = Im(field A^T)
    (the DFT applied along the columns; rows stay full length).

    cos/sin are taken once per pixel.  By cos(-aZ) = cos(aZ) and
    sin(-aZ) = -sin(aZ) the three fields are +/- combinations of
    t1 = cos(phi) pcd, t2 = sin(phi) psd, t3 = sin(phi) pcd,
    t4 = cos(phi) psd:  field(+-a) = (t1 -+ t2) + i (t3 +- t4).  Because
    the DFT is linear, the +/- combination is applied after the matmul,
    on thin (R, 2h) rows instead of (R, R) fields.
    """
    h = a_packed.shape[0] // 2
    cp = jnp.cos(phase)
    sp = jnp.sin(phase)
    t = jnp.stack([cp * pcd, sp * psd, sp * pcd, cp * psd,
                   cp * pupil, sp * pupil], axis=-3)          # (B, 6, R, R)
    a = a_packed
    if compute_dtype is not None:
        t = t.astype(compute_dtype)
        a = a.astype(compute_dtype)
    P = jnp.einsum("bkxy,jy->bkxj", t, a, precision=precision,
                   preferred_element_type=jnp.float32)       # (B, 6, R, 2h)
    re, im = P[..., :h], P[..., h:]           # are.t_k and aim.t_k
    # rr = are.fr - aim.fi,  ri = are.fi + aim.fr  per diversity
    rr_m = re[:, 0] + re[:, 1] - im[:, 2] + im[:, 3]
    ri_m = re[:, 2] - re[:, 3] + im[:, 0] + im[:, 1]
    rr_0 = re[:, 4] - im[:, 5]
    ri_0 = re[:, 5] + im[:, 4]
    rr_p = re[:, 0] - re[:, 1] - im[:, 2] - im[:, 3]
    ri_p = re[:, 2] + re[:, 3] + im[:, 0] - im[:, 1]
    rr = jnp.stack([rr_m, rr_0, rr_p], axis=1)
    ri = jnp.stack([ri_m, ri_0, ri_p], axis=1)
    return jnp.concatenate([rr, ri], axis=-1)                 # (B, 3, R, 2h)


def crops_from_rows(rows, a_packed, w, scale):
    """Second DFT stage: (B, 3, R, 2h) rows -> (B, 3, w, w) intensities.

    S = A2 @ G pairs every operator half with every row half:
    out = (are + i aim)(rr + i ri) = (are rr - aim ri) + i (are ri + aim rr).
    A (2h x R x 2h) product per diversity: small beside stage one, so it
    runs at full float32.
    """
    h = a_packed.shape[0] // 2
    S = jnp.einsum("jx,bdxk->bdjk", a_packed, rows,
                   precision=jax.lax.Precision.HIGHEST)       # (B,3,2h,2h)
    o_r = S[..., :h, :h] - S[..., h:, h:]
    o_i = S[..., :h, h:] + S[..., h:, :h]
    return ((o_r * o_r + o_i * o_i) * scale)[..., :w, :w]


def sym3_measurements(phase_res, pupil, pcd, psd, dft_op, scale,
                      compute_dtype=None, precision=MEASURE_PRECISION):
    """Measurement vector(s) for the symmetric diversity triple (-a, 0, +a).

    phase_res: (..., R, R); pcd = pupil cos(aZ), psd = pupil sin(aZ) for
    the positive diversity map aZ; dft_op: (2, w, R).  Returns
    (..., 3 w^2), equal to diversity_measurements on the stack
    (-aZ, 0, +aZ) up to float roundoff.  ``compute_dtype`` (e.g.
    jnp.bfloat16) casts the first-stage matmul operands, accumulating in
    float32.

    The first stage is chosen by ``thin_rows``: the fused GPU kernel
    (ops.psf_kernel) for batches large enough to fill the card, plain
    jnp otherwise.
    """
    lead = phase_res.shape[:-2]
    R = phase_res.shape[-1]
    w = dft_op.shape[1]
    a_packed = dft.packed_operator(dft_op)
    rows = thin_rows(phase_res.reshape((-1, R, R)).astype(jnp.float32),
                     pupil.astype(jnp.float32), pcd.astype(jnp.float32),
                     psd.astype(jnp.float32), a_packed,
                     precision=precision, compute_dtype=compute_dtype)
    crops = crops_from_rows(rows, a_packed, w, scale)
    return measurement_vector(crops.reshape(*lead, 3, w, w))


# Streaming multiprocessors of an H100: the smallest kernel grid that
# gives each of them a program.
KERNEL_MIN_PROGRAMS = 132


def uses_kernel(batch: int, resolution: int) -> bool:
    """Whether a (batch, R, R) first stage takes the GPU kernel.

    The kernel runs one program per (phase, row tile) and needs at least
    one program per SM (KERNEL_MIN_PROGRAMS) to fill the card.  Below
    that XLA's plain path wins: on an H100 (700 W), inside the closed
    loop at R=512, B=1 took 0.37 ms per step with the kernel and 0.23 ms
    without; at B=256 2.78 ms against 4.62 ms.
    """
    if not psf_kernel.supports(resolution):
        return False
    rows_per_program = psf_kernel.tiles(resolution)[0]
    return batch * (resolution // rows_per_program) >= KERNEL_MIN_PROGRAMS


def thin_rows(phase, pupil, pcd, psd, a_packed,
              precision=MEASURE_PRECISION, compute_dtype=None):
    """First DFT stage, (B, R, R) -> (B, 3, R, 2h), by the kernel or by
    thin_rows_reference as ``uses_kernel`` decides for the whole batch.

    Under ``vmap`` (montecarlo.run_batch maps the loop over scenarios)
    each scenario's call sees B=1; a custom batching rule folds the
    mapped axis into B, so the choice and the kernel's grid see every
    scenario at once.  The kernel runs only where the program is lowered
    for CUDA.
    """
    def reference(*a):
        return thin_rows_reference(*a, precision=precision,
                                   compute_dtype=compute_dtype)

    def kernel(*a):
        return psf_kernel.thin_rows(*a, precision=precision,
                                    compute_dtype=compute_dtype)

    @jax.custom_batching.custom_vmap
    def rows(phase, pupil, pcd, psd, a_packed):
        args = (phase, pupil, pcd, psd, a_packed)
        if uses_kernel(phase.shape[0], phase.shape[-1]):
            return jax.lax.platform_dependent(*args, cuda=kernel,
                                              default=reference)
        return reference(*args)

    @rows.def_vmap
    def rows_vmap(axis_size, in_batched, phase, *maps):
        if any(in_batched[1:]):
            # per-scenario pupil or operator maps: no shared kernel
            # operands, map the plain path
            axes = [0 if b else None for b in in_batched]
            return jax.vmap(reference, in_axes=axes)(phase, *maps), True
        out = rows(phase.reshape((-1,) + phase.shape[2:]), *maps)
        return out.reshape((axis_size, -1) + out.shape[1:]), True

    return rows(phase, pupil, pcd, psd, a_packed)
