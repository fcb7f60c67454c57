"""Sensorless (phase-diversity) residual-aberration estimator.

Re-implements and *regenerates* the reference's first-order PSF model
y = b_s + A_s alpha (reference: README.md:399-411, shipped precomputed in
model_approx.mat whose generation code is absent -- SURVEY.md section 2c),
then solves the linear least-squares estimate
ad_est = (A_s' A_s)^-1 A_s' (y - b_s)  (reference: README.md:478).

Design choices:
* A_s is the analytic linearization of the exact PSF measurement map at
  zero aberration, instead of the reference's unreproducible offline
  finite differences;
* the normal-equation solve is precomputed as one (nx, p) matrix so the
  per-step estimator is a single matmul over the batch;
* measurement noise (the missing SNR_10.mat blob) is defined as seeded
  white Gaussian noise with variance set by the configured SNR relative to
  the zero-aberration PSF signal power.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import dft, psf, zernike
from ..utils import hostcompute, struct
from ..utils.config import EstimatorConfig


@struct.dataclass
class EstimatorModel:
    """Precomputed estimator operators (device arrays).

    A_s:      (p, nx) linearized PSF sensitivity (piston excluded).
    b_s:      (p,) zero-aberration measurement.
    solve_op: (nx, p) = (A_s' A_s)^-1 A_s' -- the full estimator matmul.
    diversity_phases: (n_div, R, R) zd * Z_defocus maps, (-a, 0, +a).
    pupil:    (R, R).
    pcd, psd: (R, R) pupil cos(aZ), pupil sin(aZ) of the positive
              diversity map -- the constants of the symmetric-triple
              measure (ops.psf.sym3_measurements).
    noise_std: float scalar (from SNR dB).
    scale:    PSF intensity scale (dx^4 * AU), static.
    crop_half: static int.
    """

    A_s: jnp.ndarray
    b_s: jnp.ndarray
    solve_op: jnp.ndarray
    diversity_phases: jnp.ndarray
    pupil: jnp.ndarray
    noise_std: jnp.ndarray
    dft_op: jnp.ndarray
    pcd: jnp.ndarray
    psd: jnp.ndarray
    scale: float = struct.field(pytree_node=False)
    crop_half: int = struct.field(pytree_node=False)
    # "float32" | "bfloat16" DFT matmul operands (EstimatorConfig.dft_dtype)
    dft_dtype: str = struct.field(pytree_node=False, default="float32")
    # MAP regularizer sigma^2 C_prior^-1 (nx, nx) when the mmse prior is
    # configured; estimate_full_gn then solves the MAP normal equations
    # so Gauss-Newton refinement keeps the same high-order shrinkage as
    # the linear MMSE estimate (unregularized GN re-amplifies exactly the
    # weakly-sensed modes the prior suppresses).
    map_reg: jnp.ndarray | None = None

    @property
    def n_pixels(self) -> int:
        return self.A_s.shape[0]

    @property
    def n_states(self) -> int:
        return self.A_s.shape[1]


def effective_pixel_pitch(cfg: EstimatorConfig) -> float:
    """Pupil-plane pixel pitch keeping the reference's physical extent.

    The reference grid is 512 px at 6.5 um (README.md:371); at other
    resolutions we keep the same physical pupil extent so the PSF sampling
    and 31x31 crop stay geometrically equivalent.
    """
    return cfg.pixel_pitch * 512.0 / cfg.resolution


def measure(
    model: EstimatorModel,
    phase_res: jnp.ndarray,
    noise: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Residual phase(s) (..., R, R) -> noisy measurement(s) (..., p).

    Equivalent of the reference estimator loop README.md:461-475.
    """
    y = psf.sym3_measurements(
        phase_res, model.pupil, model.pcd, model.psd, model.dft_op,
        model.scale,
        compute_dtype=(jnp.bfloat16 if model.dft_dtype == "bfloat16"
                       else None))
    if noise is not None:
        y = y + noise
    return y


def estimate(model: EstimatorModel, y: jnp.ndarray) -> jnp.ndarray:
    """LS estimate ad_est = solve_op @ (y - b_s)  (README.md:478)."""
    return _apply_solve(model, y - model.b_s)


def _apply_solve(model: EstimatorModel, r: jnp.ndarray) -> jnp.ndarray:
    """solve_op @ r at full float32 (EstimatorConfig): solve_op has
    condition ~1e4, so TF32 rounding of its operands moves the estimate."""
    return jnp.matmul(r, model.solve_op.T,
                      precision=jax.lax.Precision.HIGHEST)


def mode_phase(x: jnp.ndarray, mode_stack: jnp.ndarray) -> jnp.ndarray:
    """Phase map(s) sum_k x_k Z_k at full float32: (..., nx) -> (..., R, R)."""
    return jnp.einsum("...k,kij->...ij", x, mode_stack,
                      precision=jax.lax.Precision.HIGHEST)


def estimate_gauss_newton(model: EstimatorModel, y: jnp.ndarray,
                          mode_stack: jnp.ndarray,
                          n_iters: int) -> jnp.ndarray:
    """Fixed-Jacobian Gauss-Newton refinement of the linear estimate.

    The reference's estimator is a single linearization around zero
    aberration (README.md:399-411), which decorrelates beyond ~1 rad of
    residual phase; strong-turbulence windows then destabilize the loop.
    Here we iterate   x <- x + S (y - f(x))   with f the *exact* nonlinear
    PSF measurement map (one batched partial-DFT per iteration) and
    S = (A'A)^-1 A' the fixed zero-point solve -- a quasi-Newton scheme
    that widens the capture range at ~n_iters x estimator cost.
    ``n_iters=0`` reproduces the reference's linear estimator exactly.

    mode_stack: (nx, R, R) state Zernike modes (basis.stack[1:]).
    """
    x = estimate(model, y)
    for _ in range(n_iters):
        phase = mode_phase(x, mode_stack)
        y_pred = measure(model, phase)
        x = x + _apply_solve(model, y - y_pred)
    return x


def linearize_at(model: EstimatorModel, phase: jnp.ndarray,
                 mode_stack: jnp.ndarray, mode_chunk: int = 8):
    """Exact re-linearization of the measurement map at ``phase``.

    Returns (y0, J): y0 = f(phase) and J[:, k] = df/dx_k, both computed
    with the same analytic form as build()'s zero-point linearization
    (b_s/A_s are the phase=0 case):  J_k = 2 Re(F* G_k) s with
    G_k = DFT(i field Z_k), field = pupil e^{i(zd Z4 + phase)}.
    Complex intermediates stay inside the compiled program (no
    host<->device complex transfers).  mode_chunk bounds the (k, 3, R, R)
    working set.
    """
    field = model.pupil * jnp.exp(
        1j * (model.diversity_phases + phase[None]))        # (3, R, R)
    F = dft.partial_centered_fft2(field, model.dft_op)      # (3, w, w)
    y0 = psf.measurement_vector(
        (F.real ** 2 + F.imag ** 2) * model.scale)

    def col(mode):                                          # (R,R) -> (p,)
        G = dft.partial_centered_fft2(field * (1j * mode)[None],
                                      model.dft_op)
        dy = 2.0 * (F.real * G.real + F.imag * G.imag) * model.scale
        return psf.measurement_vector(dy)

    J = jax.lax.map(col, mode_stack, batch_size=mode_chunk)  # (nx, p)
    return y0, J.T


def estimate_full_gn(model: EstimatorModel, y: jnp.ndarray,
                     mode_stack: jnp.ndarray, n_iters: int,
                     damping: float = 1e-3,
                     x_init: jnp.ndarray | None = None) -> jnp.ndarray:
    """Full Gauss-Newton with per-iterate re-linearized Jacobian.

    The reference estimator (README.md:478) and estimate_gauss_newton both
    use the zero-point Jacobian A_s, whose validity ends ~1 rad of
    residual RMS -- the capture-range wall that limits cold starts at
    D/r0 >= 10.  Re-linearizing at the current iterate restores local
    quadratic convergence out to several radians (the capture limit
    becomes PSF speckle ambiguity, not linearization).  Cost per
    iteration: nx partial-DFT column builds + one (nx, nx) solve --
    use for boot/acquisition phases, not the 200 Hz steady state.
    Single sample; vmap over batches.

    ``x_init`` seeds the iteration (default: the linear cold estimate).
    Seeding with a model PREDICTION (e.g. the closed loop's VAR one-step
    prediction) turns this into a *tracking* estimator: the capture
    requirement becomes |x - x_init| inside the local basin (~1 rad)
    instead of |x| -- absolute aberration size no longer matters.
    """
    cold = x_init is None
    x = estimate(model, y) if cold else x_init
    x_mean = jnp.zeros_like(x) if cold else x_init
    lam = damping * jnp.trace(model.A_s.T @ model.A_s) / model.n_states
    eye = jnp.eye(model.n_states, dtype=model.A_s.dtype)
    # MAP normal equations when the mmse prior is configured (keeps the
    # linear estimator's high-order shrinkage through the GN refinement).
    # The prior mean is zero for a cold solve but the SEED for a tracking
    # solve -- penalizing |x| instead of |x - x_init| would shrink a
    # large-but-well-predicted aberration toward zero and destroy the
    # tracking property.
    reg = lam * eye if model.map_reg is None else model.map_reg + lam * eye

    def body(_, x):
        phase = jnp.einsum("k,kij->ij", x, mode_stack)
        y0, J = linearize_at(model, phase, mode_stack)
        g = J.T @ (y - y0) - (model.map_reg @ (x - x_mean)
                              if model.map_reg is not None else 0.0)
        H = J.T @ J + reg
        return x + jax.scipy.linalg.solve(H, g, assume_a="pos")

    return jax.lax.fori_loop(0, n_iters, body, x)


def sample_noise(model: EstimatorModel, key, shape=()) -> jnp.ndarray:
    """Seeded measurement noise (replaces the missing SNR_10.mat blob)."""
    return model.noise_std * jax.random.normal(
        key, (*shape, model.n_pixels), dtype=model.b_s.dtype)


def build(
    cfg: EstimatorConfig,
    basis: zernike.ZernikeBasis,
    include_piston: bool = False,
    dtype=jnp.float32,
    prior_cov: np.ndarray | None = None,
) -> EstimatorModel:
    """Build the estimator model by linearizing the exact PSF map.

    ``include_piston=False`` drops the piston column, matching the
    reference's `A_s(:,1) = []` (README.md:290,331).

    ``prior_cov`` ((nx, nx), rad^2) is required when cfg.method == "mmse":
    the solve operator becomes the Bayesian linear MMSE gain
    C A' (A C A' + sigma^2 I)^-1 instead of the reference's unweighted
    normal equations (see EstimatorConfig.method).
    """
    R = cfg.resolution
    assert basis.resolution == R, "basis and estimator grids must match"
    dx = effective_pixel_pitch(cfg)
    scale = float(dx ** 4 * cfg.au)
    pupil = psf.pupil_mask(R, dtype=jnp.float32)

    defocus = basis.stack[cfg.diversity_mode].astype(jnp.float32)
    zd = jnp.asarray([-cfg.diversity_amp, 0.0, cfg.diversity_amp],
                     dtype=jnp.float32)
    diversity_phases = zd[:, None, None] * defocus

    k0 = 0 if include_piston else 1
    mode_stack = basis.stack[k0:].astype(jnp.float32)
    nx = mode_stack.shape[0]

    dft_op = dft.centered_partial_dft(R, cfg.crop_half)

    def linearize(mode_stack, diversity_phases, pupil, dft_op):
        """Analytic linearization of y = |DFT(pupil e^{i(zd Z4 + phi)})|^2
        around phi=0:  b_s = |F0|^2 s,  A_s[:,k] = 2 Re(F0* G_k) s with
        G_k = DFT(i pupil e^{i zd Z4} Z_k).  Pure batched matmuls -- no
        autodiff program (whose XLA compile dominates at R=512)."""
        field0 = pupil * jnp.exp(1j * diversity_phases)       # (3, R, R)
        F0 = dft.partial_centered_fft2(field0, dft_op)        # (3, w, w)
        b = psf.measurement_vector(
            (F0.real ** 2 + F0.imag ** 2) * scale)

        def col(mode):                                         # (R, R) -> (p,)
            G = dft.partial_centered_fft2(
                field0 * (1j * mode)[None], dft_op)            # (3, w, w)
            dy = 2.0 * (F0.real * G.real + F0.imag * G.imag) * scale
            return psf.measurement_vector(dy)

        A = jax.lax.map(col, mode_stack)                       # (nx, p)
        return b, A.T

    # set-up linearization on the host CPU backend (utils.hostcompute)
    cpu = hostcompute.cpu_device()
    mode_stack = jax.device_put(mode_stack, cpu)
    diversity_phases = jax.device_put(diversity_phases, cpu)
    pupil = jax.device_put(pupil, cpu)
    dft_op = jax.device_put(dft_op, cpu)
    with hostcompute.on_cpu():
        b_s, A_s = jax.jit(linearize)(mode_stack, diversity_phases,
                                      pupil, dft_op)

    # Noise scale (regenerates the missing SNR_10.mat; see EstimatorConfig)
    A64 = np.asarray(A_s, dtype=np.float64)
    b64 = np.asarray(b_s, dtype=np.float64)
    if cfg.snr_reference == "mean_abs":
        noise_std = float(np.mean(np.abs(b64)) * 10.0 ** (-cfg.snr_db / 20.0))
    elif cfg.snr_reference == "vector_power":
        noise_std = float(np.sqrt(np.mean(b64 ** 2)
                                  * 10.0 ** (-cfg.snr_db / 10.0)))
    else:
        raise ValueError(f"unknown snr_reference '{cfg.snr_reference}'")

    # Solve operator (host float64 for conditioning)
    if cfg.method == "ls":
        # (A'A + lam I)^-1 A'  (README.md:478)
        gram = A64.T @ A64
        if cfg.tikhonov > 0.0:
            gram = gram + cfg.tikhonov * np.eye(gram.shape[0])
        solve_op = np.linalg.solve(gram, A64.T)            # (nx, p)
        map_reg = None
    elif cfg.method == "mmse":
        if prior_cov is None:
            raise ValueError("estimator method 'mmse' needs prior_cov "
                             "(see pipeline.build)")
        C = np.asarray(prior_cov, dtype=np.float64)
        if C.shape != (A64.shape[1],) * 2:
            raise ValueError(f"prior_cov shape {C.shape} != "
                             f"({A64.shape[1]}, {A64.shape[1]})")
        CA = C @ A64.T                                     # (nx, p)
        G = A64 @ CA
        # sigma floor keeps G invertible even at (near-)noiseless SNR:
        # A C A' has rank <= nx << p
        sig2 = max(noise_std ** 2,
                   1e-9 * float(np.trace(G)) / G.shape[0])
        G = G + sig2 * np.eye(A64.shape[0])
        solve_op = np.linalg.solve(G, CA.T).T              # (nx, p)
        map_reg = sig2 * np.linalg.inv(
            C + 1e-12 * float(np.trace(C)) / C.shape[0] * np.eye(C.shape[0]))
    else:
        raise ValueError(f"unknown estimator method '{cfg.method}'")

    return hostcompute.to_default(EstimatorModel(
        A_s=A_s.astype(dtype),
        b_s=b_s.astype(dtype),
        solve_op=jnp.asarray(solve_op, dtype=dtype),
        diversity_phases=diversity_phases,
        pupil=pupil,
        noise_std=jnp.asarray(noise_std, dtype=dtype),
        dft_op=dft_op,
        scale=scale,
        crop_half=cfg.crop_half,
        # the zd stack above is always (-a, 0, +a)
        pcd=pupil * jnp.cos(diversity_phases[2]),
        psd=pupil * jnp.sin(diversity_phases[2]),
        dft_dtype=cfg.dft_dtype,
        map_reg=(None if map_reg is None
                 else jnp.asarray(map_reg, dtype=dtype)),
    ))
