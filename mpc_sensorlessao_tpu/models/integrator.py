"""Classical AO control: TSVD calibration vault + delayed leaky integrator.

Equivalent of the reference's bundled-but-unused OOMAO control
stack (SURVEY.md 2d): `calibrationVault.m` (199 LoC) and `controller.m`
(367 LoC).  The sensorless pipeline never instantiates them (the paper's
controller is the MPC), but they define the classical baseline every AO
user expects: poke-matrix calibration with truncated-SVD inversion, and a
fixed-gain closed-loop integrator with a frame delay.

Reference semantics replicated:

* calibrationVault.m:76-78  -- command matrix  M = V diag(1/s) U'  from
  the SVD of the poke (interaction) matrix D;
* calibrationVault.m:97-125 -- three equivalent truncation controls:
  drop modes by count (`n_thresholded`), by singular-value floor
  (`threshold`), or by condition number (`cond`, drops all modes with
  s[0]/s[i] > cond);
* controller.m:8,88-89      -- integrator gain default 0.5, delay frames;
* controller.m:305-308      -- update law
  ``coefs <- coefs - gain * M * slopes[k - delay]`` (here written with a
  leak factor, leak=0 reproducing the pure integrator);
* controller.m:160-190      -- calibration = poke each actuator/mode,
  record slopes (models/wfs.interaction_matrix is the batched-matmul
  version of that loop).

Design: the whole closed loop is ONE `lax.scan` whose body is
two matmuls (sense: slopes = S*phi_res; control: c += gain*M*s) --
no per-step dispatch, batched over scenarios with `vmap`, and the delay
line is a static-shape ring buffer carried through the scan.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class CalibrationVault(NamedTuple):
    """TSVD pseudo-inverse of an interaction matrix (calibrationVault.m).

    M:        (n_modes, n_slopes) command matrix with `n_thresholded`
              smallest singular modes zeroed.
    singular: (min(n,m),) singular values of D (descending).
    n_thresholded: number of truncated modes.
    """

    M: jnp.ndarray
    singular: np.ndarray
    n_thresholded: int

    @property
    def cond(self) -> float:
        """Condition number of the retained subspace
        (calibrationVault.m:124-125)."""
        kept = len(self.singular) - self.n_thresholded
        return float(self.singular[0] / self.singular[kept - 1])


def calibration_vault(D, n_thresholded: int = 0,
                      threshold: float | None = None,
                      cond: float | None = None) -> CalibrationVault:
    """Build the command matrix M = V diag(1/s) U' with TSVD truncation.

    Exactly one of the three truncation controls is applied, mirroring the
    three setters of calibrationVault.m:97-125; default keeps every mode
    (calibrationVault.m:78, nThresholded=0).  Host float64 SVD (setup
    time), float32 device operator out.
    """
    Dn = np.asarray(D, dtype=np.float64)
    U, s, Vt = np.linalg.svd(Dn, full_matrices=False)
    if threshold is not None:
        n_thresholded = int(np.sum(s < threshold))      # :97-99
    elif cond is not None:
        n_thresholded = int(np.sum(s[0] / s > cond))    # :117-121
    kept = len(s) - int(n_thresholded)
    if kept <= 0:
        raise ValueError("TSVD truncation removed every mode")
    iS = np.zeros_like(s)
    iS[:kept] = 1.0 / s[:kept]
    M = (Vt.T * iS) @ U.T                               # :76-77
    return CalibrationVault(jnp.asarray(M, dtype=jnp.float32),
                            s, int(n_thresholded))


class IntegratorConfig(NamedTuple):
    """controller.m knobs: gain (default 0.5, controller.m:8,89), leak
    (0 = pure integrator), delay in frames (controller.m:88)."""

    gain: float = 0.5
    leak: float = 0.0
    delay: int = 0


def closed_loop(sense_op: jnp.ndarray, command: CalibrationVault | jnp.ndarray,
                mode_stack_flat: jnp.ndarray, turb_modes: jnp.ndarray,
                cfg: IntegratorConfig = IntegratorConfig(),
                mask_flat: jnp.ndarray | None = None,
                slope_noise: jnp.ndarray | None = None):
    """Run the delayed leaky integrator over a turbulence sequence.

    Args:
      sense_op:  (n_slopes, P) linear sensing operator (e.g.
                 SHModel.slope_op): slopes = sense_op @ phi_res.
      command:   CalibrationVault or a raw (K, n_slopes) command matrix.
      mode_stack_flat: (K, P) controlled mode shapes, flattened pixels
                 (DM modal basis; the correction is -modes' c).
      turb_modes: (T, P) open-loop turbulence phase per step, flattened.
      cfg:       gain/leak/delay.
      slope_noise: optional (T, n_slopes) measurement noise added to the
                 slopes each step (shackHartmann camera noise at the
                 slopes level); None = ideal sensor.

    Returns:
      (c_acc, res_rms): (T, K) command history and (T,) residual-phase
      RMS over the sensed pixels (or over ``mask_flat`` when given --
      pass the pupil mask to make the RMS comparable to pupil-only
      telemetry like closed_loop.StepOutputs.rms_res).

    The scan carry is (c, slope ring buffer); update law
    controller.m:305-308 with the sign convention phi_res = phi_turb -
    modes' c, so c accumulates the modal content of the turbulence.

    Latency convention: the command computed from frame t is applied
    from frame t+1 on (the reported residual at t uses the pre-update
    command), so cfg.delay counts EXTRA measurement-path frames on top
    of that one inherent actuation frame -- matching the reference
    controller's timing.
    """
    M = command.M if isinstance(command, CalibrationVault) else command
    K = mode_stack_flat.shape[0]
    n_slopes = sense_op.shape[0]
    delay = int(cfg.delay)
    gain = jnp.float32(cfg.gain)
    leak = jnp.float32(cfg.leak)

    # fold sensing + reconstruction into K-row matmuls once (setup):
    # est = M @ sense_op @ phi  and  self-sensing of the correction
    # est_corr = (M sense_op modes') c.
    MS = M @ sense_op                                   # (K, P)
    MSB = MS @ mode_stack_flat.T                        # (K, K)
    if mask_flat is None:
        w_rms = jnp.full((mode_stack_flat.shape[1],),
                         1.0 / mode_stack_flat.shape[1], dtype=jnp.float32)
    else:
        m = mask_flat.astype(jnp.float32)
        w_rms = m / jnp.sum(m)

    if slope_noise is not None:
        # fold the per-step slope noise through the command matrix once
        noise_est = slope_noise @ M.T                   # (T, K)
    else:
        noise_est = jnp.zeros((turb_modes.shape[0], K), dtype=jnp.float32)

    def step(carry, xs):
        phi_t, n_t = xs
        c, ring = carry
        est_turb = MS @ phi_t + n_t                     # M (s + noise)
        est = est_turb - MSB @ c                        # = M s of residual
        if delay > 0:
            delayed = ring[0]
            ring = jnp.concatenate([ring[1:], est[None]], axis=0)
        else:
            delayed = est
        c_new = (1.0 - leak) * c + gain * delayed       # controller.m:308
        # the step's residual uses the command that was APPLIED while
        # this frame was sensed (c, not c_new): the update acts on the
        # next frame, so delay=0 still carries one frame of actuation
        # latency like the reference controller; cfg.delay counts
        # EXTRA frames on top of that
        res = phi_t - mode_stack_flat.T @ c
        rms = jnp.sqrt(jnp.sum(w_rms * res * res))
        return (c_new, ring), (c_new, rms)

    c0 = jnp.zeros((K,), dtype=jnp.float32)
    ring0 = jnp.zeros((max(delay, 1), K), dtype=jnp.float32)
    (_, _), (c_acc, rms) = jax.lax.scan(step, (c0, ring0),
                                        (turb_modes, noise_est))
    return c_acc, rms
