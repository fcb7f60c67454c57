"""Multi-conjugate AO demo: tomographic multi-DM correction.

The runnable equivalent of OOMAO's modalMCAO.m demo pipeline: a 3
guide-star asterism over a two-layer atmosphere drives one or two
Zernike deformable mirrors (ground + 8 km conjugate) through the
field-averaged MMSE command matrix; analytic residual variances are
reported for the on-axis and off-axis science directions and validated
by a short Monte-Carlo with projected layered screens.

    python examples/mcao_demo.py
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp

# demos run on the host CPU backend (portable; chip_smoke.py and the
# benchmarks cover the GPU)
jax.config.update("jax_platforms", "cpu")

try:
    import mpc_sensorlessao_tpu  # noqa: F401  (installed package)
except ImportError:  # source checkout without `pip install -e .`
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
from mpc_sensorlessao_tpu.models import mcao                     # noqa
from mpc_sensorlessao_tpu.ops import phase_screens, relay, zernike  # noqa
from mpc_sensorlessao_tpu.ops import zernike_stats as zs         # noqa
from mpc_sensorlessao_tpu.utils.config import AtmosphereConfig   # noqa

ARCSEC = np.pi / 180 / 3600


def main(n_mc: int = 60):
    atm = AtmosphereConfig(fractional_r0=(0.6, 0.4),
                           altitudes=(0.0, 8000.0),
                           wind_speeds=(5.0, 5.0),
                           wind_directions=(0.0, 0.0))
    th = 10 * ARCSEC
    gs = [(th, 0.0), (-th / 2, th * 0.866), (-th / 2, -th * 0.866)]
    sci = [(0.0, 0.0), (th, 0.0)]
    fov, order, D = 4.0 * th, 3, 1.0

    one = mcao.build(atm, D, fov, [mcao.DMLayer(0.0, order)],
                     order, gs, sci)
    two = mcao.build(atm, D, fov,
                     [mcao.DMLayer(0.0, order),
                      mcao.DMLayer(8000.0, order, skip_modes=3)],
                     order, gs, sci)

    print(f"piston-free turbulence variance: "
          f"{two.piston_free_var_rad2:.3f} rad^2")
    print(f"ideal on-axis SCAO (order {order}):  "
          f"{two.scao_var_rad2:.3f} rad^2")
    for name, m in (("1 DM (ground)", one), ("2 DM (0 + 8 km)", two)):
        t = ", ".join(f"{v:.3f}" for v in m.target_vars_rad2)
        print(f"{name:16s} field-avg {m.mcao_var_rad2:.3f} rad^2, "
              f"per-direction [{t}] (on-axis, 10\")")

    # --- short Monte-Carlo check of the 2-DM prediction ---
    R, pitch = 48, D / 47
    basis = zernike.make_basis(order, R)
    npix = jnp.sum(basis.mask.astype(jnp.float32))
    Nf = zs.norm_factors(order)[1:]
    dirs = list(sci) + list(gs)

    @jax.jit
    def all_coeffs(scr0, scr1):
        def c_of(ph):
            p2 = zernike.piston_removed_phase_masked(ph, basis.mask, npix)
            return (basis.fit_full @ p2.reshape(-1))[1:]
        return jnp.stack([c_of(relay.project_layers(
            [scr0, scr1], [pitch, pitch], D / 2, atm.altitudes, R,
            direction=d)) for d in dirs])

    resid = []
    for s in range(n_mc):
        scr0 = jnp.asarray(np.asarray(phase_screens.synthesize_screen(
            2 * s, atm.layer(0), 192, pitch, oversample=1)))
        scr1 = jnp.asarray(np.asarray(phase_screens.synthesize_screen(
            2 * s + 1, atm.layer(1), 192, pitch, oversample=1)))
        c = np.asarray(all_coeffs(scr0, scr1)) / Nf[None, :]
        u = np.asarray(mcao.correct(
            two, jnp.asarray(c[len(sci):], jnp.float32)))
        resid.append([float(np.sum(
            (c[k] - np.asarray(mcao.correction_coeffs(two, u, k))) ** 2))
            for k in range(len(sci))])
    mc = np.mean(np.asarray(resid), axis=0)
    pred = two.target_vars_rad2 - two.scao_var_rad2
    print(f"Monte-Carlo modeled-mode residual ({n_mc} screens): "
          f"[{mc[0]:.3f}, {mc[1]:.3f}] rad^2 "
          f"(predicted [{pred[0]:.3f}, {pred[1]:.3f}])")


if __name__ == "__main__":
    main()
