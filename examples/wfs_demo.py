"""Wavefront-sensing demo: SH camera chain, slopes-MMSE, tomography.

The runnable equivalent of OOMAO's oomaoTutorial.m sensing sections:
Shack-Hartmann spots through the detector chain, spatial MMSE
reconstruction, and a 3-guide-star tomographic estimate.

    python examples/wfs_demo.py
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
from mpc_sensorlessao_tpu.models import (                        # noqa
    imaging, slopes_mmse, tomography, wfs)
from mpc_sensorlessao_tpu.ops import phase_screens               # noqa
from mpc_sensorlessao_tpu.utils.config import (                  # noqa
    AtmosphereConfig, TelescopeConfig)

ARCSEC = np.pi / 180 / 3600


def main():
    atm = AtmosphereConfig(fractional_r0=(1.0,), altitudes=(0.0,),
                           wind_speeds=(5.0,), wind_directions=(0.0,))
    tel = TelescopeConfig(resolution=80)
    sh = wfs.build(80, n_lenslet=10)
    scr = np.asarray(phase_screens.synthesize_screen(
        7, atm, 80, tel.pixel_pitch))[:80, :80] * 0.3
    ph = jnp.asarray(scr - scr.mean(), jnp.float32)

    det = imaging.DetectorConfig(resolution=sh.dft_op.shape[1],
                                 photon_noise=True, read_out_noise=2.0)
    geo = np.asarray(wfs.geometric_slopes(sh, ph))
    cam = np.asarray(wfs.camera_slopes(
        sh, ph, jax.random.PRNGKey(0), detector=det, n_photons=500.0,
        threshold=(6.0, 0.2), ref_slopes=wfs.reference_slopes(sh)))
    print(f"SH camera chain: slope error "
          f"{np.sqrt(np.mean((cam-geo)**2)):.4f} rad/px "
          f"(signal {np.sqrt(np.mean(geo**2)):.4f})")

    model = slopes_mmse.build(atm, tel.diameter, 10, sh.valid,
                              noise_var=(0.02 / tel.pixel_pitch) ** 2)
    phi = slopes_mmse.reconstruct(model, jnp.asarray(geo), tel.pixel_pitch)
    print(f"slopes-MMSE phase map: {phi.shape}, "
          f"rms {float(jnp.std(phi)):.3f} rad")

    atm_h = AtmosphereConfig(fractional_r0=(1.0,), altitudes=(8000.0,),
                             wind_speeds=(5.0,), wind_directions=(0.0,))
    th = 15 * ARCSEC
    gs = [(th, 0.0), (-th / 2, th * 0.866), (-th / 2, -th * 0.866)]
    tomo = tomography.build(atm_h, 1.0, 4, gs)
    print(f"3-GS tomography (15\" triangle, 8 km layer): predicted "
          f"error {tomo.err_var_rad2:.3f} rad^2, "
          f"Strehl {tomo.strehl_marechal:.3f}")


if __name__ == "__main__":
    main()
