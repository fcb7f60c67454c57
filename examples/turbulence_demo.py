"""Turbulence statistics demo: synthesized screens vs analytics.

The runnable equivalent of OOMAO's phase-screen demos
(turbulent_phase_screen/*.m, atmosphere.demo) plus the analytic
zernikeStats surface: synthesizes Von Karman screens, validates their
structure function against phaseStats, and prints the Noll residual-
variance ladder and tip-tilt statistics.

    python examples/turbulence_demo.py
"""

import os
import sys

import numpy as np
import jax

# demos run on the host CPU backend (portable; chip_smoke.py and the
# benchmarks cover the GPU)
jax.config.update("jax_platforms", "cpu")

try:
    import mpc_sensorlessao_tpu  # noqa: F401  (installed package)
except ImportError:  # source checkout without `pip install -e .`
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
from mpc_sensorlessao_tpu.ops import phase_screens, phase_stats   # noqa
from mpc_sensorlessao_tpu.ops import zernike_stats as zs          # noqa
from mpc_sensorlessao_tpu.utils.config import (                   # noqa
    AtmosphereConfig, TelescopeConfig)


def main():
    atm = AtmosphereConfig(fractional_r0=(1.0,), altitudes=(0.0,),
                           wind_speeds=(5.0,), wind_directions=(0.0,))
    tel = TelescopeConfig(resolution=64)
    R, pitch = 64, tel.pixel_pitch

    print("Empirical vs analytic phase structure function:")
    seps = [2, 8, 24]
    acc = np.zeros(len(seps))
    n = 80
    for s in range(n):
        scr = np.asarray(phase_screens.synthesize_screen(
            s, atm, R, pitch))[:R, :R]
        for i, dpx in enumerate(seps):
            acc[i] += np.mean((scr[:, dpx:] - scr[:, :-dpx]) ** 2) / n
    for i, dpx in enumerate(seps):
        an = float(phase_stats.structure_function(dpx * pitch, atm))
        print(f"  sep {dpx*pitch:.3f} m: D_emp {acc[i]:7.3f}  "
              f"D_analytic {an:7.3f}  ratio {acc[i]/an:.3f}")

    print("\nNoll residual-variance ladder (D/r0=1, Kolmogorov):")
    atm_k = AtmosphereConfig(r0=1.0, L0=1e6, fractional_r0=(1.0,),
                             altitudes=(0.0,), wind_speeds=(5.0,),
                             wind_directions=(0.0,))
    for j in (1, 3, 6, 10, 21):
        print(f"  Delta_{j:<2d} = "
              f"{zs.residual_variance(j, atm_k, 1.0):.4f} rad^2")

    print("\nTip-tilt image motion:",
          f"{float(zs.rms_arcsec(atm, 1.0, zs.variance_analytic(atm, 1.0, 1)[1])):.3f} arcsec rms")


if __name__ == "__main__":
    main()
