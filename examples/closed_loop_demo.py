"""End-to-end sensorless-AO MPC demo (the reference main.mlx workflow).

Builds the full pipeline at a CPU-friendly resolution, runs the
closed loop, and prints the settled metrics -- the runnable equivalent
of the reference's Live Script (main.mlx / README.md:29-627) and
OOMAO's adaptiveOpticsHowto.m.

    python examples/closed_loop_demo.py [resolution] [d_over_r0]
"""

import dataclasses
import os
import sys

import jax

# demos run on the host CPU backend (portable; chip_smoke.py and the
# benchmarks cover the GPU)
jax.config.update("jax_platforms", "cpu")

try:
    import mpc_sensorlessao_tpu  # noqa: F401  (installed package)
except ImportError:  # source checkout without `pip install -e .`
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
from mpc_sensorlessao_tpu.models import pipeline                   # noqa
from mpc_sensorlessao_tpu.utils import metrics                     # noqa
from mpc_sensorlessao_tpu.utils.config import reference_config     # noqa


def main():
    res = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    d = float(sys.argv[2]) if len(sys.argv) > 2 else 5.0
    cfg = reference_config(resolution=res)
    cfg = cfg.replace(sim=dataclasses.replace(
        cfg.sim, n_train=300, n_valid=50, n_test=100, d_over_r0=d))
    if d >= 10:   # strong-turbulence recipe (see README "Beyond parity")
        cfg = cfg.replace(
            zernike=dataclasses.replace(cfg.zernike, radial_order=10),
            mpc=dataclasses.replace(cfg.mpc, warm_start=True,
                                    var_ridge=1e-2, r_weight=30.0),
            estimator=dataclasses.replace(cfg.estimator, method="mmse",
                                          prior_scale=min(0.15, 0.5 / d)))
    print(f"Building pipeline (R={res}, D/r0={d}) ...")
    system = pipeline.build(cfg, jax.random.PRNGKey(0))
    print(f"  atmosphere: seeing {cfg.atmosphere.seeing_arcsec:.2f}\", "
          f"tau0 {cfg.atmosphere.tau0_ms:.1f} ms, "
          f"Greenwood {cfg.atmosphere.greenwood_frequency:.1f} Hz")
    print("Running the 200 Hz closed loop ...")
    out = pipeline.run_closed_loop(system, cfg, jax.random.PRNGKey(1))
    for k, v in metrics.to_dict(metrics.summarize(out)).items():
        print(f"  {k:>22s}: {v:.4f}")


if __name__ == "__main__":
    main()
