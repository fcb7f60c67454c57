"""Mode/horizon sweep demo + telemetry display (BASELINE config 3 mini).

Builds one system, sweeps the MPC horizon via `pipeline.with_horizon`
(the expensive layers are horizon-independent -- the reference would
rebuild its whole 23-arg Fast_MPC2 object per horizon,
Fast_MPC/VAR_2/Fast_MPC2.m:28-55), prints a settled-metrics table, and
writes a closed-loop telemetry PNG with the headless display helpers
(`utils/display.py`).

    python examples/horizon_sweep_demo.py [resolution] [radial_order]
"""

import dataclasses
import os
import sys

import jax
import numpy as np

# demos run on the host CPU backend (portable; chip_smoke.py and the
# benchmarks cover the GPU)
jax.config.update("jax_platforms", "cpu")

try:
    import mpc_sensorlessao_tpu  # noqa: F401  (installed package)
except ImportError:  # source checkout without `pip install -e .`
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
from mpc_sensorlessao_tpu.models import pipeline                   # noqa
from mpc_sensorlessao_tpu.utils.config import reference_config     # noqa


def main():
    res = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    order = int(sys.argv[2]) if len(sys.argv) > 2 else 6
    cfg = reference_config(resolution=res)
    cfg = cfg.replace(
        zernike=dataclasses.replace(cfg.zernike, radial_order=order),
        mpc=dataclasses.replace(cfg.mpc, var_ridge=1e-2,
                                var_max_radius=0.85, warm_start=True,
                                r_weight=30.0),
        sim=dataclasses.replace(cfg.sim, n_train=300, n_valid=50,
                                n_test=40),
    )
    system = pipeline.build(cfg, jax.random.PRNGKey(0))
    n_modes = (order + 1) * (order + 2) // 2
    print(f"built: {n_modes} modes (radial order {order}), R={res}")

    print(f"{'N':>4} {'rms_res':>9} {'rejection':>10} {'strehl':>8}")
    last = None
    for N in (2, 8, 16):
        cfg_n = cfg.replace(mpc=dataclasses.replace(cfg.mpc, horizon=N))
        sys_n = pipeline.with_horizon(system, cfg_n)
        out = pipeline.run_closed_loop(sys_n, cfg_n, jax.random.PRNGKey(1))
        res_t = np.asarray(out.rms_res)[20:]
        turb_t = np.asarray(out.rms_turb)[20:]
        sx = np.asarray(out.strehl_exact)[20:]
        print(f"{N:>4} {res_t.mean():>9.4f} "
              f"{turb_t.mean() / res_t.mean():>10.2f} {sx.mean():>8.4f}")
        last = out

    try:
        from mpc_sensorlessao_tpu.utils import display
        display.show_telemetry(last, save="/tmp/horizon_sweep_demo.png",
                               close=True)
        print("telemetry PNG written to /tmp/horizon_sweep_demo.png")
    except ImportError:
        print("matplotlib unavailable; telemetry PNG skipped")


if __name__ == "__main__":
    main()
