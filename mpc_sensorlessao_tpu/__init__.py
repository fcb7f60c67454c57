"""mpc_sensorlessao_tpu: sensorless adaptive-optics MPC framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
jinsungkim96/MPC-SensorlessAO (MATLAB): multi-layer frozen-flow Von Karman
turbulence, Zernike modal decomposition, VAR(1)/VAR(2) aberration
prediction, phase-diversity PSF estimation, and a fixed-barrier
infeasible-start Newton ("fastMPC") interior-point QP controller -- all
batched over turbulence scenarios and sharded over device meshes.

Layout:
  ops/       compute kernels: zernike, phase statistics, phase screens,
             PSF formation (with a Pallas GPU kernel), structured Newton-KKT solves
  models/    domain models: VAR system ID, DM influence, estimator,
             MPC problem assembly, solver backends, closed-loop engine
  parallel/  device mesh + shard_map Monte-Carlo scaling
  utils/     config system, special functions, metrics, checkpointing
"""

from .utils import config
from .utils.config import (
    AtmosphereConfig,
    DMConfig,
    EstimatorConfig,
    MPCConfig,
    SimConfig,
    SystemConfig,
    TelescopeConfig,
    ZernikeConfig,
    mag_conv,
    reference_config,
)

__version__ = "0.1.0"
