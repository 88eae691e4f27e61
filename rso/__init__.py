"""rso — robust stereo visual odometry in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
famoreno/stereo-vo ("Robust Stereo Odometry"): rectify -> detect ->
stereo-match -> track -> robust Gauss-Newton pose, as one compiled XLA
program per frame, plus sliding-window / distributed bundle adjustment
the reference never had.
"""

__version__ = "0.1.0"

import jax as _jax

# On a GPU, f32 matmuls/einsums default to TF32 on the tensor cores (a
# 10-bit mantissa, ~3 decimal digits).  That is the right trade for neural
# nets but wrong for this library's geometry: ~1000-px coordinates lose
# whole pixels, which degrades RANSAC gating and the GN normal equations.
# "highest" keeps them in full f32.  Paths that *want* reduced precision
# (the squared-L2 shortlist's ranking matmul) pass Precision.DEFAULT
# explicitly and are unaffected.
_jax.config.update("jax_default_matmul_precision", "highest")

from rso.config import RSOConfig, load_config

__all__ = ["RSOConfig", "load_config", "__version__"]
