"""ocs2_tpu — JAX-native optimal control and nonlinear MPC.

A ground-up JAX/XLA/Pallas re-design of the capabilities of OCS2
(ETH Zurich's C++/ROS toolbox): SLQ/iLQR DDP,
multiple-shooting SQP/IPM, PIPG, switched systems, constraint machinery,
an MPC⇄MRT runtime, robot models, and MPC-Net-style policy learning —
re-expressed as vmapped/scanned pure functions over device meshes instead of
thread pools and virtual dispatch.
"""
import jax as _jax

# Solver recursions (Riccati, KKT) are numerically sensitive.  "highest"
# keeps float32 matrix products in full float32: without it XLA may run them
# in TF32 on the GPU's tensor cores (about three decimal digits), which
# degrades the Riccati recursion.  Set on import, before the first compile.
_jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"
