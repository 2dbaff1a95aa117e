"""Upside-MD in JAX: coarse-grained protein molecular dynamics on a GPU.

A from-scratch JAX/XLA re-design of the capabilities of Upside-MD
(github.com/John-Jumper/Upside-MD).  The reference's hand-written C++
computation graph with reverse-mode sensitivities becomes a traced, jitted
JAX energy function differentiated with ``jax.grad``; its SSE pairlist
kernels become masked dense pair computations that XLA fuses; its OpenMP
replica parallelism becomes ``vmap`` within a device and ``shard_map``
over a device mesh.

Package layout
  ops/       math kernels: uniform B-splines, dihedral geometry, sigmoids
  nodes/     the node library (energy terms + derived coordinates)
  config/    ``.up`` system reader and programmatic builder
  md/        integrator, thermostat, Monte Carlo, replica exchange, sim loop
  parallel/  device-mesh sharding of replica ensembles
  io/        trajectory/output logging
  engine.py  Upside-compatible Python API (energy/deriv/get_output/get_sens)
"""

__version__ = "0.1.0"

from . import nodes  # noqa: F401  (populates the node registry)
from .system import System, build_system  # noqa: F401
