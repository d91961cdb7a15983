"""Distributed substrate of the port: checkpointing and fault tolerance
(the jax-free copies of ``repro/distributed/checkpoint.py`` and
``fault.py``; the same on-disk format, so a snapshot written by either
package restores under the other)."""

from .checkpoint import CheckpointManager  # noqa: F401
from .fault import StepRunner  # noqa: F401
