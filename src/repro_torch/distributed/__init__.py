"""Fault-tolerance substrate of the port: failure injection and the
straggler watchdog (``fault_tolerance``), and sharded checkpoints with
atomic commit in the reference's on-disk layout (``checkpoint``)."""

from repro_torch.distributed import checkpoint

__all__ = ["checkpoint"]
