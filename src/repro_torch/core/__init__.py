"""Core: the paper's contribution (GENESYS device-initiated syscalls)."""
from repro_torch.core import genesys  # noqa: F401
