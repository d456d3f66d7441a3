"""Kernels of the port and their plain PyTorch versions."""

from . import attention  # noqa: F401
