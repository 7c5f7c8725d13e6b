"""Transforms of the port (deepinv_tpu/transform/)."""

from .base import Transform
from .geometric import Rotate

__all__ = ["Transform", "Rotate"]
