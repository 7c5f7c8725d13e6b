"""PyTorch/CUDA port of deepinv_tpu: the PnP-HQS deblurring slice.

The JAX package ``deepinv_tpu`` is the reference the port is held to
(tests/test_torch_*.py). Subpackages mirror its names: ``ops``, ``physics``,
``models``, ``optim``. This package imports torch and never jax.
"""

from . import models, ops, optim, physics

__all__ = ["models", "ops", "optim", "physics"]
