"""PyTorch/CUDA port of deepinv_tpu: PnP-HQS deblurring with DRUNet, PnP-PGD
with DnCNN on MRI and CT, and TV reconstruction (TVPrior, TVDenoiser; GD,
PGD, FISTA, ADMM, DRS and Chambolle-Pock).

The JAX package ``deepinv_tpu`` is the reference the port is held to
(tests/test_torch_*.py). Subpackages mirror its names: ``ops``, ``physics``,
``models``, ``optim``. This package imports torch and never jax. Its entry
points run on the CUDA device unless the caller passes ``device="cpu"``
(:mod:`deepinv_tpu_torch.device`).
"""

from . import models, ops, optim, physics

__all__ = ["models", "ops", "optim", "physics"]
