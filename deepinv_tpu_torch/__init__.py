"""PyTorch/CUDA port of deepinv_tpu: PnP-HQS deblurring with DRUNet, PnP-PGD
with DnCNN on MRI and CT, TV reconstruction (TVPrior, TVDenoiser; GD, PGD,
FISTA, ADMM, DRS and Chambolle-Pock), training (the Trainer with
supervised, EI and SURE losses), and sampling (DDRM, DiffPIR and DPS with
DRUNet on Inpainting, BlurFFT and Downsampling; ULA and SK-ROCK on a score
prior; the VE, VP, EDM and flow-matching SDEs and posterior diffusion).

The JAX package ``deepinv_tpu`` is the reference the port is held to
(tests/test_torch_*.py). Subpackages mirror its names: ``ops``, ``physics``,
``models``, ``optim``, ``loss``, ``datasets``, ``transform``, ``training``,
``sampling``, ``utils``. This package imports torch and never jax. Its entry
points run on the CUDA device unless the caller passes ``device="cpu"``
(:mod:`deepinv_tpu_torch.device`).
"""

from . import (datasets, loss, models, ops, optim, physics, sampling, training, transform,
               utils)

__all__ = ["datasets", "loss", "models", "ops", "optim", "physics", "sampling", "training",
           "transform", "utils"]
