"""Models of the port (deepinv_tpu/models/)."""

from .artifactremoval import ArtifactRemoval
from .base import Denoiser, Reconstructor, handle_sigma
from .classic import TVDenoiser
from .convert import load_jax_params
from .dncnn import DnCNN
from .drunet import DRUNet, ResBlock
from .precision import AutocastDenoiser, autocast
from .utils import test_pad

__all__ = ["ArtifactRemoval", "Denoiser", "Reconstructor", "handle_sigma", "load_jax_params",
           "DnCNN", "DRUNet", "ResBlock", "AutocastDenoiser", "autocast", "test_pad", "TVDenoiser"]
