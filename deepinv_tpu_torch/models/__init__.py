"""Models of the port (deepinv_tpu/models/)."""

from .artifactremoval import ArtifactRemoval
from .base import Denoiser, Reconstructor, handle_sigma
from .classic import (AnscombeDenoiser, BilateralFilter, MedianFilter, TGVDenoiser, TVDenoiser,
                      TVL1Denoiser, WaveletDenoiser, WaveletDictDenoiser,
                      generalized_anscombe_transform, inverse_generalized_anscombe_transform)
from .convert import load_jax_params
from .dncnn import DnCNN
from .drunet import DRUNet, ResBlock
from .precision import AutocastDenoiser, autocast
from .utils import test_pad
from .wrappers_models import ICNN

__all__ = ["ArtifactRemoval", "Denoiser", "Reconstructor", "handle_sigma", "load_jax_params",
           "DnCNN", "DRUNet", "ResBlock", "AutocastDenoiser", "autocast", "test_pad", "TVDenoiser",
           "TVL1Denoiser", "TGVDenoiser", "WaveletDenoiser", "WaveletDictDenoiser",
           "MedianFilter", "BilateralFilter", "AnscombeDenoiser",
           "generalized_anscombe_transform", "inverse_generalized_anscombe_transform", "ICNN"]
