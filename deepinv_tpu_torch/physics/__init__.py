"""Physics of the port (deepinv_tpu/physics/)."""

from .base import DecomposablePhysics, Denoising, LinearPhysics, Physics
from .blur import BlurFFT
from .inpainting import Inpainting
from .mri import MRI, MRIMixin
from .noise import GaussianNoise, NoiseModel
from .tomography import Tomography

__all__ = ["Physics", "LinearPhysics", "DecomposablePhysics", "Denoising", "Inpainting",
           "BlurFFT", "MRI", "MRIMixin", "Tomography", "NoiseModel", "GaussianNoise"]
