"""Physics of the port (deepinv_tpu/physics/)."""

from .base import DecomposablePhysics, LinearPhysics, Physics
from .blur import BlurFFT
from .mri import MRI, MRIMixin
from .noise import GaussianNoise, NoiseModel
from .tomography import Tomography

__all__ = ["Physics", "LinearPhysics", "DecomposablePhysics", "BlurFFT", "MRI", "MRIMixin",
           "Tomography", "NoiseModel", "GaussianNoise"]
