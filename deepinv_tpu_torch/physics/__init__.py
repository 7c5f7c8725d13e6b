"""Physics of the port (deepinv_tpu/physics/)."""

from .base import (ComposedLinearPhysics, ComposedPhysics, DecomposablePhysics, Denoising,
                   LinearPhysics, Physics, StackedLinearPhysics, StackedPhysics, compose, stack)
from .blur import Blur, BlurFFT, Downsampling, Upsampling
from .inpainting import Inpainting
from .mri import MRI, MRIMixin
from .noise import GaussianNoise, NoiseModel
from .tomography import Tomography

__all__ = ["Physics", "LinearPhysics", "DecomposablePhysics", "Denoising", "ComposedPhysics",
           "ComposedLinearPhysics", "StackedPhysics", "StackedLinearPhysics", "compose", "stack",
           "Inpainting",
           "Blur", "BlurFFT", "Downsampling", "Upsampling", "MRI", "MRIMixin", "Tomography",
           "NoiseModel", "GaussianNoise"]
