"""Physics of the port (deepinv_tpu/physics/)."""

from .base import (ComposedLinearPhysics, ComposedPhysics, DecomposablePhysics, Denoising,
                   LinearPhysics, Physics, StackedLinearPhysics, StackedPhysics, compose, stack)
from .blur import Blur, BlurFFT, Downsampling, DownsamplingMatlab, SpaceVaryingBlur, Upsampling
from .inpainting import Inpainting
from .mri import MRI, MRIMixin
from .noise import GaussianNoise, NoiseModel
from .tomography import Tomography, Tomography3D, TomographyWithAstra

__all__ = ["Physics", "LinearPhysics", "DecomposablePhysics", "Denoising", "ComposedPhysics",
           "ComposedLinearPhysics", "StackedPhysics", "StackedLinearPhysics", "compose", "stack",
           "Inpainting",
           "Blur", "BlurFFT", "Downsampling", "Upsampling", "SpaceVaryingBlur", "DownsamplingMatlab",
           "MRI", "MRIMixin", "Tomography", "TomographyWithAstra", "Tomography3D",
           "NoiseModel", "GaussianNoise"]
