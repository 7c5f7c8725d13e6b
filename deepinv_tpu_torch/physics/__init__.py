"""Physics of the port (deepinv_tpu/physics/)."""

from . import generator
from .base import (ComposedLinearPhysics, ComposedPhysics, DecomposablePhysics, Denoising,
                   LinearPhysics, Physics, StackedLinearPhysics, StackedPhysics, compose, stack)
from .blur import (Blur, BlurFFT, Downsampling, DownsamplingMatlab, SpaceVaryingBlur,
                   TiledSpaceVaryingBlur, Upsampling)
from .inpainting import Inpainting
from .mri import MRI, DynamicMRI, MRIMixin, MultiCoilMRI, SequentialMRI, birdcage_maps
from .noise import (FisherTippettNoise, GammaNoise, GaussianNoise, LaplaceNoise, LogPoissonNoise,
                    NoiseModel, PoissonGaussianNoise, PoissonNoise, RicianNoise, SaltPepperNoise,
                    UniformGaussianNoise, UniformNoise, ZeroNoise)
from .tomography import Tomography, Tomography3D, TomographyWithAstra

__all__ = ["Physics", "LinearPhysics", "DecomposablePhysics", "Denoising", "ComposedPhysics",
           "ComposedLinearPhysics", "StackedPhysics", "StackedLinearPhysics", "compose", "stack",
           "Inpainting",
           "Blur", "BlurFFT", "Downsampling", "Upsampling", "SpaceVaryingBlur", "DownsamplingMatlab",
           "TiledSpaceVaryingBlur",
           "MRI", "MRIMixin", "MultiCoilMRI", "DynamicMRI", "SequentialMRI", "birdcage_maps",
           "Tomography", "TomographyWithAstra", "Tomography3D",
           "NoiseModel", "ZeroNoise", "GaussianNoise", "UniformGaussianNoise", "PoissonNoise",
           "GammaNoise", "PoissonGaussianNoise", "UniformNoise", "LogPoissonNoise",
           "SaltPepperNoise", "FisherTippettNoise", "RicianNoise", "LaplaceNoise", "generator"]
