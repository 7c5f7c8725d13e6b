"""Physics of the port (deepinv_tpu/physics/): every name the JAX package's
``deepinv_tpu.physics`` exports, and the ``functional`` namespace."""

from . import functional, generator
from .base import (ComposedLinearPhysics, ComposedPhysics, DecomposablePhysics, Denoising,
                   LinearPhysics, Physics, StackedLinearPhysics, StackedPhysics,
                   adjoint_function, compose, stack)
from .blur import (Blur, BlurFFT, Downsampling, DownsamplingMatlab, SpaceVaryingBlur,
                   TiledSpaceVaryingBlur, Upsampling)
from .compressed_sensing import CompressedSensing
from .inpainting import Demosaicing, Inpainting
from .misc import (CompressiveSpectralImaging, Decolorize, Haze, HyperSpectralUnmixing,
                   SinglePhotonLidar, SpatialUnwrapping)
from .mri import MRI, DynamicMRI, MRIMixin, MultiCoilMRI, SequentialMRI, birdcage_maps
from .noise import (FisherTippettNoise, GammaNoise, GaussianNoise, LaplaceNoise, LogPoissonNoise,
                    NoiseModel, PoissonGaussianNoise, PoissonNoise, RicianNoise, SaltPepperNoise,
                    UniformGaussianNoise, UniformNoise, ZeroNoise)
from .pet import PET
from .phase_retrieval import (PhaseRetrieval, Ptychography, PtychographyLinearOperator,
                              RandomPhaseRetrieval, StructuredRandomPhaseRetrieval)
from .radio import RadioInterferometry
from .remote_sensing import Pansharpen
from .scattering import BornOperator, Scattering
from .singlepixel import SinglePixelCamera
from .structured_random import StructuredRandom
from .tomography import Tomography, Tomography3D, TomographyWithAstra
from .wrappers import (BlurFFTMultiScaler, BlurMultiScaler, InpaintingMultiScaler,
                       LinearPhysicsMultiScaler, PhysicsCropper, PhysicsMultiScaler,
                       VirtualLinearPhysics, to_multiscale)

__all__ = ["Physics", "LinearPhysics", "DecomposablePhysics", "Denoising", "ComposedPhysics",
           "ComposedLinearPhysics", "StackedPhysics", "StackedLinearPhysics", "compose", "stack",
           "adjoint_function", "Inpainting", "Demosaicing",
           "Blur", "BlurFFT", "Downsampling", "Upsampling", "SpaceVaryingBlur", "DownsamplingMatlab",
           "TiledSpaceVaryingBlur",
           "MRI", "MRIMixin", "MultiCoilMRI", "DynamicMRI", "SequentialMRI", "birdcage_maps",
           "Tomography", "TomographyWithAstra", "Tomography3D",
           "NoiseModel", "ZeroNoise", "GaussianNoise", "UniformGaussianNoise", "PoissonNoise",
           "GammaNoise", "PoissonGaussianNoise", "UniformNoise", "LogPoissonNoise",
           "SaltPepperNoise", "FisherTippettNoise", "RicianNoise", "LaplaceNoise", "generator",
           "CompressedSensing", "SinglePixelCamera", "StructuredRandom",
           "PhaseRetrieval", "RandomPhaseRetrieval", "StructuredRandomPhaseRetrieval",
           "PtychographyLinearOperator", "Ptychography",
           "Haze", "SinglePhotonLidar", "Decolorize", "SpatialUnwrapping",
           "HyperSpectralUnmixing", "CompressiveSpectralImaging", "Pansharpen",
           "PhysicsMultiScaler", "LinearPhysicsMultiScaler", "PhysicsCropper", "to_multiscale",
           "VirtualLinearPhysics", "BlurMultiScaler", "BlurFFTMultiScaler",
           "InpaintingMultiScaler", "RadioInterferometry", "BornOperator", "Scattering", "PET",
           "functional"]
