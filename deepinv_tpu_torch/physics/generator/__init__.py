"""Physics-parameter generators of the port (deepinv_tpu/physics/generator/)."""

from .base import GeneratorMixture, PhysicsGenerator, seed_from_string
from .blur import (ConfocalBlurGenerator3D, DiffractionBlurGenerator, DiffractionBlurGenerator3D,
                   GaussianBlurGenerator, MotionBlurGenerator, ProductConvolutionBlurGenerator,
                   PSFGenerator, TiledBlurGenerator, bump_function)
from .inpainting import (Artifact2ArtifactSplittingMaskGenerator, BernoulliSplittingMaskGenerator,
                         GaussianSplittingMaskGenerator, MultiplicativeSplittingMaskGenerator,
                         Phase2PhaseSplittingMaskGenerator)
from .mri import (BaseMaskGenerator, EquispacedMaskGenerator, GaussianMaskGenerator,
                  PolyOrderMaskGenerator, RandomMaskGenerator)
from .noise import DownsamplingGenerator, GainGenerator, SigmaGenerator
from .zernike import Zernike, noll_to_nm, zernike_basis

__all__ = ["PhysicsGenerator", "GeneratorMixture", "seed_from_string", "MotionBlurGenerator",
           "GaussianBlurGenerator", "DiffractionBlurGenerator", "ProductConvolutionBlurGenerator",
           "TiledBlurGenerator", "ConfocalBlurGenerator3D", "PSFGenerator",
           "DiffractionBlurGenerator3D", "bump_function", "BaseMaskGenerator",
           "GaussianMaskGenerator", "RandomMaskGenerator", "EquispacedMaskGenerator",
           "PolyOrderMaskGenerator", "BernoulliSplittingMaskGenerator",
           "GaussianSplittingMaskGenerator", "MultiplicativeSplittingMaskGenerator",
           "Phase2PhaseSplittingMaskGenerator", "Artifact2ArtifactSplittingMaskGenerator",
           "SigmaGenerator", "GainGenerator", "DownsamplingGenerator", "zernike_basis",
           "noll_to_nm", "Zernike"]
