"""Physics of the port (deepinv_tpu/physics/)."""

from .base import DecomposablePhysics, LinearPhysics, Physics
from .blur import BlurFFT
from .noise import GaussianNoise, NoiseModel

__all__ = ["Physics", "LinearPhysics", "DecomposablePhysics", "BlurFFT",
           "NoiseModel", "GaussianNoise"]
