"""Transforms of the port (deepinv_tpu/transform/): every name the JAX
package's ``deepinv_tpu.transform`` exports."""

from .base import Identity, Transform, TransformParam
from .diffeomorphism import CPABDiffeomorphism
from .geometric import Reflect, Rotate, Scale, Shift, rotate_via_shear
from .projective import (Affine, Euclidean, Homography, PanTiltRotate, Similarity,
                         apply_homography, rotation_matrix)
from .temporal import RandomNoise, RandomPhaseError, ShiftTime

__all__ = ["Transform", "Identity", "TransformParam", "Shift", "Rotate", "Scale", "Reflect",
           "rotate_via_shear", "Homography", "Affine", "Similarity", "Euclidean",
           "PanTiltRotate", "apply_homography", "rotation_matrix", "ShiftTime", "RandomNoise",
           "RandomPhaseError", "CPABDiffeomorphism"]
