"""Operators of the port (deepinv_tpu/ops/)."""

from .conv import filter_fft_2d, gaussian_blur
from .kernels.conv_chain import conv_chain
from .kernels.resblock_chain import resblock_chain
from .nufft import nufft2, nufft2_adjoint, nufft2_normal, nufft2_toeplitz_spec
from .radon import radon_output_size
from .radon_slice import (radon_slice, radon_slice_adjoint, radon_slice_normal,
                          radon_slice_normal_spec)

__all__ = ["filter_fft_2d", "gaussian_blur", "conv_chain", "resblock_chain", "nufft2",
           "nufft2_adjoint", "nufft2_normal", "nufft2_toeplitz_spec", "radon_output_size",
           "radon_slice", "radon_slice_adjoint", "radon_slice_normal", "radon_slice_normal_spec"]
