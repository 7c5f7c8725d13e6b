"""Operators of the port (deepinv_tpu/ops/)."""

from .conv import (bicubic_filter, bilinear_filter, conv2d, conv_transpose2d, filter_fft_2d,
                   gaussian_blur, kaiser_window, sinc_filter)
from .kernels.conv_chain import conv_chain
from .kernels.resblock_chain import resblock_chain
from .kernels.tv import chambolle_prox
from .nufft import nufft2, nufft2_adjoint, nufft2_normal, nufft2_toeplitz_spec
from .radon import radon_output_size, ramp_filter
from .radon_slice import (iradon_slice, radon_slice, radon_slice_adjoint, radon_slice_normal,
                          radon_slice_normal_spec)

__all__ = ["conv2d", "conv_transpose2d", "filter_fft_2d", "gaussian_blur", "bilinear_filter",
           "bicubic_filter", "kaiser_window", "sinc_filter", "conv_chain", "resblock_chain",
           "chambolle_prox",
           "nufft2", "nufft2_adjoint", "nufft2_normal", "nufft2_toeplitz_spec",
           "radon_output_size", "ramp_filter", "radon_slice", "radon_slice_adjoint",
           "iradon_slice", "radon_slice_normal", "radon_slice_normal_spec"]
