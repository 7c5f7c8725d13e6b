"""Arithmetic precisions of the plain reference.

``f32`` leaves tensors as they are. ``fp8`` is the control of a bfloat16
configuration (the next precision below it), held where the program holds
bfloat16: every convolution's input and weight, and the network's output,
rounded to float8 e4m3 with one scale per tensor (amax / 448, the format's
largest finite value), the products accumulated in float32.
"""

import contextlib

import torch

E4M3_MAX = 448.0


def f32(t):
    return t


def fp8(t):
    amax = t.abs().amax().clamp(min=1e-30)
    scale = amax / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


QUANTIZERS = {"f32": f32, "fp8": fp8}


@contextlib.contextmanager
def exact_f32():
    """TF32 off in cuDNN and cuBLAS inside the block: the reference is
    float32 throughout."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
