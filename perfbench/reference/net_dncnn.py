"""Plain float32 DnCNN (Zhang et al., "Beyond a Gaussian Denoiser: Residual
Learning of Deep CNN for Image Denoising", IEEE TIP 2017, DnCNN-B).

``depth`` 3x3 convs at ``nf`` channels with bias, ReLU after all but the
last, and the residual output ``out_conv(h) + x``. Departures from the
paper, as in deepinv's ``DnCNN``: no batch normalization, and the residual is
added (the paper subtracts the predicted noise; with random weights the sign
is immaterial). The noise level is not an input.
"""

import torch.nn.functional as F

from . import weights
from .precision import f32


def param_specs(cfg, channels):
    """``[(name, shape, std)]`` of the weights and biases, at the init scale
    ``cfg["weights"]`` states."""
    nf, depth, w = cfg["nf"], cfg["depth"], cfg["weights"]
    b = w["bias_std"]
    specs = [("in_conv.weight", (nf, channels, 3, 3), weights.he_std(channels * 9)),
             ("in_conv.bias", (nf,), b)]
    for i in range(depth - 2):
        specs += [(f"conv_list.{i}.weight", (nf, nf, 3, 3), weights.he_std(nf * 9)),
                  (f"conv_list.{i}.bias", (nf,), b)]
    specs += [("out_conv.weight", (channels, nf, 3, 3), weights.he_std(nf * 9, w["out_gain"])),
              ("out_conv.bias", (channels,), b)]
    return specs


def forward(p, x, sigma, cfg, q=f32):
    """DnCNN of ``x`` (``sigma`` is ignored); ``q`` rounds each conv's input
    and weight, and the output."""
    def conv(v, name):
        return F.conv2d(q(v), q(p[f"{name}.weight"]), p[f"{name}.bias"], 1, 1)

    h = F.relu(conv(x, "in_conv"))
    for i in range(cfg["depth"] - 2):
        h = F.relu(conv(h, f"conv_list.{i}"))
    return q(conv(h, "out_conv") + x)
