"""The DPIR preset (port of deepinv_tpu/optim/dpir.py): PnP-HQS with a
DRUNet prior and the log-spaced schedule of Zhang et al."""

from __future__ import annotations

import numpy as np

from .data_fidelity import L2
from .optimizers import BaseOptim
from .prior import PnP

__all__ = ["DPIR", "get_DPIR_params"]


def get_DPIR_params(noise_level_img: float, max_iter: int = 8, s1: float = 49.0 / 255.0,
                    lamb: float = 1.0 / 0.23):
    """The DPIR schedule (deepinv_tpu/optim/dpir.py:19), in float32 numpy as
    the JAX package computes it: denoiser levels log-spaced from ``s1`` to
    ``max(noise_level_img, 1e-4)``, stepsizes ``lamb (sigma_k / max(0.01,
    noise_level_img))^2``."""
    s2 = max(noise_level_img, 1e-4)
    sigma_denoiser = np.logspace(np.log10(s1), np.log10(s2), max_iter).astype(np.float32)
    stepsize = (sigma_denoiser / max(0.01, noise_level_img)) ** 2
    return {"g_param": list(sigma_denoiser), "stepsize": list(stepsize * lamb), "lambda": 1.0}


def DPIR(sigma: float = 0.1, denoiser=None, max_iter: int = 8, device=None, generator=None,
         **kwargs) -> BaseOptim:
    """PnP-HQS with the DPIR schedule (dpir.py:43).

    :param sigma: the measurement's noise level.
    :param denoiser: the prior's denoiser; a ``DRUNet()`` with random weights
        from ``generator`` on ``device`` where None (the JAX package's
        ``DRUNet(pretrained=None)``).
    :param device: the CUDA device by default.
    :param kwargs: :class:`BaseOptim`'s.
    """
    if denoiser is None:
        from ..models import DRUNet

        denoiser = DRUNet(generator=generator, device=device)
    return BaseOptim("HQS", data_fidelity=L2(), prior=PnP(denoiser),
                     params_algo=get_DPIR_params(sigma, max_iter=max_iter), max_iter=max_iter,
                     device=device, **kwargs)
