"""Computed tomography (port of deepinv_tpu/physics/tomography.py).

:class:`Tomography` (tomography.py:38) with a parallel beam and the
Fourier-slice projector (``method="slice"``), both ``circle`` settings. The
sampling plan and the Toeplitz spectrum of ``A^T A`` are built once, at
construction, and are buffers: ``physics.to(device)`` moves them. The other
projector methods, the fan beam, FBP (``A_dagger``) and
``TomographyWithAstra`` wait for ROADMAP queue 1 item 8.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..ops.radon import radon_output_size
from ..ops.radon_slice import RadonSlicePlan
from .base import LinearPhysics

__all__ = ["Tomography"]

_WAITS = "ROADMAP queue 1 item 8 (slice 6)"


class Tomography(LinearPhysics):
    r"""Parallel-beam CT ``y = R x`` (tomography.py:38).

    :param angles: number of angles (spread over [0, 180)) or the angles in
        degrees.
    :param img_width: width of the square images.
    :param circle: restrict to the inscribed circle (no padding).
    :param normalize: scale ``A`` and ``A_adjoint`` by ``1 / img_width``.
    :param method: ``"slice"`` (the only one ported).
    :param fast_normal: precompute the Toeplitz spectrum of ``A^T A`` (750 x
        750 complex64 for 256-pixel images) so ``A_adjoint_A`` is two FFTs.
    :param device: where the plan and the spectrum live.
    """

    def __init__(self, angles: Union[int, np.ndarray], img_width: int, circle: bool = False,
                 normalize: bool = False, fbp_interpolate_boundary: bool = False,
                 method: str = "interp", fan_beam: bool = False, fan_parameters: dict = None,
                 fast_normal: bool = True, device=None, **kwargs):
        super().__init__(**kwargs)
        if fan_beam:
            raise NotImplementedError(f"the fan-beam projector waits for {_WAITS}")
        if method != "slice":
            raise NotImplementedError(
                f"Tomography(method={method!r}) waits for {_WAITS}; method='slice' is ported")
        if isinstance(angles, int):
            theta = np.linspace(0, 180, angles, endpoint=False)
        else:
            theta = np.asarray(angles, np.float32)
        self.register_buffer("angles", torch.as_tensor(theta, dtype=torch.float32))
        self.img_width = int(img_width)
        self.circle = circle
        self.normalize = normalize
        self.fbp_interpolate_boundary = fbp_interpolate_boundary
        self.method = method
        self.n_det = radon_output_size(self.img_width, circle)
        # the projections use the float32 angles, as the JAX package's do
        # (tomography.py:138)
        self.plan = RadonSlicePlan(self.n_det, np.asarray(theta, np.float32), circle=circle,
                                   normal=fast_normal)
        self.to(device)

    def A(self, x, **params):
        y = self.plan.project(x)
        return y / self.img_width if self.normalize else y

    def A_adjoint(self, y, **params):
        if self.normalize:
            y = y / self.img_width
        return self.plan.backproject(y, out_size=self.img_width)

    @property
    def fast_normal(self) -> bool:
        """True when ``A_adjoint_A`` runs through the precomputed Toeplitz
        spectrum (tomography.py:176)."""
        return self.plan.spec is not None

    def A_adjoint_A(self, x, **params):
        """``A^T A x``: two FFTs with the Toeplitz spectrum (tomography.py:183),
        ``A_adjoint(A(x))`` without it."""
        if self.plan.spec is None:
            return self.A_adjoint(self.A(x))
        out = self.plan.normal(x)
        return out / self.img_width ** 2 if self.normalize else out

    def A_dagger(self, y, **params):
        raise NotImplementedError(f"filtered backprojection (iradon_slice) waits for {_WAITS}")
