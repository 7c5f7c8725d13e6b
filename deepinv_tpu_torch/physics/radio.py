"""Radio interferometry (port of deepinv_tpu/physics/radio.py): ``y = w .
NUFFT(x)`` at the (u, v) visibility coordinates, on the port's
Kaiser-Bessel NUFFT (:class:`~deepinv_tpu_torch.ops.nufft.NufftPlan`, its
taps planned once here, in float64), with the Toeplitz normal operator
``A^H |w|^2 A`` for the iterative solvers.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..ops.nufft import NufftPlan, nufft2_normal, nufft2_toeplitz_spec
from .base import LinearPhysics, replace

__all__ = ["RadioInterferometry"]


class RadioInterferometry(LinearPhysics):
    r"""Radio interferometric imaging (radio.py:18).

    :param img_size: the sky image's ``(H, W)``.
    :param samples_loc: ``(2, M)`` visibility coordinates in radians.
    :param dataWeight: per-visibility weights (1 by default).
    :param real_projection: the adjoint keeps the real part (a real sky).
    :param fast_normal: ``A_adjoint_A`` by the Toeplitz embedding (two FFTs
        at twice the size) instead of a NUFFT pair (radio.py:71-79).
    :param device: where the plan lives; the CUDA device by default.
    """

    def __init__(self, img_size, samples_loc, dataWeight=None, interp_points: int = 4,
                 k_oversampling: float = 2.0, real_projection: bool = True,
                 fast_normal: bool = True, device=None, **kwargs):
        device = resolve_device(device)
        super().__init__(**kwargs)
        self.img_size = tuple(img_size)[-2:]
        self.J = interp_points
        self.osf = k_oversampling
        self.real_projection = real_projection
        self.register_buffer("samples_loc", torch.as_tensor(samples_loc, dtype=torch.float32))
        self.plan = NufftPlan(self.samples_loc, self.img_size, self.J, self.osf)
        self.register_buffer("dataWeight", torch.ones(()) if dataWeight is None else
                             torch.as_tensor(dataWeight))
        self._fast = fast_normal
        self.register_buffer("_normal_spec", None)
        self.to(device)
        if fast_normal:
            self._normal_spec = self._spec(self.dataWeight)

    def _spec(self, w):
        return nufft2_toeplitz_spec(self.samples_loc, self.img_size, weights=w.abs() ** 2,
                                    J=self.J, osf=self.osf)

    @property
    def fast_normal(self) -> bool:
        return self._normal_spec is not None

    def A_adjoint_A(self, x, **params):
        if self._normal_spec is None:
            return self.A_adjoint(self.A(x, **params), **params)
        out = nufft2_normal(x, self._normal_spec)
        return out.real if self.real_projection else out

    def setWeight(self, w) -> "RadioInterferometry":
        """A copy with new per-visibility weights (radio.py:81). The Toeplitz
        spectrum is rebuilt with them: the JAX package keeps the old one
        (ROADMAP Queue 3)."""
        w = torch.as_tensor(w).to(self.dataWeight.device)
        return replace(self, dataWeight=w,
                       _normal_spec=self._spec(w) if self._fast else None)

    def A(self, x, **params):
        return self.plan(x) * self.dataWeight

    def A_adjoint(self, y, **params):
        x = self.plan.adjoint(y * self.dataWeight.conj())
        return x.real if self.real_projection else x
