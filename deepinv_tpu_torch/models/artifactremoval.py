"""ArtifactRemoval adapter (port of deepinv_tpu/models/artifactremoval.py).

Turns a denoiser into a reconstructor: the backbone applied to a first-pass
inversion of the measurements.
"""

from __future__ import annotations

from .base import Reconstructor

__all__ = ["ArtifactRemoval"]


class ArtifactRemoval(Reconstructor):
    """``xhat = backbone(A_init(y), sigma)`` with ``mode`` in {'adjoint',
    'dagger', 'direct'} (artifactremoval.py:16). The backbone is a submodule,
    so its parameters are this module's."""

    def __init__(self, backbone_net, mode: str = "adjoint", sigma=0.05):
        super().__init__()
        self.backbone_net = backbone_net
        self.mode = mode
        self.sigma = sigma

    def backbone_inference(self, x_in, physics=None, y=None):
        return self.backbone_net(x_in, self.sigma)

    def forward(self, y, physics, **kwargs):
        if self.mode == "adjoint":
            x_in = physics.A_adjoint(y)
        elif self.mode == "dagger":
            x_in = physics.A_dagger(y)
        elif self.mode == "direct":
            x_in = y
        else:
            raise ValueError(f"unknown mode {self.mode!r}")
        return self.backbone_inference(x_in, physics, y)
