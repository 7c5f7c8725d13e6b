"""Projective transforms in the pinhole-camera parameterisation (port of
deepinv_tpu/transform/projective.py): :class:`Homography` and its subgroups
:class:`Affine`, :class:`Similarity`, :class:`Euclidean` and
:class:`PanTiltRotate`.

The per-sample 3x3 map ``K' R^T K^{-1}`` is built in one batched product and
the warp samples the input with :func:`~.geometric.map_coordinates` (order 0
or 1, JAX's border modes), as the JAX package warps with
``jax.scipy.ndimage.map_coordinates`` (projective.py:138-150). A point
behind the camera (``w < 0``) keeps the sign of ``w`` in its division, as
there.
"""

from __future__ import annotations

import torch

from .base import Transform, TransformParam, _device
from .geometric import map_coordinates

__all__ = ["TransformParam", "Homography", "Affine", "Similarity", "Euclidean", "PanTiltRotate",
           "rotation_matrix", "apply_homography"]

_PAD_MODES = {"reflection": "reflect", "zeros": "constant", "border": "nearest"}

# inverted by the reciprocal, not the negation (projective.py:51)
_RECIPROCAL = ("zoom_f", "stretch_x", "stretch_y")


def rotation_matrix(tx, ty, tz):
    """Batched extrinsic xyz Euler rotations ``Rz @ Ry @ Rx`` from degrees
    (projective.py:54); ``(n,)`` angles give ``(n, 3, 3)``."""
    tx, ty, tz = (torch.deg2rad(torch.as_tensor(t, dtype=torch.float32)) for t in (tx, ty, tz))
    cx, sx = torch.cos(tx), torch.sin(tx)
    cy, sy = torch.cos(ty), torch.sin(ty)
    cz, sz = torch.cos(tz), torch.sin(tz)
    o, z = torch.ones_like(cx), torch.zeros_like(cx)
    Rx = torch.stack([o, z, z, z, cx, -sx, z, sx, cx], -1).reshape(cx.shape + (3, 3))
    Ry = torch.stack([cy, z, sy, z, o, z, -sy, z, cy], -1).reshape(cx.shape + (3, 3))
    Rz = torch.stack([cz, -sz, z, sz, cz, z, z, z, o], -1).reshape(cx.shape + (3, 3))
    return Rz @ Ry @ Rx


def apply_homography(im, theta_x=0.0, theta_y=0.0, theta_z=0.0, zoom_factor=1.0, skew=0.0,
                     x_stretch_factor=1.0, y_stretch_factor=1.0, x_t=0.0, y_t=0.0,
                     padding: str = "reflection", interpolation: str = "bilinear"):
    """Warp ``(B, C, H, W)`` images by per-sample pinhole-camera
    homographies (projective.py:78): each output pixel samples the input at
    ``K' R^T K^{-1} [x, y, 1]``, every geometric argument broadcast to
    ``(B,)``.

    :param padding: ``reflection``, ``zeros`` or ``border``.
    :param interpolation: ``bilinear`` or ``nearest``.
    """
    if interpolation not in ("bilinear", "nearest"):
        raise ValueError("interpolation must be 'bilinear' or 'nearest'")
    order = 1 if interpolation == "bilinear" else 0
    mode = _PAD_MODES.get(padding, padding)
    B, C, H, W = im.shape
    dev = im.device

    def bc(p):
        p = p.p if isinstance(p, TransformParam) else p
        return torch.as_tensor(p, dtype=torch.float32, device=dev).broadcast_to((B,))

    theta_x, theta_y, theta_z, zoom, skew, sfx, sfy, xt, yt = map(
        bc, (theta_x, theta_y, theta_z, zoom_factor, skew, x_stretch_factor, y_stretch_factor,
             x_t, y_t))
    f = 100.0
    u0, v0 = float(int(W / 2)), float(int(H / 2))
    o, z = torch.ones((B,), device=dev), torch.zeros((B,), device=dev)
    kp = torch.stack([f / zoom / sfx, skew, u0 + xt, z, f / zoom / sfy, v0 + yt, z, z, o],
                     -1).reshape(B, 3, 3)
    kinv = torch.stack([o / f, z, -u0 / f * o, z, o / f, -v0 / f * o, z, z, o],
                       -1).reshape(B, 3, 3)
    R = rotation_matrix(theta_x, theta_y, theta_z)
    Minv = kp @ R.transpose(-1, -2) @ kinv
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    pts = torch.stack([xx, yy, torch.ones_like(xx)], 0).reshape(3, -1)
    s = Minv @ pts
    w = s[:, 2].abs().clamp_min(1e-8)
    sgn = torch.sign(s[:, 2])
    sx = s[:, 0] / w * sgn
    sy = s[:, 1] / w * sgn
    return map_coordinates(im, sy[:, None], sx[:, None], order, mode).reshape(B, C, H, W)


class Homography(Transform):
    """Random projective transformations (projective.py:153): pan and tilt
    (``theta_x/y``), in-plane rotation (``theta_z``), zoom, shift, skew and
    axis stretches, drawn per output sample (``n_trans * B``) in that order
    from one generator. Angles, shifts and skew invert by negation, zoom and
    stretches by the reciprocal.

    :param theta_max: largest pan/tilt angle (degrees).
    :param theta_z_max: largest in-plane rotation (degrees).
    :param zoom_factor_min: smallest zoom factor (up to 1).
    :param shift_max: largest shift, a fraction of half the image.
    :param skew_max: largest skew.
    :param x_stretch_factor_min: smallest x stretch (up to 1).
    :param y_stretch_factor_min: smallest y stretch (up to 1).
    :param padding: ``reflection``, ``zeros`` or ``border``.
    :param interpolation: ``bilinear`` or ``nearest``.
    """

    def __init__(self, theta_max: float = 180.0, theta_z_max: float = 180.0,
                 zoom_factor_min: float = 0.5, shift_max: float = 1.0, skew_max: float = 50.0,
                 x_stretch_factor_min: float = 0.5, y_stretch_factor_min: float = 0.5,
                 padding: str = "reflection", interpolation: str = "bilinear", **kwargs):
        super().__init__(**kwargs)
        self.theta_max = theta_max
        self.theta_z_max = theta_z_max
        self.zoom_factor_min = zoom_factor_min
        self.shift_max = shift_max
        self.skew_max = skew_max
        self.x_stretch_factor_min = x_stretch_factor_min
        self.y_stretch_factor_min = y_stretch_factor_min
        self.padding = padding
        self.interpolation = interpolation

    def rand(self, maxi: float, mini: float = None, generator=None, n: int = None,
             device=None):
        """Uniform draws on ``[mini, maxi)`` (``-maxi`` if ``mini`` is None),
        ``n_trans`` of them by default (projective.py:206)."""
        if mini is None:
            mini = -maxi
        n = self.n_trans if n is None else n
        dev = generator.device if generator is not None else device
        return mini + (maxi - mini) * torch.rand((n,), generator=generator, device=dev)

    def get_params(self, x, generator=None) -> dict:
        n = self.n_trans * x.shape[0]
        H, W = x.shape[-2:]
        dev = _device(x, generator)

        def u(lo, hi):
            return self.rand(hi, lo, generator=generator, n=n, device=dev).to(x.device)

        return {"theta_x": u(-self.theta_max, self.theta_max),
                "theta_y": u(-self.theta_max, self.theta_max),
                "theta_z": u(-self.theta_z_max, self.theta_z_max),
                "zoom_f": u(self.zoom_factor_min, 1.0),
                "shift_x": u(-W / 2 * self.shift_max, W / 2 * self.shift_max),
                "shift_y": u(-H / 2 * self.shift_max, H / 2 * self.shift_max),
                "skew": u(-self.skew_max, self.skew_max),
                "stretch_x": u(self.x_stretch_factor_min, 1.0),
                "stretch_y": u(self.y_stretch_factor_min, 1.0)}

    def invert_params(self, params: dict) -> dict:
        return {k: (1.0 / v if k in _RECIPROCAL else -v) for k, v in params.items()}

    def transform(self, x, theta_x=None, theta_y=None, theta_z=None, zoom_f=None, shift_x=None,
                  shift_y=None, skew=None, stretch_x=None, stretch_y=None):
        x = self._repeat(x) if x.shape[0] != theta_x.shape[0] else x
        return apply_homography(x, theta_x=theta_x, theta_y=theta_y, theta_z=theta_z,
                                zoom_factor=zoom_f, skew=skew, x_stretch_factor=stretch_x,
                                y_stretch_factor=stretch_y, x_t=shift_x, y_t=shift_y,
                                padding=self.padding, interpolation=self.interpolation)


class Affine(Homography):
    """Random affine maps: no pan or tilt (projective.py:268)."""

    def __init__(self, **kwargs):
        kwargs["theta_max"] = 0.0
        super().__init__(**kwargs)


class Similarity(Homography):
    """Random similarities: shift, rotation and isotropic zoom
    (projective.py:277)."""

    def __init__(self, **kwargs):
        kwargs.update(theta_max=0.0, skew_max=0.0, x_stretch_factor_min=1.0,
                      y_stretch_factor_min=1.0)
        super().__init__(**kwargs)


class Euclidean(Homography):
    """Random Euclidean maps: shift and rotation (projective.py:289)."""

    def __init__(self, **kwargs):
        kwargs.update(theta_max=0.0, skew_max=0.0, zoom_factor_min=1.0,
                      x_stretch_factor_min=1.0, y_stretch_factor_min=1.0)
        super().__init__(**kwargs)


class PanTiltRotate(Homography):
    """Random camera rotations: pan, tilt and in-plane rotation with their
    perspective effects (projective.py:301)."""

    def __init__(self, **kwargs):
        kwargs.update(shift_max=0.0, skew_max=0.0, zoom_factor_min=1.0,
                      x_stretch_factor_min=1.0, y_stretch_factor_min=1.0)
        super().__init__(**kwargs)
