"""Computed tomography (port of deepinv_tpu/physics/tomography.py).

- :class:`Tomography` (tomography.py:38): parallel-beam CT by one of three
  projectors, ``method="interp"`` (the default: the gather Radon transform of
  :mod:`~deepinv_tpu_torch.ops.radon`), ``"fourier"`` (FFT three-shear
  rotation, :mod:`~deepinv_tpu_torch.ops.radon_fourier`) or ``"slice"``
  (Fourier-slice NUFFT, :mod:`~deepinv_tpu_torch.ops.radon_slice`, with the
  Toeplitz ``A^T A``), and the fan beam (``fan_beam=True``) with its
  approximate FBP. The slice and fourier plans are built once and are
  buffers; the interp and fan projectors sample per call from the
  ``angles`` buffer, so a gradient can reach the angles.
- :class:`TomographyWithAstra` (tomography.py:216): the ray-driven X-ray
  transform of :mod:`~deepinv_tpu_torch.ops.xray` in 2D parallel and fan and
  3D parallel and cone beam, per-view vector geometries, FBP and FDK.
- :class:`Tomography3D` (tomography.py:421): slice-stacked 3D parallel CT.

Every adjoint without a closed form is the autograd transpose of the forward
(:func:`~deepinv_tpu_torch.core.linear_transpose`), as JAX's is
``jax.linear_transpose``. ``prox_l2`` and ``A_dagger`` without a closed form
are the Krylov ones of :class:`~deepinv_tpu_torch.physics.LinearPhysics`.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Union

import numpy as np
import torch

from ..core.linalg import linear_transpose
from ..device import resolve_device
from ..ops.radon import fanbeam, iradon, radon, radon_output_size, ramp_filter
from ..ops.radon_fourier import RadonFourierPlan
from ..ops.radon_slice import RadonSlicePlan
from ..ops.xray import XrayPlan, fdk_weights, xray_geometry
from .base import LinearPhysics

__all__ = ["Tomography", "TomographyWithAstra", "Tomography3D"]

_METHODS = ("interp", "fourier", "slice")


class Tomography(LinearPhysics):
    r"""CT ``y = R x`` of square images (tomography.py:38).

    :param angles: number of angles (spread over [0, 180)) or the angles in
        degrees.
    :param img_width: width of the square images.
    :param circle: restrict to the inscribed circle (no padding).
    :param normalize: scale ``A`` and ``A_adjoint`` by ``1 / img_width``.
    :param method: ``"interp"`` (bilinear gathers), ``"fourier"`` (FFT
        shears, sinc interpolation) or ``"slice"`` (Fourier slice).
    :param fan_beam: the fan-beam projector (``method`` is then unused).
    :param fan_parameters: ``pixel_spacing`` (0.5 / img_width),
        ``source_radius`` (57.5), ``detector_radius`` (57.5),
        ``n_detector_pixels`` (258), ``detector_spacing`` (0.077), and
        optionally ``n_steps`` of :func:`~deepinv_tpu_torch.ops.radon.fanbeam`.
    :param fast_normal: with ``"slice"``, precompute the Toeplitz spectrum of
        ``A^T A`` (750 x 750 complex64 for 256-pixel images).
    :param device: where the buffers live; the CUDA device by default.
    :param kwargs: ``noise_model``, and ``solver``, ``max_iter``, ``tol`` of
        the Krylov ``prox_l2`` (:class:`~deepinv_tpu_torch.physics.LinearPhysics`).
    """

    def __init__(self, angles: Union[int, np.ndarray], img_width: int, circle: bool = False,
                 normalize: bool = False, fbp_interpolate_boundary: bool = False,
                 method: str = "interp", fan_beam: bool = False, fan_parameters: dict = None,
                 fast_normal: bool = True, device=None, **kwargs):
        device = resolve_device(device)
        super().__init__(**kwargs)
        if method not in _METHODS:
            raise ValueError(f"method must be one of {_METHODS}, got {method!r}")
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
        self.fan_beam = fan_beam
        self.n_det = radon_output_size(self.img_width, circle)
        fp = dict(fan_parameters or {})
        fp.setdefault("pixel_spacing", 0.5 / self.img_width)
        fp.setdefault("source_radius", 57.5)
        fp.setdefault("detector_radius", 57.5)
        fp.setdefault("n_detector_pixels", 258)
        fp.setdefault("detector_spacing", 0.077)
        self.fan_parameters = fp
        # the projections use the float32 angles, as the JAX package's do
        # (tomography.py:138)
        theta32 = np.asarray(theta, np.float32)
        self.plan = None
        if fan_beam:
            self.n_det = fp["n_detector_pixels"]
        elif method == "slice":
            self.plan = RadonSlicePlan(self.n_det, theta32, circle=circle, normal=fast_normal)
        elif method == "fourier":
            self.plan = RadonFourierPlan(self.img_width, theta32, circle=circle)
        self.to(device)

    @property
    def theta(self):
        """Deprecated alias of ``angles`` (tomography.py:114)."""
        warnings.warn("The attribute `theta` is deprecated and will be removed in a future "
                      "version. Use `angles` instead.", DeprecationWarning, stacklevel=2)
        return self.angles

    @theta.setter
    def theta(self, value):
        warnings.warn("The attribute `theta` is deprecated and will be removed in a future "
                      "version. Use `angles` instead.", DeprecationWarning, stacklevel=2)
        self.angles = torch.as_tensor(value, dtype=torch.float32, device=self.angles.device)

    def _project(self, x):
        """The unnormalized projector (tomography.py:141-146)."""
        if self.fan_beam:
            return fanbeam(x, self.angles, **self.fan_parameters)
        if self.plan is not None:
            return self.plan.project(x)
        return radon(x, self.angles, circle=self.circle)

    def A(self, x, **params):
        y = self._project(x)
        return y / self.img_width if self.normalize else y

    def A_adjoint(self, y, **params):
        """The exact transpose of :meth:`A` (tomography.py:151): the slice
        plan's explicit adjoint, else the autograd transpose of the
        projector (its graph kept when the angles require grad)."""
        if self.normalize:
            y = y / self.img_width
        if not self.fan_beam and self.method == "slice":
            return self.plan.backproject(y, out_size=self.img_width)
        B, C = y.shape[:2]
        return linear_transpose(self._project, y, (B, C, self.img_width, self.img_width),
                                create_graph=self.angles.requires_grad)

    @property
    def fast_normal(self) -> bool:
        """True when ``A_adjoint_A`` runs through the precomputed Toeplitz
        spectrum (tomography.py:176)."""
        return isinstance(self.plan, RadonSlicePlan) and self.plan.spec is not None

    def A_adjoint_A(self, x, **params):
        """``A^T A x``: two FFTs with the Toeplitz spectrum (tomography.py:183),
        ``A_adjoint(A(x))`` without it."""
        if not self.fast_normal:
            return self.A_adjoint(self.A(x))
        out = self.plan.normal(x)
        return out / self.img_width ** 2 if self.normalize else out

    def A_dagger(self, y, **params):
        """Filtered backprojection (tomography.py:191). Fan beam: the ramp
        filter and the adjoint, an approximate FBP; parallel beam: the
        method's ``iradon`` onto ``img_width`` images."""
        n_angles = self.angles.shape[0]
        if self.fan_beam:
            if self.normalize:
                y = y * self.img_width ** 2
            return self.A_adjoint(ramp_filter(y)) * (math.pi / (2 * n_angles))
        if self.normalize:
            y = y * self.img_width
        if self.plan is None:
            return iradon(y, self.angles, circle=self.circle, filtered=True,
                          out_size=self.img_width)
        if self.method == "slice":
            return self.plan.filtered_backproject(y, out_size=self.img_width)
        return self.plan.filtered_backproject(y)

    def fbp(self, y, **params):
        """Alias of :meth:`A_dagger` (tomography.py:212)."""
        return self.A_dagger(y, **params)


class TomographyWithAstra(LinearPhysics):
    r"""X-ray transform in 2D parallel and fan beam and 3D parallel and cone
    beam (tomography.py:216), the JAX package's native replacement of the
    reference's astra-toolbox bridge, on :class:`~deepinv_tpu_torch.ops.xray.XrayPlan`.

    Sinograms are ``(B, C, A, N)`` in 2D and ``(B, C, V, A, N)`` in 3D.
    ``A_dagger(y, fbp=True)`` is the filtered backprojection, FDK-weighted
    for divergent beams; ``A_dagger(y)`` the Krylov least-squares solve.

    :param img_size: ``(H, W)`` or ``(D, H, W)``.
    :param angles: number of views over ``angular_range`` or angles in degrees.
    :param n_detector_pixels: int (2D) or (rows, cols) (3D); default
        ``ceil(sqrt(2) H)`` (2D), ``(D, ceil(sqrt(2) H))`` (3D).
    :param angular_range: in degrees, default (0, 180).
    :param detector_spacing: cell pitch, float (2D) or (row, col) (3D).
    :param pixel_spacing: voxel pitch, float or per axis (slice, row, col).
    :param geometry_type: ``parallel``, ``fanbeam`` (2D) or ``conebeam`` (3D).
    :param geometry_parameters: ``source_radius`` and ``detector_radius``
        of divergent beams (default 80 and 20).
    :param geometry_vectors: optional ``(A, 12)`` / ``(A, 6)`` per-view
        vectors in astra's ``geom_2vec`` layout; take precedence over ``angles``.
    :param normalize: divide ``A`` and ``A_adjoint`` by the operator norm,
        estimated by 20 power iterations from a normal draw of a
        ``torch.Generator`` seeded 0 (the JAX package draws it from
        ``jax.random.key(0)``); the default None warns and means True.
    :param n_steps: samples a ray (default 3 max(img_size)).
    :param device: where the plan lives; the CUDA device by default.
    """

    def __init__(self, img_size, angles=180, n_detector_pixels=None, angular_range=(0, 180),
                 detector_spacing=1.0, pixel_spacing=1.0, geometry_type: str = "parallel",
                 geometry_parameters: Optional[dict] = None, geometry_vectors=None,
                 normalize: Optional[bool] = None, n_steps: Optional[int] = None, device=None,
                 **kwargs):
        device = resolve_device(device)
        super().__init__(**kwargs)
        img_size = tuple(int(s) for s in img_size)
        if len(img_size) not in (2, 3):
            raise ValueError("img_size must be (H, W) or (D, H, W)")
        self.img_size = img_size
        self.is_2d = len(img_size) == 2
        gp = dict(geometry_parameters or {})
        gp.setdefault("source_radius", 80.0)
        gp.setdefault("detector_radius", 20.0)
        self.geometry_type = geometry_type
        if self.is_2d and geometry_type not in ("parallel", "fanbeam"):
            raise ValueError("2D geometry_type must be 'parallel' or 'fanbeam'")
        if not self.is_2d and geometry_type not in ("parallel", "conebeam"):
            raise ValueError("3D geometry_type must be 'parallel' or 'conebeam'")
        if geometry_vectors is not None:
            n_angles, theta = np.asarray(geometry_vectors).shape[0], None
        elif isinstance(angles, int):
            theta = np.linspace(*angular_range, num=angles + 1)[:-1]
            n_angles = angles
        else:
            theta = np.asarray(angles, np.float64)
            n_angles = theta.shape[0]
        self._n_angles = int(n_angles)
        self.register_buffer("theta", None if theta is None else
                             torch.as_tensor(theta, dtype=torch.float32))
        self._geom = xray_geometry(
            geometry_type if self.is_2d or geometry_type == "conebeam" else "parallel3d",
            np.deg2rad(theta) if theta is not None else None,
            detector_spacing=detector_spacing, source_radius=gp["source_radius"],
            detector_radius=gp["detector_radius"], geometry_vectors=geometry_vectors)
        H = img_size[-2]
        if n_detector_pixels is None:
            n_det_u = int(math.ceil(math.sqrt(2) * H))
            n_detector_pixels = n_det_u if self.is_2d else (img_size[0], n_det_u)
        self.n_detector_pixels = n_detector_pixels
        self.pixel_spacing = pixel_spacing
        self.detector_spacing = detector_spacing
        self.plan = XrayPlan(self._geom, img_size, pixel_spacing, n_detector_pixels, n_steps)
        self._n_v, self._n_u = self.plan.n_v, self.plan.n_u
        sp = np.atleast_1d(np.asarray(pixel_spacing, np.float64))
        ds = np.atleast_1d(np.asarray(detector_spacing, np.float64))
        self._cell_v_length = 1.0 if self.is_2d else float(ds[0] if ds.size > 1 else ds[-1])
        self._cell_volume = float(np.prod(sp)) if sp.size > 1 else float(sp[0] ** len(img_size))
        self.register_buffer("fdk", fdk_weights(self._geom, self._n_v, self._n_u)
                             if geometry_type in ("conebeam", "fanbeam") else None)
        self.register_buffer("operator_norm", None)
        self.normalize = False
        self.to(device)
        if normalize is None:
            warnings.warn("The default value of `normalize` is not specified and will be "
                          "automatically set to `True`.")
            normalize = True
        if normalize:
            x0 = torch.randn((1, 1) + img_size, generator=torch.Generator().manual_seed(0))
            self.operator_norm = torch.sqrt(self.compute_norm(x0.to(device), max_iter=20))
            self.normalize = True

    @property
    def measurement_shape(self):
        return self.plan.measurement_shape

    @property
    def num_angles(self) -> int:
        return self._n_angles

    def A(self, x, **params):
        y = self.plan.project(x)
        return y / self.operator_norm if self.normalize else y

    def A_adjoint(self, y, **params):
        """The exact transpose of :meth:`A`, chunk by chunk (tomography.py:376)."""
        xt = self.plan.backproject(y)
        return xt / self.operator_norm if self.normalize else xt

    def fbp_weighting(self, sinogram):
        """FDK cosine weights for divergent beams, the cell ratio and
        ``pi / (2 n_angles)`` (tomography.py:386)."""
        if self.fdk is not None:
            if sinogram.dim() == 5:
                sinogram = sinogram * self.fdk.movedim(0, 1)[None, None]
            else:
                sinogram = sinogram * self.fdk[:, 0][None, None]
        sinogram = sinogram * self._cell_v_length / self._cell_volume
        return sinogram * math.pi / (2 * self.num_angles)

    def fbp(self, y, **params):
        """Filtered backprojection, FDK in cone beam (tomography.py:402): the
        ramp filter along the detector columns, the weighting, the adjoint."""
        filtered = ramp_filter(y.movedim(-1, -2)).movedim(-2, -1)
        out = self.A_adjoint(self.fbp_weighting(filtered))
        return out * self.operator_norm ** 2 if self.normalize else out

    def A_dagger(self, y, fbp: bool = False, **params):
        if fbp:
            return self.fbp(y, **params)
        return super().A_dagger(y, **params)


class Tomography3D(LinearPhysics):
    r"""3D parallel-beam CT about the z axis (tomography.py:421): each
    z-slice projects through the 2D :class:`Tomography` (any method, the
    slice method's Toeplitz ``A_adjoint_A`` included). Volumes ``(B, C, D,
    H, W)`` with square slices; sinograms ``(B, C, D, n_det, n_angles)``.

    :param angles: as :class:`Tomography`'s.
    :param img_size: ``(D, H, W)`` with ``H == W``.
    :param kwargs: ``noise_model``, and the :class:`Tomography` options
        (``device`` among them).
    """

    def __init__(self, angles, img_size, **kwargs):
        img_size = tuple(img_size)
        if len(img_size) != 3 or img_size[-1] != img_size[-2]:
            raise ValueError("img_size must be (D, H, W) with H == W")
        noise_model = kwargs.pop("noise_model", None)
        super().__init__(noise_model=noise_model)
        self.depth = img_size[0]
        self.slice_physics = Tomography(angles=angles, img_width=img_size[-1], **kwargs)
        self.img_width = img_size[-1]
        self.n_det = self.slice_physics.n_det

    @property
    def theta(self):
        return self.slice_physics.angles

    def _per_slice(self, fn, v):
        # (B, C, D, ...) -> depth folded into the channels, applied, unfolded
        B, C, D = v.shape[:3]
        out = fn(v.reshape(B, C * D, *v.shape[3:]))
        return out.reshape(B, C, D, *out.shape[2:])

    def A(self, x, **params):
        return self._per_slice(self.slice_physics.A, x)

    def A_adjoint(self, y, **params):
        return self._per_slice(self.slice_physics.A_adjoint, y)

    def A_adjoint_A(self, x, **params):
        return self._per_slice(self.slice_physics.A_adjoint_A, x)

    @property
    def fast_normal(self) -> bool:
        return self.slice_physics.fast_normal

    def A_dagger(self, y, **params):
        """Per-slice filtered backprojection (tomography.py:469)."""
        return self._per_slice(self.slice_physics.A_dagger, y)
