"""Positron emission tomography (port of deepinv_tpu/physics/pet.py).

``y = c . R(g * x) (+ b)``: a line-integral projector ``R`` (2D, 3D plane by
plane, or the multi-ring cylinder's crystal-to-crystal lines of response
with oblique michelogram segments through
:func:`~deepinv_tpu_torch.ops.xray.ray_integrals`), a separable Gaussian
resolution model ``g``, sinogram-space attenuation factors ``c``, a
sensitivity and an additive background. The adjoint is the autograd
transpose of the forward chain (the JAX package's ``jax.linear_transpose``);
``osem`` is MLEM over the ported projectors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.linalg import linear_transpose
from ..core.rng import Draws
from ..device import resolve_device
from ..ops.radon import iradon, radon
from ..ops.radon_fourier import radon_fourier
from ..ops.radon_slice import radon_slice
from ..ops.xray import ray_integrals
from .base import LinearPhysics
from .noise import PoissonNoise

__all__ = ["PET"]


class PET(LinearPhysics):
    r"""The PET forward operator (pet.py:38).

    :param img_size: int or ``(H, W)`` (2D, square), or ``(D, H, W)`` (3D,
        plane by plane over D rings, or the cylinder with
        ``ring_differences``).
    :param angles: projection angles over 180 degrees.
    :param fwhm: the Gaussian resolution model's FWHM in pixels (0: none).
    :param attenuation: an image-space ``mu`` (turned into ``c = exp(-R mu)``)
        or sinogram-space factors.
    :param background: the expected additive background.
    :param sensitivity: per-bin sensitivity.
    :param normalize: divide ``A`` and ``A_adjoint`` by the operator norm,
        from 20 power iterations on a uniform start drawn from ``generator``
        (a CPU generator seeded 0 where None; the JAX package draws it from
        ``jax.random.key(0)``), or handed in by ``draws`` (one array).
    :param gain: the default Poisson noise's gain.
    :param method: the 2-D projector, ``"interp"`` (``radon``), ``"fourier"``
        or ``"slice"``.
    :param ring_differences: (3D) the michelogram segments as ring
        differences, e.g. ``(0, -1, 1)``; measurements ``(B, C, S, D, N, A)``.
    :param scanner_radius: the crystal ring's radius in pixels (default the
        image width).
    :param ring_spacing: the axial crystal pitch in voxels.
    :param n_radial: radial bins a view (default the image width).
    :param device: where the geometry lives; the CUDA device by default.
    """

    def __init__(self, img_size=None, angles: int = 90, fwhm: float = 0.0, attenuation=None,
                 background=None, sensitivity=None, normalize: bool = False, gain: float = 1.0,
                 counts: float = 1e6, method: str = "interp", noise_model=None,
                 img_width: int = None, ring_differences=None, scanner_radius: float = None,
                 ring_spacing: float = 1.0, n_radial: int = None, generator=None, draws=None,
                 device=None, **kwargs):
        device = resolve_device(device)
        if noise_model is None:
            noise_model = PoissonNoise(gain=gain, clip_positive=True, device=device)
        super().__init__(noise_model=noise_model, **kwargs)
        if img_size is None:
            img_size = img_width
        if img_size is None:
            raise ValueError("img_size (or img_width) is required")
        if isinstance(img_size, int):
            img_size = (img_size, img_size)
        img_size = tuple(int(s) for s in img_size)
        self.is_2d = len(img_size) != 3
        self.depth = None if self.is_2d else img_size[0]
        if img_size[-1] != img_size[-2]:
            raise ValueError("PET images must have square slices (H == W)")
        self.img_width = img_size[-1]
        self._theta_np = np.linspace(0, 180, angles, endpoint=False).astype(np.float32)
        self.register_buffer("theta", torch.from_numpy(self._theta_np))
        self.method = method
        self.counts = counts
        self.normalize = normalize
        self.ring_differences = (tuple(int(d) for d in ring_differences)
                                 if ring_differences is not None else None)
        self.ring_spacing = float(ring_spacing)
        if self.ring_differences is not None:
            if self.is_2d:
                raise ValueError("ring_differences requires a 3D img_size")
            p0, p1 = self._build_lors(scanner_radius, n_radial)
        else:
            p0 = p1 = None
        self.register_buffer("_lor_p0", p0)
        self.register_buffer("_lor_p1", p1)
        psf = None
        if fwhm and fwhm > 0:
            sigma = float(fwhm) / 2.3548
            rad = max(1, int(np.ceil(3 * sigma)))
            g = np.exp(-0.5 * (np.arange(-rad, rad + 1) / sigma) ** 2)
            psf = torch.from_numpy((g / g.sum()).astype(np.float32))
        self.register_buffer("_psf", psf)
        for name, value, fill in (("sensitivity", sensitivity, 1.0),
                                  ("background", background, 0.0)):
            self.register_buffer(name, torch.full((), fill) if value is None else
                                 torch.as_tensor(value, dtype=torch.float32))
        self.register_buffer("acf", torch.ones(()))
        self.register_buffer("operator_norm", torch.ones(()))
        self.to(device)
        if attenuation is not None:
            att = torch.as_tensor(attenuation, dtype=torch.float32).to(device)
            if att.shape[-1] == self.img_width:
                # an image-space mu map -> sinogram correction factors
                if self._lor_p0 is not None:
                    while att.dim() < 5:
                        att = att[None]
                    self.acf = torch.exp(-self._project_lor(att))
                else:
                    self.acf = torch.exp(-self._project(self._fold(att)))
            else:
                self.acf = att
        if normalize:
            shape = (1, 1) + ((self.depth,) if self.depth else ()) + (self.img_width,) * 2
            x0 = Draws(generator, 0, None, draws).uniform(shape).to(device)
            with torch.no_grad():
                self.operator_norm = torch.sqrt(self._norm_unnormalized(x0))

    def plot_geometry(self, n_lors: int = 64, show: bool = True):
        """3D plot of the scanner (pet.py:216): the crystal rings, of radius
        ``scanner_radius`` if the physics keeps one, else the image width, and
        every k-th michelogram line of response, about ``n_lors`` of them.
        Returns the matplotlib figure."""
        from ..utils.plotting import _mpl

        plt = _mpl()
        fig = plt.figure(figsize=(16, 8))
        ax = fig.add_subplot(1, 1, 1, projection="3d")
        R = getattr(self, "scanner_radius", float(self.img_width))
        phi = np.linspace(0, 2 * np.pi, 181)
        D = self.depth or 1
        for z in (np.arange(D) - (D - 1) / 2.0) * self.ring_spacing:
            ax.plot(R * np.cos(phi), R * np.sin(phi), np.full_like(phi, z), color="0.6", lw=0.8)
        if self._lor_p0 is not None:
            p0 = self._lor_p0.detach().cpu().numpy().reshape(-1, 3)
            p1 = self._lor_p1.detach().cpu().numpy().reshape(-1, 3)
            keep = np.linalg.norm(p1 - p0, axis=-1) > 0
            p0, p1 = p0[keep], p1[keep]
            step = max(1, len(p0) // n_lors)
            for a, b in zip(p0[::step], p1[::step]):
                ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]], color="C0", lw=0.5, alpha=0.5)
        for set_label in (ax.set_xlabel, ax.set_ylabel, ax.set_zlabel):
            set_label("mm")
        fig.tight_layout()
        if show:
            fig.show()
        return fig

    # -- the projector -----------------------------------------------------------

    def _build_lors(self, scanner_radius, n_radial):
        """The endpoints ``(S, D, N, A, 3)`` of the cylinder's lines of
        response (pet.py:169), in float64 on the host: for segment ``delta``,
        radial bin ``t`` and view ``a`` the ray joins the crystals of rings
        ``r`` and ``r + delta`` where the chord at offset ``t`` meets the
        scanner circle; a ring ``r + delta`` outside the scanner gives a ray
        of zero length."""
        D, W = self.depth, self.img_width
        R = float(scanner_radius) if scanner_radius is not None else float(W)
        self.scanner_radius = R
        N = int(n_radial) if n_radial is not None else W
        a = np.deg2rad(self._theta_np.astype(np.float64))
        t = np.arange(N) - (N - 1) / 2.0
        d_hat = np.stack([np.sin(a), np.cos(a), np.zeros_like(a)], -1)
        u_hat = np.stack([np.cos(a), -np.sin(a), np.zeros_like(a)], -1)
        L = np.sqrt(np.maximum(R * R - t * t, 0.0))
        base = t[:, None, None] * u_hat[None]
        chord = L[:, None, None] * d_hat[None]
        S = len(self.ring_differences)
        p0 = np.zeros((S, D, N, len(a), 3))
        p1 = np.zeros_like(p0)
        zc = (np.arange(D) - (D - 1) / 2.0) * self.ring_spacing
        for si, delta in enumerate(self.ring_differences):
            for r in range(D):
                e0 = base - chord + np.array([0.0, 0.0, zc[r]])
                r2 = r + delta
                e1 = base + chord + np.array([0.0, 0.0, zc[r2]]) if 0 <= r2 < D else e0
                p0[si, r], p1[si, r] = e0, e1
        return (torch.from_numpy(p0.astype(np.float32)),
                torch.from_numpy(p1.astype(np.float32)))

    def _project_lor(self, x):
        """``(B, C, D, H, W)`` to the michelogram ``(B, C, S, D, N, A)``
        (pet.py:206)."""
        return ray_integrals(x, self._lor_p0, self._lor_p1,
                             img_size=(self.depth, self.img_width, self.img_width),
                             pixel_spacing=(self.ring_spacing, 1.0, 1.0))

    def _fold(self, v):
        """``(B, C, D, H, W)`` to ``(B, C D, H, W)`` for the plane-by-plane
        projection."""
        if self.is_2d:
            return v
        B, C, D = v.shape[:3]
        return v.reshape(B, C * D, *v.shape[3:])

    def _unfold(self, v, like):
        if self.is_2d:
            return v
        B, C, D = like[:3]
        return v.reshape(B, C, D, *v.shape[2:])

    def _resolution(self, x):
        """The separable Gaussian PSF ``g * x``, edges replicated
        (pet.py:261)."""
        if self._psf is None:
            return x
        k = self._psf.shape[0]
        xp = F.pad(x.reshape((-1, 1) + x.shape[-2:]), (k // 2,) * 4, mode="replicate")
        x1 = F.conv2d(xp, self._psf.reshape(1, 1, k, 1))
        return F.conv2d(x1, self._psf.reshape(1, 1, 1, k)).reshape(x.shape)

    def _project(self, x):
        if self.method == "fourier":
            return radon_fourier(x, self._theta_np, circle=True)
        if self.method == "slice":
            return radon_slice(x, self._theta_np, circle=True)
        return radon(x, self.theta, circle=True)

    def _fwd_chain(self, x):
        """``R(g * x)`` on a folded ``(B, C', H, W)`` input."""
        return self._project(self._resolution(x))

    def _fwd_chain_lor(self, x):
        """``LOR(g * x)`` on ``(B, C, D, H, W)`` volumes."""
        return self._project_lor(self._resolution(x))

    def _norm_unnormalized(self, x0, n_iter: int = 20):
        """``||A||^2`` of the unnormalized operator by ``n_iter`` power steps
        from ``x0`` (pet.py:281)."""
        v = x0
        for _ in range(n_iter):
            u = self._At_core(self._A_core(v))
            v = u / torch.linalg.vector_norm(u)
        Av = self._A_core(v)
        return (Av * Av).sum() / (v * v).sum()

    def _A_core(self, x):
        if self._lor_p0 is not None:
            return self._fwd_chain_lor(x) * self.acf * self.sensitivity
        y = self._fwd_chain(self._fold(x)) * self.acf * self.sensitivity
        return y if self.is_2d else self._unfold(y, x.shape)

    def _At_core(self, y):
        yw = y * self.acf * self.sensitivity
        if self._lor_p0 is not None:
            return linear_transpose(self._fwd_chain_lor, yw, tuple(y.shape[:2]) + (
                self.depth, self.img_width, self.img_width))
        if not self.is_2d:
            yw = self._fold(yw)
        xt = linear_transpose(self._fwd_chain, yw, (y.shape[0], yw.shape[1], self.img_width,
                                                    self.img_width))
        return xt if self.is_2d else self._unfold(xt, y.shape)

    # -- the operator ------------------------------------------------------------

    def A(self, x, add_background: bool = False, **params):
        out = self._A_core(x) / self.operator_norm
        return out + self.background if add_background else out

    def A_adjoint(self, y, **params):
        return self._At_core(y) / self.operator_norm

    def forward(self, x, generator=None, **params):
        """Measurements ``Poisson(c R(g * x) + b)`` (pet.py:333)."""
        return self.sensor(self.noise(self.A(x, add_background=True, **params),
                                      generator=generator))

    def generate_background(self, expected_background, generator=None):
        """A random background realization (pet.py:339)."""
        return self.noise_model(expected_background, generator=generator)

    def A_dagger(self, y, **params):
        """The FBP of the attenuation-corrected sinogram (pet.py:343); in
        michelogram mode that of the direct planes (ring difference 0), else
        the Krylov ``A_dagger``."""
        yc = y * self.operator_norm / (self.acf * self.sensitivity).clamp_min(1e-6)
        if self._lor_p0 is not None:
            if 0 not in self.ring_differences:
                return super().A_dagger(y, **params)
            yc = yc[:, :, self.ring_differences.index(0)]
            B, C, D = yc.shape[:3]
            out = iradon(yc.reshape(B, C * D, *yc.shape[3:]), self.theta, circle=True,
                         filtered=True, out_size=self.img_width)
            return out.reshape(B, C, D, self.img_width, self.img_width)
        out = iradon(self._fold(yc), self.theta, circle=True, filtered=True,
                     out_size=self.img_width)
        return out if self.is_2d else self._unfold(out, y.shape)

    def osem(self, y, n_iter: int = 4, n_subsets: int = 1):
        """MLEM (pet.py:365): the measurements and updates clipped, the
        ratio bounded, pixels the scanner does not see frozen."""
        shape = tuple(y.shape[:2]) + (() if self.is_2d else (self.depth,)) + (
            self.img_width,) * 2
        x = torch.ones(shape, dtype=y.dtype, device=y.device)
        sens_pos = self.A_adjoint(torch.ones_like(y)).clamp_min(0.0)
        y_pos = (y - self.background).clamp_min(0.0)
        valid = sens_pos > 1e-3 * sens_pos.max()
        for _ in range(n_iter):
            ratio = (y_pos / self.A(x).clamp_min(1e-6)).clamp(0.0, 1e3)
            upd = self.A_adjoint(ratio).clamp_min(0.0) / sens_pos.clamp_min(1e-9)
            x = x * torch.where(valid, upd, torch.zeros_like(upd))
        return x
