"""Random PSF generators (port of deepinv_tpu/physics/generator/blur.py).

PSFs come out non-negative and summing to 1, of shape ``(B, C, *psf_size)``,
ready for ``physics.update(filter=...)``. Motion blur rasterises a Matern
Gaussian-process trajectory; Gaussian blur draws deviations and angles;
diffraction blur takes ``|F[pupil]|^2`` of a Zernike-phase pupil (and its
propagation over depth in 3D, times a pinhole-convolved collection PSF for
the confocal microscope). ``ProductConvolutionBlurGenerator`` and
``TiledBlurGenerator`` make the parameters of the space-varying blurs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...ops.conv import conv2d, gaussian_blur
from ...ops.misc import ThinPlateSpline, histogramdd
from .base import PhysicsGenerator
from .zernike import Zernike

__all__ = ["MotionBlurGenerator", "GaussianBlurGenerator", "DiffractionBlurGenerator",
           "ProductConvolutionBlurGenerator", "TiledBlurGenerator", "ConfocalBlurGenerator3D",
           "PSFGenerator", "DiffractionBlurGenerator3D", "bump_function"]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _centered_fft2(p):
    """``ifftshift(fft2(fftshift(p)))`` over the last two axes."""
    return torch.fft.ifftshift(torch.fft.fft2(torch.fft.fftshift(p, dim=(-2, -1))),
                               dim=(-2, -1))


class MotionBlurGenerator(PhysicsGenerator):
    r"""Motion-blur PSFs from a random 2D trajectory, a Gaussian process of
    Matern 5/2 covariance, rasterised on the PSF grid (blur.py:30).

    :param psf_size: ``(h, w)`` of the PSF.
    :param l: the covariance's length scale.
    :param sigma: its amplitude.
    :param n_steps: trajectory samples drawn (``length`` is its alias).
    """

    def __init__(self, psf_size=(31, 31), l: float = 0.3, sigma: float = 0.25,
                 n_steps: int = 1000, seed: int = 0, length: int = None, device=None):
        super().__init__(seed=seed, device=device)
        self.psf_size = _pair(psf_size)
        self.l = l
        self.sigma = sigma
        self.n_steps = length if length is not None else n_steps

    def matern_kernel(self, diff, sigma=None, l=None):
        """Matern 5/2 covariance (blur.py:69)."""
        sigma = self.sigma if sigma is None else sigma
        l = self.l if l is None else l
        frac = 5 ** 0.5 * diff.abs() / l
        return sigma ** 2 * (1 + frac + frac ** 2 / 3) * torch.exp(-frac)

    def f_matern(self, draws, batch_size, sigma=None, l=None):
        """Stationary draws by spectral filtering of white noise
        (blur.py:76): the first ``n / (2 pi)`` samples."""
        n = self.n_steps
        vec = draws.normal((batch_size, n))
        time = torch.linspace(-math.pi, math.pi, n, device=self.device)[None]
        kernel_fft = torch.fft.rfft(self.matern_kernel(time, sigma, l))
        full = torch.fft.irfft(torch.fft.rfft(vec) * torch.sqrt(kernel_fft.to(torch.complex64)))
        return full[:, :int(n / (2 * math.pi))]

    def sample(self, batch_size, draws, sigma=None, l=None, **kwargs):
        f_x = self.f_matern(draws, batch_size, sigma, l)
        f_y = self.f_matern(draws, batch_size, sigma, l)
        traj = torch.stack([f_x - f_x.mean(1, keepdim=True), f_y - f_y.mean(1, keepdim=True)],
                           -1)
        psfs = []
        for tr in traj:
            k, _ = histogramdd(tr, bins=list(self.psf_size), low=[-1, -1], upp=[1, 1])
            psfs.append(k / (k.sum() + 1e-6))
        return {"filter": torch.stack(psfs)[:, None]}


class PSFGenerator(PhysicsGenerator):
    """The base of the PSF generators (blur.py:111): the PSF's size and
    channel count."""

    def __init__(self, psf_size=(31, 31), num_channels: int = 1, seed: int = 0, device=None):
        super().__init__(seed=seed, device=device)
        self.psf_size = _pair(psf_size)
        self.shape = self.psf_size
        self.num_channels = num_channels


def _as_range_tuple(vals, dim, name):
    """A scalar or a sequence of length 1 or ``dim`` as a ``dim``-tuple."""
    if isinstance(vals, (int, float)):
        vals = (float(vals),) * dim
    else:
        vals = tuple(float(v) for v in vals)
        if len(vals) == 1:
            vals = vals * dim
    if len(vals) != dim:
        raise ValueError(f"Length of {name} should be either 1 or {dim}, got {len(vals)}.")
    return vals


class GaussianBlurGenerator(PSFGenerator):
    r"""Gaussian PSFs of random deviations and angles in 1, 2 or 3
    dimensions (blur.py:136).

    :param sigma_min: the least deviation (a scalar or a tuple by dimension).
    :param sigma_max: the largest.
    :param isotropic: one deviation on every axis.
    :param angle_min: the least rotation in degrees (one in 2D, three in 3D).
    :param angle_max: the largest.
    """

    def __init__(self, psf_size=(31, 31), sigma_min=0.5, sigma_max=5.0, isotropic: bool = True,
                 angle_min=0.0, angle_max=360.0, num_channels: int = 1, seed: int = 0,
                 device=None):
        super().__init__(psf_size=psf_size, num_channels=num_channels, seed=seed, device=device)
        dim = len(self.psf_size)
        if dim not in (1, 2, 3):
            raise ValueError("Only 1D, 2D, and 3D kernels are supported.")
        self.dim = dim
        self.isotropic = isotropic
        self.sigma_min = _as_range_tuple(sigma_min, dim, "sigma_min")
        self.sigma_max = _as_range_tuple(sigma_max, dim, "sigma_max")
        adim = 3 if dim == 3 else 1
        self.angle_min = _as_range_tuple(angle_min, adim, "angle_min")
        self.angle_max = _as_range_tuple(angle_max, adim, "angle_max")
        for lo, hi, nm in ((self.sigma_min, self.sigma_max, "sigma"),
                           (self.angle_min, self.angle_max, "angle")):
            if any(a > b for a, b in zip(lo, hi)):
                raise ValueError(f"{nm}_min must be <= {nm}_max")

    def _uniform(self, draws, batch_size, lo, hi, isotropic):
        if isotropic:
            u = lo[0] + draws.uniform((batch_size, 1)) * (hi[0] - lo[0])
            return u.repeat(1, len(lo))
        return torch.stack([a + draws.uniform((batch_size,)) * (b - a) for a, b in zip(lo, hi)],
                           -1)

    def sample(self, batch_size, draws, sigma=None, angle=None, **kwargs):
        if sigma is None:
            sigma = self._uniform(draws, batch_size, self.sigma_min, self.sigma_max,
                                  self.isotropic)
        if angle is None:
            angle = self._uniform(draws, batch_size, self.angle_min, self.angle_max, False)
        angle = torch.as_tensor(angle)
        if self.dim == 2:
            angle = angle.reshape(-1)
        filt = gaussian_blur(sigma=torch.as_tensor(sigma), angle=angle, psf_size=self.psf_size)
        return {"filter": filt.to(self.device)}


class DiffractionBlurGenerator(PSFGenerator):
    r"""Diffraction-limited PSFs from a Zernike expansion of the pupil's
    phase (blur.py:213): ``h = |F[1_{|rho| <= 1} exp(-2 i pi sum_k theta_k
    z_k(rho))]|^2`` on a finer pupil grid, cropped to ``psf_size`` and
    normalised. Several channels follow the chromatic model: the base
    coefficients scale by ``fc_c / fc_0`` and take Gaussian perturbations of
    ``zernike_perturbation_amplitude``.

    :param zernike_index: the modes: ints in ``index_convention`` (Noll 4-11
        by default: defocus to primary spherical) or ``(n, m)`` tuples.
    :param fc: the cutoff ``NA * pixel_size / wavelength``: a scalar or one
        by channel (and ``(B, C)`` at step time).
    :param max_zernike_amplitude: the coefficients are drawn in
        ``[-max/2, max/2]`` waves.
    :param zernike_perturbation_amplitude: the chromatic perturbations' scale.
    :param pupil_size: the pupil grid.
    :param apodize: taper the PSF's border.
    :param random_rotate: rotate each PSF by a random angle.
    :param index_convention: ``"noll"`` or ``"ansi"``.
    """

    def __init__(self, psf_size=(31, 31), zernike_index=tuple(range(4, 12)), fc=0.2,
                 max_zernike_amplitude: float = 0.15, zernike_perturbation_amplitude: float = 0.0,
                 pupil_size=(256, 256), apodize: bool = False, random_rotate: bool = False,
                 index_convention: str = "noll", seed: int = 0, list_param=None,
                 num_channels: int = 1, device=None):
        super().__init__(psf_size=psf_size, num_channels=num_channels, seed=seed, device=device)
        if list_param is not None:
            zernike_index = list_param
        if isinstance(fc, (int, float)):
            self.fc = float(fc)
        else:
            self.fc = torch.as_tensor(fc, dtype=torch.float32, device=self.device)
            if self.fc.dim() != 1:
                raise ValueError("fc must be a scalar or 1D tensor/list/tuple at construction "
                                 f"time, got {self.fc.dim()}D.")
        zernike_index = list(zernike_index)
        for i, index in enumerate(zernike_index):
            if isinstance(index, str):
                if not index.upper().startswith("Z"):
                    raise ValueError(f"Zernike index must start with 'Z', got {index}")
                zernike_index[i] = int(index[1:])
        self.zernike_index = sorted(zernike_index,
                                    key=lambda v: (v,) if isinstance(v, int) else tuple(v))
        self.max_zernike_amplitude = max_zernike_amplitude
        self.zernike_perturbation_amplitude = zernike_perturbation_amplitude
        self.apodize = apodize
        self.random_rotate = random_rotate
        self.index_convention = index_convention
        self.n_zernike = len(self.zernike_index)
        pupil_size = _pair(pupil_size)
        self.pupil_size = (max(pupil_size[0], self.psf_size[0]),
                           max(pupil_size[1], self.psf_size[1]))
        self.lin_x = torch.linspace(-0.5, 0.5, self.pupil_size[0], device=self.device)
        self.lin_y = torch.linspace(-0.5, 0.5, self.pupil_size[1], device=self.device)
        self.step_rho = float(self.lin_x[1] - self.lin_x[0])
        self.pad_pre = tuple(math.ceil((p - s) / 2) for p, s in zip(self.pupil_size,
                                                                    self.psf_size))
        self.pad_post = tuple(math.floor((p - s) / 2) for p, s in zip(self.pupil_size,
                                                                      self.psf_size))
        self.apodize_mask = None
        if apodize:
            l0, l1 = (torch.linspace(-(n // 2), n // 2, n, device=self.device)
                      for n in self.psf_size[:2])
            X0, X1 = torch.meshgrid(l0, l1, indexing="ij")
            radius = min(self.psf_size) / 2
            ap_len = min(10, radius)
            self.apodize_mask = bump_function(torch.sqrt(X0 ** 2 + X1 ** 2), radius - ap_len,
                                              ap_len)
        self._nm_list = self._zernike_index_to_nm_list(self.zernike_index, index_convention)
        self._basis_cache = {}

    @staticmethod
    def _zernike_index_to_nm_list(zernike_index, index_convention="noll"):
        """Each index as ``(n, m)`` (blur.py:340)."""
        nm_list = []
        for index in zernike_index:
            if isinstance(index, (int, np.integer)):
                nm_list.append(Zernike.index_conversion(int(index), convention=index_convention))
            elif isinstance(index, (tuple, list)) and len(index) == 2:
                nm_list.append((int(index[0]), int(index[1])))
            else:
                raise ValueError(
                    f"Zernike index must be either int or tuple of (n, m), got {index!r}")
        return nm_list

    @property
    def zernike_polynomials(self):
        """The names of the active modes (blur.py:356)."""
        return [Zernike.get_name(n, m) for n, m in self._nm_list]

    def _format_fc(self, fc, batch_size):
        """``fc`` as a ``(B, C)`` tensor (blur.py:360)."""
        t = torch.as_tensor(fc, dtype=torch.float32, device=self.device)
        if t.dim() == 2:
            return t
        if t.dim() == 0:
            return t.reshape(1, 1).expand(batch_size, 1)
        if t.dim() == 1:
            return t[None].expand(batch_size, t.shape[0])
        raise ValueError(f"fc must be 0D, 1D or 2D, got {t.dim()}D.")

    def _zernike_basis(self, fc, nm_list=None):
        """The Zernike stack ``(Bf, Cf, H, W, K)`` and the pupil's indicator
        ``(Bf, Cf, H, W)`` at the cutoffs ``fc (Bf, Cf)`` (blur.py:371),
        memoised by value."""
        nm_list = self._nm_list if nm_list is None else nm_list
        key = (fc.detach().cpu().numpy().tobytes(), tuple(fc.shape), tuple(nm_list))
        hit = self._basis_cache.get(key)
        if hit is not None:
            return hit
        fc_r = fc.reshape(fc.shape + (1, 1))
        XX, YY = torch.meshgrid(self.lin_x, self.lin_y, indexing="ij")
        XX, YY = XX[None, None] / fc_r, YY[None, None] / fc_r
        rho = torch.sqrt(XX ** 2 + YY ** 2)
        # the pupil edge's transition in the rescaled coordinates (blur.py:385)
        step = self.step_rho / fc_r
        indicator = bump_function(rho, 1 - step / 2, step / 2)
        Z = torch.stack([Zernike.cartesian_evaluate(n, m, XX, YY) for n, m in nm_list], -1)
        self._basis_cache[key] = (Z, indicator)
        return Z, indicator

    def generate_coeff(self, batch_size, draws, fc=None, max_zernike_amplitude=None,
                       zernike_perturbation_amplitude=None, n_zernike=None):
        """Random coefficients ``(B, K)``, or ``(B, C, K)`` by the chromatic
        model (blur.py:401)."""
        amp = self.max_zernike_amplitude if max_zernike_amplitude is None \
            else max_zernike_amplitude
        pert = self.zernike_perturbation_amplitude if zernike_perturbation_amplitude is None \
            else zernike_perturbation_amplitude
        fc = self._format_fc(self.fc, batch_size) if fc is None else fc
        n_zernike = self.n_zernike if n_zernike is None else n_zernike
        base = (draws.uniform((batch_size, n_zernike)) - 0.5) * amp
        C = fc.shape[1]
        if C == 1:
            return base
        scale = fc / fc[:, 0:1]
        delta = draws.normal((batch_size, C, n_zernike)) * pert
        return base[:, None] * scale[..., None] + delta

    def generate_angles(self, batch_size, draws):
        """Random rotations in degrees (blur.py:428)."""
        return draws.uniform((batch_size,)) * 360.0

    def sample(self, batch_size, draws, coeff=None, angle=None, max_zernike_amplitude=None,
               zernike_perturbation_amplitude=None, fc=None, used_zernike_index=None,
               **kwargs):
        if used_zernike_index is not None:
            nm_used = self._zernike_index_to_nm_list(used_zernike_index, self.index_convention)
            invalid = [nm for nm in nm_used if nm not in self._nm_list]
            if invalid:
                raise ValueError(
                    f"used_zernike_index contains (n, m) entries {invalid} that are not in "
                    "self.zernike_index. Initialise with a larger zernike_index set.")
        else:
            nm_used = self._nm_list
        K = len(nm_used)
        fc = self.fc if fc is None else fc
        if coeff is not None:
            coeff = torch.as_tensor(coeff, device=self.device)
            if coeff.shape[-1] != K:
                raise ValueError(f"The number of Zernike coefficients {coeff.shape[-1]} in "
                                 f"input coeff does not match n_zernike_used={K}")
            fc_used = self._format_fc(fc, coeff.shape[0])
            B, C = fc_used.shape
            if coeff.dim() not in (2, 3) or coeff.shape[0] != B or (
                    coeff.dim() == 3 and coeff.shape[1] != C):
                raise ValueError(f"coeff shape {tuple(coeff.shape)} does not match fc "
                                 f"inferred shape (B={B}, C={C}, K).")
        else:
            fc_used = self._format_fc(fc, batch_size)
            B, C = fc_used.shape
            coeff = self.generate_coeff(B, draws, fc=fc_used,
                                        max_zernike_amplitude=max_zernike_amplitude,
                                        zernike_perturbation_amplitude=
                                        zernike_perturbation_amplitude, n_zernike=K)
        if coeff.dim() == 2:
            coeff = coeff[:, None].expand(coeff.shape[0], C, coeff.shape[1])
        Z, indicator = self._zernike_basis(fc_used, nm_list=nm_used)
        if Z.shape[1] == 1 and coeff.shape[1] > 1:
            Z = Z.expand(Z.shape[0], coeff.shape[1], *Z.shape[2:])
            indicator = indicator.expand(indicator.shape[0], coeff.shape[1],
                                         *indicator.shape[2:])
        phase = torch.einsum("bchwk,bck->bchw", Z, coeff.to(Z.dtype))
        pupil = torch.exp(-2j * math.pi * phase.to(torch.complex64)) * indicator
        psf = _centered_fft2(pupil).abs() ** 2
        psf = psf[..., self.pad_pre[0]:self.pupil_size[0] - self.pad_post[0],
                  self.pad_pre[1]:self.pupil_size[1] - self.pad_post[1]]
        psf = psf / psf.sum(dim=(-2, -1), keepdim=True)
        if self.random_rotate:
            from ...transform.geometric import rotate_via_shear

            if angle is None:
                angle = self.generate_angles(psf.shape[0], draws)
            psf = rotate_via_shear(psf, angle)
        if self.apodize:
            psf = self.apodize_mask * psf
            psf = psf / psf.sum(dim=(-2, -1), keepdim=True)
        params = {"filter": psf, "coeff": coeff, "pupil": pupil, "fc": fc_used}
        if self.random_rotate:
            params["angle"] = angle
        return params


class ProductConvolutionBlurGenerator(PhysicsGenerator):
    r"""Parameters of :class:`~deepinv_tpu_torch.physics.SpaceVaryingBlur`
    (blur.py:527): PSFs drawn on a coarse grid, reduced by SVD to
    ``n_eigen_psf`` eigen-PSFs, whose coefficients a thin-plate spline
    interpolates over the image as the multipliers.

    :param psf_generator: the PSF generator drawn at each grid point.
    :param img_size: ``(H, W)`` of the image.
    :param n_eigen_psf: the eigen-PSFs kept.
    :param spacing: the grid's spacing, ``(H // 8, W // 8)`` by default.
    """

    def __init__(self, psf_generator=None, img_size=(32, 32), n_eigen_psf: int = 10,
                 spacing=None, seed: int = 0, device=None):
        super().__init__(seed=seed, device=device)
        self.psf_generator = psf_generator if psf_generator is not None else \
            DiffractionBlurGenerator(psf_size=(15, 15), device=self.device)
        self.img_size = _pair(img_size)[-2:]
        spacing = _pair(spacing) if spacing is not None else None
        self.spacing = spacing or (self.img_size[0] // 8, self.img_size[1] // 8)
        self.n_eigen_psf = n_eigen_psf
        ny, nx = (self.img_size[0] // self.spacing[0], self.img_size[1] // self.spacing[1])
        self.n_psf_grid = ny * nx
        if self.n_psf_grid < n_eigen_psf:
            raise ValueError(f"n_eigen_psf={n_eigen_psf} must be smaller than the number of PSF "
                             f"grid points = {self.n_psf_grid}")

        def points(n0, n1):
            yy, xx = np.meshgrid(np.linspace(0, 1, n0), np.linspace(0, 1, n1), indexing="ij")
            return torch.as_tensor(np.stack([yy.ravel(), xx.ravel()], 1), dtype=torch.float32,
                                   device=self.device)

        self._X = points(ny, nx)
        self._XX = points(*self.img_size)

    def sample(self, batch_size, draws, **kwargs):
        grid = self.psf_generator.sample(self.n_psf_grid * batch_size, draws, **kwargs)["filter"]
        ph, pw = grid.shape[-2:]
        C = grid.shape[1]
        M = grid.reshape(batch_size, self.n_psf_grid, C, ph * pw).transpose(1, 2)
        _, _, Vh = torch.linalg.svd(M, full_matrices=False)
        K = min(self.n_eigen_psf, Vh.shape[-2])
        Vh = Vh[..., :K, :]
        coeffs = torch.einsum("bcnp,bckp->bcnk", M, Vh)
        w = ThinPlateSpline(0.0).fit(self._X, coeffs).transform(self._XX).transpose(-1, -2)
        return {"filters": Vh.reshape(batch_size, C, K, ph, pw),
                "multipliers": w.reshape(batch_size, C, K, *self.img_size)}


class TiledBlurGenerator(PhysicsGenerator):
    r"""One PSF of ``psf_generator`` per tile of
    :class:`~deepinv_tpu_torch.physics.TiledSpaceVaryingBlur` (blur.py:661).

    :param patch_size: the tile's size.
    :param stride: the stride between tiles (``patch_size`` by default).
    :param img_size: the image's size (or pass it at step time).
    :param tiles: with ``img_size``, a ``(ty, tx)`` grid of tiles.
    """

    def __init__(self, psf_generator=None, patch_size=16, stride=None, seed: int = 0,
                 img_size=None, tiles=None, device=None):
        super().__init__(seed=seed, device=device)
        self.psf_generator = psf_generator if psf_generator is not None else \
            DiffractionBlurGenerator(psf_size=(15, 15), device=self.device)
        if tiles is not None and img_size is not None:
            img_size = _pair(img_size)[-2:]
            patch_size = (img_size[0] // tiles[0], img_size[1] // tiles[1])
        self.patch_size = _pair(patch_size)
        self.stride = self.patch_size if stride is None else _pair(stride)
        self.psf_size = getattr(self.psf_generator, "psf_size", None)
        self.img_size = img_size

    def get_needed_pad(self, img_size):
        """The padding that makes ``img_size`` fit the tiles (blur.py:653)."""
        from ...utils.mixins import _compute_needed_pad

        return _compute_needed_pad(tuple(img_size)[-2:], self.patch_size, self.stride)

    def get_compatible_img_size(self, img_size):
        """The least size at or above ``img_size`` that the tiles fit
        (blur.py:661)."""
        from ...utils.mixins import _compute_compatible_img_size

        return _compute_compatible_img_size(tuple(img_size)[-2:], self.patch_size, self.stride)

    def image_to_patches(self, image, pad=(0, 0, 0, 0)):
        """``image`` cut in this generator's tiles (blur.py:669)."""
        from ...utils.mixins import image_to_patches

        return image_to_patches(image, self.patch_size, self.stride, pad=pad)

    def patches_to_image(self, patches, img_size=None, reduce_overlap="sum"):
        """Tiles put back together (blur.py:676)."""
        from ...utils.mixins import patches_to_image

        return patches_to_image(patches, self.stride, img_size=img_size,
                                reduce_overlap=reduce_overlap)

    def get_num_patches(self, img_size):
        """``(n_h, n_w)``, the tiles that cover ``img_size`` (blur.py:683)."""
        (H, W), (ph, pw), (sh, sw) = tuple(img_size)[-2:], self.patch_size, self.stride
        return -(-max(H - ph, 0) // sh) + 1, -(-max(W - pw, 0) // sw) + 1

    def sample(self, batch_size, draws, img_size=None, **kwargs):
        img_size = img_size if img_size is not None else self.img_size
        if img_size is None:
            raise ValueError("img_size must be given at construction or step time")
        ny, nx = self.get_num_patches(_pair(img_size))
        psf = self.psf_generator.sample(batch_size * ny * nx, draws, **kwargs)["filter"]
        h, w = psf.shape[-2:]
        return {"filters": psf.reshape(batch_size, ny * nx, -1, h, w).transpose(1, 2)}


class DiffractionBlurGenerator3D(PSFGenerator):
    r"""3D diffraction-limited PSF stacks (blur.py:707): the 2D Zernike pupil
    of :class:`DiffractionBlurGenerator` propagated to each defocus plane by
    ``exp(-2 i pi k_z z)``, ``k_z = sqrt(kb^2 - k_lateral^2)``; the PSF at
    depth ``z`` is ``|F[pupil_z]|^2``, normalised over the volume.

    :param psf_size: ``(depth, H, W)``.
    :param kb: the wave number ``NI / wavelength * pixel_size`` (above ``fc``).
    :param stepz_pixel: the axial over the lateral voxel size.
    """

    def __init__(self, psf_size=(9, 31, 31), zernike_index=tuple(range(4, 12)), fc=0.2,
                 kb=0.25, max_zernike_amplitude: float = 0.15,
                 zernike_perturbation_amplitude: float = 0.0, pupil_size=(512, 512),
                 apodize: bool = False, random_rotate: bool = False, stepz_pixel: float = 1.0,
                 index_convention: str = "noll", seed: int = 0, num_channels: int = 1,
                 n_zernike=None, device=None, **kwargs):
        if len(psf_size) != 3:
            raise ValueError("You should provide a tuple of len == 3 to generate 3D PSFs.")
        super().__init__(psf_size=psf_size[1:], num_channels=num_channels, seed=seed,
                         device=device)
        if n_zernike is not None:
            zernike_index = tuple(range(4, 4 + n_zernike))
        self.generator2d = DiffractionBlurGenerator(
            psf_size=psf_size[1:], zernike_index=zernike_index, fc=fc,
            max_zernike_amplitude=max_zernike_amplitude,
            zernike_perturbation_amplitude=zernike_perturbation_amplitude,
            pupil_size=pupil_size, apodize=apodize, index_convention=index_convention,
            seed=seed, device=self.device, **kwargs)
        self.psf_size = tuple(psf_size)
        self.shape = self.psf_size
        self.fc = self.generator2d.fc
        self.kb = kb
        self.apodize = apodize
        self.random_rotate = random_rotate
        self.stepz_pixel = stepz_pixel
        self.nzs = psf_size[0]
        self.zernike_index = self.generator2d.zernike_index
        self.n_zernike = len(self.zernike_index)
        self._defocus = torch.linspace(-self.nzs / 2, self.nzs / 2, self.nzs,
                                       device=self.device)[:, None, None] * stepz_pixel

    @property
    def zernike_polynomials(self):
        return self.generator2d.zernike_polynomials

    def sample(self, batch_size, draws, coeff=None, angle=None, fc=None, kb=None,
               max_zernike_amplitude=None, zernike_perturbation_amplitude=None, **kwargs):
        g2 = self.generator2d
        d2 = g2.sample(batch_size, draws, coeff=coeff, fc=fc,
                       max_zernike_amplitude=max_zernike_amplitude,
                       zernike_perturbation_amplitude=zernike_perturbation_amplitude, **kwargs)
        pupil, fc_used = d2["pupil"], d2["fc"]
        B, C = fc_used.shape
        kb_used = g2._format_fc(self.kb if kb is None else kb, B).expand(B, C)
        XX, YY = torch.meshgrid(g2.lin_x, g2.lin_y, indexing="ij")
        k_lat = torch.sqrt(XX ** 2 + YY ** 2)
        # the complex root keeps the evanescent branch (blur.py:801)
        d = torch.sqrt((kb_used.reshape(B, C, 1, 1) ** 2 - k_lat ** 2).to(torch.complex64))
        prop = torch.exp(-2j * math.pi * d[:, :, None] * self._defocus[None, None])
        p = torch.nan_to_num(pupil[:, :, None] * prop, nan=0.0)
        psf = _centered_fft2(p).abs() ** 2
        psf = psf[..., g2.pad_pre[0]:g2.pupil_size[0] - g2.pad_post[0],
                  g2.pad_pre[1]:g2.pupil_size[1] - g2.pad_post[1]]
        if self.random_rotate:
            from ...transform.geometric import rotate_via_shear

            if angle is None:
                angle = g2.generate_angles(B, draws)
            psf = rotate_via_shear(psf.reshape(B, -1, *psf.shape[-2:]), angle).reshape(psf.shape)
        if self.apodize:
            psf = g2.apodize_mask * psf
        psf = psf / psf.sum(dim=(-3, -2, -1), keepdim=True)
        params = {"filter": psf, "pupil": pupil, "coeff": d2["coeff"], "fc": fc_used}
        if self.random_rotate:
            params["angle"] = angle
        return params


class ConfocalBlurGenerator3D(PSFGenerator):
    r"""3D PSFs of a confocal laser-scanning microscope (blur.py:837): the
    product of the illumination PSF and the collection PSF convolved with
    the pinhole, both from :class:`DiffractionBlurGenerator3D`.

    :param NI: the immersion medium's refractive index.
    :param NA: the numerical aperture (below ``NI``).
    :param lambda_ill: the illumination wavelength(s) in metres; C of them
        make C-channel PSFs.
    :param lambda_coll: the collection wavelength(s), as many.
    :param pixelsize_XY: the lateral pixel size (m).
    :param pixelsize_Z: the axial pixel size (m).
    :param pinhole_radius: the pinhole's radius in Airy units.
    """

    def __init__(self, psf_size=(9, 15, 15), zernike_index=tuple(range(4, 12)),
                 NI: float = 1.51, NA: float = 1.37, lambda_ill=489e-9, lambda_coll=395e-9,
                 pixelsize_XY: float = 50e-9, pixelsize_Z: float = 100e-9,
                 pinhole_radius: float = 1, max_zernike_amplitude: float = 0.1,
                 zernike_perturbation_amplitude: float = 0.0, pupil_size=(512, 512),
                 index_convention: str = "noll", seed: int = 0, device=None, **kwargs):
        if len(psf_size) != 3:
            raise ValueError("You should provide a tuple of len == 3 to generate 3D PSFs.")
        lambda_ill = [lambda_ill] if isinstance(lambda_ill, (int, float)) else list(lambda_ill)
        lambda_coll = [lambda_coll] if isinstance(lambda_coll, (int, float)) \
            else list(lambda_coll)
        if len(lambda_ill) != len(lambda_coll):
            raise ValueError("lambda_ill and lambda_coll must have the same length, got "
                             f"{len(lambda_ill)} and {len(lambda_coll)}.")
        super().__init__(psf_size=psf_size[1:], seed=seed, device=device)
        self.psf_size = tuple(psf_size)
        self.shape = self.psf_size

        def one_or_list(v):
            return v[0] if len(v) == 1 else v

        self.fc_ill = one_or_list([NA / lam * pixelsize_XY for lam in lambda_ill])
        self.kb_ill = one_or_list([NI / lam * pixelsize_XY for lam in lambda_ill])
        self.fc_coll = one_or_list([NA / lam * pixelsize_XY for lam in lambda_coll])
        self.kb_coll = one_or_list([NI / lam * pixelsize_XY for lam in lambda_coll])
        self.pinhole_radius = pinhole_radius
        self.pixelsize_XY = pixelsize_XY
        self.pixel_size_Z = pixelsize_Z
        self.lambda_ill = lambda_ill
        self.lambda_coll = lambda_coll
        self.NI = NI
        self.NA = NA
        common = dict(psf_size=psf_size, zernike_index=zernike_index,
                      stepz_pixel=pixelsize_Z / pixelsize_XY,
                      max_zernike_amplitude=max_zernike_amplitude,
                      zernike_perturbation_amplitude=zernike_perturbation_amplitude,
                      pupil_size=pupil_size, index_convention=index_convention, seed=seed,
                      device=self.device, **kwargs)
        self.generator_ill = DiffractionBlurGenerator3D(fc=self.fc_ill, kb=self.kb_ill, **common)
        self.generator_coll = DiffractionBlurGenerator3D(fc=self.fc_coll, kb=self.kb_coll,
                                                         **common)
        self._pinholes = []
        for lam in self.lambda_coll:
            ph_radius = self.pinhole_radius * 0.61 * lam / self.NA
            lin = np.linspace(-1.5 * ph_radius, 1.5 * ph_radius, int(3 * ph_radius / pixelsize_XY))
            step = lin[1] - lin[0]
            XX, YY = np.meshgrid(lin, lin, indexing="ij")
            rho = torch.as_tensor(np.sqrt(XX ** 2 + YY ** 2), dtype=torch.float32,
                                  device=self.device)
            self._pinholes.append(bump_function(rho, ph_radius - step / 2, step / 2))

    @property
    def zernike_polynomials(self):
        return self.generator_ill.zernike_polynomials

    def sample(self, batch_size, draws, coeff_ill=None, coeff_coll=None, fc_ill=None,
               kb_ill=None, fc_coll=None, kb_coll=None, **kwargs):
        d_ill = self.generator_ill.sample(batch_size, draws, coeff=coeff_ill, fc=fc_ill,
                                          kb=kb_ill)
        d_coll = self.generator_coll.sample(batch_size, draws, coeff=coeff_coll, fc=fc_coll,
                                            kb=kb_coll)
        psf_coll = d_coll["filter"]
        B, C, D, H, W = psf_coll.shape
        # the collection PSF through the pinhole, plane by plane (blur.py:958)
        conv = torch.stack([conv2d(psf_coll[:, c].reshape(B * D, 1, H, W), pin[None, None],
                                   padding="constant").reshape(B, D, H, W)
                            for c, pin in enumerate(self._pinholes)], 1)
        psf = d_ill["filter"] * conv
        return {"filter": psf / psf.sum(dim=(-3, -2, -1), keepdim=True),
                "pupil_ill": d_ill["pupil"], "pupil_coll": d_coll["pupil"],
                "coeff_ill": d_ill["coeff"], "coeff_coll": d_coll["coeff"],
                "fc_ill": d_ill["fc"], "fc_coll": d_coll["fc"]}


def bump_function(x, a=1.0, b=1.0):
    r"""A smooth bump of compact support (blur.py:979): 1 on ``[-a, a]``,
    falling to 0 over ``[a, a + b]`` as ``exp(-1 / (1 - t^2)) / exp(-1)``;
    ``a`` and ``b`` broadcast against ``x``."""
    x = torch.as_tensor(x)
    abs_x = x.abs()
    t = ((abs_x - a) / b).clamp(0.0, 1.0 - 1e-6)
    transition = torch.exp(-1.0 / (1.0 - t ** 2)) / math.exp(-1.0)
    return torch.where(abs_x <= a, torch.ones_like(transition),
                       torch.where(abs_x < a + b, transition, torch.zeros_like(transition)))
