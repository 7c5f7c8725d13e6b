"""Perceptual and no-reference metrics (port of deepinv_tpu/loss/perceptual.py):
GMSD, HaarPSI, cosine similarity, the recovery coefficient, blur strength,
the sharpness index, NIQE and LPIPS.

Nothing is downloaded: NIQE's pristine statistics come from ``params=``, a
local ``weights_path`` or :meth:`NIQE.create_weights`, and LPIPS's VGG16 and
linear weights from local checkpoint paths (or random weights when asked).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .metric import Metric, _flatten_batch

__all__ = ["HaarPSI", "GMSD", "CosineSimilarity", "RecoveryCoefficient", "BlurStrength",
           "SharpnessIndex", "NIQE", "LPIPS"]

_PREWITT_X = torch.tensor([[1.0, 0.0, -1.0]] * 3) / 3


class GMSD(Metric):
    """Gradient-magnitude similarity deviation (perceptual.py:50): Prewitt
    gradient magnitudes with replicate padding, the population deviation of
    the similarity map per channel, the mean over channels."""

    def __init__(self, c: float = 0.0026, **kwargs):
        super().__init__(**kwargs)
        self.c = c

    def metric(self, x_net, x, *args, **kwargs):
        from ..ops.conv import conv2d

        if x_net.shape != x.shape:
            raise ValueError(f"x_net and x must be same shape, got {tuple(x_net.shape)} "
                             f"and {tuple(x.shape)}")
        if x_net.dim() != 4:
            raise ValueError(f"GMSD requires (B, C, H, W) tensors, got {tuple(x_net.shape)}")
        B, C, H, W = x.shape
        hx = _PREWITT_X.to(device=x.device, dtype=x.dtype)
        hy = hx.T

        def magnitude(v):
            v = v.reshape(B * C, 1, H, W)
            return torch.hypot(conv2d(v, hx, padding="replicate"),
                               conv2d(v, hy, padding="replicate"))

        ga, gb = magnitude(x), magnitude(x_net)
        gms = (2 * ga * gb + self.c) / (ga ** 2 + gb ** 2 + self.c)
        return gms.reshape(B, C, -1).std(-1, correction=0).mean(-1)


def _logistic(v, a):
    return 1.0 / (1.0 + torch.exp(-a * v))


class HaarPSI(Metric):
    """Haar-wavelet perceptual similarity (perceptual.py:84): the local
    similarities of scale-1 and 2 Haar magnitudes weighted by the scale-3
    ones, logistic pooling, and the YIQ chroma similarity of color images.
    Inputs must lie in [0, 1].

    :param C: stability constant (5, the medical images' value).
    :param alpha: logistic slope (4.9).
    :param preprocess_with_subsampling: a 2x mean subsampling first.
    """

    lower_better = False

    def __init__(self, C: float = 5.0, alpha: float = 4.9,
                 preprocess_with_subsampling: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.C = C
        self.alpha = alpha
        self.preprocess_with_subsampling = preprocess_with_subsampling

    @staticmethod
    def _convolve2d(data, kernel):
        """Rotate by 180 degrees, cross-correlate with ``k // 2`` padding,
        keep the first H rows and W columns, rotate back
        (perceptual.py:107)."""
        kh, kw = kernel.shape
        d = torch.rot90(data, 2, (2, 3))
        res = F.conv2d(d, kernel[None, None].to(d.dtype), padding=(kh // 2, kw // 2))
        res = res[:, :, :data.shape[2], :data.shape[3]]
        return torch.rot90(res, 2, (2, 3))

    @staticmethod
    def _haar_filter(scale, device):
        size = 2 ** scale
        f = np.full((size, size), 2.0 ** -scale, np.float32)
        f[: size // 2] *= -1.0
        return torch.from_numpy(f).to(device)

    def _subsample(self, image, factor: int = 2):
        kernel = torch.full((factor, factor), 1.0 / factor ** 2, device=image.device)
        return self._convolve2d(image, kernel)[:, :, ::factor, ::factor]

    def _haar_decompose(self, image, n_scales):
        fs = [self._haar_filter(s, image.device) for s in range(1, n_scales + 1)]
        coeffs = [self._convolve2d(image, f) for f in fs]
        coeffs += [self._convolve2d(image, f.T) for f in fs]
        return torch.stack(coeffs)  # (2 n_scales, B, 1, H, W)

    def metric(self, x_net, x, *args, **kwargs):
        if x.shape != x_net.shape or x.shape[1] not in (1, 3):
            raise ValueError("x and x_net must be of same shape with 1 or 3 channels.")
        if not bool(((x >= 0) & (x <= 1) & (x_net >= 0) & (x_net <= 1)).all()):
            raise ValueError("x and x_net must be in the range [0, 1]")
        x, x_net = 255.0 * x, 255.0 * x_net
        is_color = x.shape[1] == 3
        if is_color:
            mix = lambda v, a, b, c: a * v[:, :1] + b * v[:, 1:2] + c * v[:, 2:3]
            ref_y, deg_y = (mix(v, 0.299, 0.587, 0.114) for v in (x, x_net))
            ref_i, deg_i = (mix(v, 0.596, -0.274, -0.322) for v in (x, x_net))
            ref_q, deg_q = (mix(v, 0.211, -0.523, 0.312) for v in (x, x_net))
        else:
            ref_y, deg_y = x, x_net
        if self.preprocess_with_subsampling:
            ref_y, deg_y = self._subsample(ref_y), self._subsample(deg_y)
            if is_color:
                ref_i, deg_i = self._subsample(ref_i), self._subsample(deg_i)
                ref_q, deg_q = self._subsample(ref_q), self._subsample(deg_q)
        n_scales = 3
        cr = self._haar_decompose(ref_y, n_scales)
        cd = self._haar_decompose(deg_y, n_scales)
        sims, weights = [], []
        for o in (0, 1):
            rm = cr[[o * n_scales, 1 + o * n_scales]].abs()
            dm = cd[[o * n_scales, 1 + o * n_scales]].abs()
            frac = (2 * rm * dm + self.C) / (rm ** 2 + dm ** 2 + self.C)
            sims.append((frac[0] + frac[1]) / 2)
            weights.append(torch.maximum(cr[2 + o * n_scales].abs(), cd[2 + o * n_scales].abs()))
        if is_color:
            k22 = torch.full((2, 2), 0.25, device=x.device)
            ci_r, ci_d = self._convolve2d(ref_i, k22).abs(), self._convolve2d(deg_i, k22).abs()
            cq_r, cq_d = self._convolve2d(ref_q, k22).abs(), self._convolve2d(deg_q, k22).abs()
            sim_i = (2 * ci_r * ci_d + self.C) / (ci_r ** 2 + ci_d ** 2 + self.C)
            sim_q = (2 * cq_r * cq_d + self.C) / (cq_r ** 2 + cq_d ** 2 + self.C)
            sims.append((sim_i + sim_q) / 2)
            weights.append((weights[0] + weights[1]) / 2)
        ls, w = torch.stack(sims), torch.stack(weights)  # (n_ch, B, 1, H, W)
        pre_logit = (_logistic(ls, self.alpha) * w).sum((0, 3, 4)) / w.sum((0, 3, 4))
        return ((torch.log(pre_logit / (1 - pre_logit)) / self.alpha) ** 2)[:, 0]


class CosineSimilarity(Metric):
    """The signed cosine of the flattened images (perceptual.py:214);
    ``invert_metric`` is ``1 - m``."""

    lower_better = False

    def metric(self, x_net, x, *args, **kwargs):
        a, b = _flatten_batch(x_net), _flatten_batch(x)
        den = a.pow(2).sum(1).sqrt().clamp(min=1e-8) * b.pow(2).sum(1).sqrt().clamp(min=1e-8)
        return (a * b).sum(1) / den

    def invert_metric(self, m):
        return 1.0 - m


class RecoveryCoefficient(Metric):
    """Recovered over true activity inside the region ``mask=``
    (perceptual.py:232): ``sum(x_net * mask) / (sum(x * mask) + eps)``;
    ``invert_metric`` is ``|m - 1|``."""

    lower_better = False
    _EPS = {torch.float16: 1e-4, torch.float32: 1e-7, torch.float64: 1e-12}

    def __init__(self, eps: float = None, **kwargs):
        super().__init__(**kwargs)
        self.eps = eps

    def metric(self, x_net, x, *args, **kwargs):
        mask = kwargs.get("mask", None)
        if mask is None:
            raise ValueError("Recovery Coefficient requires a mask argument.")
        mask = torch.as_tensor(mask, dtype=x.dtype, device=x.device)
        axes = tuple(range(1, x.dim()))
        eps = self.eps if self.eps is not None else self._EPS.get(x_net.dtype, 1e-7)
        return (x_net * mask).sum(axes) / ((x * mask).sum(axes) + eps)

    def invert_metric(self, m):
        return (m - 1).abs()


def _filter1d(x, kernel, axis, pad):
    """Reflect-padded 1D cross-correlation along ``axis``
    (perceptual.py:263)."""
    xp = x.movedim(axis, -1)
    shape = xp.shape
    flat = F.pad(xp.reshape(-1, 1, shape[-1]), (pad, pad), mode="reflect")
    out = F.conv1d(flat, kernel.to(flat)[None, None])
    return out.reshape(shape).movedim(-1, axis)


class BlurStrength(Metric):
    """No-reference blur strength in (0, 1), higher blurrier
    (perceptual.py:276): Sobel differences before and after a 1D uniform
    blur along each spatial axis.

    :param h_size: the uniform filter's size.
    """

    def __init__(self, h_size: int = 11, **kwargs):
        super().__init__(**kwargs)
        self.h_size = h_size
        self.lower_better = True

    @staticmethod
    def uniform_filter1d(x, size: int, axis: int):
        """1D uniform filter along ``axis`` (perceptual.py:290)."""
        return _filter1d(x, torch.full((size,), 1.0 / size), axis, size // 2)

    @staticmethod
    def sobel1d(x, axis: int):
        """1D Sobel derivative along ``axis`` (perceptual.py:298)."""
        return _filter1d(x, torch.tensor([-1.0, 0.0, 1.0]), axis, 1)

    def metric(self, x_net, x=None, *args, **kwargs):
        if x_net.shape[1] not in (1, 3):
            raise ValueError("Input must have 1 or 3 channels.")
        v = x_net
        if v.shape[1] == 3:
            v = 0.2989 * v[:, :1] + 0.5870 * v[:, 1:2] + 0.1140 * v[:, 2:3]
        spatial = v.shape[2:]
        inner = (slice(None), slice(None)) + tuple(slice(2, s - 1) for s in spatial)
        results = []
        for ax in range(2, 2 + len(spatial)):
            filt = self.uniform_filter1d(v, self.h_size, ax)
            sharp = self.sobel1d(v, ax).abs()
            blur = self.sobel1d(filt, ax).abs()
            t = (sharp - blur).clamp(min=0.0)
            m1 = _flatten_batch(sharp[inner]).sum(1)
            m2 = _flatten_batch(t[inner]).sum(1)
            results.append((m1 - m2).abs() / (m1 + 1e-12))
        return torch.stack(results, 1).max(1).values


class SharpnessIndex(Metric):
    """No-reference sharpness index, higher sharper (perceptual.py:326):
    ``-log10 Phi`` of the standardized drop of total variation under
    Gaussian-noise convolution, in the Fourier domain, after the periodic
    component's extraction and a half-pixel dequantization.

    :param periodic_component: extract the periodic component first.
    :param dequantize: the (1/2, 1/2) Fourier translation.
    """

    lower_better = False

    def __init__(self, periodic_component: bool = True, dequantize: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.periodic_component = periodic_component
        self.dequantize = dequantize
        if not periodic_component and not dequantize:
            raise ValueError("At least one of periodic_component or dequantize must be True.")

    @staticmethod
    def per_decomp(u):
        """Periodic plus smooth decomposition (Moisan): ``u`` minus its smooth
        part (perceptual.py:350)."""
        B, C, H, W = u.shape
        v = torch.zeros_like(u)
        d_h = u[..., 0, :] - u[..., H - 1, :]
        d_w = u[..., :, 0] - u[..., :, W - 1]
        v[..., 0, :] += d_h
        v[..., H - 1, :] -= d_h
        v[..., :, 0] += d_w
        v[..., :, W - 1] -= d_w
        fx = torch.cos(2 * math.pi * torch.arange(W, device=u.device) / W)[None, None, None, :]
        fy = torch.cos(2 * math.pi * torch.arange(H, device=u.device) / H)[None, None, :, None]
        denom = 2.0 - fx - fy
        denom[..., 0, 0] = 2.0
        return u - torch.fft.ifft2(torch.fft.fft2(v) * (0.5 / denom)).real

    @staticmethod
    def dequant(u):
        """The (1/2, 1/2) translation in the Fourier domain
        (perceptual.py:366)."""
        B, C, H, W = u.shape
        mx, my = W // 2, H // 2
        x_mod = (torch.arange(mx, mx + W, device=u.device) % W) - mx
        y_mod = (torch.arange(my, my + H, device=u.device) % H) - my
        tx = torch.exp(-1j * math.pi / W * x_mod)
        ty = torch.exp(-1j * math.pi / H * y_mod)
        shift = (ty[:, None] * tx[None, :]).to(torch.complex64)
        return torch.fft.ifft2(torch.fft.fft2(u) * shift).real

    @staticmethod
    def logerfc(t):
        """``log(erfc(t))``, by its asymptotic expansion past 20
        (perceptual.py:378)."""
        big_t = t > 20
        z = torch.where(big_t, t, torch.full_like(t, 21.0)) ** -2.0
        s = torch.ones_like(t)
        for k in range(8, 0, -1):
            s = 1 - (k - 0.5) * z * s
        big = (-0.5 * math.log(math.pi) - t ** 2
               + torch.log(s / torch.where(big_t, t, torch.ones_like(t))))
        small = torch.log(torch.special.erfc(torch.where(big_t, torch.zeros_like(t), t))
                          .clamp(min=1e-38))
        return torch.where(big_t, big, small)

    def metric(self, x_net, x=None, *args, **kwargs):
        if x_net.dim() != 4:
            raise ValueError("Sharpness index metric only supports (B, C, H, W) images.")
        B, C, H, W = x_net.shape
        v = x_net
        if self.periodic_component:
            v = self.per_decomp(v)
        if self.dequantize:
            v = self.dequant(v)
        gx = torch.roll(v, -1, 3) - v
        gy = torch.roll(v, -1, 2) - v
        tv = (gx.abs() + gy.abs()).sum((2, 3))
        fu = torch.fft.fft2(v)
        p = (torch.arange(W, device=v.device) * (2 * math.pi / W))[None, None, None, :]
        q = (torch.arange(H, device=v.device) * (2 * math.pi / H))[None, None, :, None]
        zx = fu * torch.sin(p / 2)
        fgx2 = 4 * (zx.real ** 2 + zx.imag ** 2)
        zy = fu * torch.sin(q / 2)
        fgy2 = 4 * (zy.real ** 2 + zy.imag ** 2)
        fgxx2 = (fgx2 ** 2).sum((2, 3))
        fgyy2 = (fgy2 ** 2).sum((2, 3))
        fgxy2 = (fgx2 * fgy2).sum((2, 3))
        axx = (gx * gx).sum((2, 3))
        ayy = (gy * gy).sum((2, 3))
        axy = torch.sqrt(axx * ayy)
        zero = torch.zeros_like(axx)
        vara = torch.where(axx > 0, fgxx2 / axx.clamp(min=1e-12), zero)
        vara = vara + torch.where(ayy > 0, fgyy2 / ayy.clamp(min=1e-12), zero)
        vara = vara + torch.where(axy > 0, 2 * fgxy2 / axy.clamp(min=1e-12), zero)
        vara = vara / (math.pi * W * H)
        scale = math.sqrt(2 * W * H / math.pi)
        t = ((axx.sqrt() + ayy.sqrt()) * scale - tv) / vara.clamp(min=1e-12).sqrt()
        s = torch.where(vara > 0,
                        -self.logerfc(t / math.sqrt(2)) / math.log(10) + math.log10(2), zero)
        return s.mean(1)


# the AGGD shape parameter's lookup grid (Mittal et al. 2012, perceptual.py:441):
# gamma in [0.2, 10] by 1e-3 and its ratio r(gamma)
_NIQE_GAM = np.arange(0.2, 10.0 + 1e-9, 0.001)
_NIQE_LGAMMA = np.vectorize(math.lgamma)
_NIQE_RGAM = np.exp(2 * _NIQE_LGAMMA(2.0 / _NIQE_GAM) - _NIQE_LGAMMA(1.0 / _NIQE_GAM)
                    - _NIQE_LGAMMA(3.0 / _NIQE_GAM))
_NIQE_LUMA = (0.29893602, 0.58704307, 0.11402090)  # MATLAB's rgb2gray weights


def _gammaf(x):
    """The gamma function (perceptual.py:452)."""
    return torch.exp(torch.lgamma(x))


class NIQE(Metric):
    """Natural image quality evaluator (perceptual.py:456; Mittal et al.
    2012): MSCN coefficients, per-patch asymmetric generalized Gaussian fits
    of them and of their four pairwise products (18 features) at two scales
    (36), a Gaussian fit over each image's patches, and the pooled-covariance
    Mahalanobis distance to a pristine model. That last step runs on the host
    in float64, as the JAX package's eager path does (perceptual.py:678).

    :param weights_path: a local ``.npz`` (numpy) or ``.pt`` (torch) file of
        pristine ``mu`` and ``cov``; None leaves the model unfitted.
    :param params: ``{"mu": (36,), "cov": (36, 36)}`` pristine statistics.
    :param denominator: added to sigma in the MSCN normalization.
    :param round_tensor: round the inputs, as the MATLAB pipeline (on [0, 255]).
    :param patch_size: the patch size at scale 1 (96 in the original).
    :param patch_overlap: pixels of overlap between adjacent patches.
    """

    lower_better = True

    def __init__(self, weights_path=None, params=None, denominator: float = 1.0,
                 round_tensor: bool = False, patch_size: int = 96, patch_overlap: int = 0,
                 **kwargs):
        super().__init__(**kwargs)
        self.patch_size = patch_size
        self.patch_overlap = patch_overlap
        self.denominator = denominator
        self.round = round_tensor
        self.n_scales = 2
        if weights_path is not None:
            params = self._load_weights(weights_path)
        # kept in float32, as the JAX package keeps them (perceptual.py:500)
        self.params = None if params is None else {
            "mu": np.asarray(params["mu"], np.float32).astype(np.float64).ravel(),
            "cov": np.asarray(params["cov"], np.float32).astype(np.float64)}

    @staticmethod
    def _load_weights(path):
        path = str(path)
        if path == "download":
            raise ValueError("nothing is downloaded: pass a local weights_path (.npz/.pt) or fit "
                             "the parameters with create_weights()")
        if path.endswith(".npz"):
            d = np.load(path)
            return {"mu": d["mu"], "cov": d["cov"]}
        d = torch.load(path, map_location="cpu", weights_only=True)
        return {"mu": np.asarray(d["mu"]), "cov": np.asarray(d["cov"])}

    def _mscn_pair(self, a):
        """The MSCN coefficients and the local deviation (perceptual.py:523)."""
        from ..ops.conv import conv2d

        ax = np.arange(-3, 4, dtype=np.float64)
        g = np.exp(-(ax[:, None] ** 2 + ax[None] ** 2) / (2 * (7 / 6) ** 2))
        g = torch.from_numpy((g / g.sum()).astype(np.float32)).to(a.device)
        mu = conv2d(a, g, padding="replicate")
        sigma = (conv2d(a * a, g, padding="replicate") - mu * mu).abs().sqrt()
        return (a - mu) / (sigma + self.denominator), sigma

    @staticmethod
    def _aggd(v, eps=1e-12):
        """AGGD ``(alpha, beta_left, beta_right)`` of each row of ``v``
        (perceptual.py:537); a side with no samples gives NaN, so that the
        patch is dropped later."""
        neg = (v < 0).to(v.dtype)
        pos = (v > 0).to(v.dtype)
        cnt_neg, cnt_pos = neg.sum(1), pos.sum(1)
        nan = torch.full_like(cnt_neg, float("nan"))
        left_ms = torch.where(cnt_neg > 0, (v * v * neg).sum(1) / cnt_neg.clamp(min=1.0), nan)
        right_ms = torch.where(cnt_pos > 0, (v * v * pos).sum(1) / cnt_pos.clamp(min=1.0), nan)
        leftstd, rightstd = left_ms.sqrt(), right_ms.sqrt()
        gammahat = leftstd / rightstd.clamp(min=eps)
        rhat = v.abs().mean(1) ** 2 / (v * v).mean(1).clamp(min=eps)
        rhatnorm = (rhat * (gammahat ** 3 + 1.0) * (gammahat + 1.0)) / (
            (gammahat ** 2 + 1.0) ** 2).clamp(min=eps)
        r_gam = torch.as_tensor(_NIQE_RGAM, dtype=v.dtype, device=v.device)
        idx = ((r_gam[None] - rhatnorm[:, None]) ** 2).argmin(1)
        alpha = torch.as_tensor(_NIQE_GAM, dtype=v.dtype, device=v.device)[idx]
        beta_factor = torch.sqrt(_gammaf(1.0 / alpha) / _gammaf(3.0 / alpha))
        return alpha, leftstd * beta_factor, rightstd * beta_factor

    @staticmethod
    def _patches(img, k, stride):
        """``(B, 1, H, W)`` to its ``(B, L, k, k)`` valid patches."""
        B = img.shape[0]
        return F.unfold(img, k, stride=stride).transpose(1, 2).reshape(B, -1, k, k)

    def _patch_features(self, structdis, k, stride):
        """``(B, 1, H, W)`` to ``(B, L, 18)`` per-patch AGGD features
        (perceptual.py:586)."""
        patches = self._patches(structdis, k, stride)
        B, L = patches.shape[:2]
        a0, bl0, br0 = self._aggd(patches.reshape(B * L, k * k))
        cols = [a0, 0.5 * (bl0 + br0)]
        for sh in ((0, 1), (1, 0), (1, 1), (1, -1)):
            pair = patches.reshape(B * L, k, k)
            pair = pair * torch.roll(pair, sh, (1, 2))
            a, bl, br = self._aggd(pair.reshape(B * L, k * k))
            cols += [a, (br - bl) * (_gammaf(2.0 / a) / _gammaf(1.0 / a)), bl, br]
        return torch.stack(cols, 1).reshape(B, L, 18)

    def _multiscale_features(self, img, with_sharpness=False):
        """``(B, 1, H, W)`` to ``(B, L, 36)`` features, and each patch's mean
        deviation at scale 1 when asked (perceptual.py:600)."""
        from ..ops import imresize_matlab

        feats, sharp = [], None
        for scale in (1, 2):
            structdis, sigma = self._mscn_pair(img)
            k = max(1, self.patch_size // scale)
            stride = max(1, k - self.patch_overlap // scale)
            feats.append(self._patch_features(structdis, k, stride))
            if scale == 1 and with_sharpness:
                sharp = self._patches(sigma, k, stride).mean((-2, -1))
            if scale < self.n_scales:
                img = imresize_matlab(img, scale=0.5)
        X = torch.cat(feats, 2)
        return (X, sharp) if with_sharpness else X

    def _prepare(self, x):
        """Gray, rounded where asked, cropped to whole patches
        (perceptual.py:619)."""
        if x.shape[1] == 3:
            w = torch.tensor(_NIQE_LUMA, dtype=x.dtype, device=x.device)
            x = (x * w[None, :, None, None]).sum(1, keepdim=True)
        if x.shape[1] != 1:
            raise ValueError("NIQE operates on 1- or 3-channel images")
        if self.round:
            x = torch.round(x)
        H, W = x.shape[-2:]
        k = self.patch_size
        if H < k or W < k:
            raise ValueError(f"NIQE needs images of at least patch_size={k}, got {(H, W)}")
        return x[..., : (H // k) * k, : (W // k) * k]

    @staticmethod
    def _nanstats(X):
        """Each item's mean and covariance over its finite patch rows
        (perceptual.py:637)."""
        valid = torch.isfinite(X).all(-1)
        Xz = torch.where(valid[..., None], X, torch.zeros_like(X))
        n = valid.sum(1).to(X.dtype)
        mu = Xz.sum(1) / n.clamp(min=1.0)[:, None]
        Xc = torch.where(valid[..., None], X - mu[:, None], torch.zeros_like(X))
        cov = torch.einsum("blf,blg->bfg", Xc, Xc) / (n - 1.0).clamp(min=1.0)[:, None, None]
        return mu, cov

    def estimate_aggd_param(self, vecs, eps: float = 1e-12):
        """AGGD ``(alpha, beta_left, beta_right)`` of each row of ``vecs``
        (perceptual.py:649)."""
        return self._aggd(vecs, eps=eps)

    def niqe(self, x_net):
        """Each image's NIQE score (perceptual.py:654)."""
        return self.metric(x_net)

    def metric(self, x_net, x=None, *args, **kwargs):
        if self.params is None:
            raise RuntimeError("NIQE weights not loaded: pass weights_path/params at init or fit "
                               "them with create_weights()")
        mu_d, cov_d = self._nanstats(self._multiscale_features(self._prepare(x_net)))
        mu_d = mu_d.double().cpu().numpy()
        cov_d = cov_d.double().cpu().numpy()
        mu_p, cov_p = self.params["mu"], self.params["cov"]
        invcov = np.linalg.pinv(0.5 * (cov_d + cov_p[None]))
        d = mu_p[None] - mu_d
        s = np.sqrt(np.clip(np.einsum("bf,bfg,bg->b", d, invcov, d), 0.0, None))
        return torch.from_numpy(s.astype(np.float32)).to(x_net.device)

    def create_weights(self, dataset, sharpness_threshold: float = 0.75, save_path=None):
        """Fit the pristine ``mu`` and ``cov`` on distortion-free images
        (perceptual.py:687): the two-scale features of each image's sharpest
        patches (deviation at least ``sharpness_threshold`` of the image's
        peak), pooled. ``dataset`` yields ``(C, H, W)`` arrays, C in {1, 3}.
        Returns the parameters and keeps them; ``save_path`` (``.npz``) writes
        them for ``weights_path=``."""
        rows = []
        for item in dataset:
            img = torch.as_tensor(item)
            if img.dim() == 2:
                img = img[None]
            if img.dim() != 3 or img.shape[0] not in (1, 3):
                raise ValueError(f"expected (C, H, W) with C in {{1, 3}}, got "
                                 f"{tuple(img.shape)}")
            if min(img.shape[-2:]) < self.patch_size:
                continue  # too small to give a patch
            X, sharp = self._multiscale_features(self._prepare(img[None]), with_sharpness=True)
            X, sharp = X[0].cpu().numpy(), sharp[0].cpu().numpy()
            keep = (sharp > sharpness_threshold * sharp.max()) & np.isfinite(X).all(1)
            if keep.any():
                rows.append(X[keep])
        if not rows:
            raise RuntimeError("no usable patches: lower sharpness_threshold or check that the "
                               "images are at least patch_size wide")
        feats = np.concatenate(rows, 0).astype(np.float64)
        mu = feats.mean(0)
        xc = feats - mu
        cov = xc.T @ xc / max(1, feats.shape[0] - 1)
        # float32, as the JAX package keeps them (perceptual.py:725)
        self.params = {"mu": mu.astype(np.float32).astype(np.float64),
                       "cov": cov.astype(np.float32).astype(np.float64)}
        if save_path is not None:
            np.savez(save_path, mu=mu, cov=cov)
        return self.params


class LPIPS(Metric):
    """Learned perceptual image patch similarity (perceptual.py:732; Zhang et
    al. 2018): VGG16 features at relu1_2, 2_2, 3_3, 4_3 and 5_3
    (:class:`~deepinv_tpu_torch.models.VGG16Features`), each normalized over
    channels, weighted by the learned 1x1 linear layers (or averaged), summed
    over space and layers.

    Nothing is downloaded: ``vgg_pretrained`` is a local torchvision
    ``vgg16`` state dict and ``lin_pretrained`` an ``lpips`` package
    ``vgg.pth`` (``lin{k}.model.1.weight``); ``allow_random_weights=True``
    runs the pipeline on random features (uncalibrated); ``feature_fn``
    supplies features of one's own.

    :param generator: CPU ``torch.Generator`` of the random VGG16 weights
        (one seeded 0 where None, as the JAX package's ``key(0)``).
    :param device: the backbone's device, the CUDA device by default.
    """

    lower_better = True

    def __init__(self, feature_fn=None, vgg_pretrained=None, lin_pretrained=None,
                 allow_random_weights: bool = False, generator=None, device=None, **kwargs):
        super().__init__(**kwargs)
        self.feature_fn = feature_fn
        self.lins = None
        self.backbone = None
        if feature_fn is not None and lin_pretrained is not None:
            raise ValueError("lin_pretrained calibrates the built-in VGG16 features and cannot "
                             "be combined with a custom feature_fn (channel layouts would not "
                             "match)")
        if feature_fn is None:
            if vgg_pretrained is None and not allow_random_weights:
                raise ValueError(
                    "LPIPS needs pretrained VGG weights (nothing is downloaded): pass "
                    "vgg_pretrained=<path to torchvision vgg16 .pth> (and optionally "
                    "lin_pretrained=<lpips vgg.pth>), a custom feature_fn, or "
                    "allow_random_weights=True for an uncalibrated pipeline.")
            from ..models.vgg import VGG16Features

            g = generator if generator is not None else torch.Generator().manual_seed(0)
            self.backbone = VGG16Features(pretrained=vgg_pretrained, requires_input_norm=True,
                                          generator=g, device=device)
            if lin_pretrained is not None:
                from ..models.convert import load_torch_checkpoint

                sd = load_torch_checkpoint(lin_pretrained)
                dev = self.backbone.mean.device
                self.lins = [torch.from_numpy(np.array(sd[f"lin{k}.model.1.weight"],
                                                       np.float32)).reshape(-1).to(dev)
                             for k in range(5)]

    def _features(self, v):
        if self.feature_fn is not None:
            return self.feature_fn(v)
        return self.backbone(v)

    def metric(self, x_net, x, *args, **kwargs):
        total = 0.0
        for k, (a, b) in enumerate(zip(self._features(x_net), self._features(x))):
            an = a / torch.sqrt(a.pow(2).sum(1, keepdim=True) + 1e-10)
            bn = b / torch.sqrt(b.pow(2).sum(1, keepdim=True) + 1e-10)
            d = (an - bn) ** 2
            if self.lins is not None:
                d = (d * self.lins[k].to(d.dtype)[None, :, None, None]).sum(1, keepdim=True)
            else:
                d = d.mean(1, keepdim=True)
            total = total + _flatten_batch(d).mean(1)
        return total
