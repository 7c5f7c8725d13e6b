"""Metrics (port of deepinv_tpu/loss/metric.py).

:class:`Metric` reproduces the JAX package's preprocessing (metric.py:146-176):
complex magnitude, center crop, input normalization, reduction, and the
``train_loss`` sign flip that turns a quality metric into a loss. Metrics
return per-sample values of shape (B,). As in the JAX module, the perceptual
and no-reference metrics of ``perceptual.py`` are imported at the bottom, so
that this namespace holds every metric (metric.py:484).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["Metric", "QNR", "MSE", "NMSE", "MAE", "PSNR", "SNR", "SSIM", "LpNorm", "L1L2",
           "SpectralAngleMapper", "ERGAS", "cal_psnr", "cal_mse", "cal_mae",
           "signal_noise_ratio"]


def _flatten_batch(v):
    return v.reshape(v.shape[0], -1)


class Metric:
    """Base metric (metric.py:38).

    :param metric: optional callable computing the unreduced metric.
    :param complex_abs: take the complex magnitude first (complex dtype or
        two real channels).
    :param train_loss: invert a higher-better metric (``invert_metric``,
        ``-m``) so that it can train a network.
    :param reduction: None | 'mean' | 'sum' | 'none' | a callable over the
        batch dimension.
    :param norm_inputs: None | 'l2' | 'min_max' | 'clip' | 'standardize' |
        'none'.
    :param center_crop: an int or tuple crops the trailing spatial dims to that
        size; negative (or zero) values remove ``|c|`` border pixels.
    """

    lower_better = True

    def __init__(self, metric=None, complex_abs=False, train_loss=False, reduction=None,
                 norm_inputs=None, center_crop=None):
        self._metric = metric
        self.complex_abs = complex_abs
        self.train_loss = train_loss
        self.reduction = reduction
        self.norm_inputs = norm_inputs
        self.center_crop = center_crop
        if isinstance(center_crop, tuple) and not (
                all(c > 0 for c in center_crop) or all(c <= 0 for c in center_crop)):
            raise ValueError("If center_crop is a tuple, all values must be either "
                             "positive or negative.")

    def metric(self, x_net, x, *args, **kwargs):
        if self._metric is not None:
            return self._metric(x_net, x, *args, **kwargs)
        raise NotImplementedError

    def invert_metric(self, m):
        """Inversion used when a higher-better metric trains a network."""
        return -m

    def _center_crop(self, v):
        if self.center_crop is None or v is None:
            return v
        crops = ((self.center_crop,) * (v.dim() - 2) if isinstance(self.center_crop, int)
                 else tuple(self.center_crop))
        if v.dim() < 2 + len(crops):
            raise ValueError(f"Tensor has {v.dim()} dimensions but center_crop requires at "
                             f"least {2 + len(crops)} dimensions")
        idx = [slice(None)] * v.dim()
        for i, c in enumerate(crops):
            ax = v.dim() - len(crops) + i
            n = v.shape[ax]
            if c > 0:
                if c > n:
                    raise ValueError(f"Crop size {c} larger than dim size {n}")
                start = (n - c) // 2
                idx[ax] = slice(start, start + c)
            else:
                b = abs(c)
                if 2 * b >= n:
                    raise ValueError(f"Border removal of {b} px would remove dim of size {n}")
                idx[ax] = slice(b, n - b)
        return v[tuple(idx)]

    def _normalize(self, v):
        if v is None or self.norm_inputs is None:
            return v
        mode = self.norm_inputs.lower()
        if mode == "l2":
            n = v.abs().pow(2).sum((-2, -1), keepdim=True).sqrt()
            return v / n.clamp(min=1e-12)
        if mode == "min_max":
            shape = (-1,) + (1,) * (v.dim() - 1)
            vmin = _flatten_batch(v).min(1).values.reshape(shape)
            vmax = _flatten_batch(v).max(1).values.reshape(shape)
            return (v - vmin) / (vmax - vmin).clamp(min=1e-12)
        if mode == "clip":
            return v.clamp(0.0, 1.0)
        if mode in ("none", "standardize"):
            return v
        raise ValueError("norm_inputs must be l2, min_max, clip, standardize, none or None.")

    def _complex_abs(self, v):
        if v is None or not self.complex_abs:
            return v
        if v.is_complex():
            return v.abs()
        if v.shape[1] == 2:
            return v.pow(2).sum(1, keepdim=True).sqrt()
        return v

    def __call__(self, x_net=None, x=None, *args, **kwargs):
        if isinstance(x_net, (list, tuple)):
            x_net = x_net[0]
        if isinstance(x, (list, tuple)):
            x = x[0]
        x_net = self._center_crop(self._complex_abs(x_net))
        x = self._center_crop(self._complex_abs(x))
        if self.norm_inputs == "standardize":
            if x_net is None or x is None:
                raise ValueError("Both x and x_net must not be None to use standardize.")
            # unbiased=False: jnp.std is the population deviation
            x_net = ((x_net - x_net.mean()) / x_net.std(unbiased=False) * x.std(unbiased=False)
                     + x.mean())
        x_net = self._normalize(x_net)
        x = self._normalize(x)
        if x_net is None:
            return torch.tensor([float("nan")])
        m = self.metric(x_net, x, *args, **kwargs)
        if callable(self.reduction):
            m = self.reduction(m)
        elif self.reduction == "mean":
            m = m.mean()
        elif self.reduction == "sum":
            m = m.sum()
        if self.train_loss and not self.lower_better:
            return self.invert_metric(m)
        return m

    forward = __call__

    def __add__(self, other):
        """The sum of two metrics, a :class:`Metric` (metric.py:178)."""
        return Metric(metric=lambda x_net, x, *a, **k: self(x_net, x, *a, **k)
                      + other(x_net, x, *a, **k))


class MSE(Metric):
    """Mean squared error (metric.py:183)."""

    def metric(self, x_net, x, *args, **kwargs):
        return _flatten_batch((x_net - x).abs().pow(2)).mean(1)


class NMSE(MSE):
    """MSE over the mean of ``|x|^2`` (metric.py:190)."""

    def metric(self, x_net, x, *args, **kwargs):
        den = _flatten_batch(x.abs().pow(2)).mean(1)
        return super().metric(x_net, x) / den.clamp(min=1e-12)


class MAE(Metric):
    """Mean absolute error (metric.py:199)."""

    def metric(self, x_net, x, *args, **kwargs):
        return _flatten_batch((x_net - x).abs()).mean(1)


def cal_psnr(x_net, x, max_pixel: float = 1.0):
    """PSNR of the whole batch in dB (metric.py:206)."""
    mse = ((x_net - x) ** 2).mean()
    return 10 * torch.log10(max_pixel ** 2 / mse.clamp(min=1e-12))


class PSNR(Metric):
    """Peak signal-to-noise ratio in dB (metric.py:211); ``max_pixel=None``
    takes the ground truth's max magnitude."""

    lower_better = False

    def __init__(self, max_pixel: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.max_pixel = max_pixel

    def metric(self, x_net, x, *args, **kwargs):
        maxp = x.abs().max() if self.max_pixel is None else self.max_pixel
        mse = _flatten_batch((x_net - x).abs().pow(2)).mean(1)
        return 10 * torch.log10(maxp ** 2 / mse.clamp(min=1e-12))


class SNR(Metric):
    """Signal-to-noise ratio in dB (metric.py:236)."""

    lower_better = False

    def metric(self, x_net, x, *args, **kwargs):
        num = _flatten_batch(x.abs().pow(2)).sum(1)
        den = _flatten_batch((x_net - x).abs().pow(2)).sum(1)
        return 10 * torch.log10(num / den.clamp(min=1e-12))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """The normalized 2D Gaussian window of SSIM (metric.py:247)."""
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.from_numpy(np.outer(g, g).astype(np.float32))


class SSIM(Metric):
    """Structural similarity with an 11x11 Gaussian window (sigma 1.5) over
    the valid part of the image (metric.py:255); ``multiscale=True`` computes
    MS-SSIM with the five standard weights.

    :param multiscale: MS-SSIM.
    :param max_pixel: maximum pixel value; ``None`` takes each image's max.
    :param min_pixel: minimum pixel value; ``None`` takes each image's min.
    """

    lower_better = False
    _MS_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)

    def __init__(self, multiscale: bool = False, max_pixel: float = 1.0,
                 min_pixel: float = 0.0, **kwargs):
        kwargs.pop("torchmetric_kwargs", None)
        super().__init__(**kwargs)
        self.multiscale = multiscale
        self.max_pixel = max_pixel
        self.min_pixel = min_pixel
        self.window = _gaussian_window()

    def invert_metric(self, m):
        return 1.0 - m

    def _data_range(self, x):
        mx = (self.max_pixel if self.max_pixel is not None
              else _flatten_batch(x).max(1).values.reshape(-1, 1, 1, 1))
        mn = (self.min_pixel if self.min_pixel is not None
              else _flatten_batch(x).min(1).values.reshape(-1, 1, 1, 1))
        return mx - mn

    def _ssim_cs(self, x_net, x, L):
        C1, C2 = (0.01 * L) ** 2, (0.03 * L) ** 2
        C = x.shape[1]
        w = self.window.to(device=x.device, dtype=x.dtype).expand(C, 1, 11, 11)

        def filt(v):
            return F.conv2d(v, w, groups=C)

        mu1, mu2 = filt(x_net), filt(x)
        mu1s, mu2s, mu12 = mu1 ** 2, mu2 ** 2, mu1 * mu2
        s1 = filt(x_net ** 2) - mu1s
        s2 = filt(x ** 2) - mu2s
        s12 = filt(x_net * x) - mu12
        cs_map = (2 * s12 + C2) / (s1 + s2 + C2)
        ssim_map = ((2 * mu12 + C1) / (mu1s + mu2s + C1)) * cs_map
        return _flatten_batch(ssim_map).mean(1), _flatten_batch(cs_map).mean(1)

    def metric(self, x_net, x, *args, **kwargs):
        L = self._data_range(x)
        if not self.multiscale:
            return self._ssim_cs(x_net, x, L)[0]
        n = len(self._MS_WEIGHTS)
        min_size = 11 * 2 ** (n - 1)
        if x.shape[-2] < min_size or x.shape[-1] < min_size:
            raise ValueError(f"MS-SSIM needs images of at least {min_size}x{min_size} pixels "
                             f"for {n} scales, got {x.shape[-2]}x{x.shape[-1]}")
        vals = []
        a, b = x_net, x
        for i in range(n):
            ssim_i, cs_i = self._ssim_cs(a, b, L)
            vals.append(ssim_i if i == n - 1 else cs_i)
            if i < n - 1:
                a, b = F.avg_pool2d(a, 2), F.avg_pool2d(b, 2)
        out = torch.ones_like(vals[0])
        for v, wgt in zip(vals, self._MS_WEIGHTS):
            out = out * v.clamp(min=0.0) ** wgt
        return out


class LpNorm(Metric):
    """``||x_net - x||_p^p`` per sample (metric.py:344); ``onesided`` keeps
    the positive part of the difference."""

    def __init__(self, p: float = 2.0, onesided: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.p = p
        self.onesided = onesided

    def metric(self, x_net, x, *args, **kwargs):
        d = (x_net - x).clamp(min=0.0) if self.onesided else x_net - x
        return _flatten_batch(d.abs() ** self.p).sum(1)


class L1L2(Metric):
    """``alpha * MAE + (1 - alpha) * MSE`` (metric.py:357)."""

    def __init__(self, alpha: float = 0.5, **kwargs):
        super().__init__(**kwargs)
        self.alpha = alpha

    def metric(self, x_net, x, *args, **kwargs):
        d = _flatten_batch((x_net - x).abs())
        return self.alpha * d.mean(1) + (1 - self.alpha) * d.pow(2).mean(1)


class SpectralAngleMapper(Metric):
    """Mean spectral angle over pixels (metric.py:371)."""

    def metric(self, x_net, x, *args, **kwargs):
        num = (x_net * x).sum(1)
        den = x_net.pow(2).sum(1).sqrt() * x.pow(2).sum(1).sqrt()
        ang = torch.arccos((num / den.clamp(min=1e-12)).clamp(-1.0, 1.0))
        return _flatten_batch(ang).mean(1)


class ERGAS(Metric):
    """Relative global error of a pansharpened image (metric.py:381):
    ``100 * factor * sqrt(mean over bands of rmse_b^2 / mean_b^2)``."""

    def __init__(self, factor: int, **kwargs):
        super().__init__(**kwargs)
        self.factor = factor

    def metric(self, x_net, x, *args, **kwargs):
        rmse2 = (x_net - x).abs().pow(2).mean((-2, -1))
        mean2 = x.mean((-2, -1)).pow(2).clamp(min=1e-12)
        return 100.0 * self.factor * (rmse2 / mean2).mean(-1).sqrt().reshape(-1)


class QNR(Metric):
    """Quality with no reference of a pansharpened image (metric.py:398):
    ``(1 - D_lambda)^alpha (1 - D_s)^beta``, from the band-pair universal
    quality indices of the fused and the low-resolution multispectral image
    (D_lambda) and of each band against the panchromatic image (D_s). Call
    as ``qnr(x_net=fused, x=None, y=TensorList([ms_lr, pan]),
    physics=pansharpen)``."""

    lower_better = False

    def __init__(self, alpha: float = 1.0, beta: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.alpha = alpha
        self.beta = beta

    def invert_metric(self, m):
        return 1.0 - m

    @staticmethod
    def _uqi(a, b):
        """The universal quality index of each sample, over the flattened
        images (population variances)."""
        af, bf = _flatten_batch(a), _flatten_batch(b)
        ma, mb = af.mean(1, keepdim=True), bf.mean(1, keepdim=True)
        va, vb = af.var(1, correction=0), bf.var(1, correction=0)
        cov = ((af - ma) * (bf - mb)).mean(1)
        return (4 * cov * ma[:, 0] * mb[:, 0]) / (
            (va + vb) * (ma[:, 0] ** 2 + mb[:, 0] ** 2)).clamp(min=1e-12)

    def D_lambda(self, hrms, lrms):
        """Spectral distortion: the mean band-pair UQI difference between the
        fused and the low-resolution multispectral image (metric.py:431)."""
        C = hrms.shape[1]
        out, n_pairs = 0.0, 0
        for i in range(C):
            for j in range(i + 1, C):
                u_f = self._uqi(hrms[:, i:i + 1], hrms[:, j:j + 1])
                u_l = self._uqi(lrms[:, i:i + 1], lrms[:, j:j + 1])
                out = out + (u_f - u_l).abs()
                n_pairs += 1
        return out / max(n_pairs, 1)

    def D_s(self, hrms, lrms, pan, pan_lr):
        """Spatial distortion: the mean band-to-pan UQI difference at high
        against low resolution (metric.py:445)."""
        C = hrms.shape[1]
        out = 0.0
        for i in range(C):
            u_h = self._uqi(hrms[:, i:i + 1], pan)
            u_l = self._uqi(lrms[:, i:i + 1], pan_lr)
            out = out + (u_h - u_l).abs()
        return out / C

    def __call__(self, x_net=None, x=None, y=None, physics=None, **kwargs):
        from ..models.utils import resize_bilinear

        ms_lr, pan = y[0], y[1]
        d_lambda = self.D_lambda(x_net, ms_lr)
        # jax.image.resize(pan, ms_lr[:, :1].shape, "linear") (metric.py:460)
        pan_lr = resize_bilinear(pan, ms_lr.shape[-2:])
        d_s = self.D_s(x_net, ms_lr, pan, pan_lr)
        return (1 - d_lambda) ** self.alpha * (1 - d_s) ** self.beta

    forward = __call__


def _rest(v) -> tuple:
    return tuple(range(1, v.dim()))


def cal_mse(a, b):
    """Per-sample MSE (metric.py:465)."""
    return (a - b).abs().pow(2).mean(_rest(a))


def cal_mae(a, b):
    """Per-sample MAE (metric.py:470)."""
    return (a - b).abs().mean(_rest(a))


def signal_noise_ratio(x_hat, x):
    """Per-sample SNR in dB (metric.py:475)."""
    num = x.abs().pow(2).sum(_rest(x))
    den = (x_hat - x).abs().pow(2).sum(_rest(x))
    return 10.0 * torch.log10(num / den.clamp(min=1e-12))


# the perceptual and no-reference metrics, in this namespace as in the JAX
# package's (metric.py:484)
from .perceptual import (BlurStrength, CosineSimilarity, GMSD, HaarPSI, LPIPS, NIQE,  # noqa: E402
                         RecoveryCoefficient, SharpnessIndex)
