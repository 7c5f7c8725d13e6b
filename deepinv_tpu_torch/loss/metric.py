"""Metrics (port of deepinv_tpu/loss/metric.py).

:class:`Metric` reproduces the JAX package's preprocessing (metric.py:146-176):
complex magnitude, center crop, input normalization, reduction, and the
``train_loss`` sign flip that turns a quality metric into a loss. Metrics
return per-sample values of shape (B,).
"""

from __future__ import annotations

import torch

__all__ = ["Metric", "MSE", "PSNR", "cal_psnr"]


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


class MSE(Metric):
    """Mean squared error (metric.py:183)."""

    def metric(self, x_net, x, *args, **kwargs):
        return _flatten_batch((x_net - x).abs().pow(2)).mean(1)


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
