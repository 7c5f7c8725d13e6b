"""Histograms, random choice and thin-plate-spline interpolation (port of
deepinv_tpu/ops/misc.py). Randomness comes from a ``torch.Generator`` in
place of the JAX key.
"""

from __future__ import annotations

import math

import torch

__all__ = ["histogram", "histogramdd", "ThinPlateSpline", "random_choice"]


def _per_dim(v, D: int, like: torch.Tensor) -> torch.Tensor:
    """A scalar or length-D sequence as a ``(D,)`` tensor (misc.py:14)."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device).broadcast_to((D,))


def histogramdd(x, bins=10, low=None, upp=None, bounded: bool = False, weights=None):
    """D-dimensional histogram of ``(N, D)`` samples (misc.py:22): bins
    half-open but the last, which holds the upper bound; with ``low`` or
    ``upp`` given and ``bounded`` False, samples outside are dropped.

    :returns: ``(hist, edges)``, ``hist`` of shape ``tuple(bins)`` and
        ``edges`` D tensors of bin edges.
    """
    x = torch.as_tensor(x)
    N, D = x.shape
    bins_t = torch.as_tensor(bins, dtype=torch.long).broadcast_to((D,))
    nbins = [int(b) for b in bins_t]
    low_v = x.min(dim=0).values if low is None else _per_dim(low, D, x)
    upp_v = x.max(dim=0).values if upp is None else _per_dim(upp, D, x)
    t = (x - low_v) / (upp_v - low_v)
    idx = torch.floor(bins_t.to(x.device, x.dtype) * t).long()
    idx = torch.where(idx == bins_t.to(x.device)[None, :], idx - 1, idx)
    w = torch.ones((N,), dtype=x.dtype, device=x.device) if weights is None else \
        torch.as_tensor(weights, device=x.device)
    if not bounded and (low is not None or upp is not None):
        inside = ((x >= low_v) & (x <= upp_v)).all(dim=1)
        w = torch.where(inside, w, torch.zeros_like(w))
    idx = torch.minimum(idx.clamp_min(0), bins_t.to(x.device)[None, :] - 1)
    lin = torch.zeros((N,), dtype=torch.long, device=x.device)
    for d in range(D):
        lin = lin * nbins[d] + idx[:, d]
    hist = torch.zeros((math.prod(nbins),), dtype=w.dtype, device=x.device).index_add_(0, lin, w)
    edges = [torch.linspace(float(low_v[d]), float(upp_v[d]), nbins[d] + 1, dtype=x.dtype,
                            device=x.device) for d in range(D)]
    return hist.reshape(nbins), edges


def histogram(x, bins: int = 10, low=None, upp=None, bounded: bool = False, weights=None):
    """1D histogram (misc.py:71)."""
    h, e = histogramdd(torch.as_tensor(x).reshape(-1, 1), bins=bins, low=low, upp=upp,
                       bounded=bounded, weights=weights)
    return h, e[0]


def random_choice(generator, a, shape=(), replace: bool = True, p=None):
    """Samples of ``a`` (an int means ``range(a)``) of ``shape``, with or
    without replacement, uniform or with probabilities ``p``, drawn from
    ``generator`` (misc.py:81, ``jax.random.choice``)."""
    dev = generator.device if generator is not None else None
    a = torch.arange(a, device=dev) if isinstance(a, int) else torch.as_tensor(a, device=dev)
    n, k = a.shape[0], math.prod(shape)
    if p is not None:
        idx = torch.multinomial(torch.as_tensor(p, dtype=torch.float32, device=a.device), k,
                                replacement=replace, generator=generator)
    elif replace:
        idx = torch.randint(n, (k,), generator=generator, device=a.device)
    else:
        if k > n:
            raise ValueError(f"cannot take {k} samples without replacement from {n}")
        idx = torch.randperm(n, generator=generator, device=a.device)[:k]
    return a[idx].reshape(tuple(shape) + tuple(a.shape[1:]))


class ThinPlateSpline:
    """Thin-plate-spline interpolation (misc.py:88): :meth:`fit` control
    points ``X (n_c, d_s)`` to targets ``Y``, unbatched ``(n_c, d_t)`` or
    batched ``(B, C, n_c, d_t)``, then evaluate at query points with
    :meth:`transform`.

    :param alpha: the regularisation added to the kernel's diagonal.
    """

    def __init__(self, alpha: float = 0.0):
        self.alpha = alpha
        self._theta = None
        self._ctrl = None
        self._batched = False

    @staticmethod
    def _phi(r2):
        # U(r) = r^2 log r = r^2 log(r^2) / 2
        return 0.5 * r2 * torch.log(r2.clamp_min(1e-12))

    def _system(self, X):
        n_c, d_s = X.shape
        d2 = ((X[:, None] - X[None]) ** 2).sum(-1)
        K = self._phi(d2) + self.alpha * torch.eye(n_c, dtype=X.dtype, device=X.device)
        P = torch.cat([torch.ones((n_c, 1), dtype=X.dtype, device=X.device), X], dim=1)
        zeros = torch.zeros((d_s + 1, d_s + 1), dtype=X.dtype, device=X.device)
        return torch.cat([torch.cat([K, P], 1), torch.cat([P.T, zeros], 1)], 0)

    def fit(self, X, Y):
        """``X (n_c, d_s)`` control points; ``Y (n_c, d_t)`` or ``(B, C, n_c,
        d_t)`` (misc.py:115)."""
        X, Y = torch.as_tensor(X), torch.as_tensor(Y)
        self._ctrl, self._batched = X, Y.dim() == 4
        L = self._system(X)
        pad = torch.zeros(Y.shape[:-2] + (X.shape[1] + 1, Y.shape[-1]), dtype=Y.dtype,
                          device=Y.device)
        self._theta = torch.linalg.solve(L, torch.cat([Y, pad], dim=-2))
        return self

    def transform(self, X):
        """Values at ``(M, d_s)`` points: ``(M, d_t)`` or ``(B, C, M, d_t)``
        (misc.py:128)."""
        X = torch.as_tensor(X)
        U = self._phi(((X[:, None] - self._ctrl[None]) ** 2).sum(-1))
        P = torch.cat([torch.ones((X.shape[0], 1), dtype=X.dtype, device=X.device), X], dim=1)
        Amat = torch.cat([U, P], dim=1)
        if self._batched:
            return torch.einsum("mk,bckd->bcmd", Amat, self._theta)
        return Amat @ self._theta
