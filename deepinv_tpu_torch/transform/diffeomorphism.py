"""CPAB diffeomorphisms (port of deepinv_tpu/transform/diffeomorphism.py).

Continuous piecewise-affine velocity fields on a triangular tessellation of
[-1, 1]^2 (Freifeld et al., TPAMI 2017). The basis of continuous (optionally
zero-boundary or divergence-free) fields is a null space computed by a numpy
SVD on the host, a copy of the JAX package's (diffeomorphism.py:38-123),
cached per configuration. The field is integrated by a fixed-step RK4
(diffeomorphism.py:153) and the image sampled bilinearly at the integrated
points, border pixels repeated (``map_coordinates(order=1, mode="nearest")``).
The warp integrates ``-v`` backward from the output grid, so the inverse
(``theta -> -theta``) is the flow of ``-v``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .base import Transform, _device
from .geometric import map_coordinates

__all__ = ["CPABDiffeomorphism"]


@functools.lru_cache(maxsize=None)
def _cpab_basis(nx: int, ny: int, zero_boundary: bool, volume_preservation: bool):
    """Null-space basis of continuous PA fields on the 4-triangle-per-cell
    tessellation of [-1,1]^2. Returns (triangles' vertex matrix pseudo
    structure, basis B of shape (6*T, d), triangle count T)."""
    # vertices of the tessellation: cell corners + cell centers
    xs = np.linspace(-1, 1, nx + 1)
    ys = np.linspace(-1, 1, ny + 1)

    tris = []  # each triangle = 3 vertex coordinates (x, y)
    for i in range(nx):
        for j in range(ny):
            c = np.array([(xs[i] + xs[i + 1]) / 2, (ys[j] + ys[j + 1]) / 2])
            v00 = np.array([xs[i], ys[j]])
            v10 = np.array([xs[i + 1], ys[j]])
            v01 = np.array([xs[i], ys[j + 1]])
            v11 = np.array([xs[i + 1], ys[j + 1]])
            # triangle order inside a cell: left, right, bottom, top
            tris.append((v00, v01, c))
            tris.append((v10, v11, c))
            tris.append((v00, v10, c))
            tris.append((v01, v11, c))
    T = len(tris)

    # constraints: velocities of triangles sharing an edge agree at that
    # edge's endpoints (affine on a segment is fixed by its endpoints).
    # Build shared-vertex pairs: map rounded vertex -> list of (tri, vertex)
    def key(p):
        return (round(float(p[0]), 9), round(float(p[1]), 9))

    # shared edges: for each pair of triangles, if they share 2 vertices
    vert_map = {}
    for t, vs in enumerate(tris):
        for p in vs:
            vert_map.setdefault(key(p), []).append(t)

    rows = []

    def vel_row(t, p, dim):
        """Row of the constraint matrix for velocity dim of triangle t at p."""
        r = np.zeros(6 * T)
        # A_t = [[a, b, c], [d, e, f]]; v = A_t [x, y, 1]
        base = 6 * t + 3 * dim
        r[base : base + 3] = [p[0], p[1], 1.0]
        return r

    # edge continuity: two triangles sharing an edge (two vertices)
    from itertools import combinations

    edge_map = {}
    exact_pts = {}  # rounded key -> exact coordinates (rounding the
    # constraint points themselves would inject ~1e-10 rank noise that
    # poisons the null space)
    for t, vs in enumerate(tris):
        for a, b in combinations(range(3), 2):
            ka, kb = key(vs[a]), key(vs[b])
            exact_pts.setdefault(ka, vs[a])
            exact_pts.setdefault(kb, vs[b])
            ek = tuple(sorted([ka, kb]))
            edge_map.setdefault(ek, []).append(t)
    for (k1, k2), ts in edge_map.items():
        for ta, tb in combinations(ts, 2):
            for p in (exact_pts[k1], exact_pts[k2]):
                for dim in (0, 1):
                    rows.append(vel_row(ta, p, dim) - vel_row(tb, p, dim))

    if zero_boundary:
        for t, vs in enumerate(tris):
            for p in vs:
                if abs(abs(p[0]) - 1) < 1e-9 or abs(abs(p[1]) - 1) < 1e-9:
                    for dim in (0, 1):
                        rows.append(vel_row(t, np.array(p), dim))

    if volume_preservation:
        for t in range(T):
            r = np.zeros(6 * T)
            r[6 * t + 0] = 1.0  # a (dvx/dx)
            r[6 * t + 3 + 1] = 1.0  # e (dvy/dy)
            rows.append(r)

    L = np.asarray(rows)
    _, s, Vt = np.linalg.svd(L)  # Vt is (6T, 6T); null space = rows >= rank
    tol = max(L.shape) * np.finfo(np.float64).eps * (s[0] if len(s) else 1.0)
    rank = int(np.sum(s > tol))
    B = Vt[rank:].T  # (6T, d)
    return np.float32(B), T


def _cell_lookup(pts, nx, ny):
    """The triangle of each point (diffeomorphism.py:126): the cell by
    floor, then which of its four centre-split triangles by the diagonals."""
    x, y = pts[..., 0], pts[..., 1]
    xc = ((x + 1) * nx / 2).clamp(0, nx - 1e-6)
    yc = ((y + 1) * ny / 2).clamp(0, ny - 1e-6)
    i = torch.floor(xc)
    j = torch.floor(yc)
    fx, fy = xc - i, yc - j
    left = fx <= torch.minimum(fy, 1 - fy)
    right = fx >= torch.maximum(fy, 1 - fy)
    bottom = fy <= torch.minimum(fx, 1 - fx)
    tri = torch.where(left, 0, torch.where(right, 1, torch.where(bottom, 2, 3)))
    return (i.long() * ny + j.long()) * 4 + tri


def _velocity(pts, A, nx, ny):
    """The field at ``pts`` (``(N, P, 2)``); ``A`` is ``(N, T, 2, 3)``
    (diffeomorphism.py:144)."""
    idx = _cell_lookup(pts, nx, ny)
    At = torch.gather(A, 1, idx[..., None, None].expand(idx.shape + (2, 3)))
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)
    return torch.einsum("...ij,...j->...i", At, ph)


def _integrate(pts, A, nx, ny, n_steps=10):
    """RK4 flow of the field over unit time (diffeomorphism.py:153)."""
    h = 1.0 / n_steps
    p = pts
    for _ in range(n_steps):
        k1 = _velocity(p, A, nx, ny)
        k2 = _velocity(p + 0.5 * h * k1, A, nx, ny)
        k3 = _velocity(p + 0.5 * h * k2, A, nx, ny)
        k4 = _velocity(p + h * k3, A, nx, ny)
        p = p + (h / 6) * (k1 + 2 * k2 + 2 * k3 + k4)
    return p


class CPABDiffeomorphism(Transform):
    """Random CPAB diffeomorphisms (diffeomorphism.py:168): one theta a
    output image (``n_trans * B``), ``N(0, sigma^2)`` on the basis
    coefficients; the inverse is the exact group inverse.

    :param n_tesselation: cells per dimension of the tessellation.
    :param sigma: scale of the coefficients.
    :param zero_boundary: the velocity vanishes on the image boundary.
    :param volume_preservation: zero divergence in each triangle.
    :param n_steps: RK4 steps.
    """

    def __init__(self, n_trans: int = 1, n_tesselation: int = 3, sigma: float = 0.3,
                 zero_boundary: bool = True, volume_preservation: bool = False,
                 n_steps: int = 10, **kwargs):
        super().__init__(n_trans=n_trans, **kwargs)
        self.n_tesselation = n_tesselation
        self.sigma = sigma
        self.zero_boundary = zero_boundary
        self.volume_preservation = volume_preservation
        self.n_steps = n_steps
        B, T = _cpab_basis(n_tesselation, n_tesselation, zero_boundary, volume_preservation)
        self.basis = torch.from_numpy(B)
        self.n_tris = T
        self.dim = B.shape[1]

    def get_params(self, x, generator=None):
        n = self.n_trans * x.shape[0]
        theta = torch.randn((n, self.dim), generator=generator, device=_device(x, generator))
        return {"diffeo": (self.sigma * theta).to(x.device)}

    def _field(self, theta):
        """``(N, T, 2, 3)`` affine maps of the coefficients ``(N, d)``."""
        basis = self.basis.to(theta.device)
        return (theta @ basis.T).reshape(theta.shape[0], self.n_tris, 2, 3)

    def transform(self, x, diffeo=None):
        diffeo = torch.as_tensor(diffeo, dtype=torch.float32, device=x.device)
        if x.shape[0] != diffeo.shape[0]:
            x = torch.cat([x] * self.n_trans, 0)
        N, C, H, W = x.shape
        A = self._field(diffeo)
        n = self.n_tesselation
        gy = (torch.arange(H, device=x.device) + 0.5) / H * 2 - 1
        gx = (torch.arange(W, device=x.device) + 0.5) / W * 2 - 1
        yy, xx = torch.meshgrid(gy, gx, indexing="ij")
        pts = torch.stack([xx, yy], -1).reshape(1, -1, 2).expand(N, -1, -1)
        src = _integrate(pts, -A, n, n, self.n_steps)
        rows = (src[..., 1] + 1) / 2 * H - 0.5
        cols = (src[..., 0] + 1) / 2 * W - 0.5
        return map_coordinates(x, rows[:, None], cols[:, None], 1, "nearest").reshape(N, C, H, W)
