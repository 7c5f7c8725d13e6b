"""Ray-driven X-ray transform: 2D parallel and fan beam, 3D parallel and cone
beam, and per-view vector geometries (port of deepinv_tpu/ops/xray.py).

Every (view, detector cell) defines a ray ``P(t) = P0 + t D``, clipped to the
volume's bounding sphere and sampled at ``n_steps`` points; the line
integral is a trilinear :func:`~deepinv_tpu_torch.ops.radon._map_coordinates`
gather and a mean times the clipped length. Conventions (xray.py:23-32):
voxel (slice, row, col) is world (z, y, x); view angle ``a`` has ray
direction ``(sin a, cos a, 0)``, detector u-axis ``(cos a, -sin a, 0)`` and
v-axis ``(0, 0, 1)``; a divergent beam has its source at ``-Rs d`` and a flat
detector centred at ``+Rd d``.

:class:`XrayPlan` is the JAX package's ``_plan`` (:172): the rays planned in
float64 numpy once, kept as float32 buffers (so ``plan.to(device)`` moves
them), the views in chunks of at most 2^22 samples. :meth:`XrayPlan.project`
runs the chunks in a loop; :meth:`XrayPlan.backproject` is the exact
transpose, taken chunk by chunk (each chunk's autograd transpose added into
the volume), so autograd never holds more than one chunk's sample
coordinates. :func:`xray_geometry` (:86), :func:`geometry_static` (:53),
:func:`xray_transform` (:240), :func:`ray_integrals` (:317) and
:func:`fdk_weights` (:427) keep the JAX package's signatures.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..core.linalg import linear_transpose
from .radon import _map_coordinates

__all__ = ["xray_transform", "xray_geometry", "fdk_weights", "geometry_static", "ray_integrals",
           "XrayPlan"]

# samples a chunk of views may hold (xray.py:218-220)
CHUNK_SAMPLES = 1 << 22


def geometry_static(geom: dict) -> dict:
    """A geometry dict with nested tuples of floats for arrays (xray.py:53);
    the JAX package keys its plan cache on it."""
    return {k: (None if v is None else
                tuple(tuple(float(e) for e in row) for row in np.asarray(v, np.float64)))
            for k, v in geom.items()}


def _geom_np(geom: dict) -> dict:
    return {k: (None if v is None else np.asarray(v, np.float64)) for k, v in geom.items()}


def _as3(v, default):
    """Per-axis spacing as (x, y, z) from a scalar, (row, col) or (slice,
    row, col) (xray.py:72)."""
    if v is None:
        return np.asarray(default, np.float64)
    v = np.atleast_1d(np.asarray(v, np.float64))
    if v.size == 1:
        return np.full(3, float(v[0]))
    if v.size == 2:
        return np.array([float(v[1]), float(v[0]), 1.0])
    return v[::-1].copy()


def xray_geometry(geometry_type: str, angles, detector_spacing=1.0,
                  source_radius: float = 80.0, detector_radius: float = 20.0,
                  geometry_vectors=None) -> dict:
    """Per-view ray vectors, astra ``geom_2vec`` style (xray.py:86): a dict
    of float64 ``(A, 3)`` arrays ``ray`` (parallel beams, else None), ``src``
    (divergent beams, else None), ``det`` (detector centre), ``u``, ``v``
    (cell axes scaled by the pitch)."""
    if geometry_vectors is not None:
        V = np.asarray(geometry_vectors, np.float64)
        if V.ndim != 2 or V.shape[1] not in (6, 12):
            raise ValueError("geometry_vectors must be (A, 12) (3D) or (A, 6) (2D)")
        if V.shape[1] == 6:
            pad = np.zeros((V.shape[0], 1))
            first = np.concatenate([V[:, 0:2], pad], 1)
            det = np.concatenate([V[:, 2:4], pad], 1)
            u = np.concatenate([V[:, 4:6], pad], 1)
            v = np.tile(np.array([[0.0, 0.0, 1.0]]), (V.shape[0], 1))
        else:
            first, det, u, v = V[:, 0:3], V[:, 3:6], V[:, 6:9], V[:, 9:12]
        parallel = geometry_type in ("parallel", "parallel3d")
        return dict(ray=first if parallel else None, src=None if parallel else first,
                    det=det, u=u, v=v)
    a = np.asarray(angles, np.float64)
    sin, cos = np.sin(a), np.cos(a)
    zeros = np.zeros_like(a)
    d = np.stack([sin, cos, zeros], -1)
    u_hat = np.stack([cos, -sin, zeros], -1)
    v_hat = np.stack([zeros, zeros, np.ones_like(a)], -1)
    ds = np.atleast_1d(np.asarray(detector_spacing, np.float64))
    du = float(ds[-1])
    dv = float(ds[0]) if ds.size > 1 else du
    if geometry_type in ("parallel", "parallel3d"):
        return dict(ray=d, src=None, det=np.zeros_like(d), u=u_hat * du, v=v_hat * dv)
    if geometry_type in ("fanbeam", "conebeam", "fanflat", "cone"):
        return dict(ray=None, src=-source_radius * d, det=detector_radius * d, u=u_hat * du,
                    v=v_hat * dv)
    raise ValueError(f"unknown geometry_type {geometry_type!r}")


def _ray_bundle(geom, n_v: int, n_u: int):
    """Ray origins and directions ``(A, n_v, n_u, 3)`` of every detector cell
    (xray.py:143); a divergent beam's D spans source to cell."""
    det, u, v = geom["det"], geom["u"], geom["v"]
    iu = np.arange(n_u, dtype=np.float64) - (n_u - 1) / 2.0
    iv = np.arange(n_v, dtype=np.float64) - (n_v - 1) / 2.0
    cells = (det[:, None, None, :] + iv[None, :, None, None] * v[:, None, None, :]
             + iu[None, None, :, None] * u[:, None, None, :])
    if geom["ray"] is not None:
        return cells, np.broadcast_to(geom["ray"][:, None, None, :], cells.shape).copy()
    src = np.broadcast_to(geom["src"][:, None, None, :], cells.shape)
    return src.copy(), cells - src


def _detector_shape(img_size, n_detector_pixels):
    is_2d = len(img_size) == 2
    if is_2d:
        return 1, int(n_detector_pixels or math.ceil(math.sqrt(2) * img_size[0]))
    if n_detector_pixels is None:
        return int(img_size[0]), int(math.ceil(math.sqrt(2) * img_size[1]))
    if np.isscalar(n_detector_pixels):
        return int(n_detector_pixels), int(n_detector_pixels)
    return tuple(int(t) for t in n_detector_pixels)


class XrayPlan(nn.Module):
    """The rays of one geometry on one grid (xray.py:172): per view chunk the
    origins ``p0``, directions ``d``, the clip window ``t0``/``t1`` and the
    clipped length ``seg`` as float32 buffers ``(n_chunks, chunk, V, N[, 3])``
    (the last chunk padded by repeating the last view), the sample fractions
    ``ts``, the pitch ``sp`` and the grid centre.

    :param geom: :func:`xray_geometry`'s dict.
    :param img_size: ``(H, W)`` or ``(D, H, W)``.
    :param pixel_spacing: scalar or per-axis voxel pitch (slice, row, col).
    :param n_detector_pixels: int (2D) or (rows, cols) (3D).
    :param n_steps: samples a ray, default 3 max(size).
    """

    def __init__(self, geom: dict, img_size, pixel_spacing=1.0, n_detector_pixels=None,
                 n_steps: int | None = None, chunk_views: int | None = None):
        super().__init__()
        geom = _geom_np(geom)
        self.img_size = tuple(int(s) for s in img_size)
        self.is_2d = len(self.img_size) == 2
        shape3 = (1, *self.img_size) if self.is_2d else self.img_size
        Dz, H, W = shape3
        self.shape3 = shape3
        sp = _as3(pixel_spacing, 1.0)
        n_v, n_u = _detector_shape(self.img_size, n_detector_pixels)
        P0, Dir = _ray_bundle(geom, n_v, n_u)
        A = P0.shape[0]
        extent = np.array([W * sp[0], H * sp[1], Dz * sp[2]])
        if self.is_2d:
            extent[2] = 0.0
        R = 0.5 * float(np.linalg.norm(extent))
        d2 = np.maximum(np.sum(Dir * Dir, -1), 1e-30)
        b = np.sum(P0 * Dir, -1) / d2
        c = (np.sum(P0 * P0, -1) - R * R) / d2
        disc = b * b - c
        sq = np.sqrt(np.maximum(disc, 0.0))
        t0, t1 = -b - sq, -b + sq
        if geom["ray"] is None:     # divergent: forward of the source, up to the detector
            t0, t1 = np.clip(t0, 0.0, 1.0), np.clip(t1, 0.0, 1.0)
        seg = np.where(disc > 0, (t1 - t0) * np.sqrt(d2), 0.0)
        if n_steps is None:
            n_steps = 3 * max(shape3)
        if chunk_views is None:
            chunk_views = max(1, min(A, CHUNK_SAMPLES // max(1, n_v * n_u * n_steps)))
        n_chunks = (A + chunk_views - 1) // chunk_views
        pad = n_chunks * chunk_views - A

        def buf(arr):
            if pad:
                arr = np.concatenate([arr, np.repeat(arr[-1:], pad, 0)], 0)
            arr = arr.astype(np.float32).reshape((n_chunks, chunk_views) + arr.shape[1:])
            return torch.from_numpy(np.ascontiguousarray(arr))

        for name, arr in (("p0", P0), ("d", Dir), ("t0", t0), ("t1", t1), ("seg", seg)):
            self.register_buffer(name, buf(arr))
        ts = np.linspace(0.5 / n_steps, 1.0 - 0.5 / n_steps, n_steps)
        self.register_buffer("ts", torch.from_numpy(ts.astype(np.float32)))
        self.register_buffer("sp", torch.from_numpy(sp.astype(np.float32)))
        self.register_buffer("center", torch.tensor([(W - 1) / 2.0, (H - 1) / 2.0,
                                                     (Dz - 1) / 2.0]))
        self.n_views, self.n_v, self.n_u = A, n_v, n_u
        self.n_chunks, self.chunk_views = n_chunks, chunk_views

    @property
    def measurement_shape(self):
        if self.is_2d:
            return (self.n_views, self.n_u)
        return (self.n_v, self.n_views, self.n_u)

    def _chunk(self, vol, i: int, interp_order: int):
        """Line integrals ``(BC, chunk, V, N)`` of the view chunk ``i``
        (xray.py:282-300)."""
        tt = self.t0[i][..., None] + self.ts * (self.t1[i] - self.t0[i])[..., None]
        pts = self.p0[i][..., None, :] + tt[..., None] * self.d[i][..., None, :]
        idx = pts / self.sp + self.center              # world -> (col, row, slice)
        if self.is_2d:
            coords, grid = [idx[..., 1], idx[..., 0]], vol[:, 0]
        else:
            coords, grid = [idx[..., 2], idx[..., 1], idx[..., 0]], vol
        vals = _map_coordinates(grid, coords, interp_order)   # (BC, chunk, V, N, T)
        return vals.mean(dim=-1) * self.seg[i]

    def _assemble(self, chunks, B: int, C: int, dtype):
        out = torch.cat(chunks, dim=1)[:, :self.n_views]     # (BC, A, V, N)
        out = out.movedim(1, 2).reshape(B, C, self.n_v, self.n_views, self.n_u)
        return (out[:, :, 0] if self.is_2d else out).to(dtype)

    def project(self, x, interp_order: int = 1):
        """``(B, C, A, N)`` sinograms of ``(B, C, H, W)`` images, or ``(B, C,
        V, A, N)`` radiographs of ``(B, C, D, H, W)`` volumes, in physical
        length units (xray.py:240)."""
        B, C = x.shape[:2]
        vol = x.reshape((B * C,) + self.shape3)
        return self._assemble([self._chunk(vol, i, interp_order) for i in range(self.n_chunks)],
                              B, C, x.dtype)

    def backproject(self, y, interp_order: int = 1):
        """The exact transpose of :meth:`project`, chunk by chunk: each view
        chunk's autograd transpose added into the volume."""
        B, C = y.shape[:2]
        yv = y[:, :, None] if self.is_2d else y
        yv = yv.reshape(B * C, self.n_v, self.n_views, self.n_u).movedim(2, 1)  # (BC, A, V, N)
        cv = self.chunk_views
        out = None
        for i in range(self.n_chunks):
            part = yv[:, i * cv:(i + 1) * cv]
            if part.shape[1] < cv:     # the padded views of the last chunk see zeros
                part = torch.cat([part, part.new_zeros((part.shape[0], cv - part.shape[1])
                                                       + part.shape[2:])], dim=1)
            xt = linear_transpose(lambda v: self._chunk(v, i, interp_order), part,
                                  (B * C,) + self.shape3)
            out = xt if out is None else out + xt
        shape = (B, C) + self.img_size
        return out.reshape(shape)


def xray_transform(x, geom: dict, img_size, pixel_spacing=1.0, n_detector_pixels=None,
                   n_steps: int | None = None, chunk_views: int | None = None,
                   interp_order: int = 1):
    """Line integrals of ``x`` along the rays of ``geom`` (xray.py:240).

    :param x: ``(B, C, H, W)`` image or ``(B, C, D, H, W)`` volume.
    :returns: ``(B, C, A, N)`` sinogram or ``(B, C, V, A, N)`` radiographs,
        in physical length units (astra's scaling).
    """
    plan = XrayPlan(geom, img_size, pixel_spacing, n_detector_pixels, n_steps, chunk_views)
    return plan.to(x.device).project(x, interp_order)


def ray_integrals(x, p0, p1, img_size, pixel_spacing=1.0, n_steps: int | None = None,
                  chunk: int | None = None, interp_order: int = 1,
                  clip_radius: float | None = None):
    """Line integrals along rays from ``p0`` to ``p1`` (``(..., 3)`` world
    points, tensors) through ``x`` (xray.py:317), each clipped to the sphere
    of ``clip_radius`` (default: the volume's bounding sphere); a
    zero-length ray integrates to 0. Returns ``(B, C) + p0.shape[:-1]``, in
    physical length units. The endpoints are computed per call, so each ray
    may have its own direction (the crystal pairs of a PET scanner)."""
    is_2d = len(img_size) == 2
    Dz, H, W = (1, *img_size) if is_2d else tuple(img_size)
    dev = x.device
    sp_np = _as3(pixel_spacing, 1.0)
    sp = torch.as_tensor(sp_np, dtype=torch.float32, device=dev)
    center = torch.tensor([(W - 1) / 2.0, (H - 1) / 2.0, (Dz - 1) / 2.0], device=dev)
    lead = p0.shape[:-1]
    p0f = p0.reshape(-1, 3).to(torch.float32)
    Dir = p1.reshape(-1, 3).to(torch.float32) - p0f
    if clip_radius is None:
        R = 0.5 * float(np.linalg.norm(np.array([W, H, 0.0 if is_2d else Dz]) * sp_np))
    else:
        R = float(clip_radius)
    d2 = (Dir * Dir).sum(-1).clamp_min(1e-30)
    b = (p0f * Dir).sum(-1) / d2
    c = ((p0f * p0f).sum(-1) - R * R) / d2
    disc = b * b - c
    sq = torch.sqrt(disc.clamp_min(0.0))
    t0, t1 = (-b - sq).clamp(0.0, 1.0), (-b + sq).clamp(0.0, 1.0)
    seg = torch.where(disc > 0, (t1 - t0) * torch.sqrt(d2), torch.zeros_like(d2))
    if n_steps is None:
        n_steps = 2 * max(Dz, H, W)
    ts = torch.linspace(0.5 / n_steps, 1.0 - 0.5 / n_steps, n_steps, device=dev)
    n_rays = p0f.shape[0]
    if chunk is None:
        chunk = max(1, min(n_rays, CHUNK_SAMPLES // n_steps))
    B, C = x.shape[:2]
    vol = x.reshape(B * C, Dz, H, W)
    outs = []
    for s in range(0, n_rays, chunk):
        sl = slice(s, s + chunk)
        tt = t0[sl, None] + ts * (t1[sl] - t0[sl])[:, None]
        idx = (p0f[sl, None, :] + tt[..., None] * Dir[sl, None, :]) / sp + center
        if is_2d:
            vals = _map_coordinates(vol[:, 0], [idx[..., 1], idx[..., 0]], interp_order)
        else:
            vals = _map_coordinates(vol, [idx[..., 2], idx[..., 1], idx[..., 0]], interp_order)
        outs.append(vals.mean(dim=-1) * seg[sl])
    return torch.cat(outs, dim=1).reshape((B, C) + tuple(lead)).to(x.dtype)


def fdk_weights(geom: dict, n_v: int, n_u: int) -> torch.Tensor:
    """Feldkamp-Davis-Kress cosine weights ``Rs / |cell - src|`` per view and
    detector cell, ``(A, V, N)`` float32; all ones for parallel beams
    (xray.py:427)."""
    geom = _geom_np(geom)
    if geom["ray"] is not None:
        w = np.ones((geom["det"].shape[0], n_v, n_u), np.float32)
    else:
        _, Dir = _ray_bundle(geom, n_v, n_u)
        src_obj = np.linalg.norm(geom["src"], axis=-1)
        w = (src_obj[:, None, None] / np.maximum(np.linalg.norm(Dir, axis=-1), 1e-30))
    return torch.from_numpy(np.ascontiguousarray(w, np.float32))
