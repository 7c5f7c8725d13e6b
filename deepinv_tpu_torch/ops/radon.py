"""Parallel-beam Radon transform, its filtered backprojection and the fan
beam, by gathers (port of deepinv_tpu/ops/radon.py).

Conventions are the JAX package's: angles in degrees, ``circle=False`` pads
the image to ``ceil(sqrt(2) W)`` (:func:`_pad_image`, :33), sinograms are
``(B, C, n_det, n_angles)``, the FBP uses the frequency-domain
:func:`ramp_filter` (:89) and the ``pi / (2 n_angles)`` scaling.

:func:`radon` (:54), :func:`iradon` (:114) and :func:`fanbeam` (:169) sample
the image with :func:`_map_coordinates`, the port's counterpart of
``jax.scipy.ndimage.map_coordinates(order=0|1, mode="constant")``: every
corner whose index lies outside the grid contributes 0 on its own, and
order 0 rounds half away from zero. The coordinates are computed per call
from the ``theta`` tensor, so a gradient reaches the angles as it does in
JAX. The adjoints are the autograd transposes of these maps
(:func:`~deepinv_tpu_torch.core.linear_transpose`); their backward adds with
``index_add_`` (atomics on the card), so two adjoint calls may differ in the
last bits.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["radon_output_size", "ramp_filter", "radon", "iradon", "fanbeam"]


def radon_output_size(in_size: int, circle: bool = False) -> int:
    """Detector pixels for a square ``in_size`` image (radon.py:27):
    ``in_size`` inside the circle, else the padded diagonal."""
    if circle:
        return in_size
    return in_size + int(math.ceil(math.sqrt(2) * in_size - in_size))


def _pad_image(x: torch.Tensor, circle: bool) -> torch.Tensor:
    """Zero-pad the two last dims to the diagonal, centred (radon.py:33)."""
    if circle:
        return x
    W = x.shape[-1]
    pad = int(math.ceil(math.sqrt(2) * W - W))
    before = (W + pad) // 2 - W // 2
    return F.pad(x, (before, pad - before, before, pad - before))


def _circle_mask(W: int) -> np.ndarray:
    """``(W, W)`` float32 indicator of the inscribed disc (radon.py:48)."""
    ax = 2 * np.arange(W) / (W - 1) - 1.0
    yy, xx = np.meshgrid(ax, ax, indexing="ij")
    return (yy ** 2 + xx ** 2 <= 1).astype(np.float32)


def ramp_filter(sino: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Ramp filter along the detector axis of ``(..., n_det, n_angles)``
    sinograms (radon.py:89): zero-pad to a power of two (at least 64 and
    ``2 n_det``), multiply by the FFT of the band-limited spatial ramp (Kak &
    Slaney), crop."""
    N = sino.shape[-2]
    size = max(64, int(2 ** math.ceil(math.log2(2 * N))))
    n = np.concatenate([np.arange(1, size / 2 + 1, 2), np.arange(size / 2 - 1, 0, -2)])
    f = np.zeros(size, np.float64)
    f[0] = 0.25
    f[1::2] = -1.0 / (np.pi * n) ** 2
    ramp = torch.as_tensor(2 * np.real(np.fft.fft(f)), dtype=dtype).to(sino.device)
    sp = torch.fft.fft(F.pad(sino, (0, 0, 0, size - N)), dim=-2)
    filtered = torch.fft.ifft(sp * ramp[:, None], dim=-2).real
    return filtered[..., :N, :].to(sino.dtype)


def _round_half_away(c: torch.Tensor) -> torch.Tensor:
    return torch.sign(c) * torch.floor(c.abs() + 0.5)


def _map_coordinates(img: torch.Tensor, coords, order: int = 1) -> torch.Tensor:
    """Sample the grids ``img`` ``(N, *grid)`` at ``coords``, one tensor per
    grid axis broadcasting to a common shape ``S``; returns ``(N, *S)``.

    The semantics of ``jax.scipy.ndimage.map_coordinates(..., order,
    mode="constant", cval=0)``: order 1 interpolates linearly between
    ``floor(c)`` and ``floor(c) + 1`` on each axis, order 0 takes the index
    rounded half away from zero, and a corner whose index is outside
    ``[0, size)`` contributes 0. The corners are summed in JAX's order, each
    as ``(w_0 w_1 ...) * value``. An integer coordinate is an exact index
    inside the grid (``iradon``'s angle axis). Differentiable in ``img`` (the
    backward adds with ``index_add_``) and, at order 1, in the coordinates.

    A corner outside the grid reads, and its backward adds 0 to, an index of
    its own (the sample's position modulo the grid), not the clamped border:
    rays that miss the image (most of a fan beam's) would otherwise pile
    their atomic adds onto one border pixel.
    """
    if order not in (0, 1):
        raise NotImplementedError("map_coordinates supports order 0 and 1")
    N, grid = img.shape[0], tuple(img.shape[1:])
    if len(coords) != len(grid):
        raise ValueError(f"{len(coords)} coordinate arrays for a {len(grid)}-D grid")
    shape = tuple(torch.broadcast_shapes(*(c.shape for c in coords)))
    numel = math.prod(grid)
    itype = torch.int32 if max(numel, math.prod(shape)) < 2 ** 31 else torch.long
    strides = [math.prod(grid[d + 1:]) for d in range(len(grid))]
    # per axis: [(index offset, weight with the validity folded in, validity)];
    # an exact index has weight 1 and is valid (None)
    nodes = []
    for c, size, stride in zip(coords, grid, strides):
        if not c.is_floating_point():
            nodes.append([((c * stride).to(itype), None, None)])
            continue
        if order == 0:
            idx = _round_half_away(c).to(itype)
            ok = (idx >= 0) & (idx < size)
            nodes.append([(idx.clamp(0, size - 1) * stride, ok.to(c.dtype), ok)])
            continue
        lower = torch.floor(c)
        upper_w = c - lower
        idx = lower.to(itype)
        nodes.append([(i.clamp(0, size - 1) * stride, w * ok.to(c.dtype), ok)
                      for i, w, ok in ((i, w, (i >= 0) & (i < size))
                                       for i, w in ((idx, 1 - upper_w), (idx + 1, upper_w)))])
    spread = torch.arange(math.prod(shape), device=img.device, dtype=itype).remainder_(
        numel).reshape(shape)
    flat = img.reshape(N, -1)
    out = None
    for items in itertools.product(*nodes):
        lin, weight, valid = 0, None, None
        for off, w, ok in items:
            lin = lin + off
            if w is not None:
                weight = w if weight is None else weight * w
                valid = ok if valid is None else valid & ok
        lin = torch.broadcast_to(lin, shape)
        if valid is not None:
            lin = torch.where(valid, lin, spread)
        vals = flat.index_select(1, lin.reshape(-1)).reshape((N,) + shape)
        term = vals if weight is None else weight * vals
        out = term if out is None else out + term
    return out


def radon(x: torch.Tensor, theta, circle: bool = False, interp_order: int = 1) -> torch.Tensor:
    """Radon transform of ``(B, C, W, W)`` images to ``(B, C, n_det,
    n_angles)`` sinograms (radon.py:54): the image rotated to every angle by
    one gather, summed along the rows.

    :param theta: angles in degrees (a tensor keeps its gradient).
    """
    if x.shape[-1] != x.shape[-2]:
        raise ValueError("input image must be square")
    x = _pad_image(x, circle)
    W = x.shape[-1]
    if circle:
        x = x * torch.from_numpy(_circle_mask(W)).to(x.device, x.dtype)
    th = torch.deg2rad(torch.as_tensor(theta, dtype=torch.float32, device=x.device))
    c = (W - 1) / 2.0
    u = torch.arange(W, dtype=torch.float32, device=x.device) - c  # integration (rows)
    v = u                                                            # detector (cols)
    cos, sin = torch.cos(th), torch.sin(th)
    # out(u, v) = x(R_t [u, v]): rows c + cos u - sin v, cols c + sin u + cos v
    rows = c + cos[:, None, None] * u[None, :, None] - sin[:, None, None] * v[None, None, :]
    cols = c + sin[:, None, None] * u[None, :, None] + cos[:, None, None] * v[None, None, :]
    B, C = x.shape[:2]
    vals = _map_coordinates(x.reshape(B * C, W, W), [rows, cols], interp_order)
    sino = vals.sum(dim=2)                                 # (BC, A, n_det)
    return sino.movedim(1, 2).reshape(B, C, W, th.shape[0])


def iradon(sino: torch.Tensor, theta, circle: bool = False, filtered: bool = True,
           out_size: int | None = None, interp_order: int = 1) -> torch.Tensor:
    """(Filtered) backprojection ``(B, C, n_det, n_angles) -> (B, C, W, W)``
    (radon.py:114): each pixel samples every angle's projection at its
    detector coordinate ``x cos - y sin``, on the full padded grid, then the
    crop. The angle axis is an exact index, so the gather interpolates along
    the detector only (JAX's weights on that axis are 1 and 0)."""
    th = torch.deg2rad(torch.as_tensor(theta, dtype=torch.float32, device=sino.device))
    n_det, n_angles = sino.shape[-2:]
    W = n_det
    if out_size is None:
        out_size = W if circle else int(math.floor(math.sqrt(W ** 2 / 2.0)))
    if filtered:
        sino = ramp_filter(sino)
    c = (W - 1) / 2.0
    ax = torch.arange(W, dtype=torch.float32, device=sino.device) - c
    yy, xx = torch.meshgrid(ax, ax, indexing="ij")
    cos, sin = torch.cos(th), torch.sin(th)
    t_pos = (xx[None] * cos[:, None, None] - yy[None] * sin[:, None, None]) + c  # (A, W, W)
    ang = torch.arange(n_angles, device=sino.device)[:, None, None]
    B, C = sino.shape[:2]
    vals = _map_coordinates(sino.reshape(B * C, n_det, n_angles), [t_pos, ang], interp_order)
    out = vals.sum(dim=1).reshape(B, C, W, W)
    if not circle:
        before = W // 2 - out_size // 2
        out = out[..., before:before + out_size, before:before + out_size]
    else:
        out = out * torch.from_numpy(_circle_mask(W)).to(out.device, out.dtype)
        if out_size != W:
            before = (W - out_size) // 2
            out = out[..., before:before + out_size, before:before + out_size]
    return out * math.pi / (2 * n_angles)


def fanbeam(x: torch.Tensor, theta, source_radius: float = 57.5,
            detector_radius: float = 57.5, n_detector_pixels: int = 258,
            detector_spacing: float = 0.077, pixel_spacing: float = None,
            n_steps: int = None, interp_order: int = 1) -> torch.Tensor:
    """Fan-beam projection (radon.py:169): rays from a point source rotating
    with a flat detector array, each clipped to the image's bounding disc and
    sampled at ``n_steps`` points.

    The source lies ``source_radius / pixel_spacing / 2`` pixels from the
    centre (14720 at 256 pixels by default), so where the ray meets the disc
    is a difference of numbers that size: the JAX package solves it in
    float32 and its sinograms move by ~4e-4 of their max with one ulp of an
    angle's sine. The port solves each ray's entry point and chord in
    float64 (from the float32 angles, differentiably) and samples from the
    entry point in the input's dtype.

    :param x: ``(B, C, W, W)`` image; ``pixel_spacing`` defaults to 0.5 / W.
    :returns: sinogram ``(B, C, n_detector_pixels, n_angles)``.
    """
    W = x.shape[-1]
    dev = x.device
    if pixel_spacing is None:
        pixel_spacing = 0.5 / W
    if n_steps is None:
        n_steps = 2 * W
    th = torch.deg2rad(torch.as_tensor(theta, dtype=torch.float32, device=dev).double())
    c = (W - 1) / 2.0
    # world coordinates in pixels
    Rs = source_radius / (pixel_spacing * W) * (W / 2.0)
    Rd = detector_radius / (pixel_spacing * W) * (W / 2.0)
    det = ((torch.arange(n_detector_pixels, device=dev, dtype=torch.float64)
            - (n_detector_pixels - 1) / 2.0) * detector_spacing / (pixel_spacing * W) * (W / 2.0))
    cos, sin = torch.cos(th)[:, None], torch.sin(th)[:, None]
    # the detector cells (det, Rd) and the source (0, -Rs) rotated, as (row, col)
    d_row, d_col = sin * det + cos * Rd, cos * det - sin * Rd          # (A, D)
    s_row, s_col = -cos * Rs, sin * Rs                                 # (A, 1)
    dir_r, dir_c = d_row - s_row, d_col - s_col
    seg = torch.sqrt(dir_r ** 2 + dir_c ** 2).clamp_min(1e-9)
    u_r, u_c = dir_r / seg, dir_c / seg
    r_img = (W / 2.0) * math.sqrt(2.0)
    # |S + t u|^2 = r_img^2 for t along the ray
    b = u_r * s_row + u_c * s_col
    disc = (b ** 2 - ((s_row ** 2 + s_col ** 2) - r_img ** 2)).clamp_min(0.0)
    sq = torch.sqrt(disc)
    t0, t1 = (-b - sq).clamp_min(0.0), (-b + sq).clamp_min(0.0)
    dt = x.dtype
    # the entry point, the chord, and the samples along it
    e_row, e_col = (s_row + t0 * u_r + c).to(dt), (s_col + t0 * u_c + c).to(dt)
    chord = (t1 - t0).to(dt)
    ts = torch.linspace(0.0, 1.0, n_steps, device=dev, dtype=dt)
    tt = ts * chord[..., None]                                         # (A, D, T)
    rows = e_row[..., None] + tt * u_r.to(dt)[..., None]
    cols = e_col[..., None] + tt * u_c.to(dt)[..., None]
    step_len = torch.where(disc > 0, (t1 - t0) / n_steps, torch.zeros_like(t0)).to(dt)
    B, C = x.shape[:2]
    vals = _map_coordinates(x.reshape(B * C, W, W), [rows, cols], interp_order)
    sino = vals.sum(dim=-1) * step_len                                 # (BC, A, D)
    return sino.movedim(1, 2).reshape(B, C, n_detector_pixels, th.shape[0])
