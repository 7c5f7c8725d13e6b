"""Chambolle total-variation prox (port of deepinv_tpu/ops/pallas/tv.py).

``chambolle_prox(x, gamma, n_iter)`` is the isotropic-TV prox
``argmin_u 0.5 ||u - x||^2 + gamma TV(u)`` by Chambolle's dual projection, per
``(H, W)`` plane, with ``tau = 0.25``::

    p <- (p + tau grad u) / (1 + tau |grad u|),   u = div p - x / gamma
    out = x - gamma div p

the contract of the Pallas kernel ``_kernel`` (tv.py:53, launched by
``_pallas_impl`` :70) and of its XLA twin ``_xla_impl`` (:88).

- On a CUDA tensor it launches a hand-written kernel of
  ``deepinv_tpu_torch/csrc/tv_prox.cu`` (the source says what bounds it and
  how it is laid out), or raises: there is no fallback. The kernel takes
  float32 only. :func:`tv_plan` picks its variant from the plane's shape:
  the resident one (the whole prox in one launch, each plane held in the
  shared memory of one thread-block cluster) wherever a cluster holds the
  plane, else the global one (``n_iter + 1`` launches over dual fields in
  device memory).
- On a CPU tensor it runs :func:`chambolle_prox_plain`, the plain PyTorch
  version of ``_xla_impl`` with its safe norm.
- ``gamma`` is a scalar or a tensor that broadcasts against ``x`` and is
  constant over each plane, such as a per-sample ``(B, 1, 1, 1)``. The kernel
  reads one value per plane from device memory, so a per-sample gamma runs in
  the kernel too; the JAX package sends it to the XLA loop (tv.py:104-113).
  A gamma on the device stays there: nothing is read back to the host.
- The gradient (in ``x`` and in a tensor ``gamma``) is autograd of the plain
  version, as the JAX ``custom_vjp`` backward re-runs ``_xla_impl``
  (tv.py:124-132).

``profiling.counters["kernel.chambolle_prox.launches"]`` counts the calls
that reach the kernel (one C call each), and
``kernel.chambolle_prox.launches.<variant>`` the same calls by variant
(``resident``, ``global``), so a run can show that its main path went
through the kernel, and through which. Each call opens the span
``dinv.kernel.chambolle_prox`` with its analytic cost
(:func:`chambolle_prox_cost`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from ...utils.profiling import counters, kernel_span
from .resblock_chain import first_order_only

__all__ = ["chambolle_prox", "chambolle_prox_plain", "chambolle_prox_cost", "grad_op", "div_op",
           "fwd_diff_nd", "fwd_diff_nd_adjoint", "TAU", "TVPlan", "tv_plan"]

TAU = 0.25  # 1 / (2 * dim), Chambolle's stability bound (tv.py:30)

# the global variant's grid (csrc/tv_prox.cu): tiles of 16 x 32 pixels, planes on z
_TILE_H, _MAX_GRID_Y = 16, 65535
# the resident variant (tv_resident in csrc/tv_prox.cu): the cluster sizes it
# may take (16 is non-portable), the H100's SMs, the shared memory one block
# may use there (227 KB), the pixels a CTA should hold by default, and the rows a warp
# may walk with the most threads a CTA may then have (a longer walk holds more
# registers; max_threads in csrc/tv_prox.cu states the same limits)
CLUSTER_SIZES = (1, 2, 4, 8, 16)
SMS = 132
SMEM_MAX = 232_448
TARGET_PIXELS = 8192
_SEG_THREADS = {2: 1024, 4: 1024, 8: 1024, 16: 640, 32: 576}


def fwd_diff_nd(x: torch.Tensor, first_axis: int) -> torch.Tensor:
    """Forward differences along each axis from ``first_axis`` on, stacked on
    a new last axis, zero at the trailing edge (``_fwd_diff_nd``,
    deepinv_tpu/models/classic.py:29)."""
    comps = [torch.diff(x, dim=d, append=x.narrow(d, x.shape[d] - 1, 1))
             for d in range(first_axis, x.dim())]
    return torch.stack(comps, dim=-1)


def fwd_diff_nd_adjoint(u: torch.Tensor, first_axis: int) -> torch.Tensor:
    """Adjoint of :func:`fwd_diff_nd`: ``u[i-1] (i > 0) - u[i] (i < n-1)``
    along each axis, summed over the components (the JAX package takes it
    with ``jax.linear_transpose``, classic.py:52-59)."""
    out = None
    for k, d in enumerate(range(first_axis, u.dim() - 1)):
        c = u[..., k]
        head = c.narrow(d, 0, c.shape[d] - 1)
        z = torch.zeros_like(c.narrow(d, 0, 1))
        term = torch.cat([z, head], dim=d) - torch.cat([head, z], dim=d)
        out = term if out is None else out + term
    return out


def grad_op(x: torch.Tensor) -> torch.Tensor:
    """Forward-difference gradient over the last two axes,
    ``(..., H, W) -> (..., H, W, 2)`` (``_grad_op``, optim/prior.py:171)."""
    return fwd_diff_nd(x, x.dim() - 2)


def div_op(p: torch.Tensor) -> torch.Tensor:
    """Divergence, the negative adjoint of :func:`grad_op`
    (``_div_op``, optim/prior.py:178)."""
    return -fwd_diff_nd_adjoint(p, p.dim() - 3)


def _gamma_tensor(gamma, x: torch.Tensor) -> torch.Tensor:
    """``gamma`` as a tensor on ``x``'s device, without a host round trip:
    a Python number is filled on the device, a tensor is moved if needed."""
    if isinstance(gamma, torch.Tensor):
        return gamma.to(device=x.device, dtype=x.dtype)
    return torch.full((), float(gamma), dtype=x.dtype, device=x.device)


def chambolle_prox_plain(x: torch.Tensor, gamma, n_iter: int = 100) -> torch.Tensor:
    """Plain PyTorch version (``_xla_impl``, tv.py:88-101), differentiable by
    autograd. The norm is gated at 0, where ``sqrt`` has no derivative (the
    structural zeros at the image border), as the JAX package does."""
    g = _gamma_tensor(gamma, x)
    xg = x / g
    p = x.new_zeros(x.shape + (2,))
    for _ in range(n_iter):
        e = grad_op(div_op(p) - xg)
        s = (e * e).sum(-1, keepdim=True)
        pos = s > 0
        norm = torch.where(pos, torch.sqrt(torch.where(pos, s, torch.ones_like(s))),
                           torch.zeros_like(s))
        p = (p + TAU * e) / (1 + TAU * norm)
    return x - g * div_op(p)


def _plane_gamma(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One float32 gamma per ``(H, W)`` plane of ``x``, as a 1-D tensor on
    the device that is contiguous, or a stride-0 view of one value (no copy
    for a scalar gamma); raises unless ``g`` broadcasts to ``x`` and is
    constant over each plane."""
    if g.dim() > x.dim() or (g.dim() >= 1 and g.shape[-1] != 1) or (
            g.dim() >= 2 and g.shape[-2] != 1):
        raise ValueError(f"chambolle_prox: gamma of shape {tuple(g.shape)} must be a scalar or "
                         f"constant over each plane of x {tuple(x.shape)}, e.g. (B, 1, 1, 1)")
    try:
        planes = torch.broadcast_to(g, x.shape[:-2] + (1, 1))
    except RuntimeError as err:
        raise ValueError(f"chambolle_prox: gamma of shape {tuple(g.shape)} does not broadcast "
                         f"to x {tuple(x.shape)}") from err
    if g.numel() == 1:
        return g.reshape(1).to(torch.float32).expand(planes.numel())
    return planes.reshape(-1).to(torch.float32).contiguous()


@dataclass(frozen=True)
class TVPlan:
    """How the kernel runs a plane of one shape. ``variant`` is
    ``"resident"`` (one launch a prox: a cluster of ``cluster`` CTAs a plane,
    CTA k owning rows ``[k band, (k+1) band)``, a warp ``seg`` rows of them,
    ``threads`` threads and ``smem`` bytes of dynamic shared memory a CTA) or
    ``"global"`` (``n_iter + 1`` launches over dual fields in device memory;
    the other fields are 0)."""

    variant: str
    cluster: int = 0
    band: int = 0
    seg: int = 0
    threads: int = 0
    smem: int = 0


def _resident_plan(H: int, W: int, cluster: int) -> TVPlan | None:
    """The resident variant's layout for an ``(H, W)`` plane in a cluster of
    ``cluster`` CTAs, or None where it cannot hold the plane. A warp owns 31
    columns and ``seg`` rows (2, 4, 8, 16 or 32; the smallest whose warps fit
    the CTA: ``_SEG_THREADS``); the band must not be empty, and xg, ph, pw of
    the band with 7 halo rows (4 bytes each) must fit the shared memory a
    block may use (``tv_resident`` in csrc/tv_prox.cu)."""
    band = -(-H // cluster)
    chunks = -(-W // 31)
    smem = 4 * (3 * band + 7) * W
    if (cluster - 1) * band >= H or smem > SMEM_MAX:
        return None
    for seg, limit in _SEG_THREADS.items():
        threads = 32 * chunks * -(-band // seg)
        if threads <= limit:
            return TVPlan("resident", cluster, band, seg, threads, smem)
    return None


@functools.lru_cache(maxsize=None)
def tv_plan(H: int, W: int, variant: str | None = None, cluster: int | None = None,
            planes: int = 1) -> TVPlan:
    """The variant and layout the kernel uses for ``planes`` planes of
    ``(H, W)``.

    The variant follows from the plane's shape: the resident one where a
    cluster of up to 16 CTAs holds the plane, else the global one (1024^2).
    The cluster size, by default: the smallest of ``CLUSTER_SIZES`` whose
    CTAs hold at most ``TARGET_PIXELS`` pixels each (or the largest that
    holds the plane), then doubled while the planes, at one CTA an SM, still
    fit the card's ``SMS`` SMs at once: a 37x53 plane takes 1 CTA, a 256^2
    plane 8 and, up to 8 planes, 16; 512^2 takes 16. ``variant`` and
    ``cluster`` force a choice, and raise ``ValueError`` where it cannot hold
    the plane.
    """
    if variant not in (None, "resident", "global"):
        raise ValueError(f"chambolle_prox: unknown variant {variant!r}")
    if cluster is not None and cluster not in CLUSTER_SIZES:
        raise ValueError(f"chambolle_prox: cluster size {cluster} not in {CLUSTER_SIZES}")
    if variant == "global":
        if cluster is not None:
            raise ValueError("chambolle_prox: the global variant takes no cluster size")
        return TVPlan("global")
    if cluster is not None:
        plan = _resident_plan(H, W, cluster)
        if plan is None:
            raise ValueError(f"chambolle_prox: a cluster of {cluster} cannot hold a {H}x{W} "
                             f"plane")
        return plan
    fits = [p for p in (_resident_plan(H, W, c) for c in CLUSTER_SIZES) if p is not None]
    if not fits:
        if variant == "resident":
            raise ValueError(f"chambolle_prox: no cluster holds a {H}x{W} plane")
        return TVPlan("global")
    k = next((k for k, p in enumerate(fits) if p.band * W <= TARGET_PIXELS), len(fits) - 1)
    while k + 1 < len(fits) and planes * fits[k + 1].cluster <= SMS:
        k += 1
    return fits[k]


def _check_cuda(x: torch.Tensor, g: torch.Tensor, n_iter: int, variant: str | None = None,
                cluster: int | None = None) -> torch.Tensor:
    """Raise on what the kernel does not take (and on a forced ``variant`` or
    ``cluster`` that cannot hold the plane); return the per-plane gamma."""
    if x.dtype != torch.float32:
        raise TypeError(f"chambolle_prox kernel takes float32, got {x.dtype}")
    if x.dim() < 2 or x.numel() == 0:
        raise ValueError(f"chambolle_prox kernel takes (..., H, W) with H, W >= 1, "
                         f"got {tuple(x.shape)}")
    if n_iter < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter}")
    H, W = x.shape[-2:]
    if tv_plan(H, W, variant, cluster).variant == "global" and -(-H // _TILE_H) > _MAX_GRID_Y:
        raise ValueError(f"chambolle_prox kernel takes H <= {_TILE_H * _MAX_GRID_Y}, "
                         f"got {H}")
    return _plane_gamma(g, x)


@functools.lru_cache(maxsize=None)
def _resident_clusters(plan: TVPlan) -> int:
    """How many clusters of the resident layout ``plan`` the card can hold at
    once; raises if none (a resident launch would fail: nothing falls back)."""
    from .build import load_library

    lib = load_library()
    cluster, threads, smem = plan.cluster, plan.threads, plan.smem
    count = lib.deepinv_tv_resident_max_clusters(cluster, plan.seg, threads, smem)
    if count <= 0:
        why = (f"CUDA error {-count} ({lib.deepinv_cuda_error_string(-count).decode()})"
               if count < 0 else "0 clusters fit")
        raise RuntimeError(f"chambolle_prox: the device cannot hold a cluster of {cluster} "
                           f"CTAs of {threads} threads and {smem} bytes of shared memory: "
                           f"{why}")
    return count


def _launch(x: torch.Tensor, g: torch.Tensor, n_iter: int, variant: str | None = None,
            cluster: int | None = None) -> torch.Tensor:
    """Run the CUDA kernel in the plan's variant (``variant`` and ``cluster``
    force one: the smoke times both on the same inputs): one resident launch,
    or ``n_iter`` global steps over a ping-pong pair of dual fields and the
    output, in one C call."""
    from .build import load_library

    gp = _check_cuda(x, g, n_iter, variant, cluster)
    H, W = x.shape[-2:]
    xc = x.contiguous()
    N = xc.numel() // (H * W)
    plan = tv_plan(H, W, variant, cluster, N)
    out = torch.empty_like(xc)
    lib = load_library()
    p = ctypes.c_void_p
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if plan.variant == "resident":
            _resident_clusters(plan)
            rc = lib.deepinv_tv_prox_resident_f32(
                p(xc.data_ptr()), p(gp.data_ptr()), gp.stride(0), p(out.data_ptr()), N, H, W,
                int(n_iter), plan.cluster, plan.band, plan.seg, plan.threads, plan.smem,
                p(stream))
        else:
            # [buffer][component][plane, H, W]; buffer 0 holds the initial p = 0
            state = torch.empty((2, 2) + (N, H, W), dtype=torch.float32, device=x.device)
            state[0].zero_()
            rc = lib.deepinv_tv_prox_f32(
                p(xc.data_ptr()), p(gp.data_ptr()), gp.stride(0), p(state.data_ptr()),
                p(out.data_ptr()), N, H, W, int(n_iter), p(stream))
    if rc != 0:
        msg = lib.deepinv_cuda_error_string(rc).decode()
        raise RuntimeError(f"chambolle_prox kernel launch failed ({plan.variant} variant): "
                           f"CUDA error {rc} ({msg})")
    counters["kernel.chambolle_prox.launches"] += 1
    counters[f"kernel.chambolle_prox.launches.{plan.variant}"] += 1
    return out


class _ChambolleProx(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, n_iter):
        ctx.save_for_backward(x, g)
        ctx.n_iter = n_iter
        if x.is_cuda:
            return _launch(x, g, n_iter)
        return chambolle_prox_plain(x, g, n_iter)

    @staticmethod
    def backward(ctx, ct):
        """Autodiff of the plain prox on detached copies; no second derivative
        (:func:`~.resblock_chain.first_order_only`)."""
        x, g = ctx.saved_tensors
        with torch.enable_grad():
            xv, gv = x.detach().requires_grad_(), g.detach().requires_grad_()
            out = chambolle_prox_plain(xv, gv, ctx.n_iter)
            gx, gg = torch.autograd.grad(out, (xv, gv), ct.detach())
        return (*first_order_only("chambolle_prox", (gx, gg), (ct, x, g)), None)


def chambolle_prox(x: torch.Tensor, gamma, n_iter: int = 100) -> torch.Tensor:
    """Isotropic-TV prox of ``gamma * TV`` at ``x`` by ``n_iter`` Chambolle
    steps.

    :param x: ``(..., H, W)`` images; float32 on the GPU.
    :param gamma: a number, or a tensor that broadcasts to ``x`` and is
        constant over each ``(H, W)`` plane (a scalar, ``(B, 1, 1, 1)``).
    :param n_iter: dual iterations.
    :return: a tensor shaped like ``x``.
    """
    with kernel_span("chambolle_prox", *chambolle_prox_cost(x.shape, n_iter)):
        return _ChambolleProx.apply(x, _gamma_tensor(gamma, x), int(n_iter))


def chambolle_prox_cost(shape, n_iter: int):
    """Analytic (flops, HBM bytes) of the prox on ``shape`` ``(..., H, W)``:
    18 operations a pixel a dual step (the gradient, the norm, the dual
    update, the divergence) and 5 for the output; the images read and the
    result written once in f32, one gamma a plane."""
    pixels = math.prod(shape)
    planes = pixels // (shape[-2] * shape[-1])
    return pixels * (18 * int(n_iter) + 5), 2 * pixels * 4 + planes * 4
