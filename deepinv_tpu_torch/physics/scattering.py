"""Wave scattering (port of deepinv_tpu/physics/scattering.py): 2-D
Helmholtz inverse scattering, the Born linearization and the full
Lippmann-Schwinger model, with the Mie series of a homogeneous cylinder as
the closed-form check.

The Green's functions are built on the host in float64 with
``scipy.special`` (the Vico-Greengard band-limited kernel, applied as a
product on the 2x zero-padded FFT grid). The field solve
``(I - G m) u_sc = G(m v)`` runs on the port's Krylov solvers
(:mod:`~deepinv_tpu_torch.optim.linear`, CG on the normal equations by
default), batched over the images; its backward is one solve of the adjoint
system in a ``torch.autograd.Function`` (:class:`_FieldSolve`), never a
backward through the iterations. The receiver contraction ``(T, R, H, W)``
runs in exact f32 (:func:`~deepinv_tpu_torch.core.exact_f32`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.linalg import exact_f32
from ..device import resolve_device
from ..optim.linear import bicgstab, conjugate_gradient, least_squares
from .base import LinearPhysics, Physics, replace

__all__ = ["BornOperator", "Scattering", "mie_theory", "circular_sensors", "green_function",
           "green_fourier"]


def _special():
    from scipy import special

    return special


# -- the Green's functions (host, float64) ----------------------------------------


def green_function(r, remove_nans: bool = False) -> np.ndarray:
    """The 2-D free-space Green's function ``(i/4) H_0^(1)(r)``
    (scattering.py:79), on the host."""
    out = 0.25j * _special().hankel1(0, np.asarray(r))
    if remove_nans:
        bad = ~np.isfinite(out)
        if bad.any():
            out = np.where(bad, np.max(np.abs(out[~bad]), initial=0.0), out)
    return out


def green_fourier(img_width: int, box_length: float, wavenumber: complex):
    """The band-limited truncated Green's function of Vico et al. in 2-D
    (scattering.py:93): the kernel truncated to a disc of radius ``1.5 L``
    has an entire Fourier transform; sampled on a 4x grid and truncated to
    the 2x domain, its circular convolution on the zero-padded grid is the
    free-space convolution on the box.

    :returns: ``(filter, filterf)``, the spatial kernel and its FFT, each
        ``(1, 2 w, 2 w)`` complex128 numpy.
    """
    sp = _special()
    w = img_width
    n = 4 * w
    freqs = np.fft.fftfreq(n, d=4.0 * box_length / n)
    s = 2.0 * np.pi * np.hypot(freqs[:, None], freqs[None, :])
    k = complex(wavenumber)
    Lt = 1.5 * box_length
    c = 0.5j * np.pi * Lt
    num = 1.0 + c * s * sp.jv(1, Lt * s) * sp.hankel1(0, Lt * k)
    num = num - c * k * sp.jv(0, Lt * s) * sp.hankel1(1, Lt * k)
    den = s ** 2 - k ** 2
    # the pole at s = k is removable: a grid frequency on it takes the limit
    if abs(k.imag) < 1e-12 * max(abs(k), 1.0):
        hit = np.abs(s - k.real) < 1e-8 * max(abs(k), 1.0)
        if hit.any():
            lim = (0.125j * np.pi * Lt ** 2 * (sp.jv(0, Lt * k) * sp.hankel1(0, Lt * k)
                                               + sp.jv(1, Lt * k) * sp.hankel1(1, Lt * k)))
            den = np.where(hit, 1.0, den)
            num = np.where(hit, 2.0 * lim, num)
    filterf = num / den / 2.0
    g = np.fft.fftshift(np.fft.ifft2(filterf, norm="ortho"))[w:3 * w, w:3 * w]
    g = np.fft.ifftshift(g)[None]
    return g, np.fft.fft2(g, norm="ortho")


def _apply_filter(field: torch.Tensor, filterf: torch.Tensor) -> torch.Tensor:
    """``field (..., H, W)`` convolved with a kernel by the product of
    spectra on the 2x zero-padded grid (scattering.py:142)."""
    H, W = field.shape[-2:]
    ph, pw = H // 2, W // 2
    fp = F.pad(field, (pw, W - pw, ph, H - ph))
    out = torch.fft.ifft2(torch.fft.fft2(fp) * filterf)
    return out[..., ph:ph + H, pw:pw + W]


def circular_sensors(number: int, radius: float, max_angle: float = 360.0,
                     offset_angle: float = 0.0):
    """Equispaced sensors on a circle (scattering.py:153).

    :returns: ``(transmitters, receivers)``: positions ``(2, number)`` and the
        leave-one-out receivers ``(2, number, number - 1)``, float32 numpy.
    """
    ang = (np.linspace(0.0, max_angle / 360.0 * 2 * np.pi, number + 1)[:-1]
           + offset_angle / 360.0 * 2 * np.pi)
    tx = np.stack([radius * np.cos(ang), radius * np.sin(ang)])
    idx = np.arange(number)
    others = np.stack([np.concatenate([idx[:t], idx[t + 1:]]) for t in range(number)])
    return tx.astype(np.float32), tx[:, others].astype(np.float32)


def _img_grid(img_width: int, box_length: float):
    """The flattened physical ``(x, y)`` of the image grid, row 0 at the top
    (scattering.py:171)."""
    dom = np.linspace(-box_length / 2, box_length / 2, img_width)
    y, x = np.meshgrid(-dom, dom, indexing="ij")
    return x.ravel(), y.ravel()


def _host(x, dtype=np.float64) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).astype(dtype)


def _incident_field(transmitters, img_width, box_length, wavenumber, wave_type):
    """The incident fields ``(1, T, H, W)`` (scattering.py:179): plane waves
    toward each transmitter, or point sources ``g(k |r - r_t|)``."""
    xg, yg = _img_grid(img_width, box_length)
    tx = _host(transmitters)
    k = complex(wavenumber)
    if wave_type == "plane_wave":
        ang = np.arctan2(tx[1], tx[0])
        field = np.exp(1j * k * (np.cos(ang)[:, None] * xg[None] + np.sin(ang)[:, None] * yg[None]))
    else:
        field = green_function(k * np.hypot(xg[None] - tx[0][:, None], yg[None] - tx[1][:, None]))
    return field.reshape(1, tx.shape[1], img_width, img_width)


def _green_operator(receivers, xg, yg, wavenumber, pixel_area, img_width) -> np.ndarray:
    """The receiver Green's operator ``(T, R, H, W)``: ``k^2 g(k |r_rec -
    r'|)`` times the pixel area (scattering.py:198, :325)."""
    rx = _host(receivers)
    k = complex(wavenumber)
    dist = np.hypot(rx[0][..., None] - _host(xg), rx[1][..., None] - _host(yg))
    op = green_function(k * dist) * (k ** 2) * pixel_area
    return op.reshape(rx.shape[1], rx.shape[2], img_width, img_width)


def _complex(x, device=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x).to(
        device=device, dtype=torch.complex64)


def _as_trx(receivers, n_transmitters) -> np.ndarray:
    """Receivers as ``(2, T, R)``: shared ``(2, R)`` receivers broadcast over
    the transmitters (scattering.py:230)."""
    rx = _host(receivers)
    if rx.ndim == 2:
        rx = np.broadcast_to(rx[:, None, :], (2, n_transmitters, rx.shape[1]))
    return rx


# -- the Born linearization -------------------------------------------------------


class BornOperator(LinearPhysics):
    r"""The first-Born linearized scattering (scattering.py:247):
    ``y = G (x u)``, linear in the potential ``x`` for a known total field
    ``u`` (the incident field under the Born approximation).

    Built from ``total_field`` ``(1 or B, T, H, W)``, ``receivers`` ``(2, R)``
    or ``(2, T, R)``, ``wavenumber``, ``pixel_area`` and ``img_width``, or by
    the shorthand ``BornOperator(img_size=(H, W), n_sources=8,
    n_receivers=16)``: plane waves from equispaced circular sensors at radius
    ``box_length``.

    :param device: where the fields live; the CUDA device by default.
    """

    def __init__(self, total_field=None, receivers=None, x_domain=None, y_domain=None,
                 wavenumber=None, pixel_area=None, img_width: Optional[int] = None,
                 verbose: bool = False, box_length: float = 1.0, img_size=None,
                 n_sources: Optional[int] = None, n_receivers: Optional[int] = None,
                 k0: Optional[float] = None, device=None, **kwargs):
        device = resolve_device(device)
        super().__init__(**kwargs)
        self.verbose = verbose
        if total_field is None:
            if img_width is None:
                img_width = img_size[-1] if img_size is not None else 64
            k = float(k0) if k0 is not None else 2 * math.pi
            tx, _ = circular_sensors(int(n_sources or 8), radius=box_length)
            rxs, _ = circular_sensors(int(n_receivers or 16), radius=box_length)
            rx = _as_trx(rxs, tx.shape[1])
            total_field = _incident_field(tx, img_width, box_length, k, "plane_wave")
            pixel_area = (box_length / img_width) ** 2
        else:
            if pixel_area is None:
                pixel_area = (box_length / img_width) ** 2
            rx = _as_trx(receivers, total_field.shape[1])
            k = complex(wavenumber)
        if x_domain is None or y_domain is None:
            x_domain, y_domain = _img_grid(img_width, box_length)
        self.register_buffer("total_field", _complex(total_field))
        self.register_buffer("green_operator", _complex(
            _green_operator(rx, x_domain, y_domain, k, pixel_area, img_width)))
        self.to(device)

    def A(self, x, **params):
        """``y = G (x u)``, the induced currents contracted against the
        receiver Green's operator (scattering.py:300)."""
        with exact_f32(x.device.type):
            aux = x.to(torch.complex64) * self.total_field
            return torch.einsum("bthw,trhw->btr", aux, self.green_operator)

    def A_adjoint(self, y, **params):
        with exact_f32(y.device.type):
            aux = torch.einsum("btr,trhw->bthw", y.to(torch.complex64),
                               self.green_operator.conj())
        return (self.total_field.conj() * aux).sum(dim=1, keepdim=True)

    def A_dagger(self, y, init=None, solver: str = "lsqr", gamma: float = 1e3,
                 max_iter: int = 100, tol: float = 5e-3, **kwargs):
        """The regularized least-squares inversion (scattering.py:311)."""
        return least_squares(self.A, self.A_adjoint, y, solver=solver, gamma=gamma, init=init,
                             max_iter=max_iter, tol=tol)

    @staticmethod
    def compute_operator(receivers, x_domain, y_domain, wavenumber, pixel_area, img_width,
                         device=None, **_):
        """The Green's function sampled receiver to grid, ``(T, R, H, W)``
        complex64 (scattering.py:325)."""
        return _complex(_green_operator(receivers, x_domain, y_domain, wavenumber,
                                        pixel_area, img_width), resolve_device(device))


# -- the nonlinear model ----------------------------------------------------------


class _FieldSolve(torch.autograd.Function):
    """``u_sc = M(m)^-1 b`` with ``M(m) u = u - G(m u)`` (the
    Lippmann-Schwinger system) and its implicit backward: one solve of the
    adjoint system ``M^H w = g``, then ``db = w`` and ``dm = -(d(M(m) u_sc) /
    dm)^H w`` by one vector-Jacobian product of the matvec at the solution,
    the role of ``lax.custom_linear_solve``'s transposed solve
    (scattering.py:582)."""

    @staticmethod
    def forward(ctx, phys, m, b):
        u = phys._solve(lambda v: phys._matvec(m, v), lambda v: phys._matvec_adj(m, v), b, b)
        ctx.phys = phys
        ctx.save_for_backward(m, u)
        return u

    @staticmethod
    def backward(ctx, g):
        phys = ctx.phys
        m, u = ctx.saved_tensors
        w = phys._solve(lambda v: phys._matvec_adj(m, v), lambda v: phys._matvec(m, v), g, g)
        dm = None
        if ctx.needs_input_grad[1]:
            with torch.enable_grad():
                mv = m.detach().requires_grad_()
                (dm,) = torch.autograd.grad(phys._matvec(mv, u), mv, w)
            dm = -dm
        return None, dm, w


class Scattering(Physics):
    r"""The nonlinear Lippmann-Schwinger scattering (scattering.py:344):
    solves ``u_sc = G(m (u_sc + v))`` for each transmitter, then radiates the
    induced currents to the receivers; ``y`` is ``(B, T, R)`` complex.

    The reference's constructor (``img_width``, ``receivers`` ``(2, R)`` or
    ``(2, T, R)``, ``transmitters`` ``(2, T)``, ``background_wavenumber``,
    ``box_length``, ``wave_type`` ``"circular_wave"`` or ``"plane_wave"``),
    or the shorthand ``Scattering(img_size=(H, W), n_sources=.., n_receivers=..)``
    (plane waves from circular sensors at wavenumber 2 pi).

    :param solver_config: a :class:`Scattering.SolverConfig`: the field
        solve's ``solver`` (``"lsqr"``, CG on the normal equations, the
        default; ``"CG"``; ``"BiCGStab"``), ``max_iter`` and ``tol``.
    :param device: where the fields and kernels live; the CUDA device by
        default.
    """

    @dataclass
    class SolverConfig:
        """The field solve's configuration (scattering.py:451);
        ``adjoint_state`` is kept for the reference's signature: the backward
        is always the implicit adjoint solve."""

        min_iter: int = 1
        max_iter: int = 500
        solver: str = "lsqr"
        tol: float = 1e-5
        green_imaginary_part: float = 0.0
        adjoint_state: bool = True
        verbose: bool = False

    def __init__(self, img_width: Optional[int] = None, receivers=None, transmitters=None,
                 background_wavenumber: Optional[float] = None,
                 solver_config: Optional["Scattering.SolverConfig"] = None,
                 box_length: float = 1.0, wave_type: str = "circular_wave",
                 verbose: bool = False, img_size=None, n_sources: Optional[int] = None,
                 n_receivers: Optional[int] = None, k0: Optional[float] = None,
                 max_iter: Optional[int] = None, tol: Optional[float] = None, device=None,
                 **kwargs):
        device = resolve_device(device)
        super().__init__(**kwargs)
        if wave_type not in ("circular_wave", "plane_wave"):
            raise ValueError('Wave type not recognized, options are "circular_wave" or '
                             '"plane_wave"')
        # a None sentinel, so that the shorthand never overrides a value the
        # caller gave (the reference's default is 10)
        kb_explicit = background_wavenumber is not None
        if k0 is not None:
            background_wavenumber, kb_explicit = float(k0), True
        elif background_wavenumber is None:
            background_wavenumber = 10.0
        if img_width is None:
            img_width = img_size[-1] if img_size is not None else 64
        if transmitters is None:
            wave_type = "plane_wave"
            if not kb_explicit:
                background_wavenumber = 2 * math.pi
            transmitters, _ = circular_sensors(int(n_sources or 8), radius=box_length)
            if receivers is None:
                receivers, _ = circular_sensors(int(n_receivers or 16), radius=box_length)
        if receivers is None:
            raise ValueError("receivers positions are required")
        k = complex(background_wavenumber)
        if 2 * box_length * k.real / (2 * math.pi) > img_width:
            raise ValueError("img_width is too small to sample the background wavenumber: "
                             "need img_width >= 2*k_b*L/(2*pi).")
        if solver_config is None:
            solver_config = self.SolverConfig(max_iter=500 if max_iter is None else int(max_iter),
                                              tol=1e-5 if tol is None else float(tol))
        self.solver_config = solver_config
        self.verbose = bool(verbose)
        self.img_width = int(img_width)
        self.box_length = float(box_length)
        self.pixel_area = (self.box_length / self.img_width) ** 2
        self.wave_type = wave_type
        self._k = k
        self.register_buffer("g_fourier", self._filter(solver_config.green_imaginary_part))
        tx = _host(transmitters)[:2]
        rx = _as_trx(receivers, tx.shape[1])
        self.register_buffer("transmitters", torch.as_tensor(tx, dtype=torch.float32))
        self.register_buffer("receivers", torch.as_tensor(rx.copy(), dtype=torch.float32))
        self.register_buffer("incident_field", _complex(
            _incident_field(tx, self.img_width, self.box_length, k, wave_type)))
        self.born_operator = BornOperator(total_field=self.incident_field, receivers=rx,
                                          wavenumber=k, pixel_area=self.pixel_area,
                                          img_width=self.img_width, box_length=self.box_length,
                                          verbose=verbose, device=device)
        self.to(device)

    def _filter(self, green_imaginary_part: float) -> torch.Tensor:
        k_green = complex(np.sqrt(self._k ** 2 + 1j * green_imaginary_part))
        return _complex(green_fourier(self.img_width, self.box_length, k_green)[1])

    @property
    def ls_max_iter(self) -> int:
        return int(self.solver_config.max_iter)

    @property
    def ls_tol(self) -> float:
        return float(self.solver_config.tol)

    @property
    def wavenumber(self) -> complex:
        return self._k

    def set_solver(self, solver_config: "Scattering.SolverConfig"):
        """Set the field solve's configuration (scattering.py:468), the
        Green's filter rebuilt if ``green_imaginary_part`` changed."""
        if solver_config.green_imaginary_part != self.solver_config.green_imaginary_part:
            self.g_fourier = self._filter(solver_config.green_imaginary_part).to(
                self.g_fourier.device)
        self.solver_config = solver_config
        return self

    def set_verbose(self, verbose: bool):
        """Verbosity (scattering.py:482)."""
        self.verbose = self.born_operator.verbose = bool(verbose)
        return self

    def get_img_grid(self, dtype=torch.float32):
        """The image grid's flattened physical ``(x, y)`` (scattering.py:488)."""
        xg, yg = _img_grid(self.img_width, self.box_length)
        return torch.as_tensor(xg, dtype=dtype), torch.as_tensor(yg, dtype=dtype)

    def generate_incident_field(self):
        """The incident fields ``(1, T, H, W)`` from the stored transmitters
        (scattering.py:495)."""
        return _complex(_incident_field(self.transmitters, self.img_width, self.box_length,
                                        self._k, self.wave_type), self.incident_field.device)

    def update_parameters(self, receivers=None, transmitters=None, **kwargs):
        """A physics with new sensor positions, its incident field and
        receiver operator rebuilt on the host (scattering.py:503); other
        keywords go to :meth:`update`."""
        phys = self.update(**kwargs) if kwargs else self
        if transmitters is None and receivers is None:
            return phys
        dev = phys.incident_field.device
        tx = _host(transmitters if transmitters is not None else phys.transmitters)
        rx = _as_trx(receivers if receivers is not None else phys.receivers, tx.shape[1])
        inc = _incident_field(tx, phys.img_width, phys.box_length, phys._k, phys.wave_type)
        born = BornOperator(total_field=inc, receivers=rx, wavenumber=phys._k,
                            pixel_area=phys.pixel_area, img_width=phys.img_width,
                            box_length=phys.box_length, verbose=phys.verbose, device=dev)
        return replace(phys, transmitters=torch.as_tensor(tx, dtype=torch.float32).to(dev),
                       receivers=torch.as_tensor(rx.copy(), dtype=torch.float32).to(dev),
                       incident_field=born.total_field, born_operator=born)

    # -- the field solve ---------------------------------------------------------

    def _apply_G(self, f):
        return _apply_filter(f, self.g_fourier)

    def _matvec(self, m, u):
        """``M(m) u = u - G(m u)``."""
        return u - self._apply_G(m * u)

    def _matvec_adj(self, m, v):
        """``M(m)^H v = v - conj(m) G^H v``; ``G^H`` is the filter's
        conjugate on the same grid."""
        return v - m.conj() * _apply_filter(v, self.g_fourier.conj())

    def _solve(self, matvec, matvec_adj, b, x0):
        """A Krylov solve of ``matvec(u) = b`` from ``x0`` by
        ``solver_config.solver`` (scattering.py:536): ``"lsqr"`` (and any
        other name) is CG on the normal equations, ``"BiCGStab"`` and
        ``"CG"`` run on the system itself."""
        name = self.solver_config.solver.lower()
        kw = dict(init=x0, max_iter=self.ls_max_iter, tol=self.ls_tol)
        if name == "bicgstab":
            return bicgstab(matvec, b, **kw)
        if name == "cg":
            return conjugate_gradient(matvec, b, **kw)
        return conjugate_gradient(lambda u: matvec_adj(matvec(u)), matvec_adj(b), **kw)

    def _potential(self, x):
        c = x[:, 0] if x.dim() == 4 else x
        return ((self._k ** 2) * c.to(torch.complex64))[:, None]

    def compute_total_field(self, x, init=None, **kwargs):
        """The total field ``u (B, T, H, W)`` from the Lippmann-Schwinger
        system ``(I - G m) u_sc = G(m v)`` (scattering.py:557). From a warm
        start ``init`` the solve is a plain one; otherwise gradients take the
        implicit backward of :class:`_FieldSolve`."""
        m = self._potential(x)
        u_inc = self.incident_field
        b = self._apply_G(m * u_inc)
        if init is not None:
            x0 = torch.as_tensor(init).to(b.dtype).broadcast_to(b.shape) - u_inc
            return self._solve(lambda v: self._matvec(m, v), lambda v: self._matvec_adj(m, v),
                               b, x0) + u_inc
        return _FieldSolve.apply(self, m, b) + u_inc

    def compute_field_out(self, x, total_field):
        """The receiver samples ``y = G (x u)`` of the field the induced
        currents radiate (scattering.py:590)."""
        return replace(self.born_operator, total_field=total_field).A(x)

    def A(self, x, receivers=None, transmitters=None, **params):
        phys = self.update_parameters(receivers=receivers, transmitters=transmitters)
        return phys.compute_field_out(x, phys.compute_total_field(x))

    def A_jvp(self, x, v):
        """``(dA/dx) v`` at ``x`` by the tangent solve ``M du = G(k^2 v u)``
        (the derivative of ``M u_sc = b`` at the solution), then the product
        rule through ``G_rx (x u)``."""
        u = self.compute_total_field(x).detach()
        dm = self._potential(v)
        du = self._solve(lambda w: self._matvec(self._potential(x), w),
                         lambda w: self._matvec_adj(self._potential(x), w),
                         self._apply_G(dm * u), torch.zeros_like(u))
        born = self.born_operator
        return replace(born, total_field=u).A(v) + replace(born, total_field=du).A(x)

    def A_dagger(self, y, linear: bool = False, x_init=None, max_iter: int = 2,
                 use_init: bool = True, rel_tol: float = 1e-3, **kwargs):
        """The pseudo-inverse (scattering.py:600): the Born inversion when
        ``linear``, else total-field solves alternating with linearized
        potential updates, until the relative change is below ``rel_tol``."""
        if linear:
            max_iter = 1
        B = y.shape[0]
        inc = self.incident_field
        x = x_init if x_init is not None else torch.full(
            (B, 1, self.img_width, self.img_width), 0.05, dtype=inc.dtype, device=inc.device)
        total_field = inc if use_init else None
        for _ in range(int(max_iter)):
            prev = x
            if linear:
                total_field = inc.broadcast_to((B,) + inc.shape[1:])
            else:
                total_field = self.compute_total_field(x, init=total_field if use_init else None)
            born = replace(self.born_operator, total_field=total_field)
            x = born.A_dagger(y, init=x if use_init else None)
            rel = (((x - prev).abs() ** 2).mean()
                   / ((prev.abs() ** 2).mean()).clamp_min(1e-30))
            if float(rel) < rel_tol:
                break
        return x

    def normalize(self, x):
        """Divide the incident field (and a Gaussian noise's sigma) by the
        Jacobian's spectral norm at ``x`` (scattering.py:631)."""
        norm = torch.sqrt(self.compute_norm(x))
        self.incident_field = self.incident_field / norm
        self.born_operator = replace(self.born_operator,
                                     total_field=self.born_operator.total_field / norm)
        nm = self.noise_model
        if nm is not None and hasattr(nm, "sigma"):
            self.noise_model = nm.update(sigma=nm.sigma / norm)
        return self


# -- the closed-form check: the Mie series of a homogeneous cylinder --------------


def mie_theory(wavenumber, cylinder_radius: float, cylinder_contrast: float, img_width: int,
               angles, wave_type: str = "plane_wave", box_length: float = 1.0,
               n_coeffs: int = 70, transmitter_radius: float = 1.0, device=None, **_):
    r"""The closed-form total field of a homogeneous cylinder on the image
    grid (scattering.py:650), the Lippmann-Schwinger solver's oracle: the
    incident field in cylindrical harmonics, continuity of the field and of
    its radial derivative at ``r = a``, interior index
    ``eta = sqrt(1 + contrast)``. Computed on the host in complex128.

    :param angles: the incident waves' angles ``(P,)`` in radians.
    :param device: where the fields are returned; the CUDA device by default.
    :returns: ``(total_field, incident_field)``, each ``(1, P, img_width,
        img_width)`` complex64.
    """
    device = resolve_device(device)
    sp = _special()
    k = complex(wavenumber)
    a = float(cylinder_radius)
    eta = np.sqrt(1.0 + cylinder_contrast + 0j)
    grid = np.linspace(-box_length / 2, box_length / 2, img_width)
    yy, xx = np.meshgrid(-grid, grid, indexing="ij")
    r = np.hypot(xx, yy).ravel()
    th = np.arctan2(yy, xx).ravel()
    inside = r < a
    ns = np.arange(-(n_coeffs - 1), n_coeffs)

    def dJ(n, z):
        return 0.5 * (sp.jv(n - 1, z) - sp.jv(n + 1, z))

    def dH(n, z):
        return 0.5 * (sp.hankel1(n - 1, z) - sp.hankel1(n + 1, z))

    Ji, Jip = sp.jv(ns, eta * k * a), dJ(ns, eta * k * a)
    Jo, Jop = sp.jv(ns, k * a), dJ(ns, k * a)
    H, Hp = sp.hankel1(ns, k * a), dH(ns, k * a)
    den = Ji * Hp - eta * Jip * H
    Rn = (eta * Jip * Jo - Ji * Jop) / den
    Tn = (2j / (np.pi * k * a)) / den
    ang = _host(angles).ravel()
    if wave_type == "plane_wave":
        cn = (1j) ** ns
    elif wave_type == "circular_wave":
        cn = 0.25j * sp.hankel1(ns, k * transmitter_radius)
        cn = np.where(np.isfinite(cn), cn, 0.0)
    else:
        raise ValueError(f"Wave type {wave_type} not supported, please choose 'plane_wave' or "
                         "'circular_wave'")
    cpn = cn[None, :] * np.exp(-1j * np.outer(ang, ns))
    harm = np.exp(1j * np.outer(ns, th))
    J_out = sp.jv(ns[:, None], k * r[None, :])
    H_out = np.where(~inside[None, :],
                     sp.hankel1(ns[:, None], k * np.where(inside, a, r)[None, :]), 0.0)
    J_in = np.where(inside[None, :], sp.jv(ns[:, None], eta * k * r[None, :]), 0.0)

    def clean(v):
        return np.where(np.isfinite(v), v, 0.0)

    inc_modes = clean(J_out * harm)
    total = cpn @ (inc_modes * (~inside)[None, :] + clean(Rn[:, None] * H_out * harm)
                   + clean(Tn[:, None] * J_in * harm))
    shape = (1, ang.shape[0], img_width, img_width)
    return (_complex(total.reshape(shape), device),
            _complex((cpn @ inc_modes).reshape(shape), device))
