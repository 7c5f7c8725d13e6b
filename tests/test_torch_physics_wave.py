"""The port's radio interferometry, phase retrieval, PET and wave
scattering against the JAX package's, on the CPU.

Inputs come from numpy seeds; random tables (the phase-retrieval matrix and
diagonals, the spectral method's start, PET's power-method start) are drawn
by JAX and handed to the port. Bounds, f32, max abs error over the
reference's max: the operators within 1e-5, or 1e-4 where a NUFFT (planned
in float64 here, in float32 in JAX), an iterative solve or a power method
sits inside; adjointness within 1e-5 of ``||Ax|| ||y||``; ``osem`` within
1e-4; the Lippmann-Schwinger field and its implicit gradient within 1e-4.
The Mie check holds the JAX test's bounds (``tests/test_physics.py:763-792``:
relative error below 0.08, and below 0.62x on a 2x refinement) at 32² and
64², where the wavenumber is 10 (the JAX test's 20 at 96² and 192² keeps
three times as many pixels a wavelength; the card runs that one).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepinv_tpu.physics as J
import deepinv_tpu_torch.physics as T
from test_torch_physics_operators import KRYLOV, _close, _rel, _t

jpr = importlib.import_module("deepinv_tpu.physics.phase_retrieval")
tpr = importlib.import_module("deepinv_tpu_torch.physics.phase_retrieval")
jsc = importlib.import_module("deepinv_tpu.physics.scattering")
tsc = importlib.import_module("deepinv_tpu_torch.physics.scattering")

DEV = "cpu"
KEY = jax.random.key


def _gap(A, At, x, y, real=False):
    """``|<A x, y> - <x, A^H y>| / (||A x|| ||y||)``; with ``real`` the real
    part of the pairing, that of an operator from real images to complex
    measurements."""
    Ax, Aty = A(x), At(y)
    lhs = torch.vdot(Ax.flatten(), y.flatten().to(Ax.dtype))
    rhs = torch.vdot(x.flatten().to(Aty.dtype), Aty.flatten())
    d = complex(lhs - rhs)
    return abs(d.real if real else d) / (float(Ax.norm()) * float(y.norm()))


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


# -- radio interferometry -----------------------------------------------------------


@pytest.mark.parametrize("fast_normal", [True, False])
def test_radio_interferometry_matches_jax(fast_normal):
    """120 visibilities of the demo's law (normal, sigma pi/3, clipped to
    0.95 pi) on 16² skies: ``A``, ``A_adjoint``, the Toeplitz ``A_adjoint_A``
    and the CG ``prox_l2``; ``setWeight``."""
    rng = np.random.default_rng(0)
    uv = np.clip(rng.normal(0, np.pi / 3, (2, 120)), -0.95 * np.pi, 0.95 * np.pi).astype(
        np.float32)
    jp = J.RadioInterferometry((16, 16), uv, fast_normal=fast_normal)
    tp = T.RadioInterferometry((16, 16), uv, fast_normal=fast_normal, device=DEV)
    x = rng.random((2, 1, 16, 16)).astype(np.float32)
    y = np.asarray(jp.A(jnp.asarray(x))) + 0.05 * _cplx(rng, (2, 1, 120))
    with torch.no_grad():
        _close(tp.A(_t(x)), jp.A(jnp.asarray(x)), 1e-4)
        _close(tp.A_adjoint(_t(y)), jp.A_adjoint(jnp.asarray(y)), 1e-4)
        _close(tp.A_adjoint_A(_t(x)), jp.A_adjoint_A(jnp.asarray(x)), 1e-4)
        z = rng.random(x.shape).astype(np.float32)
        _close(tp.prox_l2(_t(z), _t(y), 0.5, **KRYLOV),
               jp.prox_l2(jnp.asarray(z), jnp.asarray(y), 0.5, **KRYLOV), 1e-4)
        assert _gap(tp.A, tp.A_adjoint, _t(x), _t(y), real=True) <= 1e-5
        w = rng.random(120).astype(np.float32) + 0.5
        tw, jw = tp.setWeight(w), jp.setWeight(jnp.asarray(w))
        _close(tw.A(_t(x)), jw.A(jnp.asarray(x)), 1e-4)
        _close(tw.A_adjoint(_t(y)), jw.A_adjoint(jnp.asarray(y)), 1e-4)
        # the port's Toeplitz spectrum follows the new weights (JAX keeps the old)
        assert _rel(tw.A_adjoint_A(_t(x)), tw.A_adjoint(tw.A(_t(x)))) <= 5e-3
        assert torch.equal(tp.A(_t(x)), tp.A(_t(x)))   # the original is left as it was


# -- phase retrieval ----------------------------------------------------------------


def test_random_phase_retrieval_matches_jax():
    """``|Bx|^2``, its vector-Jacobian product, ``B``'s adjoint and Krylov
    pseudo-inverse, ``E|B_ij|^2`` and the spectral method from JAX's start."""
    rng = np.random.default_rng(1)
    jp = J.RandomPhaseRetrieval(m=300, img_size=(1, 8, 8), key=KEY(1))
    tp = T.RandomPhaseRetrieval(m=300, img_size=(1, 8, 8), matrix=np.asarray(jp.B.mat),
                                device=DEV)
    x = _cplx(rng, (2, 1, 8, 8))
    v = rng.random((2, 300)).astype(np.float32)
    y = np.asarray(jp.A(jnp.asarray(x)))
    _close(tp.A(_t(x)), y, 1e-5)
    _close(tp.A_vjp(_t(x), _t(v)), jp.A_vjp(jnp.asarray(x), jnp.asarray(v)), 1e-5)
    _close(tp.A_adjoint(_t(y)), jp.A_adjoint(jnp.asarray(y)), 1e-5)
    yb = np.asarray(jp.B.A(jnp.asarray(x)))
    _close(tp.B_dagger(_t(yb), **KRYLOV), jp.B_dagger(jnp.asarray(yb), **KRYLOV), 1e-4)
    assert _gap(tp.B.A, tp.B.A_adjoint, _t(x), _t(yb)) <= 1e-5
    assert abs(float(tp.get_A_squared_mean()) - float(jp.get_A_squared_mean())) <= 1e-6
    x0 = np.asarray(jax.random.normal(KEY(23), x.shape))
    got = tpr.spectral_methods(_t(y), tp, x=_t(x0), n_iter=30)
    want = jpr.spectral_methods(jnp.asarray(y), jp, x=jnp.asarray(x0), n_iter=30)
    _close(got, want, 1e-4)
    cos = float(tpr.cosine_similarity(tpr.correct_global_phase(got, _t(x)), _t(x)))
    assert cos == pytest.approx(float(jpr.cosine_similarity(
        jpr.correct_global_phase(want, jnp.asarray(x)), jnp.asarray(x))), abs=1e-5)
    assert cos > 0.5     # 300 measurements of a 64-pixel image: the start is informative


@pytest.mark.parametrize("out", [(1, 10, 12), (1, 20, 24)])
def test_structured_random_phase_retrieval_matches_jax(out):
    """Cropped and zero-padded (oversampled) outputs, two phase layers."""
    rng = np.random.default_rng(2)
    jp = J.StructuredRandomPhaseRetrieval((1, 14, 16), out, n_layers=2, key=KEY(2))
    tp = T.StructuredRandomPhaseRetrieval((1, 14, 16), out, n_layers=2, device=DEV,
                                          diagonals=[np.asarray(d) for d in jp.diagonals])
    x = _cplx(rng, (2, 1, 14, 16))
    v = rng.random((2,) + out).astype(np.float32)
    _close(tp.A(_t(x)), jp.A(jnp.asarray(x)), 1e-5)
    _close(tp.A_vjp(_t(x), _t(v)), jp.A_vjp(jnp.asarray(x), jnp.asarray(v)), 1e-5)
    yb = _cplx(rng, (2,) + out)
    _close(tp.B_adjoint(_t(yb)), jp.B_adjoint(jnp.asarray(yb)), 1e-5)
    assert _gap(tp.B.A, tp.B.A_adjoint, _t(x), _t(yb)) <= 1e-5
    assert abs(complex(tp.get_A_squared_mean()) - complex(jp.get_A_squared_mean())) <= 1e-6
    assert tp.get_structure(2.5) == jp.get_structure(2.5) == "FDFDF"


def test_ptychography_matches_jax():
    rng = np.random.default_rng(3)
    jp = J.Ptychography((1, 20, 20), n_img=9)
    tp = T.Ptychography((1, 20, 20), n_img=9, device=DEV)
    x = _cplx(rng, (2, 1, 20, 20))
    y = np.asarray(jp.A(jnp.asarray(x)))
    _close(tp.A(_t(x)), y, 1e-5)
    _close(tp.A_vjp(_t(x), _t(y)), jp.A_vjp(jnp.asarray(x), jnp.asarray(y)), 1e-5)
    yb = _cplx(rng, y.shape)
    _close(tp.B_adjoint(_t(yb)), jp.B_adjoint(jnp.asarray(yb)), 1e-5)
    assert _gap(tp.B.A, tp.B.A_adjoint, _t(x), _t(yb)) <= 1e-5
    shifts = np.asarray(jp.B.shifts)
    _close(tp.B.get_overlap_img(shifts), jp.B.get_overlap_img(shifts), 1e-6)
    for sh in ((3, -2), (-4, 5)):
        _close(tp.B.shift(_t(x), *sh), jp.B.shift(jnp.asarray(x), *sh), 0)


# -- PET ------------------------------------------------------------------------------


def _pet_case(case):
    rng = np.random.default_rng(4)
    if case == "2d":
        mu = np.full((1, 1, 16, 16), 0.01, np.float32)
        kw = dict(img_width=16, angles=20, fwhm=2.0, attenuation=mu)
        shape = (2, 1, 16, 16)
    elif case == "3d_planes":
        kw = dict(img_size=(2, 16, 16), angles=12, method="fourier")
        shape = (1, 1, 2, 16, 16)
    else:
        kw = dict(img_size=(3, 12, 12), angles=8, ring_differences=(0, -1, 1), fwhm=1.5,
                  normalize=True)
        shape = (1, 1, 3, 12, 12)
    jp = J.PET(**kw)
    extra = {}
    if kw.get("normalize"):   # JAX's power-method start (pet.py:158-161)
        extra["draws"] = [np.asarray(jax.random.uniform(KEY(0), (1, 1) + shape[2:]))]
    tp = T.PET(device=DEV, **kw, **extra)
    return jp, tp, rng.random(shape).astype(np.float32) * 4


@pytest.mark.parametrize("case", ["2d", "3d_planes", "michelogram"])
def test_pet_matches_jax(case):
    """``A`` (with and without the background), its autograd-transpose
    adjoint, the FBP ``A_dagger`` and 4 iterations of ``osem``; the
    michelogram's operator norm from JAX's start."""
    jp, tp, x = _pet_case(case)
    if case == "michelogram":
        assert abs(float(tp.operator_norm) / float(jp.operator_norm) - 1) <= 1e-4

    def jax_op(f, v):  # one compile, where eager JAX compiles every op
        return jax.jit(lambda u: f(jp, u))(jnp.asarray(v))

    y = np.asarray(jax_op(lambda p, v: p.A(v), x))
    with torch.no_grad():
        _close(tp.A(_t(x)), y, 1e-4)
        _close(tp.A(_t(x), add_background=True),
               jax_op(lambda p, v: p.A(v, add_background=True), x), 1e-4)
        _close(tp.A_adjoint(_t(y)), jax_op(lambda p, v: p.A_adjoint(v), y), 1e-4)
        _close(tp.A_dagger(_t(y)), jax_op(lambda p, v: p.A_dagger(v), y), 1e-4)
        _close(tp.osem(_t(y), n_iter=4), jax_op(lambda p, v: p.osem(v, n_iter=4), y), 1e-4)
        v = np.random.default_rng(5).standard_normal(y.shape).astype(np.float32)
        assert _gap(tp.A, tp.A_adjoint, _t(x), _t(v)) <= 1e-5


# -- scattering -----------------------------------------------------------------------


def test_born_operator_matches_jax():
    n = 24
    jb = J.BornOperator(img_size=(n, n), n_sources=4, n_receivers=8)
    tb = T.BornOperator(img_size=(n, n), n_sources=4, n_receivers=8, device=DEV)
    rng = np.random.default_rng(6)
    c = (rng.random((2, 1, n, n)) * 0.05).astype(np.float32)
    y = np.asarray(jb.A(jnp.asarray(c)))
    _close(tb.A(_t(c)), y, 1e-5)
    yp = y + 0.01 * _cplx(rng, y.shape)
    _close(tb.A_adjoint(_t(yp)), jb.A_adjoint(jnp.asarray(yp)), 1e-5)
    assert _gap(tb.A, tb.A_adjoint, _t(c), _t(yp)) <= 1e-5
    _close(tb.A_dagger(_t(yp)), jb.A_dagger(jnp.asarray(yp)), 1e-4)


def _scattering(n, k=20.0):
    tx, rx = jsc.circular_sensors(3, radius=1.0)
    kw = dict(img_width=n, transmitters=tx, receivers=rx, background_wavenumber=k,
              box_length=1.0, wave_type="plane_wave")
    return J.Scattering(**kw), T.Scattering(device=DEV, **kw)


def test_scattering_field_and_implicit_gradient_match_jax():
    """The Lippmann-Schwinger total field and measurements (CG on the
    normal equations, tol 1e-5), the gradient of ``sum |A(c)|^2`` through
    the implicit adjoint solve against ``jax.grad`` through
    ``lax.custom_linear_solve``, and the JVP against ``jax.jvp``."""
    n = 32
    jp, tp = _scattering(n)
    rng = np.random.default_rng(7)
    c = (0.3 * rng.random((1, 1, n, n))).astype(np.float32)
    _close(tp.compute_total_field(_t(c)), jp.compute_total_field(jnp.asarray(c)), 1e-4)
    _close(tp.A(_t(c)), jp.A(jnp.asarray(c)), 1e-4)
    want = jax.grad(lambda v: jnp.sum(jnp.abs(jp.A(v)) ** 2))(jnp.asarray(c))
    ct = _t(c).requires_grad_()
    (tp.A(ct).abs() ** 2).sum().backward()
    _close(ct.grad, want, 1e-4)
    d = rng.standard_normal(c.shape).astype(np.float32)
    _, jv = jax.jvp(jp.A, (jnp.asarray(c),), (jnp.asarray(d),))
    _close(tp.A_jvp(_t(c), _t(d)), jv, 1e-4)


def test_scattering_matches_mie_theory():
    """The field solve against the Mie series of a cylinder (radius 0.2,
    contrast 0.6) at k = 10 on 32² and 64²: the JAX test's bounds; the series
    itself against JAX's."""
    L, k, a, contrast = 1.0, 10.0, 0.2, 0.6
    tx, _ = jsc.circular_sensors(3, radius=1.0)
    ang = np.arctan2(tx[1], tx[0])
    rels = []
    for n in (32, 64):
        _, tp = _scattering(n, k)
        grid = np.linspace(-L / 2, L / 2, n)
        yy, xx = np.meshgrid(-grid, grid, indexing="ij")
        c = (((xx ** 2 + yy ** 2) < a ** 2).astype(np.float32) * contrast)[None, None]
        u = tp.compute_total_field(_t(c))
        u_mie, inc = tsc.mie_theory(k, a, contrast, n, ang, box_length=L, device=DEV)
        j_mie, j_inc = jsc.mie_theory(k, a, contrast, n, ang, box_length=L)
        _close(u_mie, j_mie, 1e-5)
        _close(inc, j_inc, 1e-5)
        rels.append(float((u - u_mie).norm() / u_mie.norm()))
    assert rels[0] < 0.08, rels
    assert rels[1] < 0.62 * rels[0], rels
