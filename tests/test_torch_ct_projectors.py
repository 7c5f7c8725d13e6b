"""The port's CT projectors against the JAX package's, on the CPU: the
interpolation helper, the gather Radon transform, its backprojection and the
fan beam (``ops/radon.py``), the FFT-shear projector (``ops/radon_fourier.py``),
the ray-driven X-ray transform (``ops/xray.py``), and the physics on them,
``Tomography`` in every method and the fan beam, ``TomographyWithAstra`` in
2D and 3D, ``Tomography3D``; then the slice as a whole, PnP-PGD with a DnCNN
on fan-beam CT and TV-PGD on interp CT.

Inputs come from numpy seeds and go to both sides. Bounds (f32, max abs
error over the reference's max): the interpolation helper 1e-6; gathers 1e-5;
FFT-shear and FBP paths 1e-4; adjointness ``|<Ax, y> - <x, A^T y>|`` within
1e-5 of ``||Ax|| ||y||``.

The fan beam at its default geometry puts the source 57.5 / pixel_spacing / 2
pixels from the centre, and the JAX package solves where each ray meets the
image in float32: one ulp of an angle's sine moves its sinogram by ~3e-4 of
the max at 16-32 pixels. The port solves that geometry in float64, so the
default fan beam is held to a float64 transcription of the JAX formula (1e-5),
and to JAX itself within JAX's own float32 error (2e-3). The reconstructions
through the fan beam use a fan whose source is one image width away, where
both packages' float32 geometry is exact to ~1e-6.
"""

import importlib
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepinv_tpu.physics as J
import deepinv_tpu_torch.physics as T
from deepinv_tpu_torch.ops.radon import _map_coordinates

jradon = importlib.import_module("deepinv_tpu.ops.radon")
tradon = importlib.import_module("deepinv_tpu_torch.ops.radon")
jfour = importlib.import_module("deepinv_tpu.ops.radon_fourier")
tfour = importlib.import_module("deepinv_tpu_torch.ops.radon_fourier")
jxray = importlib.import_module("deepinv_tpu.ops.xray")
txray = importlib.import_module("deepinv_tpu_torch.ops.xray")

DEV = "cpu"
# a fan whose source is one image width from the centre (see the module doc)
NEAR_FAN = dict(n_detector_pixels=40, source_radius=1.0, detector_radius=1.0,
                detector_spacing=0.08)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _t(a):
    return torch.tensor(np.asarray(a))


def _adjointness(A, At, x, y):
    Ax = A(x)
    return abs(float((Ax.double() * y.double()).sum() - (x.double() * At(y).double()).sum())) \
        / float(Ax.double().norm() * y.double().norm())


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("ndim", [2, 3])
def test_map_coordinates_matches_jax(order, ndim):
    """Coordinates inside, outside, exactly on the grid and on half-integers
    (order 0 rounds half away from zero, as ``lax.round``)."""
    rng = np.random.default_rng(order + 2 * ndim)
    shape = (5, 7, 6)[-ndim:]
    img = rng.standard_normal((2,) + shape).astype(np.float32)
    coords = []
    for s in shape:
        c = np.concatenate([rng.uniform(-2.5, s + 1.5, 60), np.arange(-2, s + 2),
                            np.arange(-2, s + 2) + 0.5, [-0.5, -1.5, 0.5]]).astype(np.float32)
        coords.append(rng.permutation(np.resize(c, 90)).reshape(9, 10))
    got = _map_coordinates(_t(img), [_t(c) for c in coords], order)
    for b in range(2):
        want = jax.scipy.ndimage.map_coordinates(jnp.asarray(img[b]),
                                                 [jnp.asarray(c) for c in coords], order=order,
                                                 mode="constant")
        assert got.shape == (2, 9, 10)
        assert np.abs(got[b].numpy() - np.asarray(want)).max() <= 1e-6 * np.abs(img).max()


def test_map_coordinates_gradients_match_jax():
    """The gradient in the image (the gather's backward) and in the
    coordinates (order 1) against ``jax.grad``."""
    rng = np.random.default_rng(9)
    img = rng.standard_normal((6, 8)).astype(np.float32)
    # random coordinates, and integers (whose upper corner has weight 0 but
    # a derivative) inside and on the border
    r, c = (np.concatenate([rng.uniform(-1.5, 8.5, (4, 5)), [[0, 2, 5, 6, -1]]]).astype(np.float32)
            for _ in range(2))
    w = rng.standard_normal((5, 5)).astype(np.float32)

    def f(im, rr, cc):
        return jnp.sum(jax.scipy.ndimage.map_coordinates(im, [rr, cc], order=1,
                                                         mode="constant") * w)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(img), jnp.asarray(r), jnp.asarray(c))
    ins = [_t(a).requires_grad_() for a in (img, r, c)]
    (_map_coordinates(ins[0][None], ins[1:], 1)[0] * _t(w)).sum().backward()
    for got, wnt in zip(ins, want):
        assert _rel(got.grad.numpy(), wnt) <= 1e-5


@pytest.mark.parametrize("circle", [False, True])
def test_radon_and_iradon_match_jax(circle):
    rng = np.random.default_rng(int(circle))
    x = rng.random((2, 1, 16, 16)).astype(np.float32)
    th = np.linspace(0, 180, 12, endpoint=False).astype(np.float32)
    want = jradon.radon(jnp.asarray(x), th, circle)
    got = tradon.radon(_t(x), _t(th), circle)
    assert got.shape == want.shape and _rel(got, want) <= 1e-5
    for filtered in (True, False):
        assert _rel(tradon.iradon(_t(want), _t(th), circle, filtered),
                    jradon.iradon(want, th, circle, filtered)) <= 1e-4
    assert _rel(tradon.radon(_t(x), _t(th), circle, interp_order=0),
                jradon.radon(jnp.asarray(x), th, circle, interp_order=0)) <= 1e-5


def _fanbeam64(x, theta, source_radius=57.5, detector_radius=57.5, n_detector_pixels=258,
               detector_spacing=0.077, n_steps=None):
    """The JAX package's fan beam (ops/radon.py:169-252) transcribed in
    float64 numpy, sampled by the port's map_coordinates in float64."""
    W = x.shape[-1]
    ps = 0.5 / W
    n_steps = n_steps or 2 * W
    th = np.deg2rad(np.asarray(theta, np.float64))
    c = (W - 1) / 2.0
    Rs = source_radius / (ps * W) * (W / 2.0)
    Rd = detector_radius / (ps * W) * (W / 2.0)
    det = (np.arange(n_detector_pixels) - (n_detector_pixels - 1) / 2.0) * detector_spacing \
        / (ps * W) * (W / 2.0)
    cos, sin = np.cos(th)[:, None], np.sin(th)[:, None]
    dpos = np.stack([sin * det + cos * Rd, cos * det - sin * Rd], -1)
    spos = np.stack([-cos[:, 0] * Rs, sin[:, 0] * Rs], -1)
    dirv = dpos - spos[:, None]
    u = dirv / np.linalg.norm(dirv, axis=-1, keepdims=True)
    b = np.sum(u * spos[:, None], -1)
    disc = np.clip(b ** 2 - (np.sum(spos ** 2, -1)[:, None] - (W / 2.0) ** 2 * 2), 0, None)
    t0, t1 = np.clip(-b - np.sqrt(disc), 0, None), np.clip(-b + np.sqrt(disc), 0, None)
    tt = t0[..., None] + np.linspace(0.0, 1.0, n_steps) * (t1 - t0)[..., None]
    P = spos[:, None, None] + tt[..., None] * u[:, :, None]
    vals = _map_coordinates(torch.from_numpy(x.reshape(-1, W, W).astype(np.float64)),
                           [torch.from_numpy(P[..., 0] + c), torch.from_numpy(P[..., 1] + c)])
    sino = vals.sum(-1).numpy() * np.where(disc > 0, (t1 - t0) / n_steps, 0.0)
    return np.moveaxis(sino, 1, 2).reshape(x.shape[:2] + (n_detector_pixels, len(th)))


@pytest.mark.parametrize("width", [16, 32])
def test_fanbeam_default_geometry(width):
    """The default fan beam: the port within 1e-5 of the float64 formula;
    the JAX package within its float32 error of it, and of the port."""
    rng = np.random.default_rng(width)
    x = rng.random((1, 2, width, width)).astype(np.float32)
    th = np.linspace(0, 180, 8, endpoint=False).astype(np.float32)
    ref = _fanbeam64(x, th, n_steps=48)
    got = tradon.fanbeam(_t(x), _t(th), n_steps=48)
    jx = jradon.fanbeam(jnp.asarray(x), th, n_steps=48)
    assert got.shape == jx.shape == ref.shape == (1, 2, 258, 8)
    assert _rel(got, ref) <= 1e-5
    assert _rel(jx, ref) <= 2e-3 and _rel(got, jx) <= 2e-3


def test_fanbeam_near_source_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.random((2, 1, 24, 24)).astype(np.float32)
    th = np.linspace(0, 360, 10, endpoint=False).astype(np.float32)
    for order in (0, 1):
        want = jradon.fanbeam(jnp.asarray(x), th, n_steps=40, interp_order=order, **NEAR_FAN)
        got = tradon.fanbeam(_t(x), _t(th), n_steps=40, interp_order=order, **NEAR_FAN)
        assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("circle", [False, True])
def test_radon_fourier_matches_jax(circle):
    """The shear plan over angles in all four quarter turns (negative, past
    360, on the 45-degree boundaries)."""
    rng = np.random.default_rng(3 + circle)
    x = rng.random((2, 1, 16, 16)).astype(np.float32)
    th = np.array([-100, 0, 10, 44.9, 45.1, 95, 181, 270.5, 359], np.float32)
    want = jfour.radon_fourier(jnp.asarray(x), th, circle)
    assert _rel(tfour.radon_fourier(_t(x), th, circle), want) <= 1e-4
    s = rng.standard_normal(want.shape).astype(np.float32)
    assert _rel(tfour.iradon_fourier(_t(s), th, circle),
                jfour.iradon_fourier(jnp.asarray(s), th, circle)) <= 1e-4
    plan = tfour.RadonFourierPlan(16, th, circle)
    assert _adjointness(plan.project, plan.backproject, _t(x), _t(s)) <= 1e-5
    assert sorted(plan.order.tolist()) == list(range(9))


TOMO_CASES = [dict(method="interp"), dict(method="fourier"), dict(method="slice"),
              dict(method="interp", circle=True), dict(fan_beam=True, fan_parameters=NEAR_FAN)]


@pytest.mark.parametrize("kw", TOMO_CASES, ids=["interp", "fourier", "slice", "interp-circle",
                                                "fan"])
def test_tomography_methods_match_jax(kw):
    """``A``, ``A_adjoint``, ``A_adjoint_A`` and the FBP of every projector,
    normalized, against JAX; adjointness within 1e-5."""
    rng = np.random.default_rng(len(str(kw)))
    x = rng.random((2, 1, 16, 16)).astype(np.float32)
    ref = J.Tomography(angles=10, img_width=16, normalize=True, **kw)
    port = T.Tomography(angles=10, img_width=16, normalize=True, device=DEV, **kw)
    y = ref.A(jnp.asarray(x))
    v = rng.standard_normal(y.shape).astype(np.float32)
    assert tuple(port.A(_t(x)).shape) == y.shape and _rel(port.A(_t(x)), y) <= 1e-5
    bound = 1e-5 if kw.get("method") == "interp" else 1e-4
    assert _rel(port.A_adjoint(_t(v)), ref.A_adjoint(jnp.asarray(v))) <= bound
    assert _rel(port.A_adjoint_A(_t(x)), ref.A_adjoint_A(jnp.asarray(x))) <= 1e-4
    assert _rel(port.A_dagger(_t(y)), ref.A_dagger(y)) <= 1e-4
    assert _adjointness(port.A, port.A_adjoint, _t(x), _t(v)) <= 1e-5
    assert port.fast_normal == ref.fast_normal


def test_tomography_angle_gradient_matches_jax():
    """The interp projector keeps the angles a tensor: the gradient of a
    loss through ``A`` and ``A_adjoint`` reaches them, as ``jax.grad`` does."""
    rng = np.random.default_rng(11)
    x = rng.random((1, 1, 12, 12)).astype(np.float32)
    th = np.linspace(3, 170, 6).astype(np.float32)
    ref = J.Tomography(angles=th, img_width=12)
    port = T.Tomography(angles=th, img_width=12, device=DEV)

    def loss(angles):
        p = ref.replace(angles=angles)
        return jnp.sum(p.A_adjoint(p.A(jnp.asarray(x))) ** 2)

    want = jax.grad(loss)(jnp.asarray(th))
    port.angles.requires_grad_(True)
    (port.A_adjoint(port.A(_t(x))) ** 2).sum().backward()
    assert _rel(port.angles.grad, want) <= 1e-4


def _astra_pair(seed, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = J.TomographyWithAstra(normalize=True, **kw)
        port = T.TomographyWithAstra(normalize=True, device=DEV, **kw)
    # the power method's start differs (a JAX key, a torch generator) and 20
    # iterations leave each estimate up to ~0.5% short: the norms are held
    # to 1e-2 of each other here, then JAX's is crossed as weights are
    assert abs(float(port.operator_norm) / float(ref.operator_norm) - 1) <= 1e-2
    port.operator_norm = torch.tensor(float(ref.operator_norm))
    return ref, port


ASTRA_CASES = {
    "parallel2d": dict(img_size=(16, 16), angles=12),
    "fanbeam2d": dict(img_size=(16, 16), angles=12, geometry_type="fanbeam",
                      geometry_parameters=dict(source_radius=40.0, detector_radius=20.0)),
    "parallel3d": dict(img_size=(6, 10, 10), angles=8, n_steps=20),
    "conebeam3d": dict(img_size=(6, 10, 10), angles=8, geometry_type="conebeam",
                       angular_range=(0, 360), n_detector_pixels=(8, 14),
                       detector_spacing=(1.5, 1.5), n_steps=24,
                       geometry_parameters=dict(source_radius=30.0, detector_radius=10.0)),
    "vectors2d": dict(img_size=(12, 12), geometry_type="fanbeam", geometry_vectors=np.array(
        [[0.0, -30.0, 0.0, 10.0, 1.0, 0.0], [30.0, 0.0, -10.0, 0.0, 0.0, 1.0],
         [21.0, -21.0, -7.0, 7.0, 0.7, 0.7]])),
}


@pytest.mark.parametrize("case", list(ASTRA_CASES))
def test_tomography_with_astra_matches_jax(case):
    """``A``, ``A_adjoint``, the FBP / FDK and the shapes against JAX;
    adjointness within 1e-5."""
    kw = ASTRA_CASES[case]
    ref, port = _astra_pair(0, **kw)
    rng = np.random.default_rng(len(case))
    x = rng.random((2, 1) + kw["img_size"]).astype(np.float32)
    y = ref.A(jnp.asarray(x))
    assert port.measurement_shape == ref.measurement_shape and port.num_angles == ref.num_angles
    assert _rel(port.A(_t(x)), y) <= 1e-5
    v = rng.standard_normal(y.shape).astype(np.float32)
    assert _rel(port.A_adjoint(_t(v)), ref.A_adjoint(jnp.asarray(v))) <= 1e-5
    assert _rel(port.A_dagger(_t(y), fbp=True), ref.A_dagger(y, fbp=True)) <= 1e-4
    assert _adjointness(port.A, port.A_adjoint, _t(x), _t(v)) <= 1e-5


def test_xray_chunks_and_ray_integrals():
    """A plan in one-view chunks gives the same radiographs and adjoint as in
    one chunk (the last chunk padded); ``ray_integrals`` against JAX's."""
    geom = txray.xray_geometry("conebeam", np.deg2rad(np.arange(0, 360, 72.0)),
                               source_radius=30.0, detector_radius=10.0)
    rng = np.random.default_rng(4)
    x = _t(rng.random((1, 1, 5, 8, 8)).astype(np.float32))
    one = txray.XrayPlan(geom, (5, 8, 8), n_detector_pixels=(6, 9), n_steps=16)
    two = txray.XrayPlan(geom, (5, 8, 8), n_detector_pixels=(6, 9), n_steps=16, chunk_views=2)
    assert (one.n_chunks, two.n_chunks) == (1, 3)
    y = one.project(x)
    assert _rel(two.project(x), y) <= 1e-6
    assert _rel(two.backproject(y), one.backproject(y)) <= 1e-6
    p0 = rng.uniform(-20, 20, (4, 3, 3)).astype(np.float32)
    p1 = -p0 + rng.uniform(-2, 2, p0.shape).astype(np.float32)
    want = jxray.ray_integrals(jnp.asarray(x.numpy()), jnp.asarray(p0), jnp.asarray(p1),
                               (5, 8, 8), n_steps=20)
    got = txray.ray_integrals(x, _t(p0), _t(p1), (5, 8, 8), n_steps=20)
    assert tuple(got.shape) == want.shape == (1, 1, 4, 3) and _rel(got, want) <= 1e-5


def test_tomography3d_matches_jax():
    """The interp projector against JAX; the slice method (its Toeplitz
    ``A_adjoint_A``) against the port's 2D slice physics slice by slice."""
    rng = np.random.default_rng(6)
    x = rng.random((1, 1, 3, 16, 16)).astype(np.float32)
    ref = J.Tomography3D(angles=8, img_size=(3, 16, 16), method="interp")
    port = T.Tomography3D(angles=8, img_size=(3, 16, 16), method="interp", device=DEV)
    y = ref.A(jnp.asarray(x))
    assert _rel(port.A(_t(x)), y) <= 1e-5
    assert _rel(port.A_adjoint(_t(y)), ref.A_adjoint(y)) <= 1e-5
    assert _rel(port.A_dagger(_t(y)), ref.A_dagger(y)) <= 1e-4
    vol = T.Tomography3D(angles=8, img_size=(3, 16, 16), method="slice", device=DEV)
    flat = T.Tomography(angles=8, img_width=16, method="slice", device=DEV)
    assert vol.fast_normal and not port.fast_normal
    for fn, fn2 in ((vol.A, flat.A), (vol.A_adjoint_A, flat.A_adjoint_A)):
        assert torch.equal(fn(_t(x))[0, 0], fn2(_t(x)[0].movedim(1, 0))[:, 0])


def test_tomography_state():
    """Plans are buffers (``physics.to(device)`` moves them); the fan beam's
    detector count; an unknown method raises; ``theta`` warns."""
    four = T.Tomography(angles=12, img_width=16, method="fourier", device=DEV)
    assert {"angles", "plan.order", "plan.freqs", "plan.other"} <= set(dict(four.named_buffers()))
    fan = T.Tomography(angles=12, img_width=16, fan_beam=True, device=DEV)
    assert fan.n_det == 258 and fan.plan is None and not fan.fast_normal
    astra = T.TomographyWithAstra((4, 8, 8), angles=6, geometry_type="conebeam",
                                  normalize=False, device=DEV)
    assert {"plan.p0", "plan.d", "plan.seg", "fdk"} <= set(dict(astra.named_buffers()))
    with pytest.raises(ValueError, match="method"):
        T.Tomography(angles=4, img_width=8, method="nearest", device=DEV)
    with pytest.warns(DeprecationWarning):
        assert fan.theta is fan.angles


def test_pnp_pgd_dncnn_fan_beam_matches_jax():
    """The slice's path: PnP-PGD with a DnCNN (depth 3, nf 8, JAX weights
    crossed by ``load_jax_params``) on fan-beam CT at 32², 4 iterations,
    f32, relative L2 error within 1e-4 of JAX."""
    from deepinv_tpu.optim import L2 as JL2, PnP as JPnP, optim_builder as j_builder
    from deepinv_tpu_torch.optim import L2, PnP, optim_builder
    from test_torch_dncnn import _pair

    rng = np.random.default_rng(7)
    x = rng.random((1, 1, 32, 32)).astype(np.float32)
    kw = dict(angles=16, img_width=32, normalize=True, fan_beam=True,
              fan_parameters=dict(NEAR_FAN, n_detector_pixels=48))
    ref_p, port_p = J.Tomography(**kw), T.Tomography(**kw, device=DEV)
    y = np.asarray(ref_p.A(jnp.asarray(x)))
    ref_d, port_d = _pair(1, 3, seed=3, nf=8)
    params = {"stepsize": 0.9, "g_param": 0.05}
    ref = j_builder("PGD", data_fidelity=JL2(), prior=JPnP(ref_d), params_algo=params,
                    max_iter=4)
    want = np.asarray(jax.jit(lambda m, v, p: m(v, p))(ref, jnp.asarray(y), ref_p))
    port = optim_builder("PGD", data_fidelity=L2(), prior=PnP(port_d), params_algo=params,
                         max_iter=4, device=DEV)
    with torch.no_grad():
        got = port(_t(y), port_p).numpy()
    assert np.isfinite(got).all()
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)


def test_tv_pgd_interp_ct_matches_jax():
    """TV-PGD on interp CT from the FBP (``examples/demo_ct_projectors.py``'s
    run at 24², 30 angles, 10 iterations), both on their plain prox."""
    from deepinv_tpu.optim import L2 as JL2, TVPrior as JTV, optim_builder as j_builder
    from deepinv_tpu_torch.optim import L2, TVPrior, optim_builder

    rng = np.random.default_rng(8)
    x = (rng.random((1, 1, 24, 24)) > 0.5).astype(np.float32)
    kw = dict(angles=30, img_width=24, normalize=True, method="interp")
    ref_p, port_p = J.Tomography(**kw), T.Tomography(**kw, device=DEV)
    y = np.asarray(ref_p.A(jnp.asarray(x)))
    params = {"stepsize": 0.5, "lambda": 5e-4}
    ref = j_builder("PGD", data_fidelity=JL2(), prior=JTV(use_pallas=False), params_algo=params,
                    max_iter=10, custom_init=lambda v, p: p.A_dagger(v))
    want = np.asarray(jax.jit(lambda m, v, p: m(v, p))(ref, jnp.asarray(y), ref_p))
    port = optim_builder("PGD", data_fidelity=L2(), prior=TVPrior(use_pallas=False),
                         params_algo=params, max_iter=10, device=DEV,
                         custom_init=lambda v, p: p.A_dagger(v))
    with torch.no_grad():
        got = port(_t(y), port_p).numpy()
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)
    assert math.isfinite(float(np.abs(got).max()))
