"""The port's transforms against the JAX package's, on the CPU in f32.

Each transform's parameters are drawn by the JAX transform from a key and
handed to both (``transform(x, **params)``, ``inverse(x, **params)``);
the port's own draws are checked for shape and range. The warps sample as
``jax.scipy.ndimage.map_coordinates`` does, so they agree within 1e-5 of
the output's max, except where a bound says why it is looser.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepinv_tpu.transform as JT
import deepinv_tpu_torch.transform as PT
from deepinv_tpu.transform.diffeomorphism import _cpab_basis as jax_cpab_basis
from deepinv_tpu_torch.transform.diffeomorphism import _cpab_basis
from deepinv_tpu_torch.transform.geometric import map_coordinates


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def to_torch(p):
    """JAX parameters (nested dicts of arrays, ints) as the port's."""
    if isinstance(p, dict):
        return {k: to_torch(v) for k, v in p.items()}
    if isinstance(p, (bool, int)):
        return p
    return torch.from_numpy(np.array(p))


def image(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


ODD = (2, 3, 17, 23)
SQUARE = (2, 3, 17, 17)

# name -> (constructor on a module, input shape, bound): odd sizes, angles
# whose corners fall outside, and homographies whose points fall behind the
# camera (pan and tilt up to 180 degrees)
CASES = {
    "rotate_any_angle": (lambda M: M.Rotate(multiples=7.0, n_trans=2), ODD, 1e-5),
    "rotate_rot90": (lambda M: M.Rotate(n_trans=2), SQUARE, 0.0),
    "shift": (lambda M: M.Shift(n_trans=2), ODD, 0.0),
    "scale": (lambda M: M.Scale(), ODD, 1e-5),
    "reflect": (lambda M: M.Reflect(dim=(-2, -1)), ODD, 0.0),
    # full homographies: pan/tilt to 180 degrees, skew to 50 and zoom to 0.5
    # put points near the horizon, where the perspective division amplifies
    # the f32 rounding of the 3x3 products (4.0e-5 here)
    "homography": (lambda M: M.Homography(n_trans=2), ODD, 1e-4),
    "homography_zeros_nearest": (
        lambda M: M.Homography(padding="zeros", interpolation="nearest"), ODD, 0.0),
    "pan_tilt_rotate": (lambda M: M.PanTiltRotate(theta_max=60.0, padding="border"), ODD, 1e-5),
    "affine": (lambda M: M.Affine(), ODD, 1e-5),
    "similarity": (lambda M: M.Similarity(), ODD, 1e-5),
    "euclidean": (lambda M: M.Euclidean(padding="zeros"), ODD, 1e-5),
    "cpab": (lambda M: M.CPABDiffeomorphism(n_trans=2), ODD, 1e-5),
    "chain": (lambda M: M.Shift() * M.Rotate(multiples=15.0, n_trans=2), ODD, 1e-5),
    "stack": (lambda M: M.Rotate(n_trans=2) + M.Reflect(), SQUARE, 0.0),
    "either": (lambda M: M.Rotate() | M.Reflect(), SQUARE, 0.0),
    "random_noise": (lambda M: M.RandomNoise(noise_type="uniform"), ODD, 0.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_transform_matches_jax(name):
    """The action and its inverse at JAX's parameters, and the port's own
    draw's keys and shapes."""
    make, shape, bound = CASES[name]
    x = image(shape, seed=len(name))
    tj, tp = make(JT), make(PT)
    params = tj.get_params(jnp.asarray(x), jax.random.key(3))
    yj = tj.transform(jnp.asarray(x), **params)
    want_inv = tj.inverse(yj, **params)
    yp = tp.transform(torch.from_numpy(x), **to_torch(params))
    assert yp.shape == yj.shape
    assert rel(yp, yj) <= bound
    assert rel(tp.inverse(yp, **to_torch(params)), want_inv) <= max(bound, 1e-6)
    own = tp.get_params(torch.from_numpy(x), torch.Generator().manual_seed(0))

    def shapes(p):
        return {k: shapes(v) if isinstance(v, dict) else np.shape(np.asarray(v))
                for k, v in p.items()}

    assert shapes(own) == shapes(params)


@pytest.mark.parametrize("name", ["shift_time_reflect", "shift_time_wrap", "phase_error"])
def test_temporal_transform_matches_jax(name):
    """``ShiftTime`` (reflect and wrap) and ``RandomPhaseError`` on (B, C, T,
    H, W) data: exact for the shifts, 1e-6 for the phase (``exp(1j p)``
    against ``torch.polar``)."""
    make = {"shift_time_reflect": lambda M: M.ShiftTime(n_trans=2),
            "shift_time_wrap": lambda M: M.ShiftTime(padding="wrap"),
            "phase_error": lambda M: M.RandomPhaseError()}[name]
    x = image((2, 2, 6, 8, 9), seed=4)
    tj, tp = make(JT), make(PT)
    params = tj.get_params(jnp.asarray(x), jax.random.key(5))
    yj = tj.transform(jnp.asarray(x), **params)
    yp = tp.transform(torch.from_numpy(x), **to_torch(params))
    assert rel(yp, yj) <= 1e-6
    assert rel(tp.inverse(yp, **to_torch(params)), tj.inverse(yj, **params)) <= 1e-6


@pytest.mark.parametrize("mode", ["constant", "nearest", "reflect"])
def test_map_coordinates_matches_jax_at_the_borders(mode):
    """Bilinear and nearest samples of an odd 9x13 plane at points inside,
    on, half outside and far outside the image (and at halves, which round
    away from zero): JAX's corner-by-corner sum, exact to 1e-6."""
    img = image((9, 13), seed=7)
    rng = np.random.default_rng(8)
    rows = np.concatenate([rng.uniform(-3, 12, 60), [-0.5, 8.5, 0.0, 8.0, -1.0, 2.5]])
    cols = np.concatenate([rng.uniform(-4, 16, 60), [-0.5, 12.5, 12.0, 0.0, 13.0, -2.5]])
    rows, cols = rows.astype(np.float32), cols.astype(np.float32)
    for order in (0, 1):
        want = jax.scipy.ndimage.map_coordinates(jnp.asarray(img), [rows, cols], order=order,
                                                 mode=mode)
        got = map_coordinates(torch.from_numpy(img), torch.from_numpy(rows),
                              torch.from_numpy(cols), order, mode)
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6, (order, mode)


def test_rotate_half_outside_takes_the_inside_share_like_grid_sample():
    """At 45 degrees on an odd 15x21 image, where corners fall outside, the
    warp equals ``grid_sample(align_corners=True, padding_mode="zeros")`` up
    to its normalised coordinates' rounding (1e-5), and the pixels whose
    source is wholly outside are 0."""
    x = torch.from_numpy(image((1, 1, 15, 21), seed=9))
    out = PT.Rotate(multiples=45.0).transform(x, theta=torch.tensor([45.0]))
    H, W = 15, 21
    th = np.deg2rad(45.0)
    yy, xx = np.meshgrid(np.arange(H) - (H - 1) / 2, np.arange(W) - (W - 1) / 2, indexing="ij")
    src_r = np.cos(th) * yy + np.sin(th) * xx + (H - 1) / 2
    src_c = -np.sin(th) * yy + np.cos(th) * xx + (W - 1) / 2
    grid = torch.from_numpy(np.stack([2 * src_c / (W - 1) - 1, 2 * src_r / (H - 1) - 1],
                                     -1)[None].astype(np.float32))
    ref = torch.nn.functional.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                                          align_corners=True)
    assert float((out - ref).abs().max()) <= 1e-5
    outside = (src_r < -1) | (src_r > H) | (src_c < -1) | (src_c > W)
    assert outside.any() and bool((out[0, 0][torch.from_numpy(outside)] == 0).all())


def test_homography_behind_the_camera_matches_jax():
    """Tilts past 90 degrees send every point behind the camera (w < 0):
    both packages keep the sign of w in the division, within 1e-5."""
    x = image((3, 1, 11, 13), seed=10)
    kw = dict(theta_x=np.float32([100.0, 150.0, -120.0]), theta_y=np.float32([0.0, 30.0, 95.0]),
              theta_z=np.float32([10.0, 0.0, -40.0]), padding="zeros")
    want = JT.apply_homography(jnp.asarray(x), **{k: jnp.asarray(v) if k != "padding" else v
                                                 for k, v in kw.items()})
    got = PT.apply_homography(torch.from_numpy(x), **{k: torch.from_numpy(v) if k != "padding"
                                                      else v for k, v in kw.items()})
    assert rel(got, want) <= 1e-5
    assert rel(PT.rotation_matrix(*[torch.tensor([20.0, -70.0])] * 3),
               JT.rotation_matrix(*[jnp.asarray([20.0, -70.0])] * 3)) <= 1e-6


def test_cpab_basis_is_the_jax_packages():
    """The copied numpy null space: the same basis bit for bit, for the
    default, the free-boundary and the volume-preserving tessellations."""
    for args in ((3, 3, True, False), (2, 2, False, False), (2, 2, True, True)):
        B, T = _cpab_basis(*args)
        Bj, Tj = jax_cpab_basis(*args)
        assert T == Tj and np.array_equal(B, Bj)


def test_transform_param_iterate_params_and_symmetrize():
    """``TransformParam``'s custom negation survives ``iterate_params``;
    ``symmetrize`` of an equivariant map over ``Rotate`` x ``Reflect`` is the
    map itself; ``Identity`` and ``identity`` leave the input."""
    p = PT.TransformParam(torch.tensor([2.0, 4.0]), neg=lambda v: 1 / v)
    its = PT.Rotate().iterate_params({"theta": torch.tensor([0.0, 90.0]), "zoom": p})
    assert len(its) == 4 and float((-its[1]["zoom"]).p) == 0.25
    x = torch.from_numpy(image((2, 1, 8, 8), seed=11))
    t = PT.Rotate(n_trans=2) * PT.Reflect(dim=(-1,))
    sym = t.symmetrize(lambda v: 2 * v + 1)
    assert torch.allclose(sym(x, generator=torch.Generator().manual_seed(0)), 2 * x + 1)
    assert torch.equal(PT.Identity()(x), x) and PT.Rotate().identity(x) is x


def test_transform_exports_every_jax_name():
    """``deepinv_tpu_torch.transform`` has every public name of the JAX
    package's, and ``Rotate`` takes any angle."""
    import deepinv_tpu.transform as jt_mod

    names = [n for n in dir(jt_mod) if not n.startswith("_") and n not in (
        "base", "geometric", "projective", "temporal", "diffeomorphism")]
    assert [n for n in names if n not in PT.__all__] == []
    assert PT.Rotate(multiples=1.0).transform(torch.ones(1, 1, 5, 5),
                                              theta=torch.tensor([33.0])).shape == (1, 1, 5, 5)
