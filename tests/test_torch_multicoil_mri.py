"""The port's multi-coil, dynamic and sequential MRI, the tiled blur and the
mixins against the JAX package's, on the CPU; PnP-PGD on 4-coil MRI and the
Trainer with a physics generator through both packages.

Inputs come from numpy seeds at 16-32 pixels and 4 coils. Bounds: the
operators within 1e-5 (f32, max abs error over the max), adjointness within
1e-5 relative; ESPIRiT's maps within 1e-4 in magnitude and after the phase
alignment, inside the support where both packages keep them (the same
support but for a few pixels at its rim); PnP-PGD with a depth-4
``DnCNN(2, 2)`` crossed by ``load_jax_params`` within 1e-4 relative; the
trainer's losses within 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepinv_tpu.physics.generator as jg
import deepinv_tpu.physics.noise as jn
import deepinv_tpu_torch.physics.generator as tg
import deepinv_tpu_torch.physics.noise as tn
from deepinv_tpu.datasets import ArrayDataset as JArrayDataset
from deepinv_tpu.datasets import DataLoader as JDataLoader
from deepinv_tpu.models import ArtifactRemoval as JArtifactRemoval
from deepinv_tpu.optim import L2 as JL2
from deepinv_tpu.optim import PnP as JPnP
from deepinv_tpu.optim import optim_builder as joptim_builder
from deepinv_tpu.physics import DynamicMRI as JDynamicMRI
from deepinv_tpu.physics import MultiCoilMRI as JMultiCoilMRI
from deepinv_tpu.physics import SequentialMRI as JSequentialMRI
from deepinv_tpu.physics import TiledSpaceVaryingBlur as JTiledSpaceVaryingBlur
from deepinv_tpu.physics.mri import birdcage_maps as jbirdcage
from deepinv_tpu.training import Trainer as JTrainer
from deepinv_tpu.utils import mixins as jmix
from deepinv_tpu_torch.datasets import ArrayDataset, DataLoader
from deepinv_tpu_torch.models import ArtifactRemoval
from deepinv_tpu_torch.optim import L2, PnP, optim_builder
from deepinv_tpu_torch.physics import (DynamicMRI, MultiCoilMRI, SequentialMRI,
                                       TiledSpaceVaryingBlur, birdcage_maps)
from deepinv_tpu_torch.training import Trainer
from deepinv_tpu_torch.utils import mixins as tmix
from test_torch_dncnn import _pair

DEV = "cpu"
N_COILS = 4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _t(a):
    return torch.from_numpy(np.array(a))


def _phantom(B, size, seed=0):
    """Smooth complex images ``(B, 2, H, W)``: a disc of random texture."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size] / size - 0.5
    disc = (xx ** 2 + yy ** 2 < 0.16).astype(np.float32)
    return (rng.random((B, 2, size, size)) * disc).astype(np.float32)


def _physics(size=32, B=2, traj=None, seed=0, noise=None):
    """Both packages' ``MultiCoilMRI`` on birdcage maps, with a Gaussian
    mask of the JAX generator a sample."""
    maps = np.asarray(jbirdcage(N_COILS, (size, size)))[None]
    mask = np.asarray(jg.GaussianMaskGenerator((2, size, size), acceleration=4).step(
        B, key=jax.random.key(seed))["mask"])
    kw = dict(img_size=(size, size))
    if traj is not None:
        kw["kspace_trajectory"] = traj
    jp = JMultiCoilMRI(mask=jnp.asarray(mask), coil_maps=jnp.asarray(maps),
                       noise_model=noise[0] if noise else None, **kw)
    tp = MultiCoilMRI(mask=mask, coil_maps=torch.from_numpy(maps), device=DEV,
                      noise_model=noise[1] if noise else None, **kw)
    return jp, tp


def _radial(size, spokes=12):
    """Golden-angle radial spokes. Points exactly on the Toeplitz grid (a
    spoke at angle 0) are avoided: there the JAX package's Toeplitz spectrum
    strays ~1.6% from its own ``A^H A``, and the port's does not."""
    r = (np.arange(2 * size) - size + 0.5) * (np.pi / size)
    th = 0.1 + np.arange(spokes) * np.deg2rad(111.246)
    return np.stack([np.outer(np.cos(th), r).ravel(), np.outer(np.sin(th), r).ravel()]).astype(
        np.float32)


@pytest.mark.parametrize("cartesian", [True, False])
def test_multicoil_operators_match_jax(cartesian):
    """``A``, ``A_adjoint`` (with ``rss`` and ``crop``), the normal operator
    (the Toeplitz spectrum off the grid) and adjointness, Cartesian and
    radial, with the generator's ``(B, 2, H, W)`` mask through ``update``."""
    size = 24
    jp, tp = _physics(size, traj=None if cartesian else _radial(size))
    assert tp.fast_normal == jp.fast_normal == (not cartesian)
    x = _phantom(2, size, 1)
    yj = jp.A(jnp.asarray(x))
    yt = tp.A(_t(x))
    assert yt.shape == yj.shape and _rel(yt.numpy(), yj) <= 1e-5
    v = np.random.default_rng(2).standard_normal(yj.shape).astype(np.float32)
    assert _rel(tp.A_adjoint(_t(v)).numpy(), jp.A_adjoint(jnp.asarray(v))) <= 1e-5
    assert _rel(tp.A_adjoint(_t(v), rss=True).numpy(),
                jp.A_adjoint(jnp.asarray(v), rss=True)) <= 1e-5
    assert _rel(tp.A_adjoint_A(_t(x)).numpy(), jp.A_adjoint_A(jnp.asarray(x))) <= 1e-5
    lhs = float((yt.double() * _t(v).double()).sum())
    rhs = float((_t(x).double() * tp.A_adjoint(_t(v)).double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)
    if cartesian:
        assert _rel(tp.A_adjoint(_t(v), crop=(16, 16)).numpy(),
                    jp.A_adjoint(jnp.asarray(v), crop=(16, 16))) <= 1e-5
        new = np.asarray(jg.RandomMaskGenerator((2, size, size)).step(
            2, key=jax.random.key(9))["mask"])
        assert _rel(tp.update(mask=_t(new)).A(_t(x)).numpy(),
                    jp.update(mask=jnp.asarray(new)).A(jnp.asarray(x))) <= 1e-5
        assert _rel(tp.rss(yt).numpy(), jp.rss(yj)) <= 1e-5
        assert _rel(tp.crop(_t(x), shape=(15, 20)).numpy(),
                    jp.crop(jnp.asarray(x), shape=(15, 20))) == 0.0


class _GivenNoise(tn.GaussianNoise):
    """GaussianNoise that takes the draws it was given."""

    def __init__(self, sigma, draws):
        super().__init__(sigma, device=DEV)
        self.given = draws

    def forward(self, y, generator=None):
        return super().forward(y, draws=self.given)


def test_multicoil_noise_and_birdcage_match_jax():
    """Noise on the sampled k-space only, with a ``(B,)`` sigma through
    ``update``; the birdcage maps within 1e-6."""
    size = 16
    sig = np.array([0.05, 0.2], np.float32)
    jp, _ = _physics(size, noise=(jn.GaussianNoise(0.1), None))
    jp = jp.update(sigma=jnp.asarray(sig))
    x = _phantom(2, size, 3)
    key = jax.random.key(5)
    want = jp(jnp.asarray(x), key=key)
    eps = np.asarray(jax.random.normal(key, want.shape))
    _, tp = _physics(size, noise=(None, _GivenNoise(0.1, [eps])))
    got = tp.update(sigma=_t(sig))(_t(x))
    assert _rel(got.numpy(), want) <= 1e-5
    assert float(got[:, :, :, :, :][tp.mask[:, :, None].expand_as(got) == 0].abs().max()) == 0
    for n, shape in ((4, (16, 16)), (15, (20, 24))):
        assert np.abs(birdcage_maps(n, shape).numpy() - np.asarray(jbirdcage(n, shape))).max() \
            <= 1e-6
    assert torch.allclose(tp.simulate_birdcage_csm(N_COILS), birdcage_maps(N_COILS, (size, size)))


def test_espirit_matches_jax():
    """ESPIRiT at 32^2 with 4 coils from fully sampled k-space of birdcage
    maps: the port's maps within 1e-4 of JAX in magnitude and after both are
    aligned to coil 0, where both keep them; the supports differ on at most
    2% of the pixels; inside the object, the maps match the birdcage maps up
    to a phase a pixel (|<s_est, s_true>| >= 0.999)."""
    size = 32
    maps = np.asarray(jbirdcage(N_COILS, (size, size)))[None]
    jp = JMultiCoilMRI(mask=jnp.ones((size, size)), coil_maps=jnp.asarray(maps),
                       img_size=(size, size))
    y = np.asarray(jp.A(jnp.asarray(_phantom(1, size, 4))))
    kw = dict(calib_size=16, kernel_size=4)
    want = np.asarray(jax.jit(lambda v: JMultiCoilMRI.estimate_coil_maps(v, **kw))(
        jnp.asarray(y)))
    got = MultiCoilMRI.estimate_coil_maps(_t(y), **kw).numpy()
    keep_j, keep_t = np.abs(want).sum(1) > 0, np.abs(got).sum(1) > 0
    assert (keep_j != keep_t).mean() <= 0.02 and keep_t.mean() > 0.2
    both = (keep_j & keep_t)[:, None]
    assert np.abs(np.abs(got) - np.abs(want))[np.broadcast_to(both, got.shape)].max() <= 1e-4
    assert np.abs(got - want)[np.broadcast_to(both, got.shape)].max() <= 1e-4
    yy, xx = np.mgrid[:size, :size] / size - 0.5
    inside = both[:, 0] & (xx ** 2 + yy ** 2 < 0.16)
    assert np.abs((np.conj(got) * maps).sum(1))[inside].min() >= 0.999


def test_dynamic_and_sequential_mri_match_jax():
    """``DynamicMRI`` on k-t masks, ``to_static`` (the union of the frames'
    masks) and ``SequentialMRI.average``."""
    T, size = 4, 16
    mask = np.asarray(jg.GaussianMaskGenerator((2, T, size, size), acceleration=4).step(
        2, key=jax.random.key(3))["mask"])
    x = np.random.default_rng(0).standard_normal((2, 2, T, size, size)).astype(np.float32)
    for J, P in ((JDynamicMRI, DynamicMRI), (JSequentialMRI, SequentialMRI)):
        jp = J(mask=jnp.asarray(mask), img_size=(T, size, size))
        tp = P(mask=_t(mask), img_size=(T, size, size), device=DEV)
        y = tp.A(_t(x))
        assert _rel(y.numpy(), jp.A(jnp.asarray(x))) <= 1e-5
        assert _rel(tp.A_adjoint(y).numpy(), jp.A_adjoint(jnp.asarray(y.numpy()))) <= 1e-5
        st, sj = tp.to_static(), jp.to_static()
        assert np.array_equal(st.mask.numpy(), np.asarray(sj.mask))
        assert _rel(st.A(_t(x[:, :, 0])).numpy(), sj.A(jnp.asarray(x[:, :, 0]))) <= 1e-5
    assert _rel(tp.average(y).numpy(), jp.average(jnp.asarray(y.numpy()))) <= 1e-5
    assert _rel(tp.flatten(_t(x)).numpy(), jp.flatten(jnp.asarray(x))) == 0.0
    assert torch.equal(tp.unflatten(tp.flatten(_t(x)), batch_size=2), _t(x))
    assert _rel(tmix.TimeMixin.average(_t(x)).numpy(), jmix.TimeMixin.average(jnp.asarray(x))) \
        <= 1e-6


@pytest.mark.parametrize("mode", ["bump", "linear"])
def test_tiled_blur_and_tiling_match_jax(mode):
    """``TiledSpaceVaryingBlur`` (with ``TiledBlurGenerator``'s filters) and
    its adjointness; ``image_to_patches`` with context padding,
    ``patches_to_image`` (sum and mean), ``tiled_apply`` and the mixin's
    geometry queries."""
    rng = np.random.default_rng(1)
    H, W = 30, 37
    x = rng.random((2, 2, H, W)).astype(np.float32)
    jb = JTiledSpaceVaryingBlur(patch_size=16, stride=8, blending_mode=mode)
    tb = TiledSpaceVaryingBlur(patch_size=16, stride=8, blending_mode=mode, device=DEV)
    K = tb.num_filters((H, W), 16, 8)
    assert K == jb.num_filters((H, W), 16, 8)
    h = rng.random((2, 2, K, 5, 4)).astype(np.float32)
    h /= h.sum((-2, -1), keepdims=True)
    # the JAX operator through jax.jit: eager JAX compiles every op
    yj = jax.jit(lambda u, f: jb.A(u, filters=f))(jnp.asarray(x), jnp.asarray(h))
    yt = tb.A(_t(x), filters=_t(h))
    assert yt.shape == yj.shape and _rel(yt.numpy(), yj) <= 1e-5
    v = rng.standard_normal(yj.shape).astype(np.float32)
    assert _rel(tb.A_adjoint(_t(v), filters=_t(h)).numpy(), jax.jit(
        lambda u, f: jb.A_adjoint(u, filters=f))(jnp.asarray(v), jnp.asarray(h))) <= 1e-5
    for f in ("get_needed_pad", "get_compatible_img_size", "get_num_patches"):
        assert getattr(tb, f)((H, W)) == getattr(jb, f)((H, W))
    for pad in ((0, 0, 0, 0), (1, 2, 3, 0)):
        pj = jmix.image_to_patches(jnp.asarray(x), 12, 7, pad=pad)
        pt = tmix.image_to_patches(_t(x), 12, 7, pad=pad)
        assert pt.shape == pj.shape and _rel(pt.numpy(), pj) == 0.0
    for red in ("sum", "mean"):
        assert _rel(tmix.patches_to_image(pt, 7, img_size=(H, W), reduce_overlap=red).numpy(),
                    jmix.patches_to_image(pj, 7, img_size=(H, W), reduce_overlap=red)) <= 1e-6
    assert _rel(tmix.tiled_apply(lambda z: 2 * z + 1, _t(x), patch_size=(12, 16), overlap=4),
                jmix.tiled_apply(lambda z: 2 * z + 1, jnp.asarray(x), patch_size=(12, 16),
                                 overlap=4)) <= 1e-6


def test_pnp_pgd_on_multicoil_mri_matches_jax():
    """8 PnP-PGD iterations at stepsize 1 on 4-coil Cartesian MRI at 32^2
    (birdcage maps, a Gaussian mask a sample, B=2) with a depth-4
    ``DnCNN(2, 2)`` whose weights cross by ``load_jax_params``: the port's
    f32 recon within 1e-4 relative of JAX's."""
    size = 32
    jp, tp = _physics(size)
    x = _phantom(2, size, 6)
    y = np.asarray(jp.A(jnp.asarray(x)))
    jden, tden = _pair(2, 4, seed=3)
    params = {"stepsize": 1.0, "g_param": 0.05}
    jm = joptim_builder("PGD", data_fidelity=JL2(), prior=JPnP(jden), params_algo=params,
                        max_iter=8)
    want = np.asarray(jax.jit(lambda m, v, p: m(v, p))(jm, jnp.asarray(y), jp))
    tm = optim_builder("PGD", data_fidelity=L2(), prior=PnP(tden), params_algo=params,
                       max_iter=8, device=DEV)
    with torch.no_grad():
        got = tm(_t(y), tp).numpy()
    assert _rel(got, want) <= 1e-4


class _JGiven(jg.PhysicsGenerator):
    """The JAX side of a generator that returns precomputed parameters in
    turn, whatever the key."""

    def __init__(self, params):
        super().__init__()
        self.params, self.i = params, 0

    def sample(self, batch_size, key, **kwargs):
        p = self.params[self.i % len(self.params)]
        self.i += 1
        return {k: jnp.asarray(v) for k, v in p.items()}


class _TGiven(tg.PhysicsGenerator):
    """The port's side of :class:`_JGiven`."""

    def __init__(self, params):
        super().__init__(device=DEV)
        self.params, self.i = params, 0

    def sample(self, batch_size, draws, **kwargs):
        p = self.params[self.i % len(self.params)]
        self.i += 1
        return {k: _t(v) for k, v in p.items()}


class _JEpsNoise(jn.NoiseModel):
    """``y + sigma * eps`` with ``sigma`` and ``eps`` set by the generator."""

    def __init__(self, shape):
        super().__init__()
        self.sigma = jnp.zeros(())
        self.eps = jnp.zeros(shape)

    def sample(self, y, key):
        return y + jn._bcast(self.sigma, y) * self.eps


class _TEpsNoise(tn.NoiseModel):
    def __init__(self, shape):
        super().__init__(device=DEV)
        self._param("sigma", 0.0)
        self._param("eps", torch.zeros(shape))

    def sample(self, y, draws):
        return y + tn._bcast(self.sigma, y) * self.eps


def test_trainer_with_physics_generator_matches_jax():
    """``ArtifactRemoval(DnCNN(2, 2, depth=4))`` trained online on 4-coil
    MRI at 16^2, B=4, for 2 steps, a test-side generator in each package
    giving the same masks, sigmas and noise draws: the loss history within
    1e-4 relative of the JAX Trainer's. With the port's own
    ``GaussianMaskGenerator + SigmaGenerator``, ``loop_random_online_physics``
    repeats the parameters and the measurements each epoch, and without it
    they change."""
    size, B = 16, 4
    rng = np.random.default_rng(0)
    shape = (B, 2, N_COILS, size, size)
    masks = jg.GaussianMaskGenerator((2, size, size), acceleration=4)
    params = [{"mask": np.asarray(masks.step(B, key=jax.random.key(i))["mask"]),
               "sigma": rng.uniform(0.005, 0.05, B).astype(np.float32),
               "eps": rng.standard_normal(shape).astype(np.float32)} for i in range(2)]
    x = _phantom(B, size, 7)
    maps = np.asarray(jbirdcage(N_COILS, (size, size)))[None]
    kw = dict(img_size=(size, size))
    jphys = JMultiCoilMRI(coil_maps=jnp.asarray(maps), noise_model=_JEpsNoise(shape), **kw)
    tphys = MultiCoilMRI(coil_maps=torch.from_numpy(maps), noise_model=_TEpsNoise(shape),
                         device=DEV, **kw)
    jden, tden = _pair(2, 4, seed=5)
    opts = dict(epochs=2, online_measurements=True, verbose=False)
    jt = JTrainer(JArtifactRemoval(jden), jphys, optimizer=optax.adam(1e-3),
                  train_dataloader=JDataLoader(JArrayDataset(x), batch_size=B),
                  physics_generator=_JGiven(params), **opts)
    model = ArtifactRemoval(tden)
    pt = Trainer(model, tphys, optimizer=torch.optim.Adam(model.parameters(), lr=1e-3,
                                                          foreach=False),
                 train_dataloader=DataLoader(ArrayDataset(x), batch_size=B),
                 physics_generator=_TGiven(params), **opts)
    jt.train()
    pt.train()
    assert len(pt.loss_history) == 2
    assert _rel(pt.loss_history, jt.loss_history) <= 1e-4

    seen = []

    class Recorded(tg.PhysicsGenerator):
        def __init__(self):
            super().__init__(device=DEV)
            self.gen = tg.GaussianMaskGenerator((2, size, size), acceleration=4, device=DEV) + \
                tg.SigmaGenerator(0.005, 0.05, device=DEV)

        def sample(self, batch_size, draws, **kwargs):
            p = self.gen.sample(batch_size, draws)
            seen.append(p)
            return p

    for loop in (True, False):
        seen.clear()
        phys = MultiCoilMRI(coil_maps=torch.from_numpy(maps), noise_model=tn.GaussianNoise(
            0.01, device=DEV), device=DEV, **kw)
        m = ArtifactRemoval(_pair(2, 4, seed=5)[1])
        Trainer(m, phys, optimizer=torch.optim.Adam(m.parameters()),
                train_dataloader=DataLoader(ArrayDataset(x), batch_size=B),
                physics_generator=Recorded(), loop_random_online_physics=loop, **opts).train()
        assert len(seen) == 2
        same = all(torch.equal(seen[0][k], seen[1][k]) for k in ("mask", "sigma"))
        assert same == loop
