"""The port's physics generators against the JAX package's, on the CPU.

Each JAX generator's draws are computed with its own key schedule (``step``
through ``ensure_key``, then the splits of each ``sample``: ``g1 + g2`` gives
``k1`` to ``g1``, the mask generators one key a (sample, frame), the
splitting generators one key a sample, and so on) and passed into the port
through ``draws=``. Masks then agree exactly, noise levels within 1e-6, PSFs
within 1e-5 (max abs error over the max), and
``ProductConvolutionBlurGenerator`` (whose SVD fixes no sign) through the
blur ``SpaceVaryingBlur`` makes with its parameters, within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepinv_tpu.physics.generator as jg
import deepinv_tpu_torch.physics.generator as tg
from deepinv_tpu.physics import SpaceVaryingBlur as JSpaceVaryingBlur
from deepinv_tpu_torch.physics import SpaceVaryingBlur

DEV = "cpu"


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _gumbel_lines(key, B, T, W):
    keys = jax.random.split(key, B * T)
    return jnp.stack([jax.random.gumbel(k, (W,)) for k in keys]).reshape(B, T, W)


def jdraws(gen, B, key, **kw):
    """The draws the JAX generator ``gen`` takes in ``gen.sample(B, key)``,
    in the port's order."""
    name = type(gen).__name__
    if name in ("SigmaGenerator", "GainGenerator"):
        return [jax.random.uniform(key, (B,))]
    if name == "DownsamplingGenerator":
        k1, k2 = jax.random.split(key)
        n = len(gen.factors)
        f = jax.random.randint(k1, (), 0, n) if B > 1 and n > 1 else \
            jax.random.randint(k1, (B,), 0, n)
        return [f, jax.random.randint(k2, (B,), 0, len(gen.filters))]
    if name in ("RandomMaskGenerator", "GaussianMaskGenerator", "EquispacedMaskGenerator",
                "PolyOrderMaskGenerator"):
        T = gen.T if gen.T > 0 else 1
        W = gen.W if kw.get("img_size") is None else kw["img_size"][-1]
        gen.calculate_lines(W)
        if gen.n_lines + gen.n_center >= W:
            return []
        if name == "EquispacedMaskGenerator":
            acc = (gen.acc * (gen.n_center - W)) / (gen.n_center * gen.acc - W)
            return [jax.random.randint(key, (B,), 0, round(acc))]
        if name == "PolyOrderMaskGenerator":
            return [jax.random.uniform(key, (B, T, W))]
        return [_gumbel_lines(key, B, T, W)] if gen.n_lines > 0 else []
    if name == "_JointGenerator":
        k1, k2 = jax.random.split(key)
        return jdraws(gen.g1, B, k1, **kw) + jdraws(gen.g2, B, k2, **kw)
    if name == "GeneratorMixture":
        kc, kg = jax.random.split(key)
        seed = jax.random.randint(kc, (), 0, 2 ** 31 - 1)
        rng = np.random.RandomState(int(seed))
        if gen.use_batch_sampling and B > 1:
            idx = rng.choice(len(gen.generators), size=B, p=gen.probs)
            keys = jax.random.split(kg, B)
            return [seed] + [d for i, k in zip(idx, keys)
                             for d in jdraws(gen.generators[int(i)], 1, k, **kw)]
        idx = int(rng.choice(len(gen.generators), p=gen.probs))
        return [seed] + jdraws(gen.generators[idx], B, kg, **kw)
    if name in ("BernoulliSplittingMaskGenerator", "MultiplicativeSplittingMaskGenerator",
                "GaussianSplittingMaskGenerator", "Artifact2ArtifactSplittingMaskGenerator"):
        m = kw.get("input_mask")
        if m is not None and m.ndim > len(gen.img_size) and m.shape[0] > 1:
            B = m.shape[0]
        out = []
        for b, kb in enumerate(jax.random.split(key, B)):
            mb = None if m is None else (m[b] if m.ndim > len(gen.img_size) else m)
            out += _split_draws(gen, kb, mb, kw.get("persist_prev", False))
        return out
    if name == "Phase2PhaseSplittingMaskGenerator":
        return []
    if name == "MotionBlurGenerator":
        kx, ky = jax.random.split(key)
        return [jax.random.normal(k, (B, gen.n_steps)) for k in (kx, ky)]
    if name == "GaussianBlurGenerator":
        ks, ka = jax.random.split(key)
        if gen.isotropic:
            out = [jax.random.uniform(ks, (B, 1))]
        else:
            out = [jax.random.uniform(k, (B,)) for k in jax.random.split(ks, gen.dim)]
        return out + [jax.random.uniform(k, (B,)) for k in jax.random.split(ka, len(gen.angle_min))]
    if name == "DiffractionBlurGenerator":
        kc, ka = jax.random.split(key)
        kb, kd = jax.random.split(kc)
        C = 1 if isinstance(gen.fc, float) else gen.fc.shape[0]
        out = [jax.random.uniform(kb, (B, gen.n_zernike))]
        if C > 1:
            out.append(jax.random.normal(kd, (B, C, gen.n_zernike)))
        if gen.random_rotate:
            out.append(jax.random.uniform(ka, (B,)))
        return out
    if name in ("ProductConvolutionBlurGenerator",):
        return jdraws(gen.psf_generator, gen.n_psf_grid * B, key)
    if name == "TiledBlurGenerator":
        ny, nx = gen.get_num_patches(kw["img_size"])
        return jdraws(gen.psf_generator, B * ny * nx, key)
    if name == "DiffractionBlurGenerator3D":
        k2d, ka = jax.random.split(key)
        out = jdraws(gen.generator2d, B, k2d)
        return out + ([jax.random.uniform(ka, (B,))] if gen.random_rotate else [])
    if name == "ConfocalBlurGenerator3D":
        ki, kc = jax.random.split(key)
        return jdraws(gen.generator_ill, B, ki) + jdraws(gen.generator_coll, B, kc)
    raise KeyError(name)


def _split_draws(gen, key, m, persist_prev):
    """One sample's draws of a splitting generator."""
    name = type(gen).__name__
    if name == "MultiplicativeSplittingMaskGenerator":
        img = tuple(m.shape[-2:]) if m is not None else None
        return jdraws(gen.split_generator, 1, key, img_size=img)
    if name == "GaussianSplittingMaskGenerator":
        C = gen.img_size[0] if not gen.check_pixelwise() else 1
        T = gen.img_size[1] if len(gen.img_size) > 3 else 1
        nx, ny = gen.img_size[-2:]
        keys = jax.random.split(key, C * T)
        return [jnp.stack([jax.random.gumbel(k, (nx * ny,)) for k in keys]).reshape(C, T, -1)]
    if name == "Artifact2ArtifactSplittingMaskGenerator":
        k1, k2 = jax.random.split(key)
        size = gen.split_size
        out = []
        if isinstance(size, (tuple, list)):
            if persist_prev:
                size = gen.prev_split_size
            else:
                pick = jax.random.randint(k1, (), 0, len(size))
                out.append(pick)
                size = size[int(pick)]
        n = gen.img_size[1] // size
        if persist_prev and gen.prev_idx is not None:
            return out + [jax.random.randint(k2, (), 0, n - 1)]
        return out + [jax.random.randint(k2, (), 0, n)]
    kr, ks = jax.random.split(key)
    out = [jax.random.uniform(kr)] if gen.random_split_ratio else []
    if m is not None and np.size(m) > 1:
        src = m[0] if gen.check_pixelwise(m) else m
        return out + [jax.random.permutation(ks, int(np.count_nonzero(np.asarray(src))))]
    return out + [jax.random.uniform(ks, gen.img_size)]


def _both(name, *args, **kw):
    jkw = {k: (v[0] if isinstance(v, tuple) and len(v) == 2 and k.endswith("generator") else v)
           for k, v in kw.items()}
    tkw = {k: (v[1] if isinstance(v, tuple) and len(v) == 2 and k.endswith("generator") else v)
           for k, v in kw.items()}
    return getattr(jg, name)(*args, **jkw), getattr(tg, name)(*args, device=DEV, **tkw)


def _run(jgen, tgen, B, key, **kw):
    want = jgen.step(B, key=key, **kw)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    draws = [np.asarray(d) for d in jdraws(jgen, B, key, **jkw)]
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    got = tgen.step(B, draws=draws, **tkw)
    assert set(got) == set(want)
    return got, want


MASKS = [("RandomMaskGenerator", (2, 32, 40), {}), ("GaussianMaskGenerator", (2, 32, 40), {}),
         ("GaussianMaskGenerator", (2, 4, 24, 32), {"acceleration": 8}),
         ("EquispacedMaskGenerator", (2, 3, 16, 40), {"acceleration": 4}),
         ("EquispacedMaskGenerator", (1, 32, 32), {"acceleration": 8}),
         ("PolyOrderMaskGenerator", (2, 16, 48), {"acceleration": 4}),
         ("RandomMaskGenerator", (16, 16), {"acceleration": 2, "center_fraction": 0.5})]


@pytest.mark.parametrize("name,size,kw", MASKS)
def test_mri_masks_match_jax(name, size, kw):
    """The k-space mask generators, static and k-t, exactly; the Gumbel
    top-k takes the same lines; each mask holds ``n_lines + n_center``
    columns (Random, Gaussian)."""
    jgen, tgen = _both(name, size, **kw)
    got, want = _run(jgen, tgen, 3, jax.random.key(7))
    assert np.array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    if name in ("RandomMaskGenerator", "GaussianMaskGenerator") and tgen.n_lines > 0:
        cols = got["mask"].reshape(-1, got["mask"].shape[-2], got["mask"].shape[-1])[:, 0]
        assert torch.all(cols.sum(-1) == tgen.n_lines + tgen.n_center)


def test_noise_and_downsampling_generators_match_jax():
    """Sigma and gain levels within 1e-6; the downsampling filters within
    1e-5 and the factors exactly, at B=1 and B=3 (one factor a batch)."""
    for name, kw in (("SigmaGenerator", {"sigma_min": 0.01, "sigma_max": 0.2}),
                     ("GainGenerator", {})):
        jgen, tgen = _both(name, **kw)
        got, want = _run(jgen, tgen, 5, jax.random.key(3))
        for k in got:
            assert np.allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6)
    jgen, tgen = _both("DownsamplingGenerator", filters=["gaussian", "bilinear", "bicubic"],
                       factors=[2, 4], psf_size=(17, 17))
    for B in (1, 3):
        got, want = _run(jgen, tgen, B, jax.random.key(B))
        assert np.array_equal(got["factor"].numpy(), np.asarray(want["factor"]))
        assert _rel(got["filter"].numpy(), want["filter"]) <= 1e-5


def test_joint_mixture_average_and_seeds():
    """``g1 + g2`` (the trainer's mask and sigma), ``GeneratorMixture`` with
    one member a sample and one a step, ``average`` over three batches,
    ``seed_from_string`` and the string seeds of ``step``."""
    size = (2, 16, 32)
    jsig, tsig = _both("SigmaGenerator", sigma_min=0.005, sigma_max=0.05)
    jm, tm = _both("GaussianMaskGenerator", size, acceleration=4)
    got, want = _run(jm + jsig, tm + tsig, 4, jax.random.key(0))
    assert np.array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    assert np.allclose(got["sigma"].numpy(), np.asarray(want["sigma"]), atol=1e-7)
    jr, tr = _both("RandomMaskGenerator", size, acceleration=4)
    for batch_sampling in (True, False):
        jmix = jg.GeneratorMixture([jm, jr], probs=[0.3, 0.7], use_batch_sampling=batch_sampling)
        tmix = tg.GeneratorMixture([tm, tr], probs=[0.3, 0.7], use_batch_sampling=batch_sampling)
        assert tmix.use_batch_sampling == jmix.use_batch_sampling == batch_sampling
        got, want = _run(jmix, tmix, 4, jax.random.key(5))
        assert np.array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    assert not tg.GeneratorMixture([tm, tsig]).use_batch_sampling
    key = jax.random.key(9)
    want = jm.average(n=5, batch_size=2, key=key)["mask"]
    k, draws = key, []
    for nb in (2, 2, 1):
        k, sub = jax.random.split(k)
        draws += [np.asarray(d) for d in jdraws(jm, nb, sub)]
    got = tm.average(n=5, batch_size=2, draws=draws)["mask"]
    assert np.allclose(got.numpy(), np.asarray(want), atol=1e-7)
    assert tg.seed_from_string("patient_0042.h5") == jg.seed_from_string("patient_0042.h5")
    seed = tg.seed_from_string("a") % (1 << 63)
    ref = tm.step(2, generator=torch.Generator().manual_seed(seed))["mask"]
    assert torch.equal(tm.step(2, seed="a")["mask"], ref)
    assert torch.equal(tm.rng_manual_seed("a").step(2)["mask"], ref)
    assert torch.equal(tm.reset_rng().step(2)["mask"], tm.step(2, seed=0)["mask"])


SPLITS = [("BernoulliSplittingMaskGenerator", ((2, 12, 10), 0.6), {}, None),
          ("BernoulliSplittingMaskGenerator", ((2, 12, 10), 0.5),
           {"pixelwise": False, "random_split_ratio": True}, None),
          ("BernoulliSplittingMaskGenerator", ((2, 12, 10), 0.6), {}, "input"),
          ("GaussianSplittingMaskGenerator", ((2, 16, 12), 0.6), {"center_block": 4}, "input"),
          ("GaussianSplittingMaskGenerator", ((1, 3, 16, 12), 0.7), {"center_block": (2, 4)},
           None),
          ("MultiplicativeSplittingMaskGenerator", ((2, 16, 32),), {"split_generator": True},
           "input"),
          ("Phase2PhaseSplittingMaskGenerator", ((2, 4, 8, 8),), {}, None),
          ("Artifact2ArtifactSplittingMaskGenerator", ((2, 6, 8, 8),), {"split_size": (2, 3)},
           None)]


@pytest.mark.parametrize("name,args,kw,inp", SPLITS)
def test_splitting_masks_match_jax(name, args, kw, inp):
    """The splitting generators exactly, drawn alone or splitting a batch of
    acceleration masks; each split lies inside its input mask, and a
    Bernoulli split of a given mask keeps ``int(ratio * n)`` entries."""
    kw = dict(kw)
    if kw.pop("split_generator", False):
        kw["split_generator"] = _both("GaussianMaskGenerator", args[0], acceleration=2)
    jgen, tgen = _both(name, *args, **kw)
    step_kw = {}
    if inp:
        m = np.asarray(jg.GaussianMaskGenerator(args[0], acceleration=2).step(
            3, key=jax.random.key(1))["mask"])
        step_kw["input_mask"] = m
    got, want = _run(jgen, tgen, 3, jax.random.key(4), **step_kw)
    assert np.array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    if inp:
        assert np.all(got["mask"].numpy() <= step_kw["input_mask"])
        if name == "BernoulliSplittingMaskGenerator":
            kept = got["mask"].reshape(3, -1).sum(1)
            n = step_kw["input_mask"].reshape(3, -1).sum(1)
            # int(0.6 * n_c) of each channel's n_c = n / 2 entries, in both channels
            assert np.array_equal(kept.numpy(), 2 * np.floor(0.6 * (n / 2)))
    if name == "Artifact2ArtifactSplittingMaskGenerator":
        got2, want2 = _run(jgen, tgen, 3, jax.random.key(6), persist_prev=True)
        assert np.array_equal(got2["mask"].numpy(), np.asarray(want2["mask"]))


PSFS = [("MotionBlurGenerator", {"psf_size": (9, 9), "n_steps": 200}),
        ("GaussianBlurGenerator", {"psf_size": (7, 9), "isotropic": False}),
        ("GaussianBlurGenerator", {"psf_size": (5, 7, 7), "sigma_max": 2.0}),
        ("DiffractionBlurGenerator", {"psf_size": (9, 9), "pupil_size": 32}),
        ("DiffractionBlurGenerator", {"psf_size": (7, 7), "pupil_size": 32,
                                      "fc": (0.18, 0.22), "zernike_perturbation_amplitude": 0.05,
                                      "apodize": True}),
        ("DiffractionBlurGenerator", {"psf_size": (8, 8), "pupil_size": 32,
                                      "random_rotate": True}),
        ("DiffractionBlurGenerator3D", {"psf_size": (3, 9, 9), "pupil_size": 32,
                                        "stepz_pixel": 2.0}),
        ("ConfocalBlurGenerator3D", {"psf_size": (3, 9, 9), "pupil_size": 32,
                                     "zernike_index": (4, 5)})]


@pytest.mark.parametrize("name,kw", PSFS)
def test_psf_generators_match_jax(name, kw):
    """The PSF generators within 1e-5 of JAX: PSFs summing to 1 in each
    channel and non-negative, but for the FFT-shear rotation
    (``random_rotate``, as in JAX): it rings within 1e-3 of the peak below 0
    and moves the sum within 1e-3."""
    jgen, tgen = _both(name, **kw)
    got, want = _run(jgen, tgen, 2, jax.random.key(2))
    for k in got:
        if k == "filter" or not np.iscomplexobj(np.asarray(want[k])):
            assert _rel(got[k].numpy(), want[k]) <= 1e-5, k
    f = got["filter"]
    assert float(f.min()) >= (-1e-3 * float(f.max()) if kw.get("random_rotate") else 0.0)
    dims = tuple(range(2, f.dim()))
    # the rotation comes after the normalisation (as in JAX): its sum moves by ~5e-4
    assert torch.allclose(f.sum(dims), torch.ones(f.shape[:2]),
                          atol=1e-3 if kw.get("random_rotate") else 1e-5)


def test_space_varying_generators_match_jax():
    """``ProductConvolutionBlurGenerator`` through the blur it parameterises
    (within 1e-4 of the JAX blur; the eigen-PSFs' signs are free) and
    ``TiledBlurGenerator``'s per-tile PSFs within 1e-5."""
    jpsf, tpsf = _both("DiffractionBlurGenerator", psf_size=(7, 7), pupil_size=32, fc=0.25)
    jgen = jg.ProductConvolutionBlurGenerator(jpsf, img_size=(32, 32), n_eigen_psf=6)
    tgen = tg.ProductConvolutionBlurGenerator(tpsf, img_size=(32, 32), n_eigen_psf=6, device=DEV)
    got, want = _run(jgen, tgen, 1, jax.random.key(8))
    x = np.random.default_rng(0).random((1, 1, 32, 32)).astype(np.float32)
    yj = JSpaceVaryingBlur(**want)(jnp.asarray(x))
    yt = SpaceVaryingBlur(**got, device=DEV).A(torch.from_numpy(x))
    assert _rel(yt.numpy(), yj) <= 1e-4
    jm, tm = _both("MotionBlurGenerator", psf_size=(5, 5), n_steps=100)
    jgen = jg.TiledBlurGenerator(jm, patch_size=16, stride=8)
    tgen = tg.TiledBlurGenerator(tm, patch_size=16, stride=8, device=DEV)
    got, want = _run(jgen, tgen, 2, jax.random.key(1), img_size=(32, 40))
    assert got["filters"].shape == want["filters"].shape == (2, 1, 12, 5, 5)
    assert _rel(got["filters"].numpy(), want["filters"]) <= 1e-5
    assert tgen.get_num_patches((32, 40)) == jgen.get_num_patches((32, 40))
    assert tgen.get_compatible_img_size((30, 37)) == jgen.get_compatible_img_size((30, 37))


def test_zernike_and_bump_match_jax():
    """Zernike modes on a grid within 1e-5, their names and index
    conventions, the legacy basis, and ``bump_function``."""
    lin = np.linspace(-1.2, 1.2, 33, dtype=np.float32)
    X, Y = np.meshgrid(lin, lin, indexing="ij")
    for j in range(1, 16):
        n, m = tg.Zernike.index_conversion(j, convention="noll")
        assert (n, m) == jg.Zernike.index_conversion(j, convention="noll") == tg.noll_to_nm(j)
        assert tg.Zernike.index_conversion(j) == jg.Zernike.index_conversion(j)
        assert tg.Zernike.get_name(n, m) == jg.Zernike.get_name(n, m)
        got = tg.Zernike.cartesian_evaluate(n, m, torch.from_numpy(X), torch.from_numpy(Y))
        assert np.abs(got.numpy() - np.asarray(jg.Zernike.cartesian_evaluate(
            n, m, jnp.asarray(X), jnp.asarray(Y)))).max() <= 1e-5
    for a, b in zip(tg.zernike_basis(6, 15, 6.0), jg.zernike_basis(6, 15, 6.0)):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-6
    x = np.linspace(-3, 3, 101).astype(np.float32)
    assert np.abs(tg.bump_function(torch.from_numpy(x), 1.0, 1.5).numpy()
                  - np.asarray(jg.bump_function(jnp.asarray(x), 1.0, 1.5))).max() <= 1e-6
