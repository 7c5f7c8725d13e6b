"""The port's splitting, MRI and augmentation losses, the schedulers, the
checkpointer and the Trainer's ``train_aware`` protocol against the JAX
package's, on the CPU in f32.

As in ``tests/test_torch_selfsup_losses.py``: the same small DnCNN weights in
both packages, the JAX draws (masks, pair choices, noise, transform
parameters) remade from the JAX loss's key path and handed to the port. The
Trainer comparisons run the JAX Trainer eagerly (``jax.disable_jit``), which
lets them record the JAX masks and corruptions as they are drawn and replay
them to the port, and makes its loss scheduler draw at every step (under
``jit`` it draws once, when the step is traced: ROADMAP queue 3). Bounds are
1e-5 of the reference's max unless a test says why.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepinv_tpu.loss as JL
import deepinv_tpu.loss.measplit as jmeasplit
import deepinv_tpu.models as JM
import deepinv_tpu.models.layers as jlayers
import deepinv_tpu.physics as JP
import deepinv_tpu.transform as JT
import deepinv_tpu_torch.loss as TL
import deepinv_tpu_torch.loss.measplit as tmeasplit
import deepinv_tpu_torch.models as TM
import deepinv_tpu_torch.physics as TP
import deepinv_tpu_torch.training as TT
import deepinv_tpu_torch.transform as PT
from deepinv_tpu.datasets import ArrayDataset as JaxArrayDataset
from deepinv_tpu.datasets import DataLoader as JaxDataLoader
from deepinv_tpu.training import Trainer as JaxTrainer
from deepinv_tpu_torch.datasets import ArrayDataset, DataLoader
from test_torch_dncnn import _pair as dncnn_pair
from test_torch_drunet import DEV, jax_params


@pytest.fixture(autouse=True)
def numpy_he_init(monkeypatch):
    """The JAX layers' He-normal weights drawn by numpy (see
    ``tests/test_torch_adversarial.py``)."""
    rng = np.random.default_rng(0)

    def he_init(key, shape, fan_in, dtype=jnp.float32):
        return jnp.asarray((rng.standard_normal(shape) * math.sqrt(2.0 / fan_in)).astype(
            np.float32))

    monkeypatch.setattr(jlayers, "he_init", he_init)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def t(a):
    return torch.from_numpy(np.array(a))


def models(seed=0, depth=3, nf=8, channels=1):
    ref, port = dncnn_pair(channels=channels, depth=depth, seed=seed, nf=nf)
    return JM.ArtifactRemoval(ref), TM.ArtifactRemoval(port)


def images(shape=(2, 1, 12, 12), seed=0):
    return (np.random.default_rng(seed).random(shape) + 0.05).astype(np.float32)


def mask(shape, seed, p=0.7):
    return (np.random.default_rng(seed).random(shape) < p).astype(np.float32)


def inpainting(shape=(1, 12, 12), seed=1, p=0.7, sigma=None):
    m = mask(shape, seed, p)
    jn = None if sigma is None else JP.GaussianNoise(sigma)
    tn = None if sigma is None else TP.GaussianNoise(sigma, device=DEV)
    return (JP.Inpainting(shape, mask=jnp.asarray(m), noise_model=jn),
            TP.Inpainting(shape, mask=m, device=DEV, noise_model=tn))


def test_split_matches_jax():
    """``split`` on a physics with a mask (its mask times the split) and on
    one without (``compose(physics, Inpainting(mask))`` with the physics'
    noise model): the split measurement and operator; and the port's own
    Bernoulli split is a pixelwise subset of the physics' mask."""
    x = images(seed=1)
    m = mask((2, 1, 12, 12), 2)
    for jp, pp in (inpainting(seed=3), (JP.Denoising(JP.GaussianNoise(0.1)),
                                        TP.Denoising(TP.GaussianNoise(0.1, device=DEV)))):
        jy1, jp1 = jmeasplit.split(jnp.asarray(m), jnp.asarray(x), jp)
        py1, pp1 = tmeasplit.split(t(m), t(x), pp)
        assert rel(py1, jy1) == 0 and rel(pp1.A(t(x)), jp1.A(jnp.asarray(x))) == 0
        assert (pp1.noise_model is None) == (jp1.noise_model is None)
    jp, pp = inpainting((3, 12, 12), seed=4)
    own = tmeasplit.sample_split_mask(t(images((2, 3, 12, 12))), pp,
                                      torch.Generator().manual_seed(0), 0.6, True, None)
    pm = pp.mask
    assert bool((own <= pm).all()) and bool((own[:, :1] * pm[:, 1:2] == own[:, 1:2] * pm[:, :1]).all())


@pytest.mark.parametrize("mode", ["train", "eval", "eval_split_output", "eval_full_input"])
def test_splitting_model_matches_jax(mode):
    """``SplittingModel`` in training (one split) and in evaluation (three
    splits averaged, or their output complements, or the whole input), fed
    the JAX masks (``sample_split_mask`` at ``fold_in(key, i)``)."""
    jm, pm = models(seed=1)
    jp, pp = inpainting(seed=5)
    kw = dict(split_ratio=0.6, eval_n_samples=3, eval_split_output=mode == "eval_split_output",
              eval_split_input=mode != "eval_full_input")
    jw, pw = JL.SplittingModel(jm, **kw), TL.SplittingModel(pm, **kw)
    y = images(seed=6) * mask((1, 12, 12), 5)
    key = jax.random.key(7)
    train = mode == "train"
    masks = [t(jmeasplit.sample_split_mask(jnp.asarray(y), jp, jax.random.fold_in(key, i), 0.6,
                                           True, None)) for i in range(3)]
    want, jmask = jw(jnp.asarray(y), jp, key=key, train=train, return_mask=True)
    got, pmask = pw(t(y), pp, train=train, return_mask=True, masks=masks)
    assert rel(got.detach(), want) <= 1e-5
    assert (pmask is None) == (jmask is None)


@pytest.mark.parametrize("mode", ["adapted", "plain_model", "mask_generator"])
def test_splitting_loss_matches_jax(mode):
    """``SplittingLoss`` through its adapted model, through a plain model,
    and with a ``BernoulliSplittingMaskGenerator`` under the physics' mask,
    fed the JAX mask."""
    jm, pm = models(seed=2)
    jp, pp = inpainting(seed=6)
    y = images(seed=8) * mask((1, 12, 12), 6)
    key = jax.random.key(9)
    gen = None
    if mode == "mask_generator":
        gen = (JP.generator.BernoulliSplittingMaskGenerator((1, 12, 12), split_ratio=0.5),
               TP.generator.BernoulliSplittingMaskGenerator((1, 12, 12), split_ratio=0.5,
                                                            device=DEV))
    jl = JL.SplittingLoss(split_ratio=0.7, mask_generator=gen and gen[0])
    pl = TL.SplittingLoss(split_ratio=0.7, mask_generator=gen and gen[1])
    jmodel = jm if mode == "plain_model" else jl.adapt_model(jm)
    pmodel = pm if mode == "plain_model" else pl.adapt_model(pm)
    mkey = key if mode == "plain_model" else jax.random.fold_in(key, 0)
    m = jmeasplit.sample_split_mask(jnp.asarray(y), jp, mkey, 0.7, True, gen and gen[0])
    want = jl(y=jnp.asarray(y), physics=jp, model=jmodel, key=key)
    got = pl(y=t(y), physics=pp, model=pmodel, mask=t(m))
    assert rel(got.detach(), want) <= 1e-5


def test_neighbor2neighbor_matches_jax():
    """``Neighbor2Neighbor`` fed JAX's pair choices, its mask pair and
    sub-images, and its consistency branch run without a gradient."""
    jm, pm = models(seed=3)
    jp, pp = (JP.Denoising(JP.GaussianNoise(0.1)), TP.Denoising(TP.GaussianNoise(0.1, device=DEV)))
    y = images((2, 1, 12, 14), seed=9)
    key = jax.random.key(10)
    choice = t(jax.random.randint(key, (2, 1, 6, 7), 0, 8))
    want = JL.Neighbor2Neighbor(gamma=1.5)(y=jnp.asarray(y), physics=jp, model=jm, key=key)
    got = TL.Neighbor2Neighbor(gamma=1.5)(y=t(y), physics=pp, model=pm, choice=choice)
    assert rel(got.detach(), want) <= 1e-5
    got.sum().backward()
    x = images((2, 2, 8, 10), seed=11)
    jm1, jm2 = JL.Neighbor2Neighbor.generate_mask_pair(jnp.asarray(x), key=key)
    pm1, pm2 = TL.Neighbor2Neighbor.generate_mask_pair(
        t(x), choice=t(jax.random.randint(key, (2 * 4 * 5,), 0, 8)))
    assert np.array_equal(pm1.numpy(), np.asarray(jm1)) and np.array_equal(pm2.numpy(),
                                                                           np.asarray(jm2))
    want = JL.Neighbor2Neighbor.generate_subimages(jnp.asarray(x), jm1)
    assert rel(TL.Neighbor2Neighbor.generate_subimages(t(x), pm1), want) == 0


def _mri(seed=12, B=2, H=12, W=12):
    """Single-coil MRI with a column mask, and the two 2-channel models."""
    cols = (np.random.default_rng(seed).random(W) < 0.6).astype(np.float32)
    m = np.broadcast_to(cols, (H, W)).copy()
    return (JP.MRI(mask=jnp.asarray(m), img_size=(H, W)),
            TP.MRI(mask=m, img_size=(H, W), device=DEV), m)


@pytest.mark.parametrize("kind", ["weighted", "robust"])
def test_weighted_and_robust_splitting_match_jax(kind):
    """``WeightedSplittingLoss`` and ``RobustSplittingLoss`` on single-coil
    MRI through their adapted models (a 2-channel DnCNN): the k-space weight
    from the two generators' means (JAX's, handed to ``compute_weight``),
    the loss fed JAX's split mask and, for Robust-SSDU, its noise draw."""
    jm, pm = models(seed=4, channels=2)
    jp, pp, m = _mri()
    jpg = JP.generator.GaussianMaskGenerator((2, 12, 12), acceleration=2)
    jmg = JP.generator.BernoulliSplittingMaskGenerator((2, 12, 12), split_ratio=0.6)
    pmg = TP.generator.BernoulliSplittingMaskGenerator((2, 12, 12), split_ratio=0.6, device=DEV)
    wkey = jax.random.key(13)
    P = jpg.average(n=16, key=wkey)["mask"]
    P_tilde = jmg.average(n=16, key=wkey)["mask"]
    want_w = JL.WeightedSplittingLoss.compute_weight(jmg, jpg, n=16, key=wkey)
    got_w = TL.WeightedSplittingLoss.compute_weight(None, None, P=t(P), P_tilde=t(P_tilde))
    assert rel(got_w, want_w) <= 1e-6
    x = images((2, 2, 12, 12), seed=14)
    y = np.asarray(jp.A(jnp.asarray(x)))
    key = jax.random.key(15)
    if kind == "weighted":
        jl = JL.WeightedSplittingLoss(jmg)
        pl = TL.WeightedSplittingLoss(pmg, weight=t(want_w))
        jl.weight = want_w
    else:
        jl = JL.RobustSplittingLoss(jmg, noise_model=JP.GaussianNoise(0.05), alpha=0.5)
        pl = TL.RobustSplittingLoss(pmg, noise_model=TP.GaussianNoise(0.05, device=DEV),
                                    alpha=0.5, weight=t(want_w))
        jl.weight = want_w
    jmodel, pmodel = jl.adapt_model(jm), pl.adapt_model(pm)
    k0 = jax.random.fold_in(key, 0)
    split = jmeasplit.sample_split_mask(jnp.asarray(y), jp, k0, 0.9, True, jmg)
    want = jl(y=jnp.asarray(y), physics=jp, model=jmodel, key=key)
    if kind == "robust":
        noise = jax.random.normal(jax.random.fold_in(k0, 7), y.shape)
        x1, _ = pmodel(t(y), pp, train=True, return_mask=True, masks=[t(split)],
                       noise_draws=[t(noise)])
        jx1, _ = jmodel(jnp.asarray(y), jp, key=key, train=True, return_mask=True)
        assert rel(x1.detach(), jx1) <= 1e-5
        pmodel.forward = (lambda f: lambda *a, **k: f(*a, **dict(k, noise_draws=[t(noise)])))(
            pmodel.forward)
    got = pl(y=t(y), physics=pp, model=pmodel, mask=t(split))
    assert rel(got.detach(), want) <= 1e-5


@pytest.mark.parametrize("kind", ["phase2phase", "artifact2artifact"])
def test_dynamic_mri_splitting_matches_jax(kind):
    """``Phase2PhaseLoss`` (even frames in, odd scored) and
    ``Artifact2ArtifactLoss`` (a random chunk, JAX's) on dynamic MRI, through
    a plain model and through the adapted one."""
    T, H, W = 4, 8, 8
    m = np.broadcast_to(mask((T, H, W), 16, 0.6), (2, T, H, W)).copy()
    jp = JP.DynamicMRI(mask=jnp.asarray(m), img_size=(T, H, W))
    pp = TP.DynamicMRI(mask=m, img_size=(T, H, W), device=DEV)
    x = images((2, 2, T, H, W), seed=17)
    y = np.asarray(jp.A(jnp.asarray(x)))
    img = (2, T, H, W)
    if kind == "phase2phase":
        jl, pl = JL.Phase2PhaseLoss(img), TL.Phase2PhaseLoss(img, device=DEV)
    else:
        jl = JL.Artifact2ArtifactLoss(img, split_size=2)
        pl = TL.Artifact2ArtifactLoss(img, split_size=2, device=DEV)

    def jmodel(v, p):
        return jnp.tanh(1.5 * p.A_adjoint(v)) + 0.1 * p.A_adjoint(v) ** 2

    def pmodel(v, p):
        return torch.tanh(1.5 * p.A_adjoint(v)) + 0.1 * p.A_adjoint(v) ** 2

    key = jax.random.key(18)
    sp = jl.generator.step(2, key=key)["mask"]
    want = jl(y=jnp.asarray(y), physics=jp, model=jmodel, key=key)
    got = pl(y=t(y), physics=pp, model=pmodel, mask=t(sp))
    assert rel(got, want) <= 1e-5
    ja, pa = jl.adapt_model(jmodel), pl.adapt_model(pmodel)
    sp = jmeasplit.sample_split_mask(jnp.asarray(y), jp, jax.random.fold_in(key, 0), 0.9, True,
                                     jl.generator)
    want = jl(y=jnp.asarray(y), physics=jp, model=ja, key=key)
    got = pl(y=t(y), physics=pp, model=pa, mask=t(sp))
    assert rel(got, want) <= 1e-5


def test_ensure_matches_jax():
    """``ENSURELoss`` (a JVP divergence and the density-compensated
    residual) on inpainting with a Bernoulli mask generator's density
    (JAX's, handed in) and JAX's probe."""
    jm, pm = models(seed=5)
    jp, pp = inpainting(seed=7, sigma=0.05)
    gen = JP.generator.BernoulliSplittingMaskGenerator((1, 12, 12), split_ratio=0.7)
    jl = JL.ENSURELoss(0.05)
    jl.dsqrti = 1.0 / jnp.sqrt(jnp.clip(gen.average(n=8)["mask"], 1e-8, None))
    pl = TL.ENSURELoss(0.05, density=t(gen.average(n=8)["mask"]))
    y = images(seed=19) * mask((1, 12, 12), 7)
    key = jax.random.key(20)
    want = jax.jit(lambda v: jl(y=v, physics=jp, model=jm, key=key))(jnp.asarray(y))
    got = pl(y=t(y), physics=pp, model=pm, probe=t(jax.random.normal(key, y.shape)))
    assert rel(got.detach(), want) <= 1e-5


@pytest.mark.parametrize("kind", ["augment_consistency", "equivariant_splitting",
                                  "reduced_resolution"])
def test_augmentation_losses_match_jax(kind):
    """``AugmentConsistencyLoss`` (``Shift * Rotate(15)`` and
    ``RandomNoise``, JAX's parameters), ``EquivariantSplittingLoss`` over an
    ``EquivariantReconstructor`` (JAX's rotation and mask) and
    ``ReducedResolutionLoss`` through its adapted model (a noiseless
    degradation), on inpainting."""
    jm, pm = models(seed=6)
    jp, pp = inpainting(seed=8)
    x = images(seed=21)
    y = np.asarray(jp.A(jnp.asarray(x)))
    key = jax.random.key(22)
    yj = jnp.asarray(y)
    if kind == "augment_consistency":
        jl = JL.AugmentConsistencyLoss(T_i=JT.RandomNoise(0.05))
        pl = TL.AugmentConsistencyLoss(T_i=PT.RandomNoise(0.05))
        x_net = jm(yj, jp)
        k1, k2 = jax.random.split(key)
        kw = {"e_params": jax.tree_util.tree_map(t, jl.T_e.get_params(x_net, k1)),
              "i_params": {"eps": t(jl.T_i.get_params(yj, k2)["eps"])}}
        want = jl(x_net=x_net, y=yj, physics=jp, model=jm, key=key)
        got = pl(x_net=t(x_net), y=t(y), physics=pp, model=pm, **kw)
    elif kind == "equivariant_splitting":
        jr = JM.EquivariantReconstructor(jm, transform=JT.Rotate())
        pr = TM.EquivariantReconstructor(pm, transform=PT.Rotate())
        jl = JL.EquivariantSplittingLoss(split_ratio=0.7)
        pl = TL.EquivariantSplittingLoss(split_ratio=0.7)
        kg, km = jax.random.split(key)
        params = jl.transform.get_params(jp.A_adjoint(yj), kg)
        m = jax.random.bernoulli(km, 0.7, (2, 1, 12, 12)).astype(jnp.float32)
        rkey = jax.random.key(0)
        theta_r = JT.Rotate().get_params(yj, rkey)["theta"]
        want = jl(y=yj, physics=jp, model=lambda v, p: jr(v, p, key=rkey), key=key)
        got = pl(y=t(y), physics=pp, params={"theta": t(params["theta"])},
                 mask=t(jnp.broadcast_to(m, y.shape)),
                 model=lambda v, p: _equivariant(pr, v, p, theta_r))
    else:
        jdeg, pdeg = inpainting(seed=9, p=0.8)
        jl, pl = JL.ReducedResolutionLoss(physics=jdeg), TL.ReducedResolutionLoss(physics=pdeg)
        jmodel, pmodel = jl.adapt_model(jm), pl.adapt_model(pm)
        want = jl(x_net=jmodel(yj, jp), y=yj, physics=jp, model=jmodel)
        got = pl(x_net=pmodel(t(y), pp), y=t(y), physics=pp, model=pmodel)
        pmodel.eval()
        assert rel(pmodel(t(y), pp).detach(), jm(yj, jp)) <= 1e-5
    assert rel(got.detach(), want) <= 1e-5


def _equivariant(pr, v, p, theta):
    """The port's ``EquivariantReconstructor`` at JAX's rotation."""
    from deepinv_tpu_torch.models.wrappers_models import _transformed_physics

    params = {"theta": t(theta)}
    x_g = pr.model(v, _transformed_physics(p, pr.transform, params))
    return pr.transform.transform(x_g, **params)


def test_schedulers_match_jax():
    """The five schedulers choose alike call for call (Python's
    ``random.Random(seed)`` in both), including weighted random choices,
    and sum their active losses."""
    def names(s, **kw):
        return [[type(l).__name__ for l in s.select(**kw)] for _ in range(12)]

    for M_j, M_t in ((JL, TL),):
        a = [(M_j.SupLoss(), M_j.MCLoss(), M_j.TVLoss()), (M_t.SupLoss(), M_t.MCLoss(),
                                                           M_t.TVLoss())]
        pairs = [
            (M_j.RandomLossScheduler(*a[0], seed=5), M_t.RandomLossScheduler(*a[1], seed=5), {}),
            (M_j.RandomLossScheduler(*a[0], seed=1, weightings=[3, 1, 1]),
             M_t.RandomLossScheduler(*a[1], seed=1, weightings=[3, 1, 1]), {}),
            (M_j.InterleavedLossScheduler(*a[0]), M_t.InterleavedLossScheduler(*a[1]),
             {"step": 4}),
            (M_j.InterleavedEpochLossScheduler(*a[0]), M_t.InterleavedEpochLossScheduler(*a[1]),
             {"epoch": 5}),
            (M_j.StepLossScheduler(*a[0], epoch_thresh=2), M_t.StepLossScheduler(
                *a[1], epoch_thresh=2), {"epoch": 3}),
        ]
        for sj, st, kw in pairs:
            assert names(sj, **kw) == names(st, **kw)
    x = images(seed=23)
    jl = JL.BaseLossScheduler(JL.SupLoss(), JL.TVLoss())(x_net=jnp.asarray(x) * 0.5,
                                                         x=jnp.asarray(x))
    pl = TL.BaseLossScheduler(TL.SupLoss(), TL.TVLoss())(x_net=t(x) * 0.5, x=t(x))
    assert rel(pl, jl) <= 1e-6
    assert TL.StepLossScheduler(TL.SupLoss())(x_net=t(x), x=t(x)) == 0.0


def test_checkpointer_round_trip(tmp_path):
    """``OrbaxCheckpointer`` (``torch.save``, not orbax): the same bits come
    back for the model, the optimizer state and the extras; only the newest
    ``max_to_keep`` steps stay; an asynchronous save copies the state first,
    so a later in-place change does not reach the file."""
    ck = TT.OrbaxCheckpointer(str(tmp_path / "ck"), max_to_keep=2)
    net = TM.DnCNN(1, 1, depth=2, nf=4, device=DEV)
    opt = torch.optim.Adam(net.parameters(), lr=1e-2)
    net(torch.rand(1, 1, 8, 8)).sum().backward()
    opt.step()
    saved = {k: v.clone() for k, v in net.state_dict().items()}
    for step in range(4):
        ck.save(step, net, opt, extra={"loss_history": np.float32([1.0, 0.5]), "n": step})
        if step == 3:
            with torch.no_grad():
                for p in net.parameters():
                    p.add_(1.0)
    ck.wait()
    assert ck.latest_step() == 3 and sorted(os.listdir(ck.directory)) == ["2", "3"]
    net2 = TM.DnCNN(1, 1, depth=2, nf=4, device=DEV)
    opt2 = torch.optim.Adam(net2.parameters(), lr=1e-2)
    _, _, extra, step = ck.restore(net2, opt2)
    assert step == 3 and extra["n"] == 3 and torch.equal(extra["loss_history"],
                                                         torch.tensor([1.0, 0.5]))
    for k, v in net2.state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert torch.equal(opt2.state_dict()["state"][0]["exp_avg"],
                       opt.state_dict()["state"][0]["exp_avg"])
    ck.close()


def test_trainer_resumes_from_the_orbax_backend(tmp_path):
    """``ckpt_backend="orbax"``: two epochs saved by the checkpointer, a new
    Trainer restored from it and run one more epoch, equal to three
    uninterrupted epochs (the same weights bit for bit)."""
    x, y = images((4, 1, 12, 12), seed=24), images((4, 1, 12, 12), seed=25)

    def trainer(epochs, path):
        torch.manual_seed(0)
        model = TM.ArtifactRemoval(TM.DnCNN(1, 1, depth=2, nf=4, device=DEV))
        return TT.Trainer(model, TP.Denoising(), train_dataloader=DataLoader(
            ArrayDataset(x, y), batch_size=2), epochs=epochs, save_path=path,
            ckpt_backend="orbax", verbose=False,
            optimizer=torch.optim.Adam(model.parameters(), lr=1e-2))

    full = trainer(3, None)
    full.train()
    first = trainer(2, str(tmp_path))
    first.train()
    first._orbax.wait()
    resumed = trainer(3, str(tmp_path))
    resumed.load_model(str(tmp_path / "ckp_1.pkl"))
    assert resumed.epoch_start == 2 and len(resumed.loss_history) == 2
    resumed.train()
    for (k, v), w in zip(full.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(v, w), k
    assert resumed.loss_history == full.loss_history
    with pytest.raises(ValueError):
        TT.Trainer(full.model, TP.Denoising(), ckpt_backend="zarr")


def _record(monkeypatch, jax_owner, name, port_owner):
    """Wrap the JAX ``jax_owner.name`` to record its results and make the
    port's ``port_owner.name`` return them, in the order drawn."""
    drawn = []
    orig = getattr(jax_owner, name)

    def jax_side(*a, **k):
        out = orig(*a, **k)
        v = out
        while hasattr(v, "primal"):  # a draw made under the train step's grad
            v = v.primal
        drawn.append(np.asarray(v))
        return out

    def port_side(*a, **k):
        return t(drawn.pop(0))

    monkeypatch.setattr(jax_owner, name, jax_side)
    monkeypatch.setattr(port_owner, name, port_side)
    return drawn


def _ssl_trainers(losses_j, losses_t, jp, pp, seed=10, n=8, epochs=2):
    ref, port = dncnn_pair(depth=3, seed=seed, nf=8)
    x = images((n, 1, 12, 12), seed=26)
    y = np.asarray(jp.A(jnp.asarray(x))) + 0.05 * np.random.default_rng(27).standard_normal(
        x.shape).astype(np.float32)
    jt = JaxTrainer(JM.ArtifactRemoval(ref), jp, optimizer=optax.adam(1e-3, eps=1e-3),
                    train_dataloader=JaxDataLoader(JaxArrayDataset(x, y), batch_size=4),
                    losses=losses_j, epochs=epochs, verbose=False)
    model = TM.ArtifactRemoval(port)
    pt = TT.Trainer(model, pp, optimizer=torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-3,
                                                           foreach=False),
                    train_dataloader=DataLoader(ArrayDataset(x, y), batch_size=4),
                    losses=losses_t, epochs=epochs, verbose=False)
    return jt, pt


@pytest.mark.parametrize("kind", ["splitting", "r2r", "random_scheduler"])
def test_trainer_with_self_supervised_losses_matches_jax(kind, monkeypatch):
    """Four steps (two epochs of two batches) of the Trainer with
    ``SplittingLoss``, ``R2RLoss`` and a ``RandomLossScheduler`` of a
    splitting and an MC loss, the JAX masks and corruptions replayed: the
    loss history within 1e-4 and each weight tensor within 1e-4 (relative
    L2), the bounds of ``tests/test_torch_training.py`` (Adam at eps
    1e-3). R2R's noise level stays fixed in the port, as upstream's; the JAX
    Trainer differentiates every float leaf and moves it."""
    if kind == "r2r":
        jp, pp = JP.Denoising(), TP.Denoising()
        lj = JL.R2RLoss(noise_model=JP.GaussianNoise(0.05), eval_n_samples=2)
        lt = TL.R2RLoss(noise_model=TP.GaussianNoise(0.05, device=DEV), eval_n_samples=2)
        _record(monkeypatch, JL.R2RModel, "corrupt", TL.R2RModel)
    else:
        jp, pp = inpainting(seed=11)
        lj = JL.SplittingLoss(split_ratio=0.7, eval_n_samples=2)
        lt = TL.SplittingLoss(split_ratio=0.7, eval_n_samples=2)
        if kind == "random_scheduler":
            lj = JL.RandomLossScheduler(lj, JL.MCLoss(), seed=2)
            lt = TL.RandomLossScheduler(lt, TL.MCLoss(), seed=2)
        _record(monkeypatch, jmeasplit, "sample_split_mask", tmeasplit)
    jt, pt = _ssl_trainers(lj, lt, jp, pp)
    with jax.disable_jit():
        jt.train()
    pt.train()
    assert len(pt.loss_history) == 2
    assert rel(pt.loss_history, jt.loss_history) <= 1e-4
    want = jax_params(jt.model.model.backbone_net)
    for k, v in pt.model.model.backbone_net.state_dict().items():
        assert np.linalg.norm(v.numpy() - want[k]) <= 1e-4 * np.linalg.norm(want[k]), k
    if kind == "r2r":  # JAX's Trainer trains the noise level too (ROADMAP queue 3)
        assert float(pt.model.noise_model.sigma) == np.float32(0.05)
        assert float(jt.model.noise_model.sigma) != np.float32(0.05)


def test_trainer_feeds_a_splitting_model_one_split_a_step(monkeypatch):
    """The ``train_aware`` protocol: in a train step the Trainer calls a
    ``SplittingModel`` with ``train=True``, so its reconstruction sees one
    split, as the JAX Trainer's does (two network calls a step: the
    reconstruction's and the loss's), and evaluation averages
    ``eval_n_samples`` splits from a generator of its own."""
    calls = {"jax": 0, "port": 0}
    jp, pp = inpainting(seed=12)
    lj = JL.SplittingLoss(split_ratio=0.7, eval_n_samples=3)
    lt = TL.SplittingLoss(split_ratio=0.7, eval_n_samples=3)
    jt, pt = _ssl_trainers(lj, lt, jp, pp, n=4, epochs=1)
    jcall, pfwd = JM.ArtifactRemoval.__call__, TM.ArtifactRemoval.forward

    def jax_counted(self, *a, **k):
        calls["jax"] += 1
        return jcall(self, *a, **k)

    def port_counted(self, *a, **k):
        calls["port"] += 1
        return pfwd(self, *a, **k)

    monkeypatch.setattr(JM.ArtifactRemoval, "__call__", jax_counted)
    monkeypatch.setattr(TM.ArtifactRemoval, "forward", port_counted)
    with jax.disable_jit():
        jt.train()
    pt.train()
    assert calls["port"] == calls["jax"] == 2
    calls["port"] = 0
    x = images((4, 1, 12, 12), seed=28)
    pt.test([DataLoader(ArrayDataset(x, x * mask((1, 12, 12), 12)), batch_size=4)])
    assert calls["port"] == 3


def test_training_exports_every_jax_name():
    """``deepinv_tpu_torch.training`` has every public name of the JAX
    package's, ``OrbaxCheckpointer`` a ``torch.save`` checkpointer."""
    import deepinv_tpu.training as jtraining

    names = [n for n in dir(jtraining) if not n.startswith("_") and not isinstance(
        getattr(jtraining, n), type(jtraining))]
    assert [n for n in names if n not in TT.__all__] == []
    assert "not orbax" in TT.OrbaxCheckpointer.__doc__
