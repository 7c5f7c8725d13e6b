"""The GAN models (``models/gan.py``), the adversarial losses
(``loss/adversarial.py``) and the adversarial trainer
(``training/adversarial.py``) of the port against the JAX package's, on the
CPU, in f32, at small widths, with the JAX leaves redrawn at random (the
norms' statistics too) and carried by ``load_jax_params``.

Bounds: the modules' outputs and the losses within 1e-5 relative (max abs
error over the reference's max abs), their gradients with respect to
``x_net`` within 1e-5; CSGM's output from the same ``z0`` within 1e-4 (five
heavy-ball steps through the generator's gradient); the trainer's losses
and both networks' weights after two steps within 1e-4 (relative max of the
losses, relative L2 of each weight tensor), with Adam's eps at 1e-3 as in
``tests/test_torch_training.py``. The gradient-leak test and the kernel-gate
test hold exact counts and equalities.
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepinv_tpu.loss as JL
import deepinv_tpu.models as JM
import deepinv_tpu.models.layers as jlayers
import deepinv_tpu_torch.loss as TL
import deepinv_tpu_torch.models as TM
import deepinv_tpu_torch.ops.kernels.conv_chain as cc
from deepinv_tpu.datasets import ArrayDataset as JaxArrayDataset
from deepinv_tpu.datasets import DataLoader as JaxDataLoader
from deepinv_tpu.physics import Denoising as JaxDenoising
from deepinv_tpu.training import AdversarialTrainer as JaxAdversarialTrainer
from deepinv_tpu_torch.datasets import ArrayDataset, DataLoader
from deepinv_tpu_torch.physics import Denoising, GaussianNoise
from deepinv_tpu_torch.training import AdversarialOptimizer, AdversarialTrainer
from test_torch_dncnn import _pair as dncnn_pair
from test_torch_drunet import DEV, jax_params

BOUND = 1e-5


@pytest.fixture(autouse=True)
def numpy_he_init(monkeypatch):
    """The JAX layers' He-normal weights drawn by numpy: ``jax.random``
    compiles a draw for every new shape, most of a small test's time on the
    CPU. The weights are random either way and cross to the port as they
    are."""
    rng = np.random.default_rng(0)

    def he_init(key, shape, fan_in, dtype=jnp.float32):
        return jnp.asarray((rng.standard_normal(shape) * math.sqrt(2.0 / fan_in)).astype(
            np.float32))

    monkeypatch.setattr(jlayers, "he_init", he_init)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _name(path) -> str:
    return ".".join(str(getattr(k, "name", getattr(k, "idx", getattr(k, "key", k))))
                    for k in path)


def randomized(ref, seed: int, weights: bool = True):
    """``ref`` with every float leaf redrawn: weights normal over
    ``sqrt(fan_in)`` (or kept, with ``weights=False``), norm scales near 1,
    running variances in [1, 1.2], biases and means near 0."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(ref)
    new = []
    for path, v in leaves:
        leaf, a = _name(path).rsplit(".", 1)[-1], np.asarray(v)
        if a.ndim > 1 and not weights:
            new.append(v)
            continue
        if leaf == "running_var":
            r = 1.0 + 0.2 * rng.random(a.shape)
        elif a.ndim == 1 and leaf == "weight":
            r = 1.0 + 0.1 * rng.standard_normal(a.shape)
        elif a.ndim <= 1:
            r = 0.05 * rng.standard_normal(a.shape)
        else:
            r = rng.standard_normal(a.shape) / math.sqrt(int(np.prod(a.shape[1:])))
        new.append(jnp.asarray(r, jnp.float32))
    return jax.tree_util.tree_unflatten(treedef, new)


def crossed(name, seed, jkw, tkw=None):
    """The JAX model ``name`` randomized, and the port's with its leaves."""
    ref = randomized(getattr(JM, name)(key=jax.random.key(seed), **jkw), seed)
    port = getattr(TM, name)(device=DEV, **(jkw if tkw is None else tkw))
    return ref, TM.load_jax_params(port, jax_params(ref))


def image(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


GANS = {
    "PatchGANDiscriminator": (dict(input_nc=1, ndf=8, n_layers=3), (2, 1, 64, 64)),
    "ESRGANDiscriminator": (dict(input_shape=(3, 32, 32)), (2, 3, 32, 32)),
    "DCGANGenerator": (dict(nz=16, ngf=8, nc=3), (2, 16)),
    "DCGANDiscriminator": (dict(ndf=8, nc=3), (2, 3, 64, 64)),
}


@pytest.mark.parametrize("name", sorted(GANS))
def test_gan_module_matches_jax(name):
    kw, shape = GANS[name]
    ref, port = crossed(name, 1, kw)
    x = image(shape, 2) * 2 - 1
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    want = jax.jit(lambda m, v: m(v))(ref, jnp.asarray(x))
    assert got.shape == want.shape
    assert rel(got, want) <= BOUND


class _JaxSubsample:
    """A linear operator in both packages: every other pixel of each axis."""

    def A(self, x):
        return x[..., ::2, ::2]


def test_csgm_from_the_same_latent_matches_jax():
    """``CSGMGenerator(DCGANGenerator)`` from the same ``z0``: the fitted
    image, and the generator's weights left as they were."""
    ref_g, port_g = crossed("DCGANGenerator", 3, dict(nz=8, ngf=4, nc=1))
    before = copy.deepcopy(port_g.state_dict())
    ref = JM.CSGMGenerator(ref_g, inf_max_iter=5, inf_lr=1e-3)
    port = TM.CSGMGenerator(port_g, inf_max_iter=5, inf_lr=1e-3)
    y = image((2, 1, 32, 32), 4)
    z0 = np.random.default_rng(5).standard_normal((2, 8)).astype(np.float32)
    want = jax.jit(lambda m, z, v: m.G(m.optimize_z(z, v, _JaxSubsample())))(
        ref, jnp.asarray(z0), jnp.asarray(y))
    got = port(torch.from_numpy(y), _JaxSubsample(), z0=torch.from_numpy(z0))
    assert rel(got, want) <= 1e-4
    assert all(torch.equal(v, before[k]) for k, v in port_g.state_dict().items())
    assert all(p.grad is None for p in port_g.parameters())
    lat = port.random_latent(torch.Generator().manual_seed(0), batch_size=3)
    assert lat.shape == (3, 8) and float(lat.abs().max()) <= 1.0


def _loss_setup(seed=6):
    """A crossed PatchGAN, a small crossed DnCNN, a denoising pair."""
    ref_d, port_d = crossed("PatchGANDiscriminator", seed, dict(input_nc=1, ndf=8, n_layers=2))
    ref_m, port_m = dncnn_pair(depth=3, seed=seed, nf=8)
    x = image((2, 1, 32, 32), seed + 1)
    y = (x + 0.1 * np.random.default_rng(seed + 2).standard_normal(x.shape)).astype(np.float32)
    x_net = image((2, 1, 32, 32), seed + 3)
    return (ref_d, ref_m), (port_d, port_m), (x, y, x_net)


class _JaxModel:
    def __init__(self, m):
        self.m = m

    def __call__(self, y, physics):
        return self.m(y, 0.1)


class _PortModel(torch.nn.Module):
    def __init__(self, m):
        super().__init__()
        self.m = m

    def forward(self, y, physics):
        return self.m(y, 0.1)


LOSSES = {
    "SupAdversarialGeneratorLoss": {"weight_adv": 0.3},
    "SupAdversarialDiscriminatorLoss": {},
    "UnsupAdversarialGeneratorLoss": {},
    "UnsupAdversarialDiscriminatorLoss": {"weight_adv": 2.0},
    "UAIRGeneratorLoss": {"weight_adv": 0.5, "weight_mc": 0.7},
    "GeneratorLoss": {},
    "DiscriminatorLoss": {},
    "DiscriminatorMetric": {"real_label": 0.9, "fake_label": 0.1},
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_adversarial_loss_matches_jax(name):
    """Each loss's value, and its gradient with respect to ``x_net`` (zero
    where the loss stops it), on the same D, model and data."""
    (ref_d, ref_m), (port_d, port_m), (x, y, x_net) = _loss_setup()
    kw = LOSSES[name]
    jloss, tloss = getattr(JL, name)(**kw), getattr(TL, name)(**kw)
    jphys, tphys = JaxDenoising(), Denoising()

    def jcall(xn):
        if name == "DiscriminatorMetric":
            return jloss(ref_d(xn), real=True) + jloss(ref_d(xn), real=False)
        if name in ("GeneratorLoss", "DiscriminatorLoss"):
            return jloss.adversarial_loss(jnp.asarray(x), xn, ref_d)
        return jloss(x=jnp.asarray(x), x_net=xn, y=jnp.asarray(y), physics=jphys,
                     model=_JaxModel(ref_m), D=ref_d)

    def tcall(xn):
        if name == "DiscriminatorMetric":
            return tloss(port_d(xn), real=True) + tloss(port_d(xn), real=False)
        if name in ("GeneratorLoss", "DiscriminatorLoss"):
            return tloss.adversarial_loss(torch.from_numpy(x), xn, port_d)
        return tloss(x=torch.from_numpy(x), x_net=xn, y=torch.from_numpy(y), physics=tphys,
                     model=_PortModel(port_m), D=port_d)

    want, jgrad = jax.jit(jax.value_and_grad(jcall))(jnp.asarray(x_net))
    xn = torch.from_numpy(x_net).requires_grad_()
    got = tcall(xn)
    (tgrad,) = torch.autograd.grad(got, xn, allow_unused=True)
    tgrad = torch.zeros_like(xn) if tgrad is None else tgrad
    assert got.dim() == 0 and rel(got.detach(), want) <= BOUND
    jgrad = np.asarray(jgrad)
    if np.abs(jgrad).max() == 0:
        assert float(tgrad.abs().max()) == 0.0
    else:
        assert rel(tgrad, jgrad) <= BOUND


def _data(n, seed, size=32):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 1, size, size)).astype(np.float32)
    return x, (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)


def _trainers(**kw):
    """The JAX and the port's adversarial trainer on the same weights and
    offline batches: ``DnCNN(1, 1, depth=4, nf=16)`` against
    ``PatchGANDiscriminator(input_nc=1, ndf=8, n_layers=2)`` at 32², two
    steps of batch 4, Adam with eps 1e-3 (see
    ``tests/test_torch_training.py``)."""
    ref, port = dncnn_pair(depth=4, seed=8, nf=16)
    ref_d, port_d = crossed("PatchGANDiscriminator", 9, dict(input_nc=1, ndf=8, n_layers=2))
    x, y = _data(8, 10)
    jt = JaxAdversarialTrainer(
        JM.ArtifactRemoval(ref), JaxDenoising(), D=ref_d,
        losses=[JL.SupLoss(), JL.SupAdversarialGeneratorLoss(0.1)],
        optimizer=optax.adam(1e-3, eps=1e-3), optimizer_d=optax.adam(1e-3, eps=1e-3),
        train_dataloader=JaxDataLoader(JaxArrayDataset(x, y), batch_size=4), epochs=1,
        verbose=False, **kw)
    model = TM.ArtifactRemoval(port)
    opt = AdversarialOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-3, foreach=False),
        torch.optim.Adam(port_d.parameters(), lr=1e-3, eps=1e-3, foreach=False))
    pt = AdversarialTrainer(
        model, Denoising(), D=port_d, losses=[TL.SupLoss(), TL.SupAdversarialGeneratorLoss(0.1)],
        optimizer=opt.g, optimizer_d=opt.d,
        train_dataloader=DataLoader(ArrayDataset(x, y), batch_size=4), epochs=1, verbose=False,
        **kw)
    return jt, pt


def test_adversarial_trainer_matches_jax():
    """Two steps: the generator's and the discriminator's losses, both
    networks' weights, the recorded gradient norms of both."""
    jt, pt = _trainers(check_grad=True)
    jt.train()
    pt.train()
    assert len(pt.logs_total_loss_train.vals) == 2
    assert rel(pt.logs_total_loss_train.vals, jt.logs_total_loss_train.vals) <= 1e-4
    assert rel(pt.logs_total_loss_d.vals, jt.logs_total_loss_d.vals) <= 1e-4
    assert rel(pt.check_grad_val.vals, jt.check_grad_val.vals) <= 1e-4
    assert rel(pt.check_grad_val_D.vals, jt.check_grad_val_D.vals) <= 1e-4
    for jnet, tnet in ((jt.model.backbone_net, pt.model.backbone_net), (jt.D, pt.D)):
        want = jax_params(jnet)
        for k, v in tnet.state_dict().items():
            assert np.linalg.norm(v.numpy() - want[k]) <= 1e-4 * np.linalg.norm(want[k]), k


def test_generator_step_leaks_no_gradient_into_the_discriminator():
    """With ``optimizer_d`` plain SGD at lr 1, D's update is minus the
    gradient of the discriminator's loss alone, taken on the updated
    generator's output: the generator step's backward also reaches D's
    parameters, and none of that may remain in D's step."""
    _, pt = _trainers()
    pt.optimizer_d = torch.optim.SGD(pt.D.parameters(), lr=1.0)
    pt.setup_train()
    batch = next(pt.current_train_iterators[0])
    x, y, phys = pt.get_samples(batch, pt.physics[0], None)
    d0 = copy.deepcopy(pt.D)
    pt.generator_step(x, y, phys, (0, 0, 0))
    assert any(p.grad is not None and float(p.grad.abs().max()) > 0 for p in pt.D.parameters())
    with torch.no_grad():
        x_net = pt.model(y, phys)
    loss = TL.SupAdversarialDiscriminatorLoss()(x=x, x_net=x_net, D=d0)
    want = torch.autograd.grad(loss, list(d0.parameters()))
    pt.discriminator_step(x, y, phys, (0, 0, 0))
    for p0, p1, g in zip(d0.parameters(), pt.D.parameters(), want):
        assert torch.allclose(p1 - p0, -g, rtol=1e-5, atol=1e-7)


def test_fused_chains_govern_both_steps(monkeypatch):
    """A bf16 DnCNN (nf 64) against a PatchGAN on the CPU: with
    ``fused_chains=True`` each step runs the chain op's stash forward and
    backward once in the generator step and its inference forward once in
    the discriminator step (the plain versions here; K6, the stash backward
    and K5 on the card), with ``False`` none of them; eval batches take the
    base step."""
    calls = {"stash": 0, "backward": 0, "plain": 0}

    def counted(key, fn):
        return lambda *a, **k: calls.__setitem__(key, calls[key] + 1) or fn(*a, **k)

    monkeypatch.setattr(cc, "conv_chain_stash", counted("stash", cc.conv_chain_stash))
    monkeypatch.setattr(cc, "stash_backward", counted("backward", cc.stash_backward))
    monkeypatch.setattr(cc, "conv_chain_plain", counted("plain", cc.conv_chain_plain))
    x, _ = _data(4, 11, size=16)
    for fused in (True, False):
        for k in calls:
            calls[k] = 0
        net = TM.DnCNN(1, 1, depth=4, generator=torch.Generator().manual_seed(1), device=DEV)
        model = TM.ArtifactRemoval(TM.autocast(net))
        D = TM.PatchGANDiscriminator(input_nc=1, ndf=8, n_layers=2, device=DEV)
        t = AdversarialTrainer(
            model, Denoising(GaussianNoise(0.1, device=DEV)), D=D,
            losses=[TL.SupLoss(), TL.SupAdversarialGeneratorLoss()],
            train_dataloader=DataLoader(ArrayDataset(x), batch_size=2),
            eval_dataloader=DataLoader(ArrayDataset(x[:2]), batch_size=2), epochs=1,
            online_measurements=True, verbose=False, fused_chains=fused)
        t.train()
        steps = len(t.logs_total_loss_train.vals)
        assert steps == 2 and all(np.isfinite(t.logs_total_loss_d.vals))
        # two train steps, then one eval batch on the inference forward
        want = {"stash": 2, "backward": 2, "plain": 3} if fused else \
            {"stash": 0, "backward": 0, "plain": 1}
        assert calls == want, (fused, calls)


def test_loss_and_training_export_the_slice():
    """``deepinv_tpu_torch.loss`` has every name of the JAX ``metric.py``,
    ``perceptual.py`` and ``adversarial.py``; ``deepinv_tpu_torch.training``
    has ``AdversarialTrainer``, ``AdversarialOptimizer`` and ``train`` (which
    runs a ``Trainer`` and returns its model)."""
    import deepinv_tpu.loss.adversarial as jadv
    import deepinv_tpu.loss.metric as jmetric
    import deepinv_tpu.loss.perceptual as jperc
    import deepinv_tpu_torch.training as TT

    for mod in (jmetric, jperc, jadv):
        assert [n for n in mod.__all__ if n not in TL.__all__] == [], mod.__name__
    assert {"AdversarialTrainer", "AdversarialOptimizer", "train"} <= set(TT.__all__)
    x, _ = _data(4, 12, size=16)
    model = TM.ArtifactRemoval(TM.DnCNN(1, 1, depth=2, nf=4, device=DEV))
    assert TT.train(model, Denoising(GaussianNoise(0.1, device=DEV)),
                    DataLoader(ArrayDataset(x), batch_size=2), epochs=1,
                    online_measurements=True, verbose=False) is model
