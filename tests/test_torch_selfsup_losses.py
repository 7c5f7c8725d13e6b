"""The port's self-supervised losses of ``losses.py``, ``sure.py`` and
``base.py`` against the JAX package's, on the CPU in f32.

The model is ``ArtifactRemoval`` of a small DnCNN with the same weights in
both packages. Keys and generators cannot draw alike, so each loss is handed
the JAX draws (its probes, corruptions, operator index or transform
parameters), remade here from the JAX loss's own key path. The JAX side runs
through ``jax.jit``: eager JAX compiles every op for every new shape. Bounds
are 1e-5 of the reference's max unless a test says why.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepinv_tpu.loss as JL
import deepinv_tpu.models as JM
import deepinv_tpu.models.layers as jlayers
import deepinv_tpu.physics as JP
import deepinv_tpu.transform as JT
import deepinv_tpu_torch.loss as TL
import deepinv_tpu_torch.models as TM
import deepinv_tpu_torch.physics as TP
import deepinv_tpu_torch.transform as PT
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


def models(seed=0, depth=3, nf=8):
    """``ArtifactRemoval(DnCNN(1, 1, depth, nf))`` in both packages."""
    ref, port = dncnn_pair(depth=depth, seed=seed, nf=nf)
    return JM.ArtifactRemoval(ref), TM.ArtifactRemoval(port)


def images(shape=(2, 1, 12, 12), seed=0, scale=1.0):
    return (np.random.default_rng(seed).random(shape) * scale + 0.05).astype(np.float32)


def denoising(sigma=0.1):
    return (JP.Denoising(JP.GaussianNoise(sigma)),
            TP.Denoising(TP.GaussianNoise(sigma, device=DEV)))


def inpainting(shape=(1, 12, 12), seed=1, p=0.7):
    m = (np.random.default_rng(seed).random(shape) < p).astype(np.float32)
    return (JP.Inpainting(shape, mask=jnp.asarray(m)),
            TP.Inpainting(shape, mask=m, device=DEV), m)


def test_divergences_match_jax():
    """``exact_div`` (the Jacobian's trace, on 1x1x6x6), ``hutch_div`` over
    two JVP probes and ``mc_div``'s finite difference, fed JAX's probes. The
    finite difference divides the two forwards' f32 rounding by tau = 1e-2,
    so ``mc_div`` is held to 1e-4."""
    jm, pm = models(seed=1)
    jp, pp = denoising()
    y = images((1, 1, 6, 6), seed=2)
    want = jax.jit(lambda v: JL.exact_div(v, jp, jm))(jnp.asarray(y))
    assert rel(TL.exact_div(t(y), pp, pm).detach(), want) <= 1e-5
    y = images(seed=3)
    key = jax.random.key(4)
    want = jax.jit(lambda v: JL.hutch_div(v, jp, jm, mc_iter=2, key=key))(jnp.asarray(y))
    probes = [t(jax.random.normal(jax.random.fold_in(key, i), y.shape)) for i in range(2)]
    got = TL.hutch_div(t(y), pp, pm, mc_iter=2, probes=probes)
    assert rel(got.detach(), want) <= 1e-5
    y1 = jp.A(jm(jnp.asarray(y), jp))
    want = jax.jit(lambda v, u: JL.mc_div(u, v, jm, jp, 1e-2, key=key))(jnp.asarray(y), y1)
    got = TL.mc_div(t(y1), t(y), pm, pp, 1e-2, probe=t(jax.random.normal(key, y.shape)))
    assert rel(got.detach(), want) <= 1e-4


def _sure(M, name):
    return {"gauss": lambda: M.SureGaussianLoss(0.1, tau=1e-2),
            "gauss_unsure": lambda: M.SureGaussianLoss(0.1, unsure=True, step_size=1e-2),
            "poisson": lambda: M.SurePoissonLoss(gain=0.05),
            "pg": lambda: M.SurePGLoss(0.05, 0.05),
            "pg_second_derivative": lambda: M.SurePGLoss(0.05, 0.05, second_derivative=True),
            "pg_unsure": lambda: M.SurePGLoss(0.05, 0.05, unsure=True, step_size=(1e-2, 1e-2)),
            }[name]()


def _sure_draws(name, y, key):
    """The probes of the JAX loss's key path (losses.py:238-338)."""
    if name.startswith("gauss"):
        return {"probe": t(jax.random.normal(key, y.shape))}
    if name == "poisson":
        return {"probe": t(jax.random.bernoulli(key, 0.5, y.shape).astype(jnp.float32) * 2 - 1)}
    k1, k2 = jax.random.split(key)
    p = 0.7236
    u = np.asarray(jax.random.uniform(k2, y.shape))
    b2 = np.where(u < p, -np.sqrt((1 - p) / p), np.sqrt(p / (1 - p))).astype(np.float32)
    return {"probe": t(jax.random.bernoulli(k1, 0.5, y.shape).astype(jnp.float32) * 2 - 1),
            "probe2": t(b2)}


@pytest.mark.parametrize("name", ["gauss", "gauss_unsure", "poisson", "pg",
                                  "pg_second_derivative", "pg_unsure"])
def test_sure_losses_match_jax(name):
    """SURE-Gaussian (JVP divergence; with UNSURE's sigma^2 ascent), SURE-
    Poisson and SURE-PG (finite differences; the second-order term; UNSURE's
    sigma^2 and gain), two calls each, fed JAX's probes: the losses, and the
    learnt noise levels after the calls. The finite differences divide the
    forwards' f32 rounding by tau1 = 1e-3 (and tau2^2 = 1e-4), so those
    losses are held to 1e-3 of their max; the JVP's to 1e-5."""
    jm, pm = models(seed=2)
    jp, pp = denoising()
    y = images(seed=5, scale=0.8)
    jl, pl = _sure(JL, name), _sure(TL, name)
    bound = 1e-5 if name.startswith("gauss") else 1e-3
    for call in range(2):
        key = jax.random.key(10 + call)
        want = jl(y=jnp.asarray(y), physics=jp, model=jm, key=key)
        got = pl(y=t(y), physics=pp, model=pm, **_sure_draws(name, y, key))
        assert rel(got.detach(), want) <= bound, call
    for attr in ("sigma2", "gain"):
        if hasattr(jl, attr):
            assert abs(getattr(pl, attr) - float(getattr(jl, attr))) <= 1e-3 * abs(
                float(getattr(jl, attr))), attr


def test_forward_mode_losses_close_the_kernel_gates():
    """SURE's JVP and the Jacobian norm over a bf16 DnCNN, whose hidden chain
    is the kernel op (no forward-mode rule, no second derivative): they run
    the layers instead, so they equal the same losses run with the gates
    closed by the caller, and the norm's gradient reaches the weights."""
    from deepinv_tpu_torch.ops.kernels.conv_chain import fused_chains_disabled

    net = TM.autocast(TM.DnCNN(1, 1, depth=4, nf=8, device=DEV), torch.bfloat16)
    model = TM.ArtifactRemoval(net)
    _, pp = denoising()
    y = t(images(seed=6))
    probe = torch.randn(y.shape, generator=torch.Generator().manual_seed(0))
    got = TL.SureGaussianLoss(0.1)(y=y, physics=pp, model=model, probe=probe)
    with fused_chains_disabled():
        want = TL.SureGaussianLoss(0.1)(y=y, physics=pp, model=model, probe=probe)
    assert torch.equal(got, want)
    norm = TL.JacobianSpectralNorm(max_iter=3)(y=y, model=model, physics=pp, u0=probe)
    norm.backward()
    assert torch.isfinite(norm) and net.denoiser.in_conv.weight.grad.abs().sum() > 0


@pytest.mark.parametrize("mode", ["list", "generator", "moei"])
def test_multi_operator_losses_match_jax(mode):
    """``MOILoss`` over a list of two inpainting operators (the index JAX
    draws) and with a ``BernoulliSplittingMaskGenerator`` (its masks), and
    ``MOEILoss`` with an any-angle ``Rotate`` (its angles), noiseless."""
    jm, pm = models(seed=3)
    (j1, p1, _), (j2, p2, _) = inpainting(seed=2), inpainting(seed=3, p=0.5)
    x = images(seed=7)
    key = jax.random.key(20)
    kidx, _ = jax.random.split(key)
    xn = jnp.asarray(x)
    if mode == "list":
        jl = JL.MOILoss([j1, j2], apply_noise=False)
        pl = TL.MOILoss([p1, p2], apply_noise=False)
        kw = {"index": int(jax.random.randint(kidx, (), 0, 2))}
    elif mode == "generator":
        gen = JP.generator.BernoulliSplittingMaskGenerator((1, 12, 12), split_ratio=0.6)
        jl = JL.MOILoss([j1], physics_generator=gen, apply_noise=False)
        pl = TL.MOILoss([p1], physics_generator=TP.generator.BernoulliSplittingMaskGenerator(
            (1, 12, 12), split_ratio=0.6, device=DEV), apply_noise=False)
        kw = {"params": {"mask": t(gen.step(2, key=kidx)["mask"])}}
    else:
        jl = JL.MOEILoss(JT.Rotate(multiples=20.0), physics_list=[j1, j2], apply_noise=False)
        pl = TL.MOEILoss(PT.Rotate(multiples=20.0), physics_list=[p1, p2], apply_noise=False)
        kw = {"index": int(jax.random.randint(jax.random.fold_in(key, 7), (), 0, 2)),
              "params": {"theta": t(JT.Rotate(multiples=20.0).get_params(xn, key)["theta"])}}
    want = jax.jit(lambda v: jl(x_net=v, physics=j1, model=jm, key=key))(xn)
    got = pl(x_net=t(x), physics=p1, model=pm, **kw)
    assert rel(got.detach(), want) <= 1e-5


NOISE = {"gaussian": (lambda M, d: M.GaussianNoise(0.1, **d), 1.0),
         "poisson": (lambda M, d: M.PoissonNoise(0.05, **d), 1.0),
         "gamma": (lambda M, d: M.GammaNoise(20.0, **d), 1.0)}


@pytest.mark.parametrize("noise", sorted(NOISE))
def test_r2r_matches_jax(noise):
    """``R2RModel``'s evaluation over three corruptions and ``R2RLoss``'s
    training corruption, fed JAX's corruptions (``R2RModel.corrupt`` at the
    JAX key path), for Gaussian, Poisson and Gamma noise."""
    make, _ = NOISE[noise]
    jnm, pnm = make(JP, {}), make(TP, {"device": DEV})
    jm, pm = models(seed=4)
    jp, pp = JP.Denoising(jnm), TP.Denoising(pnm)
    y = images(seed=8)
    if noise == "poisson":
        y = (np.round(y / 0.05) * 0.05).astype(np.float32)
    key = jax.random.key(30)
    jr = JL.R2RLoss(noise_model=jnm, eval_n_samples=3)
    pr = TL.R2RLoss(noise_model=pnm, eval_n_samples=3)
    jmodel, pmodel = jr.adapt_model(jm), pr.adapt_model(pm)
    yj = jnp.asarray(y)
    corr = [t(jmodel.corrupt(yj, jnm, jax.random.fold_in(key, i))) for i in range(3)]
    want = jmodel(yj, jp, key=key, train=False)
    got = pmodel(t(y), pp, corrupted=corr)
    assert rel(got.detach(), want) <= 1e-5
    want = jr(y=yj, physics=jp, model=jmodel, key=key)
    got = pr(y=t(y), physics=pp, model=pmodel, corrupted=corr[0])
    assert rel(got.detach(), want) <= 1e-5
    own = pmodel.corrupt(t(y), pnm, torch.Generator().manual_seed(0))
    assert own.shape == y.shape and torch.isfinite(own).all()


def test_score_model_and_loss_match_jax():
    """``ScoreModel``'s Tweedie reconstruction in evaluation and its error in
    training at a given step, and ``ScoreLoss``, fed JAX's noise level and
    perturbation; the host counter anneals the same way (read, not bumped,
    by the loss's call)."""
    jm, pm = models(seed=5)
    jnm, pnm = JP.GaussianNoise(0.1), TP.GaussianNoise(0.1, device=DEV)
    jp, pp = JP.Denoising(jnm), TP.Denoising(pnm)
    y = images(seed=9)
    yj = jnp.asarray(y)
    key = jax.random.key(40)
    js, ps = JL.ScoreLoss(noise_model=jnm, total_batches=10), TL.ScoreLoss(
        noise_model=pnm, total_batches=10)
    jmodel, pmodel = js.adapt_model(jm), ps.adapt_model(pm)
    want = jmodel(yj, jp, key=key)
    got = pmodel(t(y), pp, eps=t(jax.random.normal(key, y.shape)))
    assert rel(got.detach(), want) <= 1e-5
    ks, ke = jax.random.split(key)
    draws = {"sigma_draw": t(jax.random.normal(ks, (2, 1, 1, 1))),
             "eps": t(jax.random.normal(ke, y.shape))}
    for step in (None, 4):
        want = jmodel(yj, jp, key=key, train=True, step=step, return_error=True)
        got = pmodel(t(y), pp, train=True, step=step, return_error=True, **draws)
        assert rel(got[0].detach(), want[0]) <= 1e-5 and rel(got[1].detach(), want[1]) <= 1e-5
    assert pmodel.counter == jmodel.counter == 0
    jmodel(yj, jp, key=key, train=True)
    pmodel(t(y), pp, train=True, **draws)
    assert pmodel.counter == jmodel.counter == 1
    want = js(y=yj, physics=jp, model=jmodel, key=key, step=7)
    got = ps(y=t(y), physics=pp, model=pmodel, step=7, **draws)
    assert rel(got.detach(), want) <= 1e-5


def test_tv_and_jacobian_norms_match_jax():
    """``TVLoss``; ``JacobianSpectralNorm`` (4 power steps from JAX's start,
    ``max`` and ``none``) and its gradient in the weights (the penalty's
    second derivative, 1e-4: the gradient of 4 f32 power steps); and
    ``FNEJacobianSpectralNorm`` at the interpolated point (JAX's eta)."""
    x = images((2, 3, 9, 11), seed=10)
    assert rel(TL.TVLoss(0.5)(x_net=t(x)), JL.TVLoss(0.5)(x_net=jnp.asarray(x))) <= 1e-6
    jm, pm = models(seed=6)
    jp, pp = denoising()
    y = images(seed=11)
    key = jax.random.key(50)
    u0 = t(jax.random.normal(key, y.shape))
    for red in ("max", "none"):
        jl = JL.JacobianSpectralNorm(max_iter=4, reduction=red)
        want = jax.jit(lambda v: jl(y=v, model=jm, physics=jp, key=key))(jnp.asarray(y))
        got = TL.JacobianSpectralNorm(max_iter=4, reduction=red)(y=t(y), model=pm, physics=pp,
                                                                 u0=u0)
        assert rel(got.detach(), want) <= 1e-5, red

    def jax_norm(net):
        return JL.JacobianSpectralNorm(max_iter=4)(y=jnp.asarray(y), model=JM.ArtifactRemoval(
            net), physics=jp, key=key)

    want = jax_params(jax.jit(jax.grad(jax_norm))(jm.backbone_net))
    TL.JacobianSpectralNorm(max_iter=4)(y=t(y), model=pm, physics=pp, u0=u0).backward()
    for k, p in pm.backbone_net.named_parameters():
        g = np.zeros_like(want[k]) if p.grad is None else p.grad.numpy()  # no path: JAX's 0
        assert np.linalg.norm(g - want[k]) <= 1e-4 * np.linalg.norm(want[k]), k
    x_net = images(seed=12)
    k2, ksub = jax.random.split(key)
    want = jax.jit(lambda v, w: JL.FNEJacobianSpectralNorm(max_iter=5)(
        y=v, x_net=w, model=jm, physics=jp, key=key, interpolation=True))(
        jnp.asarray(y), jnp.asarray(x_net))
    got = TL.FNEJacobianSpectralNorm(max_iter=5)(
        y=t(y), x_net=t(x_net), model=pm, physics=pp, interpolation=True,
        eta=t(jax.random.uniform(ksub, (2, 1, 1, 1))), u0=t(jax.random.normal(k2, y.shape)))
    assert rel(got.detach(), want) <= 1e-5


def test_stacked_physics_loss_matches_jax():
    """``StackedPhysicsLoss`` of an MC loss and a supervised one over a
    stacked denoising and inpainting operator."""
    jm, pm = models(seed=7)
    (ji, pi, _), (jd, pd) = inpainting(seed=4), denoising()
    js, ps = JP.stack(jd, ji), TP.stack(pd, pi)
    x = images(seed=13)
    yj = js.A(jnp.asarray(x))
    yp = ps.A(t(x))
    want = JL.StackedPhysicsLoss([JL.MCLoss(), JL.MCLoss()])(
        x_net=jnp.asarray(x) * 0.9, y=yj, physics=js, model=jm)
    got = TL.StackedPhysicsLoss([TL.MCLoss(), TL.MCLoss()])(x_net=t(x) * 0.9, y=yp, physics=ps,
                                                            model=pm)
    assert rel(got, want) <= 1e-6


def test_loss_exports_every_jax_name():
    """``deepinv_tpu_torch.loss`` has all 68 public names of the JAX
    package's ``loss``, and ``ScoreLoss.ScoreModel`` and
    ``SplittingLoss.SplittingModel`` as there."""
    names = [n for n in dir(JL) if not n.startswith("_") and not isinstance(
        getattr(JL, n), type(JL))]
    assert len(names) == 68
    assert [n for n in names if n not in TL.__all__] == []
    assert TL.ScoreLoss.ScoreModel is TL.ScoreModel
    assert TL.SplittingLoss.SplittingModel is TL.SplittingModel
