"""The port's public surface, method by method and keyword by keyword,
against the JAX package's, on the CPU.

The walk imports every module of ``deepinv_tpu`` (less ``ops/pallas/*``,
``models/drunet_fold.py`` and ``core/module.py``, which stay out by design)
and the module at the same path in ``deepinv_tpu_torch``. For every public
class defined there, every public method and property defined on the JAX
class exists on the port's class (JAX's ``__call__`` is the port's
``forward``, or its ``__call__`` where the port's class is no
``nn.Module``); for every method, constructor and function, every named
parameter of the JAX signature is a named parameter of the port's, and the
positional parameters the two share come in the same order. A JAX ``key`` is
the port's ``generator``, or its ``draws`` or ``normal`` where the port's
function takes the caller's draws in place of a key; ``self``, ``cls`` and
``dtype`` are skipped. What stays out is in ``ALLOWLIST`` with its reason.

The rest holds each method and keyword that the walk found missing, and
that the port now has, to the JAX package on the same inputs, made from a
numpy seed: 1e-5 relative where the two compute the same float32 arithmetic,
exactly where they copy or count.
"""

import importlib
import inspect
import pkgutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepinv_tpu
import deepinv_tpu_torch

import test_torch_drunet  # noqa: F401  (each xdist worker takes its share of the cores)

DEV = "cpu"
TOL = 1e-5

# Names of the JAX package the port leaves out, each with its reason. The
# keys are "module:name" (a class, a function, or "Class.method").
_CORE = ("pytree and key plumbing of the JAX Module system: nn.Module, torch.Generator, "
         "core/rng.py Draws and core/linalg.py take its role (ROADMAP Queue 1)")
_HOOKS = ("a host-side metric hook that neither package's forward calls (JAX's forward "
          "runs its fixed point in one scan); the port's forward runs FixedPoint and keeps no "
          "per-iteration metric lists")
ALLOWLIST = {
    "deepinv_tpu.core:Module": _CORE,
    "deepinv_tpu.core:combine": _CORE,
    "deepinv_tpu.core:partition_arrays": _CORE,
    "deepinv_tpu.core:is_array": _CORE,
    "deepinv_tpu.core:update": _CORE,
    "deepinv_tpu.core.rng:split_like": _CORE,
    "deepinv_tpu.core.rng:ensure_key": _CORE,
    "deepinv_tpu.core.rng:epoch_key": _CORE,
    "deepinv_tpu.core.linalg:transpose_primal": (
        "shard_map plumbing of jax.linear_transpose's cotangent; the port's "
        "linear_transpose is an autograd vector-Jacobian product and has no "
        "varying-manual-axes to carry"),
    # what the JAX package takes and never uses: the port leaves it out, so a
    # caller learns of it by a TypeError and not by a silent no-op
    "deepinv_tpu.optim.iterators:OptimIterator.__init__(has_cost)": (
        "read only by the metric hooks below; no iterator of either package writes X['cost']"),
    "deepinv_tpu.optim.optimizers:BaseOptim.init_iterate_fn": _HOOKS,
    "deepinv_tpu.optim.optimizers:BaseOptim.init_metrics_fn": _HOOKS,
    "deepinv_tpu.optim.optimizers:BaseOptim.update_metrics_fn": _HOOKS,
    "deepinv_tpu.optim.optimizers:create_iterator(prior)": (
        "not used by JAX's create_iterator (the iterator gets the prior at each call); the "
        "port's keywords follow the iteration, so a JAX positional call raises"),
    "deepinv_tpu.optim.optimizers:create_iterator(cost_fn)": (
        "not used by JAX's create_iterator; as create_iterator(prior)"),
    "deepinv_tpu.models.unrolled:VarNetBlock.__init__(key)": (
        "not used by JAX's VarNetBlock: its weight starts at 1 and nothing is drawn"),
    "deepinv_tpu.loss.adversarial:UAIRGeneratorLoss.__call__(key)": (
        "not used by JAX's UAIRGeneratorLoss; the port's **kwargs takes the trainer's "
        "generator"),
    "deepinv_tpu.transform.geometric:rotate_via_shear(center)": (
        "not used by JAX's rotate_via_shear, which rotates about the image centre whatever "
        "it is given"),
    "deepinv_tpu.utils.logger:AverageMeter.__init__(fmt)": (
        "stored and never read by the JAX package; the port's meters print no format"),
}

_SKIPPED = ("deepinv_tpu.ops.pallas", "deepinv_tpu.models.drunet_fold", "deepinv_tpu.core.module")
_RANDOM = {"generator", "draws", "normal"}


def _modules():
    out = []
    for m in pkgutil.walk_packages(deepinv_tpu.__path__, "deepinv_tpu."):
        if m.name.startswith(_SKIPPED) or m.name.rsplit(".", 1)[1].startswith("_"):
            continue
        out.append(m.name)
    return out


def _params(f):
    try:
        sig = inspect.signature(f)
    except (TypeError, ValueError):
        return None
    P = inspect.Parameter
    return [(p.name, p.kind) for p in sig.parameters.values()
            if p.kind not in (P.VAR_POSITIONAL, P.VAR_KEYWORD)]


def _compare(where, jf, tf, gaps):
    jp, tp = _params(jf), _params(tf)
    if jp is None or tp is None:
        return
    tnames = {n for n, _ in tp}
    skip = ("self", "cls", "dtype")
    for n, _ in jp:
        if n in skip or n in tnames or (n == "key" and tnames & _RANDOM):
            continue
        gaps.append(f"{where}({n})")
    kw = inspect.Parameter.KEYWORD_ONLY
    jpos = [n for n, k in jp if k != kw and n not in skip]
    tpos = [n for n, k in tp if k != kw and n not in skip]
    if [n for n in jpos if n in tpos] != [n for n in tpos if n in jpos]:
        gaps.append(f"{where}(order {jpos} / {tpos})")


def _defines(cls, name):
    return any(name in vars(k) for k in cls.__mro__ if k is not object)


def _walk():
    """Every gap, as "module:Class.method", "module:Class.method(param)",
    "module:function(param)" or "module:name" for a missing name."""
    gaps = []
    for name in _modules():
        jm = importlib.import_module(name)
        tm = importlib.import_module(name.replace("deepinv_tpu", "deepinv_tpu_torch", 1))
        for attr, obj in vars(jm).items():
            if attr.startswith("_") or getattr(obj, "__module__", None) != name:
                continue
            port = getattr(tm, attr, None)
            if port is None:
                gaps.append(f"{name}:{attr}")
            elif inspect.isclass(obj):
                for m, v in vars(obj).items():
                    if m.startswith("_") and m not in ("__init__", "__call__"):
                        continue
                    if not (inspect.isfunction(v) or isinstance(v, (staticmethod, classmethod,
                                                                     property))):
                        continue
                    tname = m
                    if m == "__call__":
                        tname = ("forward" if issubclass(port, torch.nn.Module)
                                 else "__call__")
                    where = f"{name}:{attr}.{m}"
                    if not _defines(port, tname):
                        gaps.append(where)
                    elif not isinstance(v, property):
                        jf = v.__func__ if isinstance(v, (staticmethod, classmethod)) else v
                        _compare(where, jf, getattr(port, tname), gaps)
            elif inspect.isfunction(obj):
                _compare(f"{name}:{attr}", obj, port, gaps)
    # core/module.py stays out of the walk; its exports are held by name
    import deepinv_tpu.core as jcore
    import deepinv_tpu_torch.core as tcore

    for n in getattr(jcore, "__all__", ()):
        if getattr(getattr(jcore, n), "__module__", "") == "deepinv_tpu.core.module" \
                and not hasattr(tcore, n):
            gaps.append(f"deepinv_tpu.core:{n}")
    return gaps


@pytest.fixture(scope="module")
def gaps():
    return _walk()


def test_walk_covers_every_module():
    """The walk reaches every subpackage, and the modules it leaves out are
    only the three that stay out by design."""
    mods = _modules()
    assert len(mods) > 120
    for sub in ("core", "datasets", "loss", "models", "native", "ops", "optim", "parallel",
                "physics", "sampling", "training", "transform", "unfolded", "utils"):
        assert f"deepinv_tpu.{sub}" in mods
    assert not [m for m in mods if m.startswith(_SKIPPED)]


def test_every_jax_method_and_keyword_is_in_the_port(gaps):
    offenders = [g for g in gaps if g not in ALLOWLIST]
    assert not offenders, offenders


def test_allowlist_is_not_stale(gaps):
    """Each allowlisted name is still missing from the port; a name the port
    gains leaves the list."""
    assert not sorted(set(ALLOWLIST) - set(gaps))


def test_trainer_steps_take_progress_bar_second():
    """A positional call means the same in both packages: ``progress_bar``
    second, ``train_ite`` third (trainer.py:491, adversarial.py:128)."""
    from deepinv_tpu.training import AdversarialTrainer as JA, Trainer as JT
    from deepinv_tpu_torch.training import AdversarialTrainer as TA, Trainer as TT

    for j, t in ((JT, TT), (JA, TA)):
        jb = inspect.signature(j.step).bind(None, 0, "bar", 3, False, True).arguments
        tb = inspect.signature(t.step).bind(None, 0, "bar", 3, False, True).arguments
        assert {k: v for k, v in tb.items() if k != "self"} == {
            k: v for k, v in jb.items() if k != "self"}
        assert tb["progress_bar"] == "bar" and tb["train_ite"] == 3


# -- physics ---------------------------------------------------------------------------------


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, tol=TOL):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol * max(1.0, float(np.abs(w).max())))


def _img(seed, shape):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a), jnp.asarray(a)


def test_physics_setters_match_jax():
    """``update_parameters`` routes ``sigma`` into the noise model,
    ``set_noise_model`` swaps it, ``set_ls_solver`` changes the solver's
    defaults and keeps the rest, and each returns a new physics; ``clone`` is
    a deep copy whose buffers are not the original's."""
    import deepinv_tpu.physics as J
    import deepinv_tpu_torch.physics as T

    jp = J.Inpainting((1, 6, 6), mask=0.5, noise_model=J.GaussianNoise(0.1),
                      key=jax.random.key(0))
    tp = T.Inpainting((1, 6, 6), mask=torch.from_numpy(np.asarray(jp.mask)),
                      noise_model=T.GaussianNoise(0.1, device=DEV), device=DEV)
    ju, tu = jp.update_parameters(sigma=0.3), tp.update_parameters(sigma=0.3)
    assert float(ju.noise_model.sigma) == pytest.approx(float(tu.noise_model.sigma))
    assert float(tp.noise_model.sigma) == pytest.approx(0.1)
    tn = tp.set_noise_model(T.PoissonNoise(gain=0.5, device=DEV))
    jn = jp.set_noise_model(J.PoissonNoise(gain=0.5))
    assert type(tn.noise_model).__name__ == type(jn.noise_model).__name__
    assert type(tp.noise_model).__name__ == "GaussianNoise"
    for args in (("BiCGStab", 7, 1e-3), ("lsqr", None, None)):
        js, ts = jp.set_ls_solver(*args), tp.set_ls_solver(*args)
        assert (ts.solver, ts.max_iter, ts.tol) == (js.solver, js.max_iter, js.tol)
    assert (tp.solver, tp.max_iter, tp.tol) == (jp.solver, jp.max_iter, jp.tol)
    c = tp.clone()
    assert c is not tp and c.mask is not tp.mask and torch.equal(c.mask, tp.mask)
    c.mask.zero_()
    assert float(tp.mask.sum()) > 0
    x_t, x_j = _img(1, (2, 1, 6, 6))
    _close(tp.clone().A(x_t), jp.clone().A(x_j))


def test_linear_physics_from_img_shape_matches_jax():
    """``LinearPhysics(A, img_shape=...)`` without ``A_adjoint`` takes the
    autograd transpose of ``A`` at the batch size of ``y`` (base.py:264-300);
    ``compute_sqnorm`` is ``compute_norm``."""
    import deepinv_tpu.physics as J
    import deepinv_tpu_torch.physics as T

    M = np.random.default_rng(0).standard_normal((5, 12)).astype(np.float32)
    Mt, Mj = torch.from_numpy(M), jnp.asarray(M)
    tp = T.LinearPhysics(A=lambda x: (x.reshape(x.shape[0], -1) @ Mt.T), img_shape=(1, 1, 3, 4))
    jp = J.LinearPhysics(A=lambda x: (x.reshape(x.shape[0], -1) @ Mj.T), img_shape=(1, 1, 3, 4))
    y_t, y_j = _img(2, (3, 5))
    _close(tp.A_adjoint(y_t), jax.jit(jp.A_adjoint)(y_j))
    x_t, x_j = _img(3, (3, 1, 3, 4))
    assert abs(float(tp.adjointness_test(x_t))) < 1e-4
    _close(tp.compute_sqnorm(x_t, max_iter=200, tol=1e-8),
           jp.compute_sqnorm(x_j, max_iter=200, tol=1e-8), 1e-4)
    with pytest.raises(NotImplementedError, match="img_shape"):
        T.LinearPhysics(A=lambda x: x).A_adjoint(y_t)


def test_decomposable_physics_from_callables_matches_jax():
    """``DecomposablePhysics(U=, U_adjoint=, V=, V_adjoint=, mask=)``: ``A``,
    its adjoint, the closed-form prox and pseudo-inverse over orthonormal
    ``U`` and ``V`` (base.py:418-444)."""
    import deepinv_tpu.physics as J
    import deepinv_tpu_torch.physics as T

    rng = np.random.default_rng(4)
    U, _ = np.linalg.qr(rng.standard_normal((8, 8)))
    V, _ = np.linalg.qr(rng.standard_normal((8, 8)))
    s = rng.uniform(0.2, 1.5, 8).astype(np.float32)
    U, V = U.astype(np.float32), V.astype(np.float32)

    def make(mod, lib, conv):
        Uu, Vv = conv(U), conv(V)
        return mod.DecomposablePhysics(U=lambda x: x @ Uu.T, U_adjoint=lambda x: x @ Uu,
                                       V=lambda x: x @ Vv.T, V_adjoint=lambda x: x @ Vv,
                                       mask=conv(s))

    tp, jp = make(T, torch, torch.from_numpy), make(J, jnp, jnp.asarray)
    x_t, x_j = _img(5, (2, 8))
    y_t, y_j = _img(6, (2, 8))
    _close(tp.A(x_t), jp.A(x_j))
    _close(tp.A_adjoint(y_t), jp.A_adjoint(y_j))
    _close(tp.prox_l2(x_t, y_t, 0.7), jp.prox_l2(x_j, y_j, 0.7))
    _close(tp.A_dagger(y_t), jp.A_dagger(y_j), 1e-4)


def test_blurfft_filter_parameters_match_jax():
    """``BlurFFT.get_filter_parameters``: the PSF and its full-spectrum
    transfer function, on the physics' size and on another (blur.py:132)."""
    import deepinv_tpu.physics as J
    import deepinv_tpu_torch.physics as T
    from deepinv_tpu.ops import gaussian_blur as jg
    from deepinv_tpu_torch.ops import gaussian_blur as tg

    tp = T.BlurFFT((1, 16, 16), filter=tg(1.0), device=DEV)
    jp = J.BlurFFT((1, 16, 16), filter=jg(1.0))
    for size in (None, (1, 12, 20)):
        t = tp.get_filter_parameters(size, tg((2.0, 0.5), angle=30.0))
        j = jp.get_filter_parameters(size, jg((2.0, 0.5), angle=30.0))
        _close(t["filter"], j["filter"])
        _close(t["mask"], j["mask"])
    assert tp.get_filter_parameters() == {"filter": None, "mask": None}


def test_pet_plot_geometry_draws_what_jax_draws():
    """``PET.plot_geometry``: one ring a plane and the same lines of response
    as JAX's figure, point for point (pet.py:216)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    import deepinv_tpu.physics as J
    import deepinv_tpu_torch.physics as T

    kw = dict(img_size=(3, 12, 12), angles=8, ring_differences=(0, -1, 1))
    jf = J.PET(**kw).plot_geometry(n_lors=16, show=False)
    tf = T.PET(device=DEV, **kw).plot_geometry(n_lors=16, show=False)
    jl, tl = jf.axes[0].lines, tf.axes[0].lines
    assert len(tl) == len(jl) > 3
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(np.asarray(a.get_data_3d()), np.asarray(b.get_data_3d()),
                                   rtol=1e-5, atol=1e-4)
    plt.close("all")


# -- optim -----------------------------------------------------------------------------------


def _blur_pair(sigma=0.0):
    import deepinv_tpu.physics as J
    import deepinv_tpu_torch.physics as T
    from deepinv_tpu.ops import gaussian_blur as jg
    from deepinv_tpu_torch.ops import gaussian_blur as tg

    return (J.BlurFFT((1, 12, 12), filter=jg(1.2)),
            T.BlurFFT((1, 12, 12), filter=tg(1.2), device=DEV))


def test_iterator_cost_and_relaxation_step_match_jax():
    """``relaxation_step`` is ``relaxation`` on the same inputs as JAX's
    (iterators.py:71); JAX's ``has_cost``, which only its unused metric
    hooks read, is allowlisted, so the port's iterator refuses it."""
    import deepinv_tpu.optim as JO
    import deepinv_tpu_torch.optim as TO

    x_t, x_j = _img(7, (2, 1, 12, 12))
    y_t, y_j = _img(8, (2, 1, 12, 12))
    _close(TO.OptimIterator().relaxation_step(x_t, y_t, 0.3),
           JO.OptimIterator().relaxation_step(x_j, y_j, 0.3))
    assert JO.PGDIteration(has_cost=True).has_cost
    with pytest.raises(TypeError):
        TO.PGDIteration(has_cost=True)


def test_create_iterator_takes_prior_and_cost_fn():
    """``create_iterator(iteration, g_first=...)`` gives the iterator JAX's
    gives; JAX's positional ``prior`` and ``cost_fn``, which it does not
    use, are refused by the port rather than read as ``g_first``
    (optimizers.py:89)."""
    import deepinv_tpu.optim as JO
    import deepinv_tpu_torch.optim as TO

    j = JO.create_iterator("PGD", JO.TVPrior(), lambda *a: 0.0, True)
    t = TO.create_iterator("PGD", g_first=True)
    assert type(t).__name__ == type(j).__name__ and t.g_first == j.g_first is True
    with pytest.raises(TypeError):
        TO.create_iterator("PGD", TO.TVPrior(), lambda *a: 0.0, True)


def test_base_optim_hooks_match_jax():
    """``objective`` on the same inputs, and ``update_prior_fn`` and
    ``update_data_fidelity_fn`` over lists (optimizers.py:215-237), as
    JAX's; ``DEQ_additional_step`` takes the last iteration's prior and data
    fidelity from them, as JAX's does (:307): with ``[Zero(), TVPrior()]``
    over 3 iterations the step is a PGD step with TV's prox on the same
    iterate, within 1e-5 of JAX's."""
    import deepinv_tpu.optim as JO
    import deepinv_tpu_torch.optim as TO

    jp, tp = _blur_pair()
    x_t, x_j = _img(9, (2, 1, 12, 12))
    y_t, y_j = _img(10, (2, 1, 12, 12))
    pa = {"stepsize": 0.5, "lambda": [0.1, 0.2, 0.3]}
    jm = JO.BaseOptim(JO.PGDIteration(), JO.L2(), JO.TVPrior(), pa, max_iter=3)
    tm = TO.BaseOptim(TO.PGDIteration(), TO.L2(), TO.TVPrior(), pa, max_iter=3, device=DEV)
    _close(tm.objective(x_t, y_t, tp), jm.objective(x_j, y_j, jp))
    priors_t, priors_j = torch.nn.ModuleList([TO.TVPrior(), TO.Zero()]), [JO.TVPrior(), JO.Zero()]
    tm.prior, jm.prior = priors_t, priors_j
    for it in range(4):
        assert type(tm.update_prior_fn(it)).__name__ == type(jm.update_prior_fn(it)).__name__
    tm.data_fidelity, jm.data_fidelity = torch.nn.ModuleList([TO.L2(), TO.L1()]), [JO.L2(),
                                                                                  JO.L1()]
    for it in range(3):
        assert (type(tm.update_data_fidelity_fn(it)).__name__
                == type(jm.update_data_fidelity_fn(it)).__name__)
    tm.prior = torch.nn.ModuleList([TO.Zero(), TO.TVPrior()])
    jm.prior = [JO.Zero(), JO.TVPrior()]
    tm.data_fidelity, jm.data_fidelity = TO.L2(), JO.L2()
    Xt = {"est": (x_t, x_t), "it": 0}
    Xj = {"est": (x_j, x_j), "it": jnp.asarray(0)}
    got = tm.DEQ_additional_step(Xt, y_t, tp)["est"][0]
    want = jm.DEQ_additional_step(Xj, y_j, jp)["est"][0]
    _close(got, want)
    tm.prior = torch.nn.ModuleList([TO.TVPrior(), TO.Zero()])
    assert not torch.allclose(tm.DEQ_additional_step(Xt, y_t, tp)["est"][0], got, atol=1e-4)


def test_data_fidelity_grad_d_and_prior_grad_match_jax():
    """``DataFidelity.grad_d`` is the distance's gradient
    (data_fidelity.py:63); ``Prior.grad(x, sigma_denoiser)`` passes the level
    to the cost (prior.py:51)."""
    import deepinv_tpu.optim as JO
    import deepinv_tpu_torch.optim as TO

    u_t, u_j = _img(12, (2, 1, 6, 6))
    y_t, y_j = _img(13, (2, 1, 6, 6))
    for jd, td in ((JO.L2(sigma=0.5), TO.L2(sigma=0.5)), (JO.L1(), TO.L1())):
        _close(td.grad_d(u_t, y_t), jd.grad_d(u_j, y_j))
    jpr = JO.Prior(g=lambda x, s: s * jnp.sum(jnp.cos(x) ** 2, axis=(1, 2, 3)))
    tpr = TO.Prior(g=lambda x, s: s * (torch.cos(x) ** 2).sum((1, 2, 3)))
    _close(tpr.grad(u_t, 0.7), jpr.grad(u_j, 0.7))
    _close(tpr.grad(u_t, sigma_denoiser=0.2), jpr.grad(u_j, sigma_denoiser=0.2))


# -- models, sampling ------------------------------------------------------------------------


def test_icnn_weight_hooks_match_jax(monkeypatch):
    """``ICNN.zero_clip_weights`` clamps the convex path's raw weights as
    JAX does on the same weights, and the potential agrees after it
    (wrappers_models.py:197). ``initialize_weights`` redraws each ``w_z``
    and then ``final`` in ``[min, max]`` and leaves ``w_x`` as it was
    (:182): with the same uniform draws handed to both packages, in the
    order and at the shapes each asks for them, every weight equals JAX's
    and the potential agrees within 1e-4."""
    import deepinv_tpu.models as JM
    import deepinv_tpu_torch.models as TM
    from deepinv_tpu_torch.models import load_jax_params
    from test_torch_drunet import jax_built, jax_params

    jm = jax_built(JM.ICNN, in_channels=1, dim_hidden=8, depth=3)
    tm = load_jax_params(TM.ICNN(in_channels=1, dim_hidden=8, depth=3, device=DEV),
                         jax_params(jm))
    x_t, x_j = _img(14, (2, 1, 8, 8))
    jm, tm = jm.zero_clip_weights(), tm.zero_clip_weights()
    for k, v in jax_params(jm).items():
        _close(tm.state_dict()[k], v, 0)
    with torch.no_grad():
        _close(tm(x_t), jm(x_j), 1e-4)

    shapes = [tuple(c.weight.shape) for c in list(tm.w_z) + [tm.final]]
    rng = np.random.default_rng(22)
    draws = [rng.random(sh).astype(np.float32) for sh in shapes]
    jq, tq = list(draws), list(draws)

    def jax_uniform(key, shape=(), *a, **k):
        u = jq.pop(0)
        assert tuple(shape) == u.shape
        return jnp.asarray(u)

    def torch_rand(*shape, generator=None, **k):
        u = tq.pop(0)
        assert tuple(shape[0] if len(shape) == 1 else shape) == u.shape
        return torch.from_numpy(u.copy())

    monkeypatch.setattr(jax.random, "uniform", jax_uniform)
    monkeypatch.setattr(torch, "rand", torch_rand)
    wx = tm.w_x[0].weight.clone()
    jm = jm.initialize_weights(0.1, 0.3, key=jax.random.key(1))
    tm = tm.initialize_weights(0.1, 0.3, generator=torch.Generator().manual_seed(1))
    assert not jq and not tq
    assert torch.equal(tm.w_x[0].weight, wx)
    for k, v in jax_params(jm).items():
        _close(tm.state_dict()[k], v, 1e-7)
    for c in list(tm.w_z) + [tm.final]:
        assert 0.1 <= float(c.weight.min()) and float(c.weight.max()) <= 0.3
    with torch.no_grad():
        _close(tm(x_t), jm(x_j), 1e-4)


def test_diffusion_sde_declares_sigma_t():
    """``DiffusionSDE.sigma_t`` is declared on the class and raises there,
    and an instance takes the constructor's schedule (sde.py:169)."""
    import deepinv_tpu.sampling as JS
    import deepinv_tpu_torch.sampling as TS

    for S in (JS.DiffusionSDE, TS.DiffusionSDE):
        with pytest.raises(NotImplementedError):
            S.sigma_t(None, 0.5)
    f = lambda t: 2.0 * t
    t = TS.DiffusionSDE(lambda x, s: x, f, lambda t: 2.0)
    j = JS.DiffusionSDE(lambda x, s: x, f, lambda t: 2.0)
    assert t.sigma_t(0.25) == j.sigma_t(0.25) == 0.5


def test_varnet_block_and_uair_take_a_generator():
    """``UAIRGeneratorLoss`` takes the trainer's ``generator`` through its
    keywords and draws nothing from it: the loss is the same with or
    without one; ``VarNetBlock``'s weight is 1, as JAX's, whose ``key`` it
    does not use (allowlisted)."""
    import deepinv_tpu_torch.loss as TL
    import deepinv_tpu_torch.models as TM
    import deepinv_tpu_torch.physics as T

    b = TM.unrolled.VarNetBlock(lambda x, s: 0 * x)
    assert float(b.dc_weight) == 1.0
    x, _ = _img(15, (2, 1, 8, 8))
    p = T.Denoising()
    D = lambda v: v.mean((1, 2, 3))
    loss = TL.UAIRGeneratorLoss()
    a = loss(y=x, x_net=x, physics=p, model=lambda y, ph: y, D=D)
    g = loss(y=x, x_net=x, physics=p, model=lambda y, ph: y, D=D,
             generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, g)


# -- training, loss, transform, utils --------------------------------------------------------


def _port_trainer(**kw):
    from deepinv_tpu_torch.datasets import ArrayDataset, DataLoader
    from deepinv_tpu_torch.loss import SupLoss
    from deepinv_tpu_torch.models import ArtifactRemoval, DnCNN
    from deepinv_tpu_torch.physics import Denoising, GaussianNoise
    from deepinv_tpu_torch.training import Trainer

    xs = np.random.default_rng(16).random((4, 1, 8, 8)).astype(np.float32)
    m = ArtifactRemoval(DnCNN(1, 1, depth=2, nf=4, device=DEV,
                              generator=torch.Generator().manual_seed(0)))
    return Trainer(m, Denoising(GaussianNoise(0.1, device=DEV)), losses=SupLoss(),
                   optimizer=torch.optim.SGD(m.parameters(), lr=1e-3),
                   train_dataloader=DataLoader(ArrayDataset(xs), batch_size=2),
                   eval_dataloader=DataLoader(ArrayDataset(xs), batch_size=2), epochs=1,
                   online_measurements=True, verbose=False, metrics=[_Psnr()], **kw)


class _Psnr:
    lower_better = False

    def __call__(self, x_net, x):
        return -10 * torch.log10(((x_net - x) ** 2).flatten(1).mean(1))


def test_trainer_losses_property_and_grad_norm_match_jax():
    """``Trainer.losses`` is a list property whose setter wraps one loss
    (trainer.py:254-260); ``check_clip_grad(grad_norm)`` records a given
    norm under ``check_grad``, as JAX's (:387), and clips to ``grad_clip``
    all the same, as JAX's optax chain does (:152-154): without it the
    gradients stay as they are; the adversarial trainer's
    ``check_clip_grad_D`` records a given norm likewise."""
    from deepinv_tpu.training.trainer import Trainer as JT
    from deepinv_tpu_torch.loss import MCLoss, SupLoss
    from deepinv_tpu_torch.training import AdversarialTrainer

    assert isinstance(inspect.getattr_static(JT, "losses"), property)
    t = _port_trainer(check_grad=True)
    assert [type(l).__name__ for l in t.losses] == ["SupLoss"]
    t.losses = MCLoss()
    assert [type(l).__name__ for l in t.losses] == ["MCLoss"]
    t.losses = [SupLoss(), MCLoss()]
    assert len(t.losses) == 2
    w = [p.detach().clone() for p in t.model.parameters()]
    for p in t.model.parameters():
        p.grad = torch.ones_like(p)
    assert t.check_clip_grad(torch.tensor(2.5)) == 2.5 and t.check_clip_grad(1.5) == 1.5
    assert t.check_grad_val.vals == [2.5, 1.5]
    assert all(torch.equal(p.grad, torch.ones_like(p)) for p in t.model.parameters())
    assert all(torch.equal(a, b) for a, b in zip(w, t.model.parameters()))
    off = _port_trainer()
    assert off.check_clip_grad(3.0) == 3.0 and off.check_grad_val.vals == []
    clip = _port_trainer(check_grad=True, grad_clip=0.5)
    for p in clip.model.parameters():
        p.grad = torch.ones_like(p)
    assert clip.check_clip_grad(2.5) == 2.5 and clip.check_grad_val.vals == [2.5]
    norm = torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in clip.model.parameters()]))
    assert abs(float(norm) - 0.5) < 1e-5
    adv = AdversarialTrainer(t.model, t.physics, check_grad=True, verbose=False)
    assert adv.check_clip_grad_D(0.75) == 0.75 and adv.check_grad_val_D.vals == [0.75]


def test_trainer_step_and_test_take_jax_arguments():
    """``step(epoch, progress_bar, train_ite, train, last_batch)`` runs as
    JAX's is called; ``test(generator=...)`` takes a generator where JAX
    takes a key: the same generator seed gives the same metrics, and the
    default draws are those of ``seed + 10000`` as before."""
    t = _port_trainer()
    t.setup_train()
    t._ite_in_epoch = 0
    logs = t.step(0, None, 0, True, True)
    assert np.isfinite(logs["TotalLoss"])
    a = t.test(generator=torch.Generator().manual_seed(5))
    b = t.test(generator=torch.Generator().manual_seed(5))
    c = t.test()
    assert a == b and set(a) == set(c) and a != c
    assert t.test() == c


def test_trainer_test_splits_match_jax_at_every_batch(monkeypatch):
    """``Trainer.test`` on a ``SplittingModel`` (3 eval splits) over 2 eval
    batches: JAX draws its splits from one key at every batch
    (trainer.py:707-710), so each batch sees the same 3 masks; the port's
    masks, drawn from its own generator, are likewise the same at every
    batch, with and without ``test(generator=...)``. With JAX's masks
    replayed to the port (``ArtifactRemoval(DnCNN(1, 1, depth=3, nf=8))``
    with crossed weights, offline inpainting pairs, 8 of 16x16 in batches
    of 4), the port's PSNR and its deviation lie within 1e-4 dB of JAX's."""
    import functools

    import deepinv_tpu.loss.measplit as jms
    import deepinv_tpu_torch.loss.measplit as tms
    from deepinv_tpu.datasets import ArrayDataset as JDS
    from deepinv_tpu.datasets import DataLoader as JDL
    from deepinv_tpu.models import ArtifactRemoval as JArtifact
    from deepinv_tpu.physics import Inpainting as JInpainting
    from deepinv_tpu.training import Trainer as JTrainer
    from deepinv_tpu_torch.datasets import ArrayDataset, DataLoader
    from deepinv_tpu_torch.models import ArtifactRemoval
    from deepinv_tpu_torch.physics import Inpainting
    from deepinv_tpu_torch.training import Trainer
    from test_torch_dncnn import _pair

    n, batches = 3, 2
    rng = np.random.default_rng(21)
    m = (rng.random((1, 16, 16)) < 0.7).astype(np.float32)
    x = rng.random((8, 1, 16, 16)).astype(np.float32)
    y = (m * (x + 0.1 * rng.standard_normal(x.shape))).astype(np.float32)
    ref, net = _pair(depth=3, nf=8, seed=7)

    jrec, jcalls = {i: [] for i in range(n)}, []
    jsample = jms.sample_split_mask

    def jax_mask(*a, **k):
        mask = jsample(*a, **k)
        i = len(jcalls) % n
        jcalls.append(i)
        jax.debug.callback(functools.partial(lambda i, v: jrec[i].append(np.array(v)), i), mask)
        return mask

    monkeypatch.setattr(jms, "sample_split_mask", jax_mask)
    jt = JTrainer(jms.SplittingModel(JArtifact(ref), split_ratio=0.6, eval_n_samples=n),
                  JInpainting((1, 16, 16), mask=jnp.asarray(m)), train_dataloader=None,
                  verbose=False)
    want = jt.test(JDL(JDS(x, y), batch_size=4))
    jax.effects_barrier()
    jmasks = [[jrec[i][b] for i in range(n)] for b in range(batches)]
    assert all(np.array_equal(a, b) for a, b in zip(*jmasks))

    tsample, trec = tms.sample_split_mask, []
    monkeypatch.setattr(tms, "sample_split_mask",
                        lambda *a, **k: trec.append(tsample(*a, **k)) or trec[-1])
    t = Trainer(tms.SplittingModel(ArtifactRemoval(net), split_ratio=0.6, eval_n_samples=n),
                Inpainting((1, 16, 16), mask=m, device=DEV), train_dataloader=None,
                verbose=False)
    loader = DataLoader(ArrayDataset(x, y), batch_size=4)
    for gen in (None, torch.Generator().manual_seed(5)):
        trec.clear()
        t.test(loader, generator=gen)
        assert len(trec) == n * batches
        assert all(torch.equal(a, b) for a, b in zip(trec[:n], trec[n:]))

    tforward, queue = tms.SplittingModel.forward, []

    def replay(self, y, physics, generator=None, train=False, **kw):
        return tforward(self, y, physics, generator=generator, train=train,
                        masks=queue.pop(0), **kw)

    monkeypatch.setattr(tms.SplittingModel, "forward", replay)
    for gen in (None, torch.Generator().manual_seed(5)):
        queue[:] = [list(b) for b in jmasks]
        got = t.test(loader, generator=gen)
        assert not queue and set(got) == set(want)
        for k in want:
            assert abs(got[k] - float(want[k])) <= 1e-4, (k, got[k], want[k])


def test_loss_forward_and_name_match_jax():
    """``Loss.forward`` is the loss; ``name`` warns that it is deprecated
    and gives the class name, or ``_name`` where a loss sets one
    (loss/base.py:27-39)."""
    import deepinv_tpu.loss as JL
    import deepinv_tpu_torch.loss as TL

    x_t, x_j = _img(17, (2, 1, 6, 6))
    n_t, n_j = _img(18, (2, 1, 6, 6))
    _close(TL.SupLoss().forward(x_net=n_t, x=x_t), JL.SupLoss()(x_net=n_j, x=x_j))
    for L in (TL.SupLoss(), JL.SupLoss()):
        with pytest.warns(DeprecationWarning, match="deprecated"):
            assert L.name == "SupLoss"
        L._name = "mine"
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            assert L.name == "mine"
    with pytest.raises(NotImplementedError):
        TL.Loss().forward(x_net=n_t, x=x_t)


@pytest.mark.parametrize("interpolation", ["bilinear", "nearest"])
def test_rotate_interpolation_and_rotate_via_shear_center_match_jax(interpolation):
    """``Rotate(multiples, limits, interpolation)`` positionally, as in JAX
    (geometric.py:93): on the rot90 subgroup both give the same images
    whatever ``interpolation`` says; off it the port warps bilinearly as JAX
    does, and raises on another interpolation, where JAX would warp
    bilinearly all the same. ``rotate_via_shear(image, angle)`` matches JAX's
    within 1e-4 (JAX's unused ``center`` is allowlisted, :185)."""
    import deepinv_tpu.transform as JT
    import deepinv_tpu_torch.transform as TT

    x_t, x_j = _img(19, (2, 1, 16, 16))
    th = np.asarray([90.0, 270.0], np.float32)
    jr, tr = JT.Rotate(90.0, 360.0, interpolation), TT.Rotate(90.0, 360.0, interpolation)
    assert tr.interpolation == jr.interpolation == interpolation
    _close(tr.transform(x_t, theta=torch.from_numpy(th)), jr.transform(x_j, theta=jnp.asarray(th)),
           0)
    th = np.asarray([30.0, 120.0], np.float32)
    jr, tr = JT.Rotate(30.0, 360.0, interpolation), TT.Rotate(30.0, 360.0, interpolation)
    if interpolation == "bilinear":
        _close(tr.transform(x_t, theta=torch.from_numpy(th)),
               jr.transform(x_j, theta=jnp.asarray(th)), 1e-4)
    else:
        with pytest.raises(NotImplementedError, match="bilinear"):
            tr.transform(x_t, theta=torch.from_numpy(th))
    from deepinv_tpu.transform.geometric import rotate_via_shear as jrot
    from deepinv_tpu_torch.transform.geometric import rotate_via_shear as trot

    _close(trot(x_t, 20.0), jrot(x_j, 20.0), 1e-4)


def test_average_meter_keeps_its_format():
    """``AverageMeter(name)`` keeps the same name, mean, deviation and
    values as JAX's over uneven batches (logger.py:14); JAX's ``fmt``, which
    nothing reads, is allowlisted and refused."""
    from deepinv_tpu.utils.logger import AverageMeter as J
    from deepinv_tpu_torch.utils.logger import AverageMeter as T

    j, t = J("loss", ":.3e"), T("loss")
    for m in (j, t):
        m.update(np.asarray([1.0, 2.0]), n=2)
        m.update(4.0)
    assert (t.name, t.avg, t.std, t.vals) == (j.name, j.avg, j.std, j.vals)
    with pytest.raises(TypeError):
        T("loss", ":.3e")
