"""The port's parallel layer against the JAX package's, on the CPU.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py; the
port's single-controller mesh is ``[cpu] * 8`` (``[cpu] * 4`` for the
pipeline), so both split the work the same way. Inputs come from numpy's
seeded draws and cross as arrays; each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepinv_tpu.parallel as jpar
from deepinv_tpu.models import MedianFilter as JaxMedian
from deepinv_tpu.ops import conv2d as jconv2d
from deepinv_tpu.ops import gaussian_blur as jgauss
from deepinv_tpu.optim import L1 as JL1
from deepinv_tpu.optim import L2 as JL2
from deepinv_tpu.physics import Blur as JBlur
from deepinv_tpu.physics import Inpainting as JInpainting
from deepinv_tpu_torch.models import MedianFilter
from deepinv_tpu_torch.ops import conv2d
from deepinv_tpu_torch.optim import L1, L2, Tikhonov, optim_builder
from deepinv_tpu_torch.parallel import (DistributedContext, DistributedDataFidelity,
                                        DistributedProcessing, DistributedStackedLinearPhysics,
                                        DistributedStackedPhysics, PipelineParallel, distribute,
                                        pipeline, stack_homogeneous)
from deepinv_tpu_torch.physics import Blur, Inpainting, stack

import test_torch_drunet  # noqa: F401  (each xdist worker takes its share of the cores)

CPU = torch.device("cpu")
IMSIZE = (1, 32, 32)


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _ctx(axis="op", n=8):
    return DistributedContext(axis_names=(axis,), devices=[CPU] * n)


def _jax_filters(n):
    """``n`` Gaussian PSFs of one size (the JAX test's ``_filters_same_size``)."""
    fs = [np.asarray(jgauss(sigma=0.5 + 0.3 * i)) for i in range(n)]
    m = max(f.shape[-1] for f in fs)
    out = []
    for f in fs:
        p = (m - f.shape[-1]) // 2
        f = np.pad(f, [(0, 0), (0, 0), (p, m - f.shape[-2] - p), (p, m - f.shape[-1] - p)])
        out.append((f / f.sum()).astype(np.float32))
    return out


def _stacks(n):
    """The same ``n`` circular blurs in both packages."""
    fs = _jax_filters(n)
    jlist = [JBlur(filter=jnp.asarray(f), padding="circular") for f in fs]
    tlist = [Blur(filter=torch.from_numpy(f), padding="circular", device="cpu") for f in fs]
    return jlist, tlist


def _x(seed, shape=(2,) + IMSIZE):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_context_matches_jax(monkeypatch):
    """rank, world size, axis sizes and the round-robin shards as in JAX;
    the placements split a tensor over the axis' devices; without CUDA the
    default mesh raises naming ``devices=``."""
    jctx = jpar.DistributedContext(axis_names=("op",))
    ctx = _ctx()
    assert (ctx.world_size, ctx.rank, ctx.axis_size("op")) == (
        jctx.world_size, jctx.rank, jctx.axis_size("op"))
    for n in (4, 10):
        assert ctx.local_indices(n) == jctx.local_indices(n)
    two = DistributedContext(axis_names=("dp", "sp"), shape=(2, 4), devices=[CPU] * 8)
    assert (two.axis_size("dp"), two.axis_size("sp"), len(two.axis_devices("sp"))) == (2, 4, 4)
    chunks = two.sharding("dp").split(torch.arange(10.0))
    assert [len(c) for _, c in chunks] == [5, 5] and len(two.replicated().split(
        torch.zeros(3))) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        DistributedContext()


@pytest.mark.parametrize("n_ops", [8, 10, 3])
def test_stacked_linear_physics_matches_jax(n_ops):
    """A, the psum adjoint, the noisy forward and CG's pseudo-inverse on 8, 10
    (padded to 16 in JAX) and 3 operators on 8 devices: A and A^T within
    1e-5 of JAX's; contiguous blocks of ceil(n/8) operators; A_dagger's
    residual below 1e-3."""
    jlist, tlist = _stacks(n_ops)
    jd = jpar.DistributedStackedLinearPhysics(jlist, jpar.DistributedContext(axis_names=("op",)))
    d = DistributedStackedLinearPhysics(tlist, _ctx())
    per = -(-n_ops // 8)
    assert [len(b) for _, b in d.batched] == [min(per, n_ops - j * per)
                                              for j in range(-(-n_ops // per))]
    assert d.n_pad == jd.n_pad
    x = _x(21)
    y, jy = d.A(torch.from_numpy(x)), jd.A(jnp.asarray(x))
    assert y.shape[0] == n_ops
    _close(y, jy, 1e-5, 1e-5)
    _close(d.A_adjoint(y), jd.A_adjoint(jy), 1e-4, 1e-5)
    yn = d(torch.from_numpy(x), generator=torch.Generator().manual_seed(1))
    assert yn.shape == y.shape
    xd = d.A_dagger(y, max_iter=150)
    assert float(((d.A(xd) - y) ** 2).sum() / (y ** 2).sum()) < 1e-3


def test_norm_dagger_prox_match_jax():
    """compute_norm within 1e-3 of JAX's, A_dagger and prox_l2 (conjugate
    gradient on both sides) within 1e-3 relative L2."""
    jlist, tlist = _stacks(8)
    jd = jpar.DistributedStackedLinearPhysics(jlist, jpar.DistributedContext(axis_names=("op",)))
    d = DistributedStackedLinearPhysics(tlist, _ctx())
    x = _x(1, (1,) + IMSIZE)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    n, jn = float(d.compute_norm(xt, max_iter=100)), float(jd.compute_norm(xj, max_iter=100))
    assert abs(n - jn) / jn < 1e-3
    y, jy = d.A(xt), jd.A(xj)
    rel = lambda a, b: float(np.linalg.norm(_np(a) - _np(b)) / np.linalg.norm(_np(b)))
    assert rel(d.A_dagger(y, max_iter=200), jd.A_dagger(jy, max_iter=200)) < 1e-3
    z = _x(2, (1,) + IMSIZE)
    assert rel(d.prox_l2(torch.from_numpy(z), y, 0.5),
               jd.prox_l2(jnp.asarray(z), jy, 0.5)) < 1e-3


def test_data_fidelity_matches_jax():
    """DistributedDataFidelity with one L2 and with a per-operator L2/L1
    list: value and gradient within 1e-4 of JAX's; autograd through the
    distributed value equals the serial stack's gradient within 1e-5."""
    jlist, tlist = _stacks(8)
    jctx = jpar.DistributedContext(axis_names=("op",))
    jd = jpar.DistributedStackedLinearPhysics(jlist, jctx)
    d = DistributedStackedLinearPhysics(tlist, _ctx())
    x, xg = _x(2), _x(3)
    y, jy = d.A(torch.from_numpy(xg)), jd.A(jnp.asarray(xg))
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for fid, jfid in ((L2(), JL2()), ([L2() if i % 2 == 0 else L1() for i in range(8)],
                                       [JL2() if i % 2 == 0 else JL1() for i in range(8)])):
        df, jdf = DistributedDataFidelity(fid, _ctx()), jpar.DistributedDataFidelity(jfid, jctx)
        _close(df(xt, y, d), jdf(xj, jy, jd), 1e-4)
        _close(df.grad(xt, y, d), jdf.grad(xj, jy, jd), 1e-4, 1e-5)
    df = DistributedDataFidelity(L2(), _ctx())
    u = xt.clone().requires_grad_()
    g = torch.autograd.grad(df(u, y, d).sum(), u)[0]
    u2 = xt.clone().requires_grad_()
    g_serial = torch.autograd.grad(sum(L2()(u2, y[i], p).sum() for i, p in enumerate(tlist)),
                                   u2)[0]
    _close(g, g_serial, 1e-5, 1e-5)


def test_nonlinear_stack_and_factories():
    """The nonlinear stack of 8 phase-retrieval operators takes the
    homogeneous path and matches JAX's A within 1e-4; a heterogeneous stack
    gives a TensorList; a factory is called once an index with its block's
    device; a missing num_operators raises."""
    from deepinv_tpu.physics import BlurFFT as JBlurFFT
    from deepinv_tpu.physics import Denoising as JDen
    from deepinv_tpu.physics import PhaseRetrieval as JPR
    from deepinv_tpu_torch.physics import BlurFFT, Denoising, Haze, PhaseRetrieval

    fs = [np.asarray(jgauss(sigma=0.5 + 0.2 * i, psf_size=(7, 7))) for i in range(8)]
    jd = jpar.DistributedStackedPhysics(
        [JPR(B=JBlurFFT(img_size=IMSIZE, filter=jnp.asarray(f))) for f in fs],
        jpar.DistributedContext(axis_names=("op",)))
    d = DistributedStackedPhysics(
        [PhaseRetrieval(B=BlurFFT(IMSIZE, filter=torch.from_numpy(f.copy()), device="cpu")) for f in fs],
        _ctx())
    assert d.batched is not None and jd.batched is not None
    x = np.random.default_rng(0).random((1,) + IMSIZE).astype(np.float32) + 0.1
    _close(d.A(torch.from_numpy(x)), jd.A(jnp.asarray(x)), 1e-4, 1e-5)
    het = DistributedStackedPhysics([Denoising(), d.physics_list[0]], _ctx())
    assert het.batched is None
    yh = het.A(torch.from_numpy(x))
    jyh = jpar.DistributedStackedPhysics([JDen(), jd.physics_list[0] if jd.physics_list else
                                          JPR(B=JBlurFFT(img_size=IMSIZE, filter=jnp.asarray(
                                              fs[0])))], jd.ctx).A(jnp.asarray(x))
    assert len(yh) == len(jyh) == 2
    _close(yh[1], jyh[1], 1e-4, 1e-5)
    with pytest.raises(ValueError):
        stack_homogeneous([Denoising(), Haze()])
    assert stack_homogeneous(d.physics_list[:3]).B.mask.shape[0] == 3

    calls = []

    def factory(i, device, kw):
        calls.append((i, device, kw["sigma"]))
        return Blur(filter=torch.from_numpy(np.asarray(jgauss(sigma=kw["sigma"] + 0.1 * i,
                                                              psf_size=(7, 7)))),
                    padding="circular", device=device)

    def jfactory(i, device, kw):
        return JBlur(filter=jgauss(sigma=kw["sigma"] + 0.1 * i, psf_size=(7, 7)),
                     padding="circular")

    dd = distribute(factory, _ctx(), num_operators=6, type_object="linear_physics",
                    factory_kwargs={"sigma": 0.5})
    jdd = jpar.distribute(jfactory, jd.ctx, num_operators=6, type_object="linear_physics",
                          factory_kwargs={"sigma": 0.5})
    assert sorted(c[0] for c in calls) == list(range(6))
    assert all(c[1] == CPU and c[2] == 0.5 for c in calls)
    xs = _x(23, (1,) + IMSIZE)
    _close(dd.A(torch.from_numpy(xs)), jdd.A(jnp.asarray(xs)), 1e-4, 1e-5)
    with pytest.raises(ValueError):
        distribute(factory, _ctx(), type_object="linear_physics")


def test_gather_strategies_and_dispatch():
    """The three gather strategies give the same bits, a bad one raises;
    distribute() builds the JAX package's wrapper types."""
    _, tlist = _stacks(8)
    x = torch.from_numpy(_x(20))
    outs = [DistributedStackedLinearPhysics(tlist, _ctx(), gather_strategy=s)
            for s in ("naive", "concatenated", "broadcast")]
    ys = [o.A(x) for o in outs]
    assert all(torch.equal(ys[0], v) for v in ys[1:])
    assert all(torch.equal(outs[0].A_adjoint(ys[0]), o.A_adjoint(ys[0])) for o in outs[1:])
    with pytest.raises(ValueError):
        DistributedStackedLinearPhysics(tlist, _ctx(), gather_strategy="bogus")
    assert isinstance(distribute(tlist, _ctx()), DistributedStackedLinearPhysics)
    assert isinstance(distribute(stack(*tlist), _ctx()), DistributedStackedLinearPhysics)
    assert isinstance(distribute(L2(), _ctx()), DistributedDataFidelity)
    assert isinstance(distribute(MedianFilter(3), _ctx("sp"), type_object="auto"),
                      DistributedProcessing)


@pytest.mark.parametrize("case", [
    dict(overlap=4), dict(overlap=4, max_batch_size=2), dict(overlap=4, tiling_dims=-1),
    dict(overlap=8), dict(tiling_strategy="basic"), dict(overlap=0)])
def test_processing_matches_jax(case):
    """A 3x3 median over 8 bands of 64 rows: each option equal to JAX's
    sharded processor within 1e-6 (overlap 8 is a band's height: the edge
    rows' reflect rule); with a halo of 4 or more both equal the whole-image
    median."""
    x = np.random.default_rng(0).random((3, 1, 64, 64)).astype(np.float32)
    got = DistributedProcessing(MedianFilter(3), _ctx("sp"), **case)(torch.from_numpy(x), 0.1)
    want = jpar.DistributedProcessing(JaxMedian(3), jpar.DistributedContext(axis_names=("sp",)),
                                      **case)(jnp.asarray(x), 0.1)
    _close(got, want, 1e-6, 1e-6)
    if case.get("overlap", 8) >= 4 and case.get("tiling_strategy") != "basic":
        _close(got, MedianFilter(3)(torch.from_numpy(x)), 1e-6, 1e-6)
    with pytest.raises(ValueError):
        DistributedProcessing(MedianFilter(3), _ctx("sp"), tiling_strategy="bogus")
    with pytest.raises(ValueError):
        DistributedProcessing(MedianFilter(3), _ctx("sp"), tiling_dims=(0, 1))


@pytest.mark.parametrize("tiling_dims", [-1, -2])
def test_processing_blur_tiling_dims(tiling_dims):
    """A circular 2-D blur tiled by rows or columns with a halo of the PSF's
    size: within 1e-5 of JAX's tiling, and of the whole-image blur inside."""
    h = jgauss(sigma=0.7)
    ht = torch.from_numpy(np.asarray(h))
    ov = max(h.shape[-2:])
    x = np.random.default_rng(1).random((1, 1, 64, 64)).astype(np.float32)
    got = DistributedProcessing(lambda v, s=None: conv2d(v, ht, padding="circular"), _ctx("sp"),
                                overlap=ov, tiling_dims=tiling_dims)(torch.from_numpy(x))
    want = jpar.DistributedProcessing(lambda v, s=None: jconv2d(v, h, padding="circular"),
                                      jpar.DistributedContext(axis_names=("sp",)), overlap=ov,
                                      tiling_dims=tiling_dims)(jnp.asarray(x))
    _close(got, want, 1e-5, 1e-5)
    direct = conv2d(torch.from_numpy(x), ht, padding="circular")
    _close(got[..., ov:-ov, ov:-ov], direct[..., ov:-ov, ov:-ov], 1e-5, 1e-5)


@pytest.mark.parametrize("M", [1, 3, 8])
def test_pipeline_matches_jax(M):
    """4 stages of 2 unrolled PGD steps on inpainting over [cpu] * 4, M
    microbatches: the output within 1e-5 and the stepsizes' gradient within
    1e-4 of JAX's pipeline and of the stages run in sequence; the module
    wrapper on the flat batch likewise."""
    jphys = JInpainting(img_size=(1, 16, 16), mask=0.5, key=jax.random.key(0))
    phys = Inpainting((1, 16, 16), mask=torch.from_numpy(np.asarray(jphys.mask)), device="cpu")
    S, K, B = 4, 2, 2

    def make_stage(p):
        def stage_apply(step, carry):
            x, y = carry
            for _ in range(K):
                x = (x - step[0] * p.A_adjoint(p.A(x) - y)).clip(0.0, 1.0)
            return (x, y)
        return stage_apply

    xt = np.random.default_rng(M).random((M, B, 1, 16, 16)).astype(np.float32)
    y = np.stack([np.asarray(jphys.A(jnp.asarray(v))) for v in xt])
    x0 = np.stack([np.asarray(jphys.A_adjoint(jnp.asarray(v))) for v in y])
    steps = np.linspace(0.9, 1.2, S, dtype=np.float32).reshape(S, 1)
    jctx = jpar.DistributedContext(axis_names=("pp",), devices=jax.devices()[:4])

    def jrun(s):
        return jpar.pipeline(s, make_stage(jphys), (jnp.asarray(x0), jnp.asarray(y)), jctx)[0]

    want = jax.jit(jrun)(jnp.asarray(steps))
    jgrad = jax.jit(jax.grad(lambda s: jnp.sum((jrun(s) - jnp.asarray(xt)) ** 2)))(
        jnp.asarray(steps))
    st = torch.from_numpy(steps).requires_grad_()
    carries = (torch.from_numpy(x0), torch.from_numpy(y))
    got = pipeline(st, make_stage(phys), carries, _ctx("pp", 4))[0]
    g = torch.autograd.grad(((got - torch.from_numpy(xt)) ** 2).sum(), st)[0]
    _close(got, want, 1e-5, 1e-6)
    _close(g, jgrad, 1e-4, 1e-5)
    seq = []
    for m in range(M):
        c = (carries[0][m], carries[1][m])
        for s in range(S):
            c = make_stage(phys)(st[s], c)
        seq.append(c[0])
    _close(got, torch.stack(seq), 1e-6, 1e-7)
    wrap = PipelineParallel(st.detach(), make_stage(phys), _ctx("pp", 4), n_microbatches=M)
    flat = wrap((carries[0].reshape(M * B, 1, 16, 16), carries[1].reshape(M * B, 1, 16, 16)))
    _close(flat[0].reshape(M, B, 1, 16, 16), want, 1e-5, 1e-6)


def test_distributed_pgd_matches_serial_and_jax():
    """PGD with Tikhonov, 30 iterations, on 4 blurs: the distributed
    fidelity over the distributed stack equals the serial stack's run within
    1e-5 and JAX's distributed run within 1e-4."""
    from deepinv_tpu.optim import Tikhonov as JTik
    from deepinv_tpu.optim import optim_builder as jbuilder

    jlist, tlist = _stacks(4)
    params = {"stepsize": 0.3, "lambda": 0.05}
    x = np.random.default_rng(5).random((1,) + IMSIZE).astype(np.float32)
    d = DistributedStackedLinearPhysics(tlist, _ctx())
    serial = stack(*tlist)
    xt = torch.from_numpy(x)
    run = lambda fid, y, p: optim_builder("PGD", data_fidelity=fid, prior=Tikhonov(),
                                          params_algo=params, max_iter=30, device="cpu")(y, p)
    with torch.no_grad():
        got = run(DistributedDataFidelity(L2(), _ctx()), d.A(xt), d)
        ser = run(L2(), serial.A(xt), serial)
    jctx = jpar.DistributedContext(axis_names=("op",))
    jd = jpar.DistributedStackedLinearPhysics(jlist, jctx)
    want = jbuilder("PGD", data_fidelity=jpar.DistributedDataFidelity(JL2(), jctx),
                    prior=JTik(), params_algo=params, max_iter=30)(jd.A(jnp.asarray(x)), jd)
    _close(got, ser, 1e-5, 1e-6)
    _close(got, want, 1e-4, 1e-5)


def test_data_parallel_trainer():
    """Two epochs of DnCNN training with the batch split over [cpu] * 8:
    the weights within 1e-4 of the single-device run (the JAX package's
    test_data_parallel_trainer), the losses within 1e-5; a mesh of one
    device trains as without data_parallel."""
    from deepinv_tpu_torch.datasets import ArrayDataset, DataLoader, random_circles
    from deepinv_tpu_torch.models import DnCNN
    from deepinv_tpu_torch.physics import Denoising, GaussianNoise
    from deepinv_tpu_torch.training import Trainer

    data = np.stack([random_circles(16, seed=i) for i in range(16)])

    def run(dp):
        net = DnCNN(1, 1, depth=3, nf=4, device="cpu", generator=torch.Generator().manual_seed(0))
        t = Trainer(net, Denoising(GaussianNoise(0.1, device="cpu")),
                    train_dataloader=DataLoader(ArrayDataset(data), batch_size=8),
                    online_measurements=True, epochs=2, verbose=False, data_parallel=dp, seed=0)
        t.train()
        return t

    dp, single = run(_ctx("dp")), run(False)
    assert dp._dp is not None and len(dp._replicas) == 8
    _close(dp.model.in_conv.weight, single.model.in_conv.weight, 1e-4, 1e-5)
    _close(dp.loss_history, single.loss_history, 1e-5)
    assert run(_ctx("dp", 1))._dp is None


def _replayed_splits(monkeypatch):
    """Record the masks the JAX ``SplittingModel`` draws in the train step
    (``jax.debug.callback``, the whole batch's mask) and replay them, in
    order, to the port's: ``"net"`` for the trainer's ``x_net`` call,
    ``"loss"`` for the loss's call (``return_mask``). Returns the record and
    a function that arms the port's side with a copy of it."""
    import functools

    import deepinv_tpu.loss.measplit as jms
    import deepinv_tpu_torch.loss.measplit as tms

    record = {"net": [], "loss": []}
    jcall, tforward = jms.SplittingModel.__call__, tms.SplittingModel.forward

    def jax_call(self, y, physics, key=None, train=False, return_mask=False):
        out, mask = jcall(self, y, physics, key=key, train=train, return_mask=True)
        if train:
            tag = "loss" if return_mask else "net"
            jax.debug.callback(functools.partial(lambda t, m: record[t].append(np.array(m)),
                                                 tag), mask)
        return (out, mask) if return_mask else out

    monkeypatch.setattr(jms.SplittingModel, "__call__", jax_call)

    def arm():
        queue = {k: list(v) for k, v in record.items()}

        def forward(self, y, physics, generator=None, train=False, return_mask=False, **kw):
            if train:
                kw["masks"] = [queue["loss" if return_mask else "net"].pop(0)]
            return tforward(self, y, physics, generator=generator, train=train,
                            return_mask=return_mask, **kw)

        monkeypatch.setattr(tms.SplittingModel, "forward", forward)
        return queue

    return record, arm


@pytest.mark.parametrize("loss", ["sup", "splitting"])
def test_data_parallel_trainer_matches_jax(loss, monkeypatch):
    """JAX's ``Trainer(data_parallel=True)`` on its 8 virtual devices and the
    port's over ``[cpu] * 8``: ``ArtifactRemoval(DnCNN(1, 1, depth=3))`` with
    crossed weights, offline inpainting pairs (16 of 16x16, batch 8), 2
    epochs of Adam(1e-3, eps 1e-3 as in test_torch_training's ``_trainers``).
    ``splitting`` trains with ``SplittingLoss``, JAX's whole-batch split masks
    replayed to the port. The loss histories within 1e-4 (relative max
    error) and each final weight within 1e-4 (relative L2) of JAX's; the
    port's data-parallel run within 1e-5 of its single-device run on the
    same masks, so the split draws nothing of its own."""
    import optax
    from deepinv_tpu.datasets import ArrayDataset as JDS
    from deepinv_tpu.datasets import DataLoader as JDL
    from deepinv_tpu.loss import SplittingLoss as JSplit
    from deepinv_tpu.models import ArtifactRemoval as JArtifact
    from deepinv_tpu.training import Trainer as JTrainer
    from deepinv_tpu_torch.datasets import ArrayDataset, DataLoader
    from deepinv_tpu_torch.loss import SplittingLoss
    from deepinv_tpu_torch.models import ArtifactRemoval
    from deepinv_tpu_torch.training import Trainer
    from test_torch_dncnn import _pair
    from test_torch_drunet import jax_params

    rng = np.random.default_rng(11)
    m = (rng.random((1, 16, 16)) < 0.7).astype(np.float32)
    x = rng.random((16, 1, 16, 16)).astype(np.float32)
    y = (m * (x + 0.1 * rng.standard_normal(x.shape))).astype(np.float32)
    record, arm = _replayed_splits(monkeypatch)
    ref, _ = _pair(depth=3, nf=8, seed=7)
    opts = dict(epochs=2, verbose=False)
    jt = JTrainer(JArtifact(ref), JInpainting((1, 16, 16), mask=jnp.asarray(m)),
                  optimizer=optax.adam(1e-3, eps=1e-3), train_dataloader=JDL(JDS(x, y), batch_size=8),
                  losses=JSplit(split_ratio=0.6) if loss == "splitting" else None,
                  data_parallel=True, **opts)
    jt.train()
    assert jt._dp_sharding is not None
    assert len(record["net"]) == (4 if loss == "splitting" else 0)

    def port(dp):
        queue = arm()
        net = _pair(depth=3, nf=8, seed=7)[1]
        model = ArtifactRemoval(net)
        t = Trainer(model, Inpainting((1, 16, 16), mask=m, device="cpu"),
                    optimizer=torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-3),
                    train_dataloader=DataLoader(ArrayDataset(x, y), batch_size=8),
                    losses=SplittingLoss(split_ratio=0.6) if loss == "splitting" else None,
                    data_parallel=dp, **opts)
        t.train()
        assert not queue["net"] and not queue["loss"]
        return t, net

    (pt, pnet), (st, snet) = port(_ctx("dp")), port(False)
    assert pt._dp is not None and len(pt._replicas) == 8
    jnet = jt.model.model.backbone_net if loss == "splitting" else jt.model.backbone_net
    want = jax_params(jnet)
    for k, v in pnet.state_dict().items():
        assert np.linalg.norm(v.numpy() - want[k]) <= 1e-4 * np.linalg.norm(want[k]), k
        _close(v, snet.state_dict()[k], 1e-5, 1e-7)
    jl = np.asarray(jt.loss_history, np.float32)
    assert np.abs(np.asarray(pt.loss_history) - jl).max() <= 1e-4 * np.abs(jl).max()
    _close(pt.loss_history, st.loss_history, 1e-5)


def test_data_parallel_splits_per_sample_physics():
    """A per-sample physics reaches each replica cut to its chunk's rows:
    with online measurements through a per-sample inpainting mask (a mask
    a sample, of the measurement's rank) and SplittingLoss drawing its split
    for the whole batch, the data-parallel run over ``[cpu] * 8`` (batch 8,
    chunks of 1) equals the single-device run within 1e-5, and a physics that
    has no per-sample tensor is passed on as it is."""
    from deepinv_tpu_torch.datasets import ArrayDataset, DataLoader, random_circles
    from deepinv_tpu_torch.loss import SplittingLoss
    from deepinv_tpu_torch.models import ArtifactRemoval, DnCNN
    from deepinv_tpu_torch.physics import GaussianNoise
    from deepinv_tpu_torch.training.trainer import _batch_rows

    data = np.stack([random_circles(16, seed=i) for i in range(16)])
    masks = (np.random.default_rng(3).random((8, 1, 16, 16)) < 0.7).astype(np.float32)
    physics = Inpainting((1, 16, 16), mask=masks, device="cpu",
                         noise_model=GaussianNoise(0.05, device="cpu"))
    cut = _batch_rows(physics, 8, 4, 2, 4)
    _close(cut.mask, masks[2:4], 0)
    assert physics.mask.shape[0] == 8
    plain = Inpainting((1, 16, 16), mask=masks[0], device="cpu")
    assert _batch_rows(plain, 8, 4, 2, 4) is plain

    def run(dp):
        from deepinv_tpu_torch.training import Trainer

        net = DnCNN(1, 1, depth=3, nf=4, device="cpu", generator=torch.Generator().manual_seed(0))
        t = Trainer(ArtifactRemoval(net), physics,
                    train_dataloader=DataLoader(ArrayDataset(data), batch_size=8),
                    losses=SplittingLoss(split_ratio=0.6), online_measurements=True, epochs=2,
                    verbose=False, data_parallel=dp, seed=0)
        t.train()
        return t, net

    (dp, dnet), (single, snet) = run(_ctx("dp")), run(False)
    for k, v in dnet.state_dict().items():
        _close(v, snet.state_dict()[k], 1e-5, 1e-7)
    _close(dp.loss_history, single.loss_history, 1e-5)


def test_data_parallel_keeps_one_physics_copy_a_device():
    """The data-parallel step moves a physics to another device once and
    keeps the copy while the physics lives (``meta`` stands in for a second
    device here); a physics already on the device is passed on as it is."""
    import gc

    from deepinv_tpu_torch.models import ArtifactRemoval, DnCNN
    from deepinv_tpu_torch.training import Trainer

    t = Trainer(ArtifactRemoval(DnCNN(1, 1, depth=2, nf=4, device="cpu")),
                Inpainting((1, 8, 8), mask=0.5, device="cpu"), verbose=False)
    p = Inpainting((1, 8, 8), mask=0.5, device="cpu")
    meta = torch.device("meta")
    a = t._physics_on(p, meta)
    assert a is not p and a.mask.device.type == "meta" and t._physics_on(p, meta) is a
    assert t._physics_on(p, CPU) is p and t._physics_on(p.update(mask=p.mask), meta) is not a
    del p, a
    gc.collect()
    assert len(t._physics_copies) == 0
