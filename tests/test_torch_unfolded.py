"""The port's unfolded and deep-equilibrium networks and DPIR against the JAX
package's, on the CPU: an unfolded PGD's loss and gradients (the schedule's
and a DnCNN's crossed by ``load_jax_params``) against ``jax.grad``; a DEQ's
forward and implicit gradient against ``deq_fixed_point``; the same
unfolded PGD in bf16 at 64 channels, whose hidden chain takes the stash op's
plain version and its stash backward; DPIR with a small DRUNet.

f32 bounds are 1e-4 (max abs error over the reference's max); the bf16 case
is held at the 3e-2 of
``test_torch_training.py::test_autocast_gradient_reaches_the_f32_parameters``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import deepinv_tpu.optim as J
import deepinv_tpu.physics as JP
import deepinv_tpu.unfolded as JU
import deepinv_tpu_torch.ops.kernels.conv_chain as ck
import deepinv_tpu_torch.optim as T
import deepinv_tpu_torch.physics as TP
import deepinv_tpu_torch.unfolded as TU
from deepinv_tpu.core import Module as JModule
from deepinv_tpu.models import DnCNN as JaxDnCNN
from deepinv_tpu.models import DRUNet as JaxDRUNet
from deepinv_tpu.models import autocast as jax_autocast
from deepinv_tpu_torch.models import DnCNN, DRUNet, autocast, load_jax_params
from deepinv_tpu_torch.models.base import Denoiser
from test_torch_drunet import DEV, jax_params

SIZE = 16


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _dncnn(depth=4, nf=8, seed=0):
    ref = JaxDnCNN(1, 1, depth=depth, nf=nf, key=jax.random.key(seed))
    rng = np.random.default_rng(seed)
    for conv in [ref.in_conv, *ref.conv_list, ref.out_conv]:
        conv.bias = jnp.asarray(rng.standard_normal(conv.bias.shape) * 0.02, jnp.float32)
    return ref, load_jax_params(DnCNN(1, 1, depth=depth, nf=nf, device=DEV), jax_params(ref))


def _inpainting(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.random((2, 1, SIZE, SIZE)).astype(np.float32)
    mask = (rng.random((1, SIZE, SIZE)) < 0.6).astype(np.float32)
    y = (x * mask + 0.02 * rng.standard_normal(x.shape) * mask).astype(np.float32)
    jphys = JP.Inpainting(img_size=(1, SIZE, SIZE), mask=jnp.asarray(mask))
    tphys = TP.Inpainting((1, SIZE, SIZE), mask=torch.from_numpy(mask), device=DEV)
    return x, y, jphys, tphys


def _grads(jg_net, tnet, names):
    """``[(port grad, JAX grad)]`` of the schedule entries ``names`` and the
    prior's denoiser weights."""
    out = [(getattr(tnet, f"param_{k}").grad, jg_net.params_algo[k]) for k in names]
    den = tnet.prior.denoiser
    den = getattr(den, "denoiser", den)
    den = getattr(den, "net", den)
    jden = jg_net.prior.denoiser
    jden = getattr(jden, "denoiser", jden)
    jden = getattr(jden, "net", jden)
    want = jax_params(jden)
    out += [(p.grad, want[n]) for n, p in den.named_parameters()]
    return out


def _unfolded_pair(jden, tden, max_iter=3):
    pa = {"stepsize": [1.0, 0.9, 0.8][:max_iter], "g_param": 0.05, "beta": 0.9}
    jnet = JU.unfolded_builder("PGD", data_fidelity=J.L2(), prior=J.PnP(jden), params_algo=pa,
                               max_iter=max_iter)
    tnet = TU.unfolded_builder("PGD", data_fidelity=T.L2(), prior=T.PnP(tden), params_algo=pa,
                               max_iter=max_iter, device=DEV)
    return jnet, tnet


def test_unfolded_pgd_gradients_match_jax():
    """Loss and gradients of an unfolded PGD (3 iterations, a depth-4 DnCNN)
    in the schedule (stepsize, beta) and the DnCNN's weights, f32."""
    x, y, jphys, tphys = _inpainting()
    jden, tden = _dncnn()
    jnet, tnet = _unfolded_pair(jden, tden)
    assert isinstance(tnet, TU.BaseUnfold) and isinstance(tnet.param_stepsize, torch.nn.Parameter)

    def jloss(net):
        return jnp.mean((net(jnp.asarray(y), jphys) - jnp.asarray(x)) ** 2)

    jl, jg = jax.value_and_grad(jloss)(jnet)
    tl = ((tnet(torch.from_numpy(y), tphys) - torch.from_numpy(x)) ** 2).mean()
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * float(jl)
    for got, want in _grads(jg, tnet, ("stepsize", "beta")):
        assert got is not None and _rel(got.numpy(), want) <= 1e-4


class _JContractive(JModule):
    """``0.9 x + 0.1 net(x)``, examples/demo_deq.py:26-40."""

    def __init__(self, net):
        self.net = net

    def __call__(self, x, sigma=None, **kw):
        return 0.9 * x + 0.1 * self.net(x, sigma)


class _TContractive(Denoiser):
    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x, sigma=None, **kw):
        return 0.9 * x + 0.1 * self.net(x, sigma)


def test_deq_forward_and_implicit_gradient_match_jax():
    """A DEQ on PGD with the demo's contractive DnCNN: the equilibrium and
    the implicit gradient in the DnCNN's weights and the schedule's last
    stepsize against ``jax.grad`` through JAX ``deq_fixed_point`` (f32); the
    iteration counts are kept in ``last_run``."""
    x, y, jphys, tphys = _inpainting(seed=2)
    jden, tden = _dncnn(seed=3)
    pa = {"stepsize": 0.5, "g_param": 0.05}
    kw = dict(params_algo=pa, max_iter=30, max_iter_backward=20)
    jnet = JU.DEQ_builder("PGD", data_fidelity=J.L2(), prior=J.PnP(_JContractive(jden)), **kw)
    tnet = TU.DEQ_builder("PGD", data_fidelity=T.L2(), prior=T.PnP(_TContractive(tden)),
                          device=DEV, **kw)

    def jloss(net):
        return jnp.mean((net(jnp.asarray(y), jphys) - jnp.asarray(x)) ** 2)

    jout = jnet(jnp.asarray(y), jphys)
    jl, jg = jax.value_and_grad(jloss)(jnet)
    tout = tnet(torch.from_numpy(y), tphys)
    assert _rel(tout.detach().numpy(), jout) <= 1e-4
    tl = ((tout - torch.from_numpy(x)) ** 2).mean()
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-4 * float(jl)
    runs = tnet.last_run
    assert 1 <= int(runs["forward_iterations"]) <= 30
    assert 1 <= int(runs["backward_iterations"]) <= 20
    # only the last stepsize carries a gradient, as in JAX
    got = tnet.param_stepsize.grad
    assert torch.count_nonzero(got[:-1]) == 0
    for g, want in _grads(jg, tnet, ("stepsize",)):
        assert g is not None and _rel(g.numpy(), want) <= 1e-4
    with torch.no_grad():
        assert torch.allclose(tnet(torch.from_numpy(y), tphys), tout.detach())


def test_bf16_unfolded_gradient_takes_the_stash_path():
    """The unfolded PGD with a bf16 DnCNN at 64 channels: on the CPU its
    hidden chain runs the stash op's plain version and the stash backward
    (the counts of the ops' wrappers), and the gradient of the DnCNN's
    float32 weights and the schedule lies within 3e-2 of ``jax.grad``
    through the JAX ``autocast`` network (the relative max error of the whole
    gradient)."""
    x, y, jphys, tphys = _inpainting(seed=4)
    jden, tden = _dncnn(depth=5, nf=64, seed=5)
    jnet, tnet = _unfolded_pair(jax_autocast(jden), autocast(tden), max_iter=2)

    def jloss(net):
        return jnp.mean((net(jnp.asarray(y), jphys) - jnp.asarray(x)) ** 2)

    jg = jax.grad(jloss)(jnet)
    calls = {"stash": 0, "backward": 0}
    real_bwd, real_plain = ck.stash_backward, ck.conv_chain_stash_plain

    def stash_plain(*a, **k):
        calls["stash"] += 1
        return real_plain(*a, **k)

    def bwd(*a, **k):
        calls["backward"] += 1
        return real_bwd(*a, **k)

    ck.conv_chain_stash_plain, ck.stash_backward = stash_plain, bwd
    try:
        tl = ((tnet(torch.from_numpy(y), tphys) - torch.from_numpy(x)) ** 2).mean()
        tl.backward()
    finally:
        ck.conv_chain_stash_plain, ck.stash_backward = real_plain, real_bwd
    assert calls == {"stash": 2, "backward": 2}
    pairs = _grads(jg, tnet, ("stepsize", "beta"))
    got = np.concatenate([g.numpy().ravel() for g, _ in pairs])
    want = np.concatenate([np.asarray(w).ravel() for _, w in pairs])
    assert _rel(got, want) <= 3e-2


def test_dpir_matches_jax():
    """DPIR (4 iterations, the DPIR schedule at sigma 0.05) with a small
    f32 DRUNet crossed from JAX, on 32² deblurring."""
    from deepinv_tpu.ops import gaussian_blur as jgauss

    rng = np.random.default_rng(6)
    x = rng.random((1, 1, 32, 32)).astype(np.float32)
    psf = np.asarray(jgauss(sigma=1.0))
    jphys = JP.BlurFFT(img_size=(1, 32, 32), filter=jnp.asarray(psf))
    tphys = TP.BlurFFT((1, 32, 32), filter=torch.from_numpy(psf), device=DEV)
    y = np.asarray(jphys.A(jnp.asarray(x))) + 0.05 * rng.standard_normal(x.shape).astype(
        np.float32)
    nc = (16, 16, 16, 16)
    jden = JaxDRUNet(1, 1, nc=nc, nb=1, key=jax.random.key(7))
    tden = load_jax_params(DRUNet(1, 1, nc=nc, nb=1, device=DEV), jax_params(jden))
    want = J.DPIR(0.05, denoiser=jden, max_iter=4)(jnp.asarray(y), jphys)
    with torch.no_grad():
        got = T.DPIR(0.05, denoiser=tden, max_iter=4, device=DEV)(torch.from_numpy(y), tphys)
    assert _rel(got.numpy(), want) <= 1e-4
