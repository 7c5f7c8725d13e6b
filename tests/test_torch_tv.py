"""The port's TV prox op, ``TVPrior`` and ``TVDenoiser`` against the JAX
package on the CPU.

The CUDA kernel itself runs only on a GPU (chip_smoke.py compares it with its
plain version there). Here the op takes its plain PyTorch version, which is
held to the JAX XLA loop ``_xla_impl``, to the Pallas kernel ``_pallas_impl``
run in interpret mode (as tests/test_ops_battery.py:125-135 runs it) and, for
gradients, to ``jax.grad`` through the kernel's custom_vjp. Inputs come from
a numpy seed.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinv_tpu.models import TVDenoiser as JaxTVDenoiser
from deepinv_tpu.ops.pallas import tv as jax_tv
from deepinv_tpu.optim import TVPrior as JaxTVPrior
from deepinv_tpu_torch.models import TVDenoiser
from deepinv_tpu_torch.ops.kernels import build
from deepinv_tpu_torch.ops.kernels.tv import (_check_cuda, chambolle_prox, chambolle_prox_plain,
                                              div_op, grad_op)
from deepinv_tpu_torch.optim import TVPrior

SHAPES = [(1, 2, 16, 24), (1, 1, 13, 17)]


def _x(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_prox_matches_xla_loop(shape):
    """Plain version vs ``_xla_impl`` (tv.py:88), 30 iterations: atol 1e-5
    (both f32, the same update; observed ~1e-7)."""
    x = _x(shape)
    want = np.asarray(jax_tv._xla_impl(jnp.asarray(x), 0.1, 30))
    got = chambolle_prox_plain(torch.from_numpy(x), 0.1, 30)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_op_matches_pallas_interpret(shape):
    """The op on a CPU tensor vs the Pallas kernel in interpret mode
    (tv.py:70), 30 iterations: atol 1e-5."""
    x = _x(shape, seed=1)
    want = np.asarray(jax_tv._pallas_impl(jnp.asarray(x), jnp.asarray(0.2), 30))
    got = chambolle_prox(torch.from_numpy(x), 0.2, 30)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("gamma_shape", [(2, 1, 1, 1), (2, 3, 1, 1)])
def test_per_sample_and_per_plane_gamma_match_xla_loop(gamma_shape):
    """A per-sample (or per-plane) gamma vs ``_xla_impl`` with the same
    array, and each sample against its own scalar prox: atol 1e-5."""
    x = _x((2, 3, 16, 16), seed=2)
    g = np.random.default_rng(3).uniform(0.05, 0.3, gamma_shape).astype(np.float32)
    want = np.asarray(jax_tv._xla_impl(jnp.asarray(x), jnp.asarray(g), 30))
    got = chambolle_prox(torch.from_numpy(x), torch.from_numpy(g), 30)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    if gamma_shape[1] == 1:
        one = chambolle_prox(torch.from_numpy(x[1:]), float(g[1, 0, 0, 0]), 30)
        np.testing.assert_allclose(got[1:].numpy(), one.numpy(), atol=1e-6)


@pytest.mark.parametrize("gamma_shape", [(), (2, 1, 1, 1)])
def test_gradients_match_jax_custom_vjp(gamma_shape):
    """Gradients in x and gamma of ``sum(w * prox(x, gamma))`` against
    ``jax.grad`` through ``chambolle_prox``'s custom_vjp (whose backward is
    autodiff of ``_xla_impl``, as the port's is of the plain version):
    rtol 1e-4."""
    x = _x((2, 1, 12, 14), seed=4)
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    g = np.full(gamma_shape, 0.15, np.float32) if gamma_shape else np.float32(0.15)
    if gamma_shape:
        g[1] = 0.25

    def loss(xx, gg):
        return jnp.sum(jnp.asarray(w) * jax_tv.chambolle_prox(xx, gg, 20))

    want_x, want_g = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    gt = torch.tensor(g).requires_grad_()
    (chambolle_prox(xt, gt, 20) * torch.from_numpy(w)).sum().backward()
    assert gt.grad.shape == gt.shape
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(gt.grad.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-6)


def test_grad_and_div_match_jax_and_are_adjoint():
    """``grad_op``/``div_op`` against the JAX package's ``_grad_op``/``_div_op``
    (prior.py:171-184), and ``<grad u, p> = -<u, div p>``; ``nabla`` and
    ``nabla_adjoint`` of ``TVPrior`` (4D and 5D) against the JAX ones, and
    adjoint to 1e-5 relative."""
    from deepinv_tpu.optim.prior import _div_op as jax_div, _grad_op as jax_grad

    rng = np.random.default_rng(6)
    u = rng.standard_normal((2, 3, 9, 11)).astype(np.float32)
    p = rng.standard_normal((2, 3, 9, 11, 2)).astype(np.float32)
    np.testing.assert_allclose(grad_op(torch.from_numpy(u)).numpy(),
                               np.asarray(jax_grad(jnp.asarray(u))), atol=1e-6)
    np.testing.assert_allclose(div_op(torch.from_numpy(p)).numpy(),
                               np.asarray(jax_div(jnp.asarray(p))), atol=1e-6)
    lhs = float((grad_op(torch.from_numpy(u)).double() * torch.from_numpy(p).double()).sum())
    rhs = -float((torch.from_numpy(u).double() * div_op(torch.from_numpy(p)).double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)
    for shape in [(2, 3, 9, 11), (1, 2, 5, 6, 7)]:
        v = rng.standard_normal(shape).astype(np.float32)
        q = rng.standard_normal(shape + (len(shape) - 2,)).astype(np.float32)
        Nv = TVPrior.nabla(torch.from_numpy(v))
        Nq = TVPrior.nabla_adjoint(torch.from_numpy(q))
        np.testing.assert_allclose(Nv.numpy(), np.asarray(JaxTVPrior.nabla(jnp.asarray(v))),
                                   atol=1e-6)
        np.testing.assert_allclose(Nq.numpy(),
                                   np.asarray(JaxTVPrior.nabla_adjoint(jnp.asarray(q))),
                                   atol=1e-5)
        lhs = float((Nv.double() * torch.from_numpy(q).double()).sum())
        rhs = float((torch.from_numpy(v).double() * Nq.double()).sum())
        assert abs(lhs - rhs) <= 1e-5 * abs(lhs)
    with pytest.raises(ValueError):
        TVPrior.nabla(torch.zeros(3, 4, 5))
    with pytest.raises(ValueError):
        TVPrior.nabla_adjoint(torch.zeros(3, 4, 5, 2))


def test_tv_prior_fn_grad_and_prox_match_jax():
    """``TVPrior.fn`` (rtol 1e-5), its autograd gradient against ``jax.grad``
    (rtol 1e-4), and its prox through the op and with ``use_pallas=False``
    against the JAX prox (atol 1e-5)."""
    x = _x((2, 1, 16, 20), seed=7)
    prior, ref = TVPrior(n_it_max=25), JaxTVPrior(n_it_max=25)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_allclose(prior.fn(xt).numpy(), np.asarray(ref.fn(xj)), rtol=1e-5)
    np.testing.assert_allclose(prior.grad(xt).numpy(), np.asarray(ref.grad(xj)), rtol=1e-4,
                               atol=1e-5)
    want = np.asarray(ref.prox(xj, gamma=0.1))
    np.testing.assert_allclose(prior.prox(xt, gamma=0.1).numpy(), want, atol=1e-5)
    plain = TVPrior(n_it_max=25, use_pallas=False)
    np.testing.assert_allclose(plain.prox(xt, gamma=0.1).numpy(), want, atol=1e-5)


def test_tv_denoiser_matches_jax():
    """``TVDenoiser(n_it_max)(x, ths)`` (classic.py:73) against the JAX
    denoiser, atol 1e-5; it denoises a piecewise-constant image as the JAX
    doctest does; ``prox_tau_fx`` and ``prox_sigma_g_conj`` match too."""
    rng = np.random.default_rng(8)
    clean = np.zeros((1, 1, 16, 16), np.float32)
    clean[..., 8:] = 1.0
    noisy = (clean + 0.1 * rng.standard_normal(clean.shape)).astype(np.float32)
    port, ref = TVDenoiser(n_it_max=50), JaxTVDenoiser(n_it_max=50)
    got = port(torch.from_numpy(noisy), 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref(jnp.asarray(noisy), 0.1)), atol=1e-5)
    assert float(((got.numpy() - clean) ** 2).mean()) < float(((noisy - clean) ** 2).mean())
    u = rng.standard_normal((1, 1, 4, 5, 2)).astype(np.float32)
    np.testing.assert_allclose(port.prox_sigma_g_conj(torch.from_numpy(u), 0.5).numpy(),
                               np.asarray(ref.prox_sigma_g_conj(jnp.asarray(u), 0.5)), atol=1e-6)
    np.testing.assert_allclose(
        port.prox_tau_fx(torch.from_numpy(noisy), torch.from_numpy(clean)).numpy(),
        np.asarray(ref.prox_tau_fx(jnp.asarray(noisy), jnp.asarray(clean))), atol=1e-6)


def test_cpu_tensor_takes_the_plain_version():
    """On a CPU tensor the op runs the plain version (bit for bit), counts no
    launch and builds nothing."""
    x = torch.from_numpy(_x((1, 3, 10, 12), seed=9))
    before = chambolle_prox.launches
    assert torch.equal(chambolle_prox(x, 0.3, 15), chambolle_prox_plain(x, 0.3, 15))
    assert chambolle_prox.launches == before
    assert build.load_library.cache_info().currsize == 0


@pytest.mark.parametrize("case", ["f64", "one_dim", "empty", "n_iter", "spatial_gamma",
                                  "batch_vector_gamma", "mismatched_gamma"])
def test_kernel_input_checks_raise(case):
    """What the CUDA kernel does not take raises before any launch: float64,
    fewer than two dims, an empty tensor, a negative n_iter, a gamma that
    varies inside a plane or does not broadcast to x. The accepted gammas
    map to one value per plane."""
    x = torch.zeros((2, 3, 8, 8))
    bad = {
        "f64": (x.double(), torch.tensor(0.1), 5),
        "one_dim": (torch.zeros(8), torch.tensor(0.1), 5),
        "empty": (torch.zeros((0, 3, 8, 8)), torch.tensor(0.1), 5),
        "n_iter": (x, torch.tensor(0.1), -1),
        "spatial_gamma": (x, torch.full((2, 1, 8, 8), 0.1), 5),
        "batch_vector_gamma": (x, torch.tensor([0.1, 0.2]), 5),
        "mismatched_gamma": (x, torch.full((3, 1, 1, 1), 0.1), 5),
    }[case]
    with pytest.raises(TypeError if case == "f64" else ValueError):
        _check_cuda(*bad)
    assert torch.equal(_check_cuda(x, torch.tensor(0.5), 5), torch.full((6,), 0.5))
    g = torch.tensor([0.1, 0.2]).reshape(2, 1, 1, 1)
    assert torch.equal(_check_cuda(x, g, 5), g.reshape(2, 1).expand(2, 3).reshape(-1))
    g = torch.arange(6.0).reshape(2, 3, 1, 1)
    assert torch.equal(_check_cuda(x, g, 0), torch.arange(6.0))


def test_tv_modules_import_no_jax():
    """The port's TV modules stand alone: importing them loads no JAX module
    and nothing of the JAX package."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import deepinv_tpu_torch.ops.kernels.tv, deepinv_tpu_torch.optim.prior\n"
        "import deepinv_tpu_torch.models.classic, deepinv_tpu_torch.optim.iterators\n"
        "import deepinv_tpu_torch.ops.radon_slice, deepinv_tpu_torch.physics.tomography\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'deepinv_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=str(Path(__file__).parents[1]))
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_without_device_need_cuda():
    """With no CUDA device, an entry point built without ``device`` raises
    and names ``device="cpu"``: there is no quiet fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the GPU")
    from deepinv_tpu_torch.models import DnCNN, DRUNet
    from deepinv_tpu_torch.ops import gaussian_blur
    from deepinv_tpu_torch.optim import optim_builder
    from deepinv_tpu_torch.physics import MRI, BlurFFT, GaussianNoise, Tomography

    makers = [
        lambda: BlurFFT((1, 8, 8), filter=gaussian_blur(1.0)),
        lambda: MRI(img_size=(8, 8)),
        lambda: Tomography(angles=4, img_width=8, method="slice"),
        lambda: GaussianNoise(0.1),
        lambda: DRUNet(nc=(8, 8, 8, 8), nb=1),
        lambda: DnCNN(1, 1, depth=3),
        lambda: optim_builder("PGD", prior=TVPrior(), max_iter=2),
    ]
    for make in makers:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()
    assert BlurFFT((1, 8, 8), filter=gaussian_blur(1.0), device="cpu").mask.device.type == "cpu"
