"""The PnP-HQS deblurring slice through both packages on the CPU.

The ``entry()`` problem (__graft_entry__.py:17-43): BlurFFT with a sigma-1.5
Gaussian PSF on 1x3x64x64, DRUNet(nc=(16, 32, 64, 64), nb=2) as the PnP
denoiser, 4 HQS iterations at stepsize 2.0 and denoiser level 0.02. Same
measurement (noise drawn with numpy) and same weights on both sides.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinv_tpu.models import DRUNet as JaxDRUNet
from deepinv_tpu.models import autocast as jax_autocast
from deepinv_tpu.optim import L2 as JaxL2
from deepinv_tpu.optim import Zero as JaxZero
from deepinv_tpu.optim import PnP as JaxPnP
from deepinv_tpu.optim import optim_builder as jax_optim_builder
from deepinv_tpu.physics import BlurFFT as JaxBlurFFT
from deepinv_tpu_torch.models import DRUNet, autocast, load_jax_params
from deepinv_tpu_torch.ops import gaussian_blur
from deepinv_tpu_torch.optim import (L2, DataFidelity, PnP, Potential, Zero, create_iterator,
                                     optim_builder)
from deepinv_tpu_torch.physics import BlurFFT, GaussianNoise
from test_torch_drunet import jax_params

SHAPE = (1, 3, 64, 64)
PARAMS = {"stepsize": 2.0, "g_param": 0.02}


def _setup(nc=(16, 32, 64, 64), nb=2, shape=SHAPE, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(np.float32)
    psf = gaussian_blur(1.5)
    port_phys = BlurFFT(shape[1:], filter=psf, noise_model=GaussianNoise(0.01))
    ref_phys = JaxBlurFFT(shape[1:], filter=jnp.asarray(psf.numpy()))
    y = np.asarray(ref_phys.A(jnp.asarray(x))) + 0.01 * rng.standard_normal(shape).astype(
        np.float32)
    ref_den = JaxDRUNet(nc=nc, nb=nb, key=jax.random.key(seed))
    port_den = load_jax_params(DRUNet(nc=nc, nb=nb), jax_params(ref_den))
    return x, y, port_phys, ref_phys, port_den, ref_den


def _run_both(port_den, ref_den, y, port_phys, ref_phys, params=PARAMS, max_iter=4, **kw):
    ref = jax_optim_builder("HQS", data_fidelity=JaxL2(), prior=JaxPnP(ref_den),
                            params_algo=params, max_iter=max_iter, **kw)
    want = np.asarray(jax.jit(lambda m, v, p: m(v, p))(ref, jnp.asarray(y), ref_phys))
    port = optim_builder("HQS", data_fidelity=L2(), prior=PnP(port_den),
                         params_algo=params, max_iter=max_iter, **kw)
    with torch.no_grad():
        got = port(torch.from_numpy(y), port_phys).numpy()
    return got, want


def _psnr(a, x):
    return float(10 * np.log10(1.0 / np.mean((np.asarray(a, np.float32) - x) ** 2)))


def _rel(a, b):
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def test_entry_problem_f32_matches_jax():
    """f32 reconstruction, relative error <= 1e-4."""
    x, y, port_phys, ref_phys, port_den, ref_den = _setup()
    got, want = _run_both(port_den, ref_den, y, port_phys, ref_phys)
    assert got.shape == SHAPE and np.isfinite(got).all()
    assert _rel(got, want) <= 1e-4


def test_entry_problem_bf16_psnr_matches_jax():
    """bf16 autocast reconstruction: PSNR within 0.1 dB of the JAX package's
    bf16 run and of the port's own f32 run (the repo's bf16 policy,
    tests/test_models.py::test_autocast_bf16_parity)."""
    x, y, port_phys, ref_phys, port_den, ref_den = _setup(seed=1)
    got, want = _run_both(autocast(port_den), jax_autocast(ref_den), y, port_phys, ref_phys)
    f32 = optim_builder("HQS", data_fidelity=L2(), prior=PnP(port_den), params_algo=PARAMS,
                        max_iter=4)
    with torch.no_grad():
        got32 = f32(torch.from_numpy(y), port_phys).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert abs(_psnr(got, x) - _psnr(want, x)) <= 0.1
    assert abs(_psnr(got, x) - _psnr(got32, x)) <= 0.1


@pytest.mark.parametrize("g_first", [False, True])
def test_hqs_branches_schedule_and_relaxation_match_jax(g_first):
    """Both HQS orders, relaxation beta = 0.7, and per-iteration schedules
    that cycle (a 2-entry stepsize list over 3 iterations); f32, relative
    error <= 1e-4."""
    x, y, port_phys, ref_phys, port_den, ref_den = _setup(
        nc=(8, 8, 8, 8), nb=1, shape=(2, 3, 32, 32), seed=2)
    params = {"stepsize": [1.0, 3.0], "g_param": [0.05, 0.03, 0.02], "beta": 0.7}
    got, want = _run_both(port_den, ref_den, y, port_phys, ref_phys, params=params,
                          max_iter=3, g_first=g_first)
    assert _rel(got, want) <= 1e-4


def test_l2_fidelity_matches_jax():
    """L2's value and gradient through the physics, and its prox, f32."""
    x, y, port_phys, ref_phys, _, _ = _setup(nc=(8, 8, 8, 8), nb=1, shape=(2, 3, 32, 32))
    pairs = [
        (L2(sigma=0.5).fn(torch.from_numpy(x), torch.from_numpy(y), port_phys),
         JaxL2(sigma=0.5).fn(jnp.asarray(x), jnp.asarray(y), ref_phys)),
        (L2(sigma=0.5).grad(torch.from_numpy(x), torch.from_numpy(y), port_phys),
         JaxL2(sigma=0.5).grad(jnp.asarray(x), jnp.asarray(y), ref_phys)),
        (L2(sigma=0.5).prox(torch.from_numpy(x), torch.from_numpy(y), port_phys, gamma=0.3),
         JaxL2(sigma=0.5).prox(jnp.asarray(x), jnp.asarray(y), ref_phys, gamma=0.3)),
        (Zero().fn(torch.from_numpy(x)), JaxZero().fn(jnp.asarray(x))),
    ]
    for got, want in pairs:
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_potential_defaults():
    """Autograd gradient and inner-gradient-descent prox defaults
    (potential.py:36-53, data_fidelity.py:69): on 0.5||u||^2 and on the L2
    fidelity, against their closed forms."""
    x = torch.rand((2, 1, 8, 8), generator=torch.Generator().manual_seed(0))
    pot = Potential(fn=lambda u: 0.5 * u.pow(2).flatten(1).sum(1))
    assert torch.allclose(pot.grad(x), x)
    np.testing.assert_allclose(pot.prox(x, gamma=0.5, max_iter_inter=60).numpy(),
                               (x / 1.5).numpy(), atol=1e-6)
    _, y, port_phys, _, _, _ = _setup(nc=(8, 8, 8, 8), nb=1, shape=(1, 3, 32, 32))
    z = torch.rand((1, 3, 32, 32), generator=torch.Generator().manual_seed(1))
    yt = torch.from_numpy(y)
    inner = DataFidelity.prox(L2(), z, yt, port_phys, gamma=0.5)
    np.testing.assert_allclose(inner.numpy(), port_phys.prox_l2(z, yt, 0.5).numpy(), atol=1e-5)


def test_builder_schedule_and_unported_options():
    model = optim_builder("hqs", params_algo={"stepsize": [1.0, 2.0]}, max_iter=5)
    assert torch.equal(model.params_algo["stepsize"], torch.tensor([1.0, 2.0, 1.0, 2.0, 1.0]))
    assert model.params_algo["g_param"].shape == (5,)
    assert "param_stepsize" in model.state_dict()  # a buffer: .to(device) moves it
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        create_iterator("FISTA")
    with pytest.raises(ValueError):
        create_iterator("nope")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        optim_builder("HQS", early_stop=True)


def test_import_loads_no_jax():
    """The port stands alone: importing it loads no JAX module and nothing
    of the JAX package."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import deepinv_tpu_torch, deepinv_tpu_torch.ops.kernels.build\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'deepinv_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=str(__import__("pathlib").Path(__file__).parents[1]))
    assert proc.returncode == 0, proc.stdout + proc.stderr
