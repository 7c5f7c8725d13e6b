"""The PnP-PGD slice (MRI and CT) through both packages on the CPU.

The bench problems of ``bench.py`` (``mri`` and ``ct``, bench.py:140-162) cut
to 64 x 64 images: a 30% random k-space mask on 2-channel images, or a
90-angle normalized Fourier-slice CT; a full-depth, full-width
``DnCNN(depth=20, nf=64)`` as the PnP denoiser with seeded weights and small
random biases; 8 PGD iterations at stepsize 1.0 and denoiser level 0.05.
Same measurement and same weights on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinv_tpu.models import autocast as jax_autocast
from deepinv_tpu.optim import L2 as JaxL2
from deepinv_tpu.optim import PnP as JaxPnP
from deepinv_tpu.optim import Prior as JaxPrior
from deepinv_tpu.optim import create_iterator as jax_create_iterator
from deepinv_tpu.optim import optim_builder as jax_optim_builder
from deepinv_tpu.physics import MRI as JaxMRI
from deepinv_tpu.physics import Tomography as JaxTomography
from deepinv_tpu_torch.models import DnCNN, autocast
from deepinv_tpu_torch.optim import L2, PnP, Prior, create_iterator, optim_builder
from deepinv_tpu_torch.physics import MRI, Tomography
from test_torch_dncnn import _pair

SIZE = 64
PARAMS = {"stepsize": 1.0, "g_param": 0.05}


def _problem(kind, seed=0):
    """Ground truth, measurement and the two packages' physics."""
    rng = np.random.default_rng(seed)
    if kind == "mri":
        x = rng.standard_normal((1, 2, SIZE, SIZE)).astype(np.float32)
        mask = (rng.random((SIZE, SIZE)) < 0.3).astype(np.float32)
        ref = JaxMRI(mask=jnp.asarray(mask), img_size=(SIZE, SIZE))
        port = MRI(mask=mask, img_size=(SIZE, SIZE))
    else:
        x = rng.random((1, 1, SIZE, SIZE)).astype(np.float32)
        kw = dict(img_width=SIZE, angles=90, method="slice", normalize=True)
        ref, port = JaxTomography(**kw), Tomography(**kw)
    y = np.array(ref.A(jnp.asarray(x)))
    return x, y, ref, port


def _run_both(kind, bf16=False, seed=0, iterator="PGD", prior=None, params=PARAMS,
              max_iter=8):
    x, y, ref_phys, port_phys = _problem(kind, seed)
    if prior is None:
        ref_den, port_den = _pair(x.shape[1], 20, seed=seed)
        if bf16:
            ref_den, port_den = jax_autocast(ref_den), autocast(port_den)
        prior = (JaxPnP(ref_den), PnP(port_den))
    it = (jax_create_iterator("PGD", g_first=True), create_iterator("PGD", g_first=True)) \
        if iterator == "PGD-g_first" else (iterator, iterator)
    ref = jax_optim_builder(it[0], data_fidelity=JaxL2(), prior=prior[0], params_algo=params,
                            max_iter=max_iter)
    want = np.asarray(jax.jit(lambda m, v, p: m(v, p))(ref, jnp.asarray(y), ref_phys))
    port = optim_builder(it[1], data_fidelity=L2(), prior=prior[1], params_algo=params,
                         max_iter=max_iter)
    with torch.no_grad():
        got = port(torch.from_numpy(y), port_phys).numpy()
    return x, got, want, port, port_phys, y


def _psnr(a, x):
    return float(10 * np.log10(1.0 / np.mean((np.asarray(a, np.float32) - x) ** 2)))


def _rel(a, b):
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


@pytest.mark.parametrize("kind,bound", [("mri", 1e-4), ("ct", 1e-3)])
def test_pgd_f32_matches_jax(kind, bound):
    """f32 reconstruction, relative max error <= 1e-4 (MRI) and <= 1e-3 (CT).
    CT's gradient ``A_adjoint_A(x) - A^T y`` subtracts two nearly equal
    terms, which scales up the last-bit differences of the NUFFT weights
    (float64-built here, float32 in the JAX trace)."""
    x, got, want, *_ = _run_both(kind)
    assert got.shape == x.shape and np.isfinite(got).all()
    assert _rel(got, want) <= bound


@pytest.mark.parametrize("kind", ["mri", "ct"])
def test_pgd_bf16_psnr_matches_jax(kind):
    """bf16 autocast DnCNN: PSNR within 0.1 dB of the JAX package's bf16 run
    and of the port's own f32 run (the repo's bf16 policy,
    tests/test_models.py::test_autocast_bf16_parity)."""
    x, got, want, *_ = _run_both(kind, bf16=True, seed=1)
    _, got32, _, _, _, _ = _run_both(kind, seed=1)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert abs(_psnr(got, x) - _psnr(want, x)) <= 0.1
    assert abs(_psnr(got, x) - _psnr(got32, x)) <= 0.1


@pytest.mark.parametrize("kind,iterator", [("mri", "PGD"), ("ct", "PGD"),
                                            ("mri", "PGD-g_first")])
def test_pgd_branches_schedule_and_relaxation_match_jax(kind, iterator):
    """Both PGD orders (``create_iterator("PGD", g_first=True)`` takes a
    gradient step on g, then the prox of f), relaxation beta = 0.7 and a
    stepsize schedule that cycles, with an explicit quadratic prior; f32,
    relative max error <= 1e-4. The g-first order needs the prox of f, which
    CT's slice projector has only through the Krylov solver (waiting, ROADMAP
    queue 1 item 8), so it runs on MRI."""
    def g_jax(v, *args):
        return 0.5 * jnp.sum(v.reshape(v.shape[0], -1) ** 2, axis=1)

    def g_port(v, *args):
        return 0.5 * v.flatten(1).pow(2).sum(1)

    params = {"stepsize": [0.8, 0.5], "lambda": 0.3, "beta": 0.7}
    _, got, want, *_ = _run_both(kind, seed=2, iterator=iterator, params=params, max_iter=3,
                                 prior=(JaxPrior(g=g_jax), Prior(g=g_port)))
    assert _rel(got, want) <= 1e-4


def test_adjoint_of_measurement_is_computed_once_per_reconstruction():
    """Eager PyTorch does not hoist ``A^T y`` out of the iterations as XLA
    does: the reconstruction computes it once (the initial iterate and every
    gradient step share it), with the same result as a loop that computes it
    at every step."""
    x, y, _, physics = _problem("ct", seed=3)
    den = DnCNN(1, 1, depth=4, generator=torch.Generator().manual_seed(0))
    model = optim_builder("PGD", data_fidelity=L2(), prior=PnP(den), params_algo=PARAMS,
                          max_iter=4)
    calls = []
    adjoint = physics.A_adjoint
    physics.A_adjoint = lambda v, **kw: calls.append(1) or adjoint(v, **kw)
    yt = torch.from_numpy(y)
    with torch.no_grad():
        got = model(yt, physics)
        assert len(calls) == 1
        model(yt, physics)
        assert len(calls) == 2
        v = adjoint(yt)
        for _ in range(4):
            v = den(v - (physics.A_adjoint_A(v) - adjoint(yt)), 0.05)
    assert torch.equal(got, v)
    assert model.data_fidelity._measurement is None
