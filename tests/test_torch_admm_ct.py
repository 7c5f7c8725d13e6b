"""PnP-ADMM, DRS, Chambolle-Pock and g-first PGD on the CT bench problem
through both packages on the CPU: the data step is ``Tomography.prox_l2``,
CG over the Toeplitz normal (the physics' defaults: 50 iterations, tol
1e-4), and the prior a DnCNN crossed from JAX.

The bench's CT problem (``bench.py:151-162``) cut to 64 x 64 images: a
90-angle normalized Fourier-slice ``Tomography``, stepsize 1.0, denoiser
level 0.05. Chambolle-Pock takes the identity ``K`` (the physics enters
through the fidelity's ``prox_conjugate``); g-first PGD takes a gradient step
on ``ScorePrior(DnCNN)`` at ``lambda = g_param^2`` (a step to the denoiser's
output: ``PnP`` has no gradient in either package), then the prox of f.
DnCNN's residual layer is scaled by 0.1, as ``chip_smoke.py`` scales it
(``DNCNN_RESIDUAL_SCALE``): with He-normal weights the random net's residual
is as large as its input, the iterate grows ~40x in 8 iterations, and the
two packages' f32 conv roundings (~1e-5 a call) grow with it to ~1e-3.
Bounds: f32 within 1e-4 relative L2 error of JAX (a single prox agrees to
~1e-6); bf16 ADMM's PSNR within 0.1 dB of JAX's bf16 run and of the port's
own f32 run.
"""

import numpy as np
import pytest
import torch

from deepinv_tpu.optim import PnP as JaxPnP
from deepinv_tpu.optim import ScorePrior as JaxScorePrior
from deepinv_tpu_torch.core import loop_stats
from deepinv_tpu_torch.utils.profiling import counters
from deepinv_tpu_torch.optim import PnP, ScorePrior
from test_torch_dncnn import _pair
from test_torch_pgd import PARAMS, _psnr, _run_both

DEPTH = 5   # 3 hidden layers of 64 channels on the chain op (its plain version here)
ALGOS = ["ADMM", "DRS", "CP", "PGD-g_first"]
RESIDUAL_SCALE = 0.1


def _priors(algo, bf16=False, seed=0):
    from deepinv_tpu.models import autocast as jax_autocast
    from deepinv_tpu_torch.models import autocast

    ref, port = _pair(1, DEPTH, seed=seed)
    ref.out_conv.weight = ref.out_conv.weight * RESIDUAL_SCALE
    with torch.no_grad():
        port.out_conv.weight.mul_(RESIDUAL_SCALE)
    if bf16:
        ref, port = jax_autocast(ref), autocast(port)
    if algo == "PGD-g_first":
        return JaxScorePrior(ref), ScorePrior(port)
    return JaxPnP(ref), PnP(port)


def _params(algo):
    if algo == "PGD-g_first":   # x - lambda * stepsize * (x - D(x)) / sigma^2 = D(x)
        return {**PARAMS, "lambda": PARAMS["g_param"] ** 2}
    return PARAMS


@pytest.mark.parametrize("algo", ALGOS)
def test_f32_matches_jax(algo):
    """8 iterations; every data step a CG solve of the Toeplitz system."""
    loop_stats.reset()
    counters.reset()
    x, got, want, *_ = _run_both("ct", iterator=algo, prior=_priors(algo), params=_params(algo))
    assert got.shape == x.shape and np.isfinite(got).all()
    assert counters["loop.loops"] == 8 and 0 < loop_stats.iterations <= 8 * 50
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)


def test_bf16_admm_psnr_matches_jax():
    """bf16 autocast DnCNN (the chain op's plain version): PSNR within 0.1 dB
    of the JAX package's bf16 run and of the port's f32 run."""
    x, got, want, *_ = _run_both("ct", seed=1, iterator="ADMM", prior=_priors("ADMM", True, 1))
    _, got32, *_ = _run_both("ct", seed=1, iterator="ADMM", prior=_priors("ADMM", False, 1))
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert abs(_psnr(got, x) - _psnr(want, x)) <= 0.1
    assert abs(_psnr(got, x) - _psnr(got32, x)) <= 0.1


def test_ct_prox_solves_its_normal_equations():
    """``Tomography.prox_l2`` with a scalar and a per-sample gamma: the
    relative residual of ``(gamma A^T A + I) x = gamma A^T y + z`` within
    the CG tolerance, and the same bits with the stop flag read every
    iteration as every 8."""
    from test_torch_pgd import _problem

    x, y, _, ct = _problem("ct", seed=4)
    x2 = np.concatenate([x, x[..., ::-1]]).copy()
    y2 = ct.A(torch.from_numpy(x2))
    z = torch.zeros_like(torch.from_numpy(x2))
    for gamma in (1.0, torch.tensor([0.5, 4.0])):
        outs = [ct.prox_l2(z, y2, gamma, check_every=k) for k in (1, 8)]
        assert torch.equal(*outs)
        g = gamma if isinstance(gamma, float) else gamma[:, None, None, None]
        b = g * ct.A_adjoint(y2) + z
        r = (g * ct.A_adjoint_A(outs[0]) + outs[0] - b).flatten(1).norm(dim=1)
        assert float((r / b.flatten(1).norm(dim=1)).max()) <= 2 * ct.tol
