"""A custom MCMC kernel (port of examples/demo_custom_mcmc_kernel.py):
ULA preconditioned by the diagonal Fisher information, plugged into
``BaseSampling``, on 16x16 inpainting (70% of the pixels, noise 0.1) with
a Tikhonov prior of weight 2; 12000 steps, a quarter burnt in, every second
kept. The chain's mean and variance match the analytic Gaussian posterior
(mean within 0.15, variance within 50%).
"""

import torch

from ..optim import L2, Tikhonov
from ..physics import GaussianNoise, Inpainting
from ..sampling import BaseSampling
from ..sampling.iterators import SamplingIterator
from . import _util


class PreconditionedULAIterator(SamplingIterator):
    """ULA with ``M = (diag(A^T A) / sigma2 + eps)^-1``:
    ``x+ = x + eta M (grad log p(y|x) + alpha grad log p(x)) + sqrt(2 eta M) z``."""

    def forward(self, X, y, physics, data_fidelity, prior, iteration, normal):
        x = X["x"]
        p = self.algo_params
        eta, alpha, eps = p["step_size"], p.get("alpha", 1.0), p.get("eps", 0.1)
        # the diagonal of A^T A of a mask is the mask
        diag = physics.A_adjoint(physics.A(torch.ones_like(x)))
        M = 1.0 / (diag / p["sigma2"] + eps)
        glik = -data_fidelity.grad(x, y, physics) / p["sigma2"]
        gpri = -alpha * prior.grad(x)
        return {"x": x + eta * M * (glik + gpri) + torch.sqrt(2 * eta * M) * normal.like(x)}


def main(device=None, fast=False):
    dev = _util.device(device)
    sigma, lam = 0.1, 2.0  # the noise's std, Tikhonov's weight
    physics = Inpainting((1, 16, 16), mask=0.7, generator=_util.generator(0),
                         noise_model=GaussianNoise(sigma, device="cpu"), device="cpu")
    x = torch.rand((1, 1, 16, 16), generator=_util.generator(1))
    y = physics(x, generator=_util.generator(2))
    physics, x, y = physics.to(dev), x.to(dev), y.to(dev)
    kernel = PreconditionedULAIterator({"step_size": 0.05, "alpha": lam, "sigma2": sigma ** 2,
                                        "eps": 1.0})
    sampler = BaseSampling(kernel, data_fidelity=L2(), prior=Tikhonov(),
                           max_iter=_util.scale(12000, 3000, fast), burnin_ratio=0.25,
                           thinning=2)
    with torch.no_grad():
        mean, var = sampler.sample(y, physics, generator=torch.Generator(dev).manual_seed(3))
    # the analytic Gaussian posterior: precision m / sigma^2 + lam per pixel
    # (m the mask), mean y m / sigma^2 / precision
    m = physics.A_adjoint(physics.A(torch.ones_like(mean)))
    prec = m / sigma ** 2 + lam
    mean_true = physics.A_adjoint(y) / sigma ** 2 / prec
    var_true = 1.0 / prec
    out = {"mean_error": float((mean - mean_true).abs().max()),
           "var_rel_error": float(((var - var_true).abs() / var_true).max())}
    print(f"posterior mean max err: {out['mean_error']:.4f}")
    print(f"posterior var  max rel err: {out['var_rel_error']:.3f}")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)
