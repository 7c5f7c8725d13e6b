"""Phase retrieval (port of examples/demo_phase_retrieval.py): a complex
24x24 signal seen through 4 n² random intensity measurements, the spectral
initialization (400 power steps), then 1200 gradient steps of 1e-3 on the
amplitude loss by autograd. The refinement raises the cosine similarity
above the spectral start and above 0.9.
"""

import torch

from ..optim import AmplitudeLoss
from ..physics import RandomPhaseRetrieval
from ..physics.phase_retrieval import correct_global_phase, cosine_similarity, spectral_methods
from . import _util


def main(device=None, fast=False, n=24):
    dev = _util.device(device)
    physics = RandomPhaseRetrieval(m=4 * n * n, img_size=(1, n, n), generator=_util.generator(0),
                                   device="cpu").to(dev)
    x = torch.randn((1, 1, n, n), dtype=torch.complex64, generator=_util.generator(1)).to(dev)
    y = physics.A(x)
    # the spectral initialization (optim/phase_retrieval.py upstream)
    x0 = spectral_methods(y, physics, n_iter=400)
    c0 = float(cosine_similarity(x0, x).abs())
    # gradient refinement on the amplitude loss; autograd's gradient of a
    # real loss in a complex variable is already the ascent direction
    loss = AmplitudeLoss()
    u = x0.detach().requires_grad_(True)
    for _ in range(_util.scale(1200, 600, fast)):
        (g,) = torch.autograd.grad(loss.fn(u, y, physics).sum(), u)
        u = (u - 1e-3 * g).detach().requires_grad_(True)
    xr = u.detach()
    c1 = float(cosine_similarity(xr, x).abs())
    err = float((correct_global_phase(xr, x) - x).norm() / x.norm())
    print(f"cosine similarity: spectral {c0:.3f} -> refined {c1:.3f}")
    print(f"relative error after phase alignment: {err:.3f}")
    return {"cosine_spectral": c0, "cosine_refined": c1, "rel_error": err}


if __name__ == "__main__":
    _util.cli(main, __doc__)
