"""PET (port of examples/demo_pet.py): a 2-D attenuated Radon transform
(32x32 Shepp-Logan, 45 angles, water-like attenuation) under Poisson
counting noise of gain 1e-2, reconstructed by the scaled backprojection and
by 25 MLEM iterations; then a 3-ring scanner's michelogram of oblique
sinogram planes (12 angles, ring differences 0 and +-1) with an adjointness
test of the 3-D projector.
"""

import torch

from ..datasets import shepp_logan
from ..loss import PSNR
from ..optim import PoissonLikelihood, ZeroPrior, optim_builder
from ..physics import PET, PoissonNoise
from . import _util


def main(device=None, fast=False):
    dev = _util.device(device)
    W = 32
    x = torch.from_numpy(shepp_logan(W))[None, None].clamp_min(0)
    # the attenuation map: water-like inside the phantom's support
    mu = 0.01 * (x > 0).float()
    gain = 1e-2  # the counts' scale: a lower gain is noisier data
    physics = PET(img_width=W, angles=45, attenuation=mu, normalize=True,
                  noise_model=PoissonNoise(gain=gain, device="cpu"), device="cpu")
    y = physics(x, generator=_util.generator(0))
    physics, x, y = physics.to(dev), x.to(dev), y.to(dev)
    print(f"2D PET sinogram: {tuple(y.shape)}, mean counts {float(y.mean()) / gain:.1f}")
    psnr = PSNR()
    with torch.no_grad():
        # MLEM: multiplicative updates that keep the iterate positive and
        # maximise the Poisson likelihood
        model = optim_builder("MLEM", data_fidelity=PoissonLikelihood(gain=gain),
                              prior=ZeroPrior(), max_iter=_util.scale(25, 10, fast),
                              params_algo={"stepsize": 1.0}, device=dev)
        xhat = model(y, physics)
        x_bp = physics.A_adjoint(y)
        x_bp = x_bp * (x.mean() / (x_bp.mean() + 1e-9))
    out = {"psnr_backprojection": float(psnr(x_bp, x)[0]), "psnr_mlem": float(psnr(xhat, x)[0])}
    print(f"backprojection PSNR: {out['psnr_backprojection']:.2f} dB")
    print(f"MLEM PSNR          : {out['psnr_mlem']:.2f} dB")
    # 3-D PET: a multi-ring scanner's michelogram of oblique sinogram planes
    D = 3
    x3 = x[:, :, None].expand(1, 1, D, W, W)
    p3 = PET(img_size=(D, W, W), angles=12, ring_differences=(0, -1, 1), device=dev)
    with torch.no_grad():
        y3 = p3.A(x3)
        u = torch.randn(x3.shape, generator=_util.generator(1)).to(dev)
        v = torch.randn(y3.shape, generator=_util.generator(2)).to(dev)
        lhs = float(torch.vdot(p3.A(u).flatten(), v.flatten()))
        rhs = float(torch.vdot(u.flatten(), p3.A_adjoint(v).flatten()))
    out["adjointness_3d"] = abs(lhs - rhs) / abs(lhs)
    print(f"3D PET michelogram: {tuple(y3.shape)} (segments x rings x radial bins x angles)")
    print(f"adjointness <Au,v> vs <u,A'v>: {lhs:.4f} vs {rhs:.4f}")
    return out


if __name__ == "__main__":
    _util.cli(main, __doc__)
