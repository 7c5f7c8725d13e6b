"""The port's ``BlurFFT`` on the benchmark's PSF."""


def build(tensors, traffic, shape, device):
    from deepinv_tpu_torch.physics import BlurFFT, GaussianNoise

    return BlurFFT(shape, filter=tensors["psf"],
                   noise_model=GaussianNoise(sigma=traffic["noise_sigma"], device=device),
                   device=device)
