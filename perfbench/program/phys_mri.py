"""The port's single-coil ``MRI`` on the benchmark's mask."""


def build(tensors, traffic, shape, device):
    from deepinv_tpu_torch.physics import MRI, GaussianNoise

    return MRI(mask=tensors["mask"][0, 0], img_size=tuple(shape[-2:]),
               noise_model=GaussianNoise(sigma=traffic["noise_sigma"], device=device),
               device=device)
