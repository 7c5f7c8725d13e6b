"""DnCNN's convs for one ``channels x H x W`` image."""

from .convs import conv


def convs(cfg, channels, H, W):
    nf = cfg["nf"]
    return ([conv("in_conv", H, W, channels, nf, 3)]
            + [conv("hidden", H, W, nf, nf, 3)] * (cfg["depth"] - 2)
            + [conv("out_conv", H, W, nf, channels, 3)])
