"""DRUNet's convs for one ``channels x H x W`` image."""

from .convs import conv


def convs(cfg, channels, H, W):
    nc, nb = cfg["nc"], cfg["nb"]
    out = [conv("m_head", H, W, channels + 1, nc[0], 3)]
    for s in range(3):
        h, w = H >> s, W >> s
        out += [conv(f"down{s}.res", h, w, nc[s], nc[s], 3)] * (2 * nb)
        out.append(conv(f"down{s}.proj", h // 2, w // 2, nc[s], nc[s + 1], 2))
    out += [conv("body.res", H >> 3, W >> 3, nc[3], nc[3], 3)] * (2 * nb)
    for s in (3, 2, 1):
        h, w = H >> s, W >> s
        out.append(conv(f"up{s}.proj", h, w, nc[s], nc[s - 1], 2))
        out += [conv(f"up{s}.res", 2 * h, 2 * w, nc[s - 1], nc[s - 1], 3)] * (2 * nb)
    out.append(conv("m_tail", H, W, nc[0], channels, 3))
    return out
