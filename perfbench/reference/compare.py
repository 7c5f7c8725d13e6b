"""The numbers that decide ``correct``: gaps between what the program
produced and what the reference computes from the same inputs."""

import torch


def xhat_rel_l2(got, want):
    """The largest relative L2 gap ``||got_i - want_i|| / ||want_i||`` over
    the images ``i`` (non-finite output reads infinity)."""
    g, w = got.float().flatten(1), want.float().flatten(1)
    if not bool(torch.isfinite(g).all()):
        return float("inf")
    return float(((g - w).norm(dim=1) / w.norm(dim=1)).max())
