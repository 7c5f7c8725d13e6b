"""Convolution arithmetic (the counts ``chip_smoke.py`` uses for K1's and
K5's bounds, extended to whole networks).

A conv is ``(name, flops, weight elements)`` for one image: a multiply and
an add per weight per output pixel. A strided 2x2 conv of ``cin -> cout``
from ``H x W`` makes ``H/2 x W/2`` outputs; a 2x2 transposed conv of ``cin
-> cout`` from ``H x W`` does the same work on its ``H x W`` inputs.
"""

import json
from pathlib import Path


def conv(name, h_out, w_out, cin, cout, k):
    return (name, 2 * h_out * w_out * cin * cout * k * k, cin * cout * k * k)


def forward_flops(convs):
    return sum(c[1] for c in convs)


def weight_count(convs):
    return sum(c[2] for c in convs)


def bound_s(flops, nbytes, peak):
    """The least time the card could take: the larger of the operations over
    the bf16 peak and the bytes (each input read once, each output written
    once) over the memory bandwidth."""
    return max(flops / peak["bf16_flops_per_s"], nbytes / peak["bytes_per_s"])


def peak(device_name):
    """The published peaks of the card named ``device_name``, or None."""
    table = json.loads((Path(__file__).with_name("peaks.json")).read_text())
    return table.get(device_name)
