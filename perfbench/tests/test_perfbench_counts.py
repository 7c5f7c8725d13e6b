"""The frozen counts against hand counts and the published models."""

import json
import math

import pytest

from perfbench import harness
from perfbench.counts import convs, net_dncnn, net_drunet
from perfbench.reference import net_dncnn as ref_dncnn
from perfbench.reference import net_drunet as ref_drunet

DRUNET = json.loads((harness.HERE / "configs/drunet.json").read_text())
DNCNN = json.loads((harness.HERE / "configs/dncnn.json").read_text())


def test_drunet_277_gflop_an_image_call_at_256():
    c = net_drunet.convs(DRUNET, 3, 256, 256)
    # a 3x3 conv of 64 -> 64 channels at 256x256: 2 * 256^2 * 64^2 * 9
    per = 2 * 256 ** 2 * 64 ** 2 * 9
    assert c[1][1] == per
    # 16 such convs at each of scales 0, 1, 2 (the work per conv is the same
    # at every scale), 8 in the body, the projections and the head and tail
    res = (3 * 16 + 8) * per
    proj = 6 * 2 * 128 ** 2 * 64 * 128 * 4
    head_tail = 2 * 256 ** 2 * 9 * (4 * 64 + 64 * 3)
    assert convs.forward_flops(c) == res + proj + head_tail
    assert convs.forward_flops(c) / 1e9 == pytest.approx(277.6, abs=0.1)
    # K1's chain: the 8 convs of scale 0's down ResBlocks, 38.7 GFLOP
    assert sum(f for n, f, _ in c if n == "down0.res") / 1e9 == pytest.approx(38.65, abs=0.01)


def test_drunet_weights_are_the_published_32_6_million():
    n = sum(math.prod(s) for _, s, _ in ref_drunet.param_specs(DRUNET, 3))
    assert n == DRUNET["parameters"] == convs.weight_count(net_drunet.convs(DRUNET, 3, 64, 64))
    assert n / 1e6 == pytest.approx(32.6, abs=0.05)


def test_dncnn_87_gflop_an_image_call_at_256():
    c = net_dncnn.convs(DNCNN, 1, 256, 256)
    hidden = sum(f for n, f, _ in c if n == "hidden")
    assert hidden == 18 * 2 * 256 ** 2 * 64 ** 2 * 9
    assert hidden / 1e9 == pytest.approx(87.0, abs=0.05)
    assert convs.forward_flops(c) == hidden + 2 * (2 * 256 ** 2 * 64 * 9)
    n = sum(math.prod(s) for k, s, _ in ref_dncnn.param_specs(DNCNN, 1) if k.endswith("weight"))
    assert n == convs.weight_count(c)


def test_dncnn_136_gflop_at_320_on_two_channels():
    assert convs.forward_flops(net_dncnn.convs(DNCNN, 2, 320, 320)) / 1e9 == pytest.approx(
        136.37, abs=0.01)


def test_bound_is_the_larger_of_operations_and_bytes():
    peak = convs.peak("NVIDIA H100 80GB HBM3")
    assert peak["bf16_flops_per_s"] == 989e12 and peak["bytes_per_s"] == 3.35e12
    assert convs.bound_s(989e12, 0, peak) == 1.0
    assert convs.bound_s(0, 3.35e12, peak) == 1.0
    assert convs.peak("some other card") is None
