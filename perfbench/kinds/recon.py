"""Reconstruction traffic: batches of ``batch`` images, ``pool`` of them
made at set-up and cycled, each reconstructed by the traffic's PnP solver
over its physics, one caller in a closed loop.

The benchmark makes the images, the physics' tensors, the noise and the
measurements ``y`` (by the reference's own operator) and the network's
weights from the seed, on the device, and hands the same to the program and
to the plain reference. The program's model is built from them through its
public entry points; the reference recomputes the answers the window
produced from the same inputs, in float32 with TF32 off.
"""

import gc

import torch

from perfbench import harness
from perfbench.reference import compare, images, precision, weights


class Cell:
    def __init__(self, cfg, traffic, seed, device, traced=False):
        self.cfg, self.t, self.seed, self.device, self.traced = cfg, traffic, seed, device, traced
        im = traffic["image"]
        self.shape = (im["channels"], im["height"], im["width"])
        self.ref_net = harness.load_module(f"reference/net_{cfg['family']}.py")
        self.ref_phys = harness.load_module(f"reference/phys_{traffic['physics']}.py")
        self.ref_solver = harness.load_module(f"reference/solver_{traffic['solver'].lower()}.py")

    def setup(self):
        t, dev, (C, H, W) = self.t, self.device, self.shape
        B, P = t["batch"], t["pool"]
        g = harness.generator(self.seed, dev)
        self.phys_tensors = self.ref_phys.make(t["physics_args"], self.shape, g, dev)
        self.op = self.ref_phys.Op(self.phys_tensors, self.shape)
        x = images.smooth_fields(P * B, C, H, W, g, dev, t["image"]["f0"])
        noise = torch.randn(x.shape, generator=g, device=dev) * t["noise_sigma"]
        self.y = [self.op.measure(x[i * B:(i + 1) * B], noise[i * B:(i + 1) * B])
                  for i in range(P)]
        self.weights = weights.draw(self.ref_net.param_specs(self.cfg, C), g, dev)
        harness.stamp(self, "inputs and weights")
        net = harness.load_module(f"program/net_{self.cfg['family']}.py").build(
            self.cfg, C, self.weights, dev)
        if self.traced:
            from perfbench.trace import Span

            net = Span(net)
        self.physics = harness.load_module(f"program/phys_{t['physics']}.py").build(
            self.phys_tensors, t, self.shape, dev)
        self.recon = harness.load_module("program/recon.py")
        self.model = self.recon.build(t["solver"], net, t, dev)
        harness.stamp(self, "the program's model")
        self.call(0)   # warm-up: the one shape of this traffic
        harness.sync(dev)
        harness.stamp(self, "warm-up")

    def call(self, k):
        return self.recon.call(self.model, self.y[k % self.t["pool"]], self.physics)

    def free(self):
        """Drop the program's state, so that the reference runs on its own."""
        self.model = self.physics = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, pool_index, quant="f32"):
        q = precision.QUANTIZERS[quant]
        with torch.no_grad():
            return self.ref_solver.run(
                self.y[pool_index], self.op,
                lambda v, s: self.ref_net.forward(self.weights, v, s, self.cfg, q),
                self.t["params_algo"], self.t["max_iter"])

    def check(self, kept, against=None):
        """The numbers of ``kept`` (``[(call index, x_hat)]``): the largest
        relative L2 gap of an image to the reference's. ``against(pool
        index)`` replaces the program's answers (the control: the reference
        in a lower precision put in the program's place)."""
        self.free()
        P, refs, worst = self.t["pool"], {}, 0.0
        with precision.exact_f32():
            for k, xhat in kept:
                i = k % P
                if i not in refs:
                    refs[i] = self.reference(i)
                got = xhat if against is None else against(i)
                worst = max(worst, compare.xhat_rel_l2(got, refs[i]))
        return {"xhat_rel_l2": worst}

    def counts(self):
        """The analytic counts the metrics read."""
        C, H, W = self.shape
        B, cfg = self.t["batch"], self.cfg
        conv = harness.load_module("counts/convs.py")
        convs = harness.load_module(f"counts/net_{cfg['family']}.py").convs(cfg, C, H, W)
        itemsize = 2 if cfg["dtype"] == "bfloat16" else 4
        return {"images_per_call": B,
                "denoiser_calls_per_call": self.t["max_iter"],
                "iterations_per_call": self.t["max_iter"],
                "denoiser_flops": B * conv.forward_flops(convs),
                "denoiser_bytes": itemsize * (conv.weight_count(convs) + 2 * B * C * H * W),
                "peak": conv.peak(torch.cuda.get_device_name(0))
                if torch.device(self.device).type == "cuda" else None}
