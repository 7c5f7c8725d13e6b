"""The trace's reduction on events made by hand, and the metrics that read
it."""

from types import SimpleNamespace

import pytest

from perfbench import harness, trace

MS = 1_000_000  # ns


def ev(name, dev, act, a, b, corr=0):
    return (name, dev, act, a * MS, b * MS, corr)


EVENTS = [
    # host: one call span holding one denoiser span; three launches
    ev("pb.call", False, "user_annotation", 0, 10),
    ev("pb.denoiser", False, "user_annotation", 1, 4),
    ev("cudaLaunchKernel", False, "cuda_runtime", 1, 1.1, 11),
    ev("cudaLaunchKernel", False, "cuda_runtime", 2, 2.1, 12),
    ev("cudaLaunchKernel", False, "cuda_runtime", 5, 5.1, 13),
    ev("aten::item", False, "cpu_op", 6, 9),
    # device: two overlapping kernels of the denoiser (PDL), one of the data step
    ev("conv_tile", True, "kernel", 2, 4, 11),
    ev("conv_tile", True, "kernel", 3.5, 5, 12),
    ev("fft", True, "kernel", 8, 9, 13),
    ev("spin_kernel", True, "kernel", 0, 0.5, 99),
    ev("pb.denoiser", True, "gpu_user_annotation", 2, 5),
]


def test_union_counts_overlap_once():
    assert trace.union_s([(0, 2 * MS), (1 * MS, 3 * MS), (5 * MS, 6 * MS)]) == 0.004


def test_reduce_attributes_by_launch():
    r = trace.reduce(EVENTS)
    assert r.kernels == 3
    assert r.busy_s == pytest.approx(0.004)
    assert r.span_busy_s["pb.denoiser"] == [pytest.approx(0.003)]
    assert r.span_busy_s["pb.call"] == [pytest.approx(0.004)]
    assert r.breakdown["device_ops"][0] == ["conv_tile", pytest.approx(0.0035)]
    gap = r.breakdown["idle_gaps"][0]
    assert gap[0] == "pb.call > aten::item" and gap[1] == pytest.approx(0.003)


def test_reduce_refuses_an_operation_without_its_launch():
    with pytest.raises(RuntimeError, match="1 of 3 device operations have no launch"):
        trace.reduce([e for e in EVENTS if not (e[5] == 13 and not e[1])])


def ctx(**kw):
    base = dict(kind="recon", calls=1, window_s=0.01, untraced_calls=1, untraced_s=0.005,
                setup_s=1.0, latencies_ms=[5.0] * 20,
                percentile=harness.percentile, images_per_call=8, denoiser_calls_per_call=1,
                iterations_per_call=1, denoiser_flops=989e12 * 0.0015, denoiser_bytes=0,
                peak={"bf16_flops_per_s": 989e12, "bytes_per_s": 3.35e12},
                trace=trace.reduce(EVENTS))
    return SimpleNamespace(**{**base, **kw})


@pytest.mark.parametrize("name,want", [
    ("device_idle.recon", 20.0), ("mfu.recon", 30.0), ("denoiser_roofline", 50.0),
    ("data_step_ms", 1.0), ("kernels_per_recon", 3.0), ("recon_images_per_s", 800.0),
    ("recon_ms_p95", 5.0), ("setup_s", 1.0)])
def test_recon_metrics(name, want):
    assert harness.load_module(f"metrics/{name}.py").read(ctx()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["device_idle.recon", "mfu.recon", "kernels_per_recon",
                                  "recon_images_per_s"])
def test_recon_metrics_read_nothing_in_another_kind(name):
    assert harness.load_module(f"metrics/{name}.py").read(ctx(kind="train")) is None


def test_a_share_of_a_peak_reads_nothing_without_a_peak():
    for name in ("mfu.recon", "denoiser_roofline"):
        assert harness.load_module(f"metrics/{name}.py").read(ctx(peak=None)) is None


def test_reservoir_keeps_k_and_the_last():
    r = harness.Reservoir(3, 5)
    for i in range(100):
        r.offer(i, i)
    kept = r.sample()
    assert 3 <= len(kept) <= 4 and kept[-1] == (99, 99)
    r2 = harness.Reservoir(3, 5)
    for i in range(100):
        r2.offer(i, i)
    assert r2.sample() == kept
