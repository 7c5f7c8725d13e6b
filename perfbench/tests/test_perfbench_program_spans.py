"""The program's own spans (``dinv.*``) in a profile, read beside the
benchmark's by ``program_spans.py``: on events made by hand, as the card's
profiler gives them (no activity type), and in a whole small run on the
CPU."""

import pytest

from perfbench import program_spans, trace
from perfbench.tests.test_perfbench_trace import EVENTS, ev

# the program's spans around test_perfbench_trace.EVENTS' call: a recon, one
# iteration, the prior around the benchmark's denoiser span, K1 inside it,
# the data step around the third launch; and their device-side annotations,
# with no activity type, as torch 2.11 gives every event
PROGRAM = [
    ev("dinv.recon", False, "", 0.1, 9.9),
    ev("dinv.iteration", False, "", 0.2, 9.8),
    ev("dinv.prior", False, "", 0.9, 4.1),
    ev("dinv.kernel.resblock_chain", False, "", 1.5, 2.5),
    ev("dinv.data_fidelity", False, "", 4.5, 7.0),
    ev("dinv.recon", True, "", 2, 9),
    ev("dinv.prior", True, "", 2, 5),
    ev("dinv.kernel.resblock_chain", True, "", 3.5, 5),
    ev("dinv.data_fidelity", True, "", 8, 9),
]


def test_the_accepted_reduction_takes_an_annotation_for_an_operation():
    """Why the annotations are left out: with no activity type, a ``dinv.``
    span's device-side annotation reads as an operation without a launch."""
    with pytest.raises(RuntimeError, match="have no launch"):
        trace.reduce(EVENTS + PROGRAM)


def test_split_leaves_the_readings_and_adds_the_program_spans():
    evs, renamed = program_spans.split(EVENTS + PROGRAM)
    base, got, r = trace.reduce(EVENTS), trace.reduce(evs), trace.reduce(renamed)
    for red in (got, r):
        assert red.kernels == base.kernels == 3 and red.busy_s == base.busy_s
        assert red.breakdown["device_ops"] == base.breakdown["device_ops"]
    assert got.span_busy_s == base.span_busy_s
    assert r.span_busy_s["pb.dinv.data_fidelity"] == [pytest.approx(0.001)]
    assert r.span_busy_s["pb.dinv.kernel.resblock_chain"] == [pytest.approx(0.0015)]
    assert r.span_busy_s["pb.dinv.prior"] == r.span_busy_s["pb.denoiser"]
    assert r.span_busy_s["pb.dinv.recon"] == r.span_busy_s["pb.call"]
    gap = r.breakdown["idle_gaps"][0]
    assert gap[0] == "pb.dinv.data_fidelity > pb.dinv.data_fidelity"
    assert gap[1] == pytest.approx(0.003)


@pytest.mark.parametrize("cell", ["drunet.hqs-deblur-256-b16", "dncnn.pgd-mri-320-b16"])
def test_program_spans_read_a_small_cell_on_the_cpu(cell):
    """The reading outside the result line, at a test's size: a recon and
    its 8 iterations, each with its data-fidelity, prior and kernel spans
    (33 a recon), and the recorded recons' host times."""
    from perfbench.tests.test_perfbench_faults import SMALL

    out = program_spans.read(cell, 2 ** 31 + 5, 1, "cpu", {**SMALL[cell], "trace_calls": 2})
    assert out["spans_per_recon"] == 33 and out["recons_per_group"] == 2
    assert out["host_issue_ms"] > 0 and out["kernels_per_recon"] == 0
    assert out["data_fidelity_ms"] is None and "kernel_roofline" not in out
