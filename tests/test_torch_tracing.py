"""The library's spans and counter registry (``utils/profiling.py``) on the
CPU: spans cost a flag read outside ``recording()``, under a profiler too;
inside it a reconstruction gives ``dinv.recon`` > ``dinv.iteration`` (one a
loop body, a backtracking retry its own) > the data fidelity's and the
prior's spans > the kernel ops' spans, each carrying its reconstruction's
number; a profiler's timeline and ``trace()``'s Chrome file carry them; the
kernel ops' spans carry the analytic cost ``compiled_cost`` adds up, K5's
and K6's the JAX package's record sites' numbers; the registry holds the
device loops' counts.
"""

import json
import sys
import threading
from collections import defaultdict

import jax.numpy as jnp
import pytest
import torch

import deepinv_tpu.ops.pallas.conv_chain as jax_cc
from deepinv_tpu.utils import compiled_cost as jax_compiled_cost
from deepinv_tpu_torch.core import device_while
from deepinv_tpu_torch.models import DnCNN, autocast
from deepinv_tpu_torch.ops import gaussian_blur
from deepinv_tpu_torch.ops.kernels.conv_chain import (conv_chain, conv_chain_cost,
                                                      conv_chain_stash, stash_backward)
from deepinv_tpu_torch.ops.kernels.tv import chambolle_prox, chambolle_prox_cost
from deepinv_tpu_torch.optim import L2, PnP, PoissonLikelihood, Tikhonov, optim_builder
from deepinv_tpu_torch.optim.prior import Prior
from deepinv_tpu_torch.physics import MRI, BlurFFT, Inpainting
from deepinv_tpu_torch.utils import profiling
from deepinv_tpu_torch.utils.profiling import (DATA_FIDELITY, ITERATION, PRIOR, RECON, Counters,
                                               compiled_cost, counters, recording, span)

DEV = "cpu"
MAX_ITER = 3


def _problem(solver):
    """A small PnP problem with DnCNN's chain (K5's plain path) as the
    prior: HQS deblurring of one grey 16² image, or PGD on 2-channel 16²
    MRI."""
    g = torch.Generator().manual_seed(0)
    if solver == "HQS":
        physics = BlurFFT((1, 16, 16), filter=gaussian_blur(sigma=1.5), device=DEV)
        x, C, params = torch.rand((1, 1, 16, 16), generator=g), 1, {"stepsize": 2.0,
                                                                     "g_param": 0.02}
    else:
        physics = MRI(mask=(torch.rand((16, 16), generator=g) < 0.5).float(), img_size=(16, 16),
                      device=DEV)
        x, C, params = torch.rand((1, 2, 16, 16), generator=g), 2, {"stepsize": 1.0,
                                                                     "g_param": 0.05}
    net = DnCNN(C, C, depth=4, device=DEV)
    model = optim_builder(solver, L2(), PnP(autocast(net)), params_algo=params,
                          max_iter=MAX_ITER, device=DEV)
    return model, physics.A(x), physics


def _inpainting(**kwargs):
    """PGD or GD with Tikhonov on a 16² inpainting problem."""
    g = torch.Generator().manual_seed(1)
    physics = Inpainting((1, 16, 16), mask=(torch.rand((1, 16, 16), generator=g) < 0.7).float(),
                         device=DEV)
    y = physics.A(torch.rand((1, 1, 16, 16), generator=g))
    return optim_builder(prior=Tikhonov(), data_fidelity=L2(), device=DEV, **kwargs), y, physics


def _inside(inner, outer):
    return outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_off_opens_no_span_and_keeps_nothing(monkeypatch):
    """With no recording and no profiler a recon constructs no span, enters
    no ``record_function`` and keeps no record; inside ``recording()`` the
    same recon's sites do construct spans (so the sites are reached)."""
    made, entered = [], []

    class Counted(profiling._Span):
        __slots__ = ()

        def __init__(self, name, attrs):
            made.append(name)
            super().__init__(name, attrs)

    monkeypatch.setattr(profiling, "_Span", Counted)
    monkeypatch.setattr(profiling._autograd_profiler, "record_function",
                        lambda *a, **k: entered.append(a))
    model, y, physics = _problem("HQS")
    with torch.no_grad():
        model(y, physics)
    assert made == [] and entered == [] and profiling._sinks == []
    assert span(RECON, max_iter=1) is span(ITERATION, k=0)
    with torch.no_grad(), recording() as records:
        model(y, physics)
    assert entered == [] and len(made) == len(records) > 0


def test_a_profiler_alone_opens_no_span():
    """A ``torch.profiler`` session outside ``recording()`` sees none of the
    library's spans: a profile taken by someone else holds the same events
    with this library as without its spans."""
    model, y, physics = _problem("PGD")
    with torch.no_grad(), torch.profiler.profile() as prof:
        model(y, physics)
    assert not [e.key for e in prof.key_averages() if e.key.startswith("dinv.")]
    assert profiling._stack() == []


@pytest.mark.parametrize("solver,fidelity_op", [("HQS", "prox"), ("PGD", "grad")])
def test_recon_spans_nest(solver, fidelity_op):
    """Two recons: one ``dinv.recon`` each, with a number of its own that
    every span inside it carries; ``MAX_ITER`` iterations inside it, each
    holding one data-fidelity span and one prior span, the prior holding
    K5's span; parents as nested, intervals inside their parent's."""
    model, y, physics = _problem(solver)
    with torch.no_grad(), recording() as records:
        model(y, physics)
        model(y, physics)
    recons = [r for r in records if r.name == RECON]
    assert len(recons) == 2 and recons[0].recon != recons[1].recon
    assert {r.recon for r in records} == {r.recon for r in recons}
    for rc in recons:
        assert rc.parent is None and rc.attrs == {"solver": solver, "max_iter": MAX_ITER}
        mine = [r for r in records if r.recon == rc.recon and r is not rc]
        its = [r for r in mine if r.name == ITERATION]
        assert [r.attrs for r in its] == [{"k": k} for k in range(MAX_ITER)]
        assert all(r.parent == RECON and _inside(r, rc) for r in its)
        for it in its:
            kids = sorted((r for r in mine if r.parent == ITERATION and _inside(r, it)),
                          key=lambda r: r.start_ns)
            assert [r.name for r in kids] == [DATA_FIDELITY, PRIOR]
            assert [r.attrs["op"] for r in kids] == [fidelity_op, "prox"]
            chain = [r for r in mine if r.name == "dinv.kernel.conv_chain" and _inside(r, kids[1])]
            assert len(chain) == 1 and chain[0].parent == PRIOR
        assert len(mine) == 4 * MAX_ITER


def test_early_stop_gives_a_span_a_loop_body():
    """Under early stop every body the device loop evaluates, frozen ones
    included, has its iteration span, numbered from 0."""
    model, y, physics = _inpainting(iteration="PGD", params_algo={"stepsize": 0.9,
                                                                  "lambda": 0.3},
                                    max_iter=200, early_stop=True, thres_conv=1e-4)
    model.fixed_point.check_every = 4
    before = counters["loop.bodies"]
    with torch.no_grad(), recording() as records:
        model(y, physics)
    bodies = counters["loop.bodies"] - before
    its = [r.attrs["k"] for r in records if r.name == ITERATION]
    stop = int(model.fixed_point.last_run["iterations"])
    assert its == list(range(bodies)) and stop <= bodies < stop + 4 < 200


def test_backtracking_retry_is_a_span_of_its_own():
    """A stepsize at which the plain run diverges: each retry is a second
    span of its iteration's ``k`` with ``retry=1``."""
    model, y, physics = _inpainting(iteration="GD", params_algo={"stepsize": 2.5,
                                                                 "lambda": 0.3},
                                    max_iter=20, backtracking=True)
    with torch.no_grad(), recording() as records:
        model(y, physics)
    its = [r.attrs for r in records if r.name == ITERATION]
    retries = [a for a in its if a.get("retry") == 1]
    assert len(retries) == model.fixed_point.last_run["retries"] >= 1
    assert len(its) == 20 + len(retries)
    assert [a["k"] for a in its if "retry" not in a] == list(range(20))


def test_anderson_gives_a_span_an_iteration():
    model, y, physics = _inpainting(iteration="PGD", params_algo={"stepsize": 0.9,
                                                                  "lambda": 0.3},
                                    max_iter=5, anderson_acceleration=True)
    with torch.no_grad(), recording() as records:
        model(y, physics)
    assert [r.attrs["k"] for r in records if r.name == ITERATION] == list(range(5))


def test_a_layer_spans_its_outermost_call_only():
    """The data fidelity's prox by inner gradient steps calls its gradient:
    one span, the prox's. A prior a user subclasses is spanned too."""

    class Shrink(Prior):
        def prox(self, x, *args, gamma=1.0, **kwargs):
            return x / (1 + gamma)

    x = torch.rand((1, 1, 8, 8)) + 0.5
    physics = Inpainting((1, 8, 8), mask=torch.ones((1, 8, 8)), device=DEV)
    with recording() as records:
        PoissonLikelihood().prox(x, physics.A(x), physics, max_iter_inter=5)
        Shrink().prox(x, gamma=0.5)
    assert [(r.name, r.attrs) for r in records] == [(DATA_FIDELITY, {"op": "prox"}),
                                                     (PRIOR, {"op": "prox"})]


def test_profiler_timeline_and_trace_file_carry_the_spans(tmp_path):
    """Under ``trace()`` (a ``torch.profiler`` session inside ``recording()``)
    the spans open ``record_function``: its Chrome file holds every layer's
    name."""
    model, y, physics = _problem("PGD")
    with torch.no_grad(), profiling.trace(str(tmp_path)):
        model(y, physics)
    names = {e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())[
        "traceEvents"]}
    assert {RECON, ITERATION, DATA_FIDELITY, PRIOR, "dinv.kernel.conv_chain"} <= names


def test_threads_keep_their_own_nesting():
    """16 threads opening nested spans at once, with a short switch
    interval: every recon's three spans carry its number and their
    parents, and no number repeats."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for k in range(50):
                with span(RECON), span(ITERATION, k=k), span(PRIOR):
                    pass

        with recording() as records:
            threads = [threading.Thread(target=work) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    by_recon = defaultdict(list)
    for r in records:
        by_recon[r.recon].append((r.name, r.parent))
    assert len(by_recon) == 16 * 50
    assert all(v == [(PRIOR, ITERATION), (ITERATION, RECON), (RECON, None)]
               for v in by_recon.values())


def test_registry_counts_the_device_loops():
    """``device_while`` counts its loop, its host reads and its bodies in
    the registry: a loop that stops after 5 bodies, its flag read every 2."""
    c = Counters()
    assert c["never"] == 0 and "never" not in c
    c["a"] += 2
    c["b"] += 1
    snap = c.snapshot()
    c.reset("a")
    assert snap == {"a": 2, "b": 1} and c.snapshot() == {"b": 1}
    before = counters.snapshot()
    state, n = device_while(lambda s: s < 5, lambda s: s + 1, torch.zeros(()), 20, 2)
    moved = {k: counters[k] - before.get(k, 0) for k in ("loop.loops", "loop.host_reads",
                                                          "loop.bodies")}
    assert int(n) == 5 and float(state) == 5
    assert moved == {"loop.loops": 1, "loop.host_reads": 3, "loop.bodies": 6}


def _chain_inputs(B, L=2, H=16, W=16):
    g = torch.Generator().manual_seed(B)
    h = torch.randn((B, 64, H, W), generator=g).to(torch.bfloat16)
    ws = torch.randn((L, 64, 64, 3, 3), generator=g) * 0.05
    bs = torch.randn((L, 64), generator=g) * 0.01
    return h, ws, bs


@pytest.mark.parametrize("op", ["conv_chain", "conv_chain_stash"])
def test_k5_k6_costs_match_jax(op):
    """K5's and K6's recorded cost of one image equals what the JAX
    package's record sites give its ``compiled_cost`` (conv_chain.py:299-301,
    344-346), on its interpret-mode Pallas forward."""
    h, ws, bs = _chain_inputs(1)
    port = conv_chain if op == "conv_chain" else conv_chain_stash
    got = compiled_cost(lambda v: port(v, ws, bs), h)
    impl = jax_cc._fused_fwd_impl if op == "conv_chain" else jax_cc._fused_fwd_stash_impl
    jws, jbs = jnp.asarray(ws.numpy()), jnp.asarray(bs.numpy())
    want = jax_compiled_cost(lambda v: impl(v, jws, jbs, True),
                             jnp.asarray(h.float().numpy(), jnp.bfloat16))
    assert got["pallas_flops"] == want["pallas_flops"] > 0
    assert got["pallas_bytes"] == want["pallas_bytes"] > 0


def _cost(op, B):
    h, ws, bs = _chain_inputs(B)
    if op == "conv_chain":
        return compiled_cost(lambda: conv_chain(h, ws, bs))
    if op == "conv_chain_stash":
        return compiled_cost(lambda: conv_chain_stash(h, ws, bs))
    if op == "stash_backward":
        acts = conv_chain_stash(h, ws, bs)
        return compiled_cost(lambda: stash_backward(h, ws, acts, h.float()))
    return compiled_cost(lambda: chambolle_prox(torch.rand((B, 3, 12, 10)), 0.1, 5))


@pytest.mark.parametrize("op", ["conv_chain", "conv_chain_stash", "chambolle_prox"])
def test_batch_of_two_costs_twice_one(op):
    one, two = _cost(op, 1), _cost(op, 2)
    assert two["pallas_flops"] == 2 * one["pallas_flops"] > 0
    assert two["pallas_bytes"] == 2 * one["pallas_bytes"] > 0


def test_stash_backward_cost():
    """The stash backward's L dX and L dW convs, twice as many at B=2; its
    bytes grow by one image's activations (input, cotangent, L stash slots,
    dh in bf16), the weights, dW and db counted once."""
    one, two = _cost("stash_backward", 1), _cost("stash_backward", 2)
    conv = 2 * 16 * 16 * 64 * 64 * 9   # one 3x3 conv of one image
    assert two["pallas_flops"] == 2 * one["pallas_flops"] == 2 * 2 * 2 * conv
    assert two["pallas_bytes"] - one["pallas_bytes"] == 2 * 16 * 16 * 64 * (3 + 2)


def test_k7_cost_is_its_analytic_count():
    """K7 at 1x3x256², 100 steps: 18 operations a pixel a step and 5 for the
    output, 0.355 GFLOP; the images in and out in f32 and a gamma a plane."""
    got = compiled_cost(lambda v: chambolle_prox(v, 0.1, 100), torch.rand((1, 3, 256, 256)))
    assert got["pallas_flops"] == 3 * 256 * 256 * (18 * 100 + 5) == 354_877_440
    assert got["pallas_bytes"] == 2 * 3 * 256 * 256 * 4 + 3 * 4
    assert chambolle_prox_cost((1, 3, 256, 256), 100) == (got["pallas_flops"],
                                                          got["pallas_bytes"])


def test_a_call_site_without_a_span_reports_its_cost():
    """``record_pallas_cost`` (the JAX package's name) adds a cost to the open
    ``compiled_cost`` tally, and nothing outside one."""
    profiling.record_pallas_cost(1e9, 1e6)
    got = compiled_cost(lambda: profiling.record_pallas_cost(3.0, 2.0))
    assert (got["pallas_flops"], got["pallas_bytes"], got["flops"]) == (3.0, 2.0, 3.0)


def test_dncnn_cost_includes_k5():
    """``compiled_cost`` of a bf16 DnCNN call counts its hidden chain (K5,
    depth - 2 layers) beside the aten convs of its first and last layer (and,
    on the CPU, of the chain's plain version)."""
    net = autocast(DnCNN(1, 1, depth=6, device=DEV))
    x = torch.rand((2, 1, 16, 16))
    got = compiled_cost(lambda v: net(v, 0.05), x)
    k5 = conv_chain_cost(2, 16, 16, 4)
    assert (got["pallas_flops"], got["pallas_bytes"]) == k5
    assert got["flops"] - k5[0] >= 2 * 2 * 16 * 16 * 9 * 64 * 2
