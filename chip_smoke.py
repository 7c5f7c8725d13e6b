#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (each one raises, and the script exits non-zero, if it fails):

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build the CUDA kernels from ``deepinv_tpu_torch/csrc`` (nvcc, sm_90a, one
   nvcc per source, all started together);
3. each kernel against its plain PyTorch version, TF32 off, at its main-path
   shapes: the DRUNet resblock chain (K1) and the DnCNN conv+bias+ReLU chain
   (K5);
4. the HQS bench problem through the port's entry points: PnP-HQS deblurring
   of a 1x3x256x256 image (BlurFFT, Gaussian blur sigma 1.5, Gaussian noise
   0.01) with a bf16 full-width DRUNet (nc=(64,128,256,512), nb=4, seeded
   random weights), 8 iterations;
5. the PGD bench problems: PnP-PGD with a bf16 full-depth, full-width DnCNN
   (depth 20, nf 64, seeded random weights, the residual layer scaled to a
   denoiser's size), 8 iterations at stepsize 1.0 and denoiser level 0.05, on
   MRI (1x2x256x256, 30% random k-space mask) and on CT (1x1x256x256,
   Fourier-slice Tomography, 90 angles, normalized), and the CT Toeplitz
   normal operator against ``A_adjoint(A(x))``.
   For each of the three reconstructions (4 and 5) the output must be finite,
   the path's kernel must have been launched once per iteration (its counter
   is set to 0 just before the run and read just after), each denoiser call
   must agree with the same call on the plain chain, and the output with the
   same reconstruction run on the plain chain on the card (PGD: and on the
   chain in f32 without rounding);
6. times, with CUDA events after warm-up, in turns: each kernel against its
   plain version and against the same chain as cuDNN bf16 layers, and each
   reconstruction's iterations per second on the kernel path and on the plain
   chain.

It prints the card line and a JSON line ``{"kernels": [...]}`` before the last
line, and ends with ``{"ok": true, "device": {...}}``. It exits non-zero with
no result when there is no CUDA device. It imports no JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

SEED = 0
R_MAIN = 4                      # DRUNet nb: blocks in the scale-0 chain
KERNEL_SHAPES = [((1, 64, 256, 256), R_MAIN), ((2, 64, 256, 256), R_MAIN),
                 ((1, 64, 40, 56), 1)]
L_MAIN = 18                     # DnCNN depth 20: hidden layers in the chain
CHAIN_SHAPES = [((1, 64, 256, 256), L_MAIN), ((2, 64, 256, 256), L_MAIN),
                ((1, 64, 40, 56), 3)]
# Kernel vs plain: the two differ only in the order of the f32 sums, so an
# output differs by at most a few bf16 ulps (2^-8 relative) after the chain
# (tests/test_models.py:616 holds the Pallas kernel to the same bound).
KERNEL_RTOL = 2e-2
# Each denoiser call of the run against the same call on the plain chain:
# the ulps pass through the rest of the bf16 net; bound on the max error
# relative to the output's range, the repo's bf16 denoiser policy
# (tests/test_models.py::test_autocast_bf16_parity). DnCNN's residual
# (output minus input) is also held, by its relative L2 error.
DENOISER_RTOL = 3e-2
# The whole reconstruction against the plain chain's, relative L2 error. With
# random weights PnP-HQS is unstable (the iterate grows ~5x per iteration in
# both packages), which amplifies the per-call differences. HQS is also held
# to the repo's bf16 quality policy of 0.1 dB PSNR.
RECON_RTOL = 5e-2
RECON_PSNR_DB = 0.1
MAX_ITER = 8
PGD_PARAMS = {"stepsize": 1.0, "g_param": 0.05}
# DnCNN predicts the noise, so a trained one's residual at g_param 0.05 is a
# few percent of its input. With He-normal out_conv weights the random net's
# residual is as large as its input: the PGD iterate then grows 1.3-3x per
# iteration, and on CT two bf16 runs that differ only in rounding (kernel,
# plain chain, unrounded chain) end 30-67% apart in relative L2. Scaled by
# 0.1, the iterate stays within the ground truth's range and the three runs
# agree within 1% (PERF.md, section 6, the DnCNN chain).
DNCNN_RESIDUAL_SCALE = 0.1
# CT: the Toeplitz A_adjoint_A against A_adjoint(A(x)), relative L2; they
# differ by the Kaiser-Bessel gridding (the JAX package: 3.5e-4 on the CPU).
CT_NORMAL_RTOL = 1e-3


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` calls, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def psnr(a, b) -> float:
    mse = float(((a - b) ** 2).mean())
    return 10.0 * math.log10(1.0 / max(mse, 1e-20))


@contextlib.contextmanager
def swapped(module, name: str, fn):
    """``module.name`` replaced by ``fn`` inside the block."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def kernel_vs_plain(label: str, run, plain, x, bound: float) -> float:
    """Max abs error of ``run(x)`` against ``plain(x)``, checked against
    ``bound`` times the plain output's max."""
    import torch

    with torch.no_grad():
        got = run(x)
        torch.cuda.synchronize()
        want = plain(x)
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    print(f"{label}: max_abs_err {err} (scale {scale}, rel {err / scale}, bound {bound})",
          flush=True)
    check(bool(torch.isfinite(got.float()).all()), f"non-finite kernel output: {label}")
    check(err <= bound * scale, f"kernel disagrees with plain: {label}")
    return err


def drive(name: str, model, y, physics, net, op, plain_chain, shape, exact_chain=None):
    """One reconstruction on the kernel path (``op.launches`` set to 0 just
    before it and read just after), checked: finite output of ``shape``, one
    launch and one denoiser call per iteration, each call of ``net`` against
    the same call on the plain chain, and the whole run against the plain
    chain's run. Returns ``(out, out_plain, launches)``.

    With ``exact_chain`` (a context that runs the chain in f32 with no
    rounding inside it; DnCNN), each call's residual is held too, and the
    whole run against the run on that unrounded chain."""
    import torch

    calls = []  # every denoiser input of the run, to replay on the plain chain
    hook = net.register_forward_pre_hook(
        lambda mod, args: calls.append((args[0].detach().clone(), args[1])))
    torch.cuda.reset_peak_memory_stats()
    op.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        out = model(y, physics)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = op.launches
    hook.remove()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{name} {MAX_ITER} it: first run {first_s:.3f} s, kernel launches {launches}, "
          f"peak memory {peak_gib:.3f} GiB", flush=True)
    check(launches == MAX_ITER, f"{name}: expected {MAX_ITER} kernel launches, got {launches}")
    check(tuple(out.shape) == shape and out.dtype == torch.float32,
          f"{name}: bad output shape/dtype")
    check(bool(torch.isfinite(out).all()), f"{name}: non-finite reconstruction")
    check(len(calls) == MAX_ITER, f"{name}: expected {MAX_ITER} denoiser calls, got {len(calls)}")
    for i, (xin, sigma) in enumerate(calls):
        with torch.no_grad():
            d_k = net(xin, sigma).float()
            with plain_chain():
                d_p = net(xin, sigma).float()
        derr, dscale = float((d_k - d_p).abs().max()), float(d_p.abs().max())
        line = (f"{name} denoiser call {i}: kernel vs plain chain max_abs_err {derr} "
                f"(scale {dscale}, rel {derr / dscale}, bound {DENOISER_RTOL})")
        ok = derr <= DENOISER_RTOL * dscale
        if exact_chain is not None:
            r_k, r_p = d_k - xin, d_p - xin
            rl2 = float((r_k - r_p).norm() / r_p.norm())
            line += f"; residual relative L2 {rl2}"
            ok = ok and rl2 <= DENOISER_RTOL
        print(line, flush=True)
        check(ok, f"{name}: denoiser call {i} disagrees with the plain chain")
    launches_after = op.launches
    with plain_chain(), torch.no_grad():
        out_plain = model(y, physics)
    torch.cuda.synchronize()
    check(op.launches == launches_after, f"{name}: the plain run launched the kernel")
    rerr = float((out - out_plain).norm() / out_plain.norm())
    print(f"{name} kernel vs plain chain: relative L2 error {rerr} (bound {RECON_RTOL}), "
          f"max_abs_err {float((out - out_plain).abs().max())}, output max "
          f"{float(out_plain.abs().max())}", flush=True)
    check(rerr <= RECON_RTOL, f"{name}: reconstruction disagrees with the plain chain")
    if exact_chain is not None:
        with exact_chain(), torch.no_grad():
            out_exact = model(y, physics)
        e_k = float((out - out_exact).norm() / out_exact.norm())
        e_p = float((out_plain - out_exact).norm() / out_exact.norm())
        print(f"{name} vs the run on the unrounded chain: relative L2 error kernel {e_k}, "
              f"plain {e_p} (bound {RECON_RTOL})", flush=True)
        check(e_k <= RECON_RTOL, f"{name}: reconstruction disagrees with the unrounded chain")
    return out, out_plain, launches


def recon_rates(name: str, recon, recon_plain, reps: int = 20):
    """Iterations/s of the kernel path and the plain chain, 4 rounds each in
    turns (a B=1 recon is host-bound and varies run to run)."""
    r_k, r_p = [], []
    for _ in range(2):
        for fn, times in ((recon, r_k), (recon_plain, r_p), (recon_plain, r_p), (recon, r_k)):
            times.append(cuda_ms(fn, reps, warmup=3))
    rec_ms, rec_plain_ms = sorted(r_k)[len(r_k) // 2], sorted(r_p)[len(r_p) // 2]
    print(f"{name}, ms per recon: kernel path {r_k}, median {MAX_ITER * 1e3 / rec_ms:.2f} it/s; "
          f"plain chain {r_p}, median {MAX_ITER * 1e3 / rec_plain_ms:.2f} it/s", flush=True)


def time_chain(label: str, run_k, run_p, run_cudnn, flop: float):
    """Kernel, plain and cuDNN bf16 times in ms (plain, kernel, kernel, plain,
    then cuDNN). Returns the kernel's and the plain version's mean."""
    import torch

    with torch.no_grad():
        t_p = [cuda_ms(run_p, 50)]
        t_k = [cuda_ms(run_k, 50), cuda_ms(run_k, 50)]
        t_p.append(cuda_ms(run_p, 50))
        t_bf16 = cuda_ms(run_cudnn, 50)
    k_ms, p_ms = sum(t_k) / 2, sum(t_p) / 2
    print(f"time {label}: kernel {t_k} ms, plain f32 {t_p} ms, cuDNN bf16 layers {t_bf16} ms; "
          f"kernel {flop / k_ms / 1e9:.1f} TFLOP/s", flush=True)
    return k_ms, p_ms


def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1

    import deepinv_tpu_torch.models.dncnn as dncnn_mod
    import deepinv_tpu_torch.models.drunet as drunet_mod
    from deepinv_tpu_torch.models import DnCNN, DRUNet, autocast
    from deepinv_tpu_torch.ops import gaussian_blur
    from deepinv_tpu_torch.ops.kernels import build
    from deepinv_tpu_torch.ops.kernels.conv_chain import (
        chain_f32, conv_chain, conv_chain_plain, pack_bias)
    from deepinv_tpu_torch.ops.kernels.resblock_chain import (
        pack_weights, resblock_chain, resblock_chain_plain)
    from deepinv_tpu_torch.optim import L2, PnP, optim_builder
    from deepinv_tpu_torch.physics import MRI, BlurFFT, GaussianNoise, Tomography

    # 1. the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    # plain side in full f32: no TF32 in cuDNN convs or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 2. build
    t0 = time.perf_counter()
    build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    # 3. each kernel vs its plain version on the card
    g = torch.Generator().manual_seed(SEED)
    std = 0.2 * (2.0 / (64 * 9)) ** 0.5      # DRUNet's ResBlock init scale
    main_err = None
    for shape, R in KERNEL_SHAPES:
        h = torch.randn(shape, generator=g).to(dev, torch.bfloat16)
        w1 = (torch.randn((R, 64, 64, 3, 3), generator=g) * std).to(dev)
        w2 = (torch.randn((R, 64, 64, 3, 3), generator=g) * std).to(dev)
        err = kernel_vs_plain(f"kernel vs plain {shape} R={R}",
                              lambda v: resblock_chain(v, w1, w2),
                              lambda v: resblock_chain_plain(v, w1, w2), h, KERNEL_RTOL)
        if main_err is None:
            main_err = err
    he_std = (2.0 / (64 * 9)) ** 0.5           # DnCNN's He-normal init scale
    chain_err = None
    for shape, L in CHAIN_SHAPES:
        h = torch.randn(shape, generator=g).to(dev, torch.bfloat16)
        ws = (torch.randn((L, 64, 64, 3, 3), generator=g) * he_std).to(dev)
        bs = (torch.randn((L, 64), generator=g) * 0.02).to(dev)
        err = kernel_vs_plain(f"conv_chain vs plain {shape} L={L}",
                              lambda v: conv_chain(v, ws, bs),
                              lambda v: conv_chain_plain(v, ws, bs), h, KERNEL_RTOL)
        if chain_err is None:
            chain_err = err

    # 4. the HQS bench problem, kernel path, then the plain chain on the card
    shape = (1, 3, 256, 256)
    physics = BlurFFT(shape[1:], filter=gaussian_blur(sigma=1.5),
                      noise_model=GaussianNoise(0.01), device=dev)
    x = torch.rand(shape, generator=g).to(dev)
    y = physics(x, generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    denoiser = autocast(DRUNet(nc=(64, 128, 256, 512), nb=R_MAIN, generator=g))
    model = optim_builder("HQS", data_fidelity=L2(), prior=PnP(denoiser),
                          params_algo={"stepsize": 2.0, "g_param": 0.02},
                          max_iter=MAX_ITER).to(dev)

    def plain_resblocks():
        """DRUNet's scale-0 chain on the plain version instead of the kernel."""
        return swapped(drunet_mod, "resblock_chain",
                       lambda h, w1s, w2s, packed=None: resblock_chain_plain(h, w1s, w2s))

    out, out_plain, launches = drive("HQS", model, y, physics, denoiser.denoiser,
                                     resblock_chain, plain_resblocks, shape)
    p_k, p_p, p_y = psnr(out, x), psnr(out_plain, x), psnr(y, x)
    print(f"HQS PSNR vs x: kernel {p_k:.4f} dB, plain {p_p:.4f} dB, y {p_y:.4f} dB "
          f"(gap bound {RECON_PSNR_DB} dB)", flush=True)
    check(abs(p_k - p_p) <= RECON_PSNR_DB, "HQS: PSNR gap to the plain chain too large")

    def recon(m, v, p):
        def run():
            with torch.no_grad():
                return m(v, p)
        return run

    def on_plain(run, plain_chain):
        def run_plain():
            with plain_chain():
                return run()
        return run_plain

    hqs = recon(model, y, physics)

    # 5. the PGD bench problems (bench.py:140-162): MRI, then CT
    def plain_conv_chain():
        """DnCNN's hidden chain on the plain version instead of the kernel."""
        return swapped(dncnn_mod, "conv_chain",
                       lambda h, ws, bs, packed=None: conv_chain_plain(h, ws, bs))

    def exact_conv_chain():
        """DnCNN's hidden chain in f32 with no rounding inside it (bf16
        weights and input, one rounding of the output)."""
        return swapped(dncnn_mod, "conv_chain", lambda h, ws, bs, packed=None: chain_f32(
            h, ws.to(torch.bfloat16), bs).to(torch.bfloat16))

    mask = (np.random.default_rng(0).random((256, 256)) < 0.3).astype(np.float32)
    problems = {
        "MRI": (MRI(mask=mask, img_size=(256, 256), device=dev),
                torch.randn((1, 2, 256, 256), generator=g).to(dev)),
        "CT": (Tomography(img_width=256, angles=90, method="slice", normalize=True,
                          device=dev),
               torch.rand((1, 1, 256, 256), generator=g).to(dev)),
    }
    pgd, chain_launches = {}, 0
    for name, (phys, xt) in problems.items():
        c = xt.shape[1]
        net = DnCNN(c, c, depth=20, nf=64, generator=g)
        with torch.no_grad():
            net.out_conv.weight.mul_(DNCNN_RESIDUAL_SCALE)
        den = autocast(net)
        m = optim_builder("PGD", data_fidelity=L2(), prior=PnP(den), params_algo=PGD_PARAMS,
                          max_iter=MAX_ITER).to(dev)
        yt = phys.A(xt)
        out, out_plain, n = drive(f"PGD {name}", m, yt, phys, den.denoiser, conv_chain,
                                  plain_conv_chain, tuple(xt.shape), exact_conv_chain)
        chain_launches += n
        print(f"PGD {name} PSNR vs x: kernel {psnr(out, xt):.4f} dB, plain "
              f"{psnr(out_plain, xt):.4f} dB, A^T y {psnr(phys.A_adjoint(yt), xt):.4f} dB; "
              f"max |x_hat| {float(out.abs().max())}, max |x| {float(xt.abs().max())}",
              flush=True)
        pgd[name] = recon(m, yt, phys)
    ct, xct = problems["CT"]
    with torch.no_grad():
        fast, slow = ct.A_adjoint_A(xct), ct.A_adjoint(ct.A(xct))
    nerr = float((fast - slow).norm() / slow.norm())
    print(f"CT A_adjoint_A (Toeplitz) vs A_adjoint(A(x)): relative L2 error {nerr} "
          f"(bound {CT_NORMAL_RTOL})", flush=True)
    check(bool(torch.isfinite(fast).all()) and nerr <= CT_NORMAL_RTOL,
          "CT Toeplitz normal operator disagrees with A_adjoint(A(x))")

    # 6. times, in turns; channels_last inputs, as DRUNet and DnCNN hand the chains
    h = torch.randn(KERNEL_SHAPES[0][0], generator=g).to(dev, torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    w1 = (torch.randn((R_MAIN, 64, 64, 3, 3), generator=g) * std).to(dev)
    w2 = (torch.randn((R_MAIN, 64, 64, 3, 3), generator=g) * std).to(dev)
    packed = (pack_weights(w1), pack_weights(w2))
    w1b, w2b = ([w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last) for w in ws]
                for ws in (w1, w2))

    def cudnn_bf16_resblocks():  # the chain as cuDNN bf16 layers, two roundings per block
        v = h
        for r in range(R_MAIN):
            t = torch.relu(F.conv2d(v, w1b[r], padding=1))
            v = v + F.conv2d(t, w2b[r], padding=1)
        return v

    flop_conv = 2 * 256 * 256 * 64 * 64 * 9
    k_ms, p_ms = time_chain(
        f"(1,64,256,256) R={R_MAIN}", lambda: resblock_chain(h, w1, w2, packed),
        lambda: resblock_chain_plain(h, w1, w2), cudnn_bf16_resblocks, R_MAIN * 2 * flop_conv)

    ws = (torch.randn((L_MAIN, 64, 64, 3, 3), generator=g) * he_std).to(dev)
    bs = (torch.randn((L_MAIN, 64), generator=g) * 0.02).to(dev)
    chain_packed = (pack_weights(ws), pack_bias(bs))
    wsb = [w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last) for w in ws]
    bsb = bs.to(torch.bfloat16)

    def cudnn_bf16_chain():  # the chain as cuDNN bf16 layers, bias added by cuDNN
        v = h
        for l in range(L_MAIN):
            v = torch.relu(F.conv2d(v, wsb[l], bsb[l], padding=1))
        return v

    ck_ms, cp_ms = time_chain(
        f"(1,64,256,256) L={L_MAIN}", lambda: conv_chain(h, ws, bs, chain_packed),
        lambda: conv_chain_plain(h, ws, bs), cudnn_bf16_chain, L_MAIN * flop_conv)

    recon_rates(f"HQS {MAX_ITER} it (1x3x256x256, DRUNet full width, bf16)", hqs,
                on_plain(hqs, plain_resblocks))
    for name, run in pgd.items():
        recon_rates(f"PGD {name} {MAX_ITER} it (B=1, 256x256, DnCNN depth 20 nf 64, bf16)",
                    run, on_plain(run, plain_conv_chain))

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "resblock_chain",
        "route": "cuda",
        "source": "deepinv_tpu_torch/csrc/resblock_chain.cu",
        "replaces": "deepinv_tpu/ops/pallas/resblock_chain.py:43",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }, {
        "name": "conv_chain",
        "route": "cuda",
        "source": "deepinv_tpu_torch/csrc/conv_chain.cu",
        "replaces": "deepinv_tpu/ops/pallas/conv_chain.py:112",
        "launches": chain_launches,
        "max_abs_err": chain_err,
        "ms": ck_ms,
        "plain_ms": cp_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
