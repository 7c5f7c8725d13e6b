#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each one raises, and the script exits non-zero, if it fails):

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build the CUDA kernels from ``deepinv_tpu_torch/csrc`` (nvcc, sm_90a);
3. the DRUNet resblock-chain kernel against its plain PyTorch version, TF32
   off, at the main-path shapes;
4. the bench problem through the port's entry points: PnP-HQS deblurring of
   a 1x3x256x256 image (BlurFFT, Gaussian blur sigma 1.5, Gaussian noise
   0.01) with a bf16 full-width DRUNet (nc=(64,128,256,512), nb=4, seeded
   random weights), 8 iterations. The output must be finite, the kernel must
   have been launched once per iteration, each denoiser call must agree with
   the same call on the plain chain, and the output with the same
   reconstruction run on the plain chain on the card;
5. times, with CUDA events after warm-up: the kernel against the plain
   version, and the reconstruction's iterations per second.

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
# Kernel vs plain: the two differ only in the order of the f32 sums, so an
# output differs by at most a few bf16 ulps (2^-8 relative) after R blocks.
KERNEL_RTOL = 2e-2
# Each denoiser call of the run against the same call on the plain chain:
# the ulps pass through the rest of the bf16 UNet; bound on the max error
# relative to the output's range, the repo's bf16 denoiser policy
# (tests/test_models.py::test_autocast_bf16_parity).
DENOISER_RTOL = 3e-2
# The whole reconstruction against the plain chain's. With random weights the
# PnP iteration is unstable (the iterate grows ~5x per iteration in both
# packages), which amplifies the per-call differences; bound on the relative
# L2 error, and the repo's bf16 quality policy of 0.1 dB PSNR.
RECON_RTOL = 5e-2
RECON_PSNR_DB = 0.1
MAX_ITER = 8


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1

    import deepinv_tpu_torch.models.drunet as drunet_mod
    from deepinv_tpu_torch.models import DRUNet, autocast
    from deepinv_tpu_torch.ops import gaussian_blur
    from deepinv_tpu_torch.ops.kernels import build
    from deepinv_tpu_torch.ops.kernels.resblock_chain import (
        pack_weights, resblock_chain, resblock_chain_plain)
    from deepinv_tpu_torch.optim import L2, PnP, optim_builder
    from deepinv_tpu_torch.physics import BlurFFT, GaussianNoise

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

    # 3. kernel vs plain on the card
    g = torch.Generator().manual_seed(SEED)
    std = 0.2 * (2.0 / (64 * 9)) ** 0.5      # DRUNet's ResBlock init scale
    main_err = None
    for shape, R in KERNEL_SHAPES:
        h = torch.randn(shape, generator=g).to(dev, torch.bfloat16)
        w1 = (torch.randn((R, 64, 64, 3, 3), generator=g) * std).to(dev)
        w2 = (torch.randn((R, 64, 64, 3, 3), generator=g) * std).to(dev)
        with torch.no_grad():
            got = resblock_chain(h, w1, w2)
            torch.cuda.synchronize()
            want = resblock_chain_plain(h, w1, w2)
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        print(f"kernel vs plain {shape} R={R}: max_abs_err {err} (scale {scale}, "
              f"rel {err / scale}, bound {KERNEL_RTOL})", flush=True)
        check(bool(torch.isfinite(got.float()).all()), f"non-finite kernel output at {shape}")
        check(err <= KERNEL_RTOL * scale, f"kernel disagrees with plain at {shape}")
        if main_err is None:
            main_err = err

    # 4. the bench problem, kernel path, then the plain chain on the card
    shape = (1, 3, 256, 256)
    physics = BlurFFT(shape[1:], filter=gaussian_blur(sigma=1.5),
                      noise_model=GaussianNoise(0.01), device=dev)
    x = torch.rand(shape, generator=g).to(dev)
    y = physics(x, generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    denoiser = autocast(DRUNet(nc=(64, 128, 256, 512), nb=R_MAIN, generator=g))
    model = optim_builder("HQS", data_fidelity=L2(), prior=PnP(denoiser),
                          params_algo={"stepsize": 2.0, "g_param": 0.02},
                          max_iter=MAX_ITER).to(dev)

    @contextlib.contextmanager
    def plain_chain():
        """DRUNet's scale-0 chain on the plain version instead of the kernel."""
        drunet_mod.resblock_chain = lambda h, w1s, w2s, packed=None: resblock_chain_plain(
            h, w1s, w2s)
        try:
            yield
        finally:
            drunet_mod.resblock_chain = resblock_chain

    def recon():
        with torch.no_grad():
            return model(y, physics)

    def recon_plain():
        with plain_chain():
            return recon()

    drunet = denoiser.denoiser
    calls = []  # every denoiser input of the run, to replay on the plain chain
    hook = drunet.register_forward_pre_hook(
        lambda mod, args: calls.append((args[0].detach().clone(), args[1])))
    torch.cuda.reset_peak_memory_stats()
    resblock_chain.launches = 0
    t0 = time.perf_counter()
    out = recon()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = resblock_chain.launches
    hook.remove()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"HQS {MAX_ITER} it: first run {first_s:.3f} s, kernel launches {launches}, "
          f"peak memory {peak_gib:.3f} GiB", flush=True)
    check(launches == MAX_ITER, f"expected {MAX_ITER} kernel launches, got {launches}")
    check(tuple(out.shape) == shape and out.dtype == torch.float32, "bad output shape/dtype")
    check(bool(torch.isfinite(out).all()), "non-finite reconstruction")
    check(len(calls) == MAX_ITER, f"expected {MAX_ITER} denoiser calls, got {len(calls)}")
    for i, (xin, sigma) in enumerate(calls):
        with torch.no_grad():
            d_k = drunet(xin, sigma).float()
            with plain_chain():
                d_p = drunet(xin, sigma).float()
        derr, dscale = float((d_k - d_p).abs().max()), float(d_p.abs().max())
        print(f"denoiser call {i}: kernel vs plain chain max_abs_err {derr} (scale {dscale}, "
              f"rel {derr / dscale}, bound {DENOISER_RTOL})", flush=True)
        check(derr <= DENOISER_RTOL * dscale, f"denoiser call {i} disagrees with the plain chain")
    launches_after = resblock_chain.launches
    out_plain = recon_plain()
    torch.cuda.synchronize()
    check(resblock_chain.launches == launches_after, "the plain run launched the kernel")
    rerr = float((out - out_plain).norm() / out_plain.norm())
    p_k, p_p, p_y = psnr(out, x), psnr(out_plain, x), psnr(y, x)
    print(f"HQS kernel vs plain chain: relative L2 error {rerr} (bound {RECON_RTOL}), "
          f"max_abs_err {float((out - out_plain).abs().max())}, output max "
          f"{float(out_plain.abs().max())}; PSNR vs x: kernel {p_k:.4f} dB, "
          f"plain {p_p:.4f} dB, y {p_y:.4f} dB (gap bound {RECON_PSNR_DB} dB)", flush=True)
    check(rerr <= RECON_RTOL, "reconstruction disagrees with the plain chain")
    check(abs(p_k - p_p) <= RECON_PSNR_DB, "PSNR gap to the plain chain too large")

    # 5. times, in turns: plain, kernel, kernel, plain; channels_last input, as
    # DRUNet hands the chain
    h = torch.randn(KERNEL_SHAPES[0][0], generator=g).to(dev, torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    w1 = (torch.randn((R_MAIN, 64, 64, 3, 3), generator=g) * std).to(dev)
    w2 = (torch.randn((R_MAIN, 64, 64, 3, 3), generator=g) * std).to(dev)
    packed = (pack_weights(w1), pack_weights(w2))
    w1b, w2b = ([w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last) for w in ws]
                for ws in (w1, w2))

    def cudnn_bf16_chain():  # the chain as cuDNN bf16 layers, two roundings per block
        v = h
        for r in range(R_MAIN):
            t = torch.relu(torch.nn.functional.conv2d(v, w1b[r], padding=1))
            v = v + torch.nn.functional.conv2d(t, w2b[r], padding=1)
        return v

    with torch.no_grad():
        run_k = lambda: resblock_chain(h, w1, w2, packed)  # noqa: E731
        run_p = lambda: resblock_chain_plain(h, w1, w2)  # noqa: E731
        t_p = [cuda_ms(run_p, 50)]
        t_k = [cuda_ms(run_k, 50), cuda_ms(run_k, 50)]
        t_p.append(cuda_ms(run_p, 50))
        t_bf16 = cuda_ms(cudnn_bf16_chain, 50)
    k_ms, p_ms = sum(t_k) / 2, sum(t_p) / 2
    flop = R_MAIN * 2 * (2 * 256 * 256 * 64 * 64 * 9)
    print(f"time (1,64,256,256) R={R_MAIN}: kernel {t_k} ms, plain f32 {t_p} ms, "
          f"cuDNN bf16 layers {t_bf16} ms; kernel {flop / k_ms / 1e9:.1f} TFLOP/s", flush=True)

    # the B=1 recon is host-bound and varies run to run: 4 rounds in turns
    r_k, r_p = [], []
    for _ in range(2):
        for fn, times in ((recon, r_k), (recon_plain, r_p), (recon_plain, r_p), (recon, r_k)):
            times.append(cuda_ms(fn, 20, warmup=3))
    rec_ms, rec_plain_ms = sorted(r_k)[len(r_k) // 2], sorted(r_p)[len(r_p) // 2]
    print(f"HQS {MAX_ITER} it (1x3x256x256, DRUNet full width, bf16), ms per recon: kernel "
          f"path {r_k}, median {MAX_ITER * 1e3 / rec_ms:.2f} it/s; plain chain {r_p}, median "
          f"{MAX_ITER * 1e3 / rec_plain_ms:.2f} it/s", flush=True)

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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
