#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (each one raises, and the script exits non-zero, if it fails):

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build the CUDA kernels from ``deepinv_tpu_torch/csrc`` (nvcc, sm_90a, one
   nvcc per source, all started together), and check in the library's SASS
   (``cuobjdump -sass``) that each source holds its wgmma kernels
   (WGMMA_KERNELS: the 64-channel conv tile of ``csrc/conv3x3_wgmma.cuh`` in
   K1, K5 (with K6 and the stash backward's dX chain: its bias+ReLU,
   mask+db and rounding epilogues), K2/K3 and K4; the 2x2 projections of
   ``csrc/proj2x2_wgmma.cuh`` in
   K2/K3 and K4; the 128-channel cluster tile of
   ``csrc/conv3x3_c128_wgmma.cuh`` in K4) and that each has ``HGMMA``
   (wgmma), ``UTMALDG`` (TMA load) and ``UTMASTG`` (TMA store) instructions;
3. each kernel against its plain PyTorch version, TF32 off, at its main-path
   shapes: the DRUNet resblock chain (K1) and the DnCNN conv+bias+ReLU chain
   (K5) on the wgmma tile at every KERNEL_SHAPES and CHAIN_SHAPES entry and
   at 8x64x256² (R=4, L=18), each of the tile's nine taps alone at a ragged
   two-strip shape, and K1 and K5 on the earlier mma.sync tile (the private
   ``_launch(..., tile="mma")``) at the main shape; the Chambolle TV prox (K7; 1x3x256², 1x2x256², B=2 with two
   gammas, a ragged 1x1x37x53 plane, 8x3x256² with eight gammas, the
   largest and a ragged plane a cluster holds, each on the variant its plan
   picks, the resident one, and a 1x1x1024² plane that no cluster holds, on
   the global variant; 1x3x256² also in a cluster of 16 and on the global
   variant, the layouts phase 7 times; 100 iterations each, and 0 and 1 at
   1x3x256²), DRUNet's up-projection chain (K2/K3; v 1x128x128²
   and 2x128x128² with R=4, a ragged 1x128x20x28 with R=1, and 8x128x128²)
   and its up tail (K4; s2 1x256x64² and d0 1x64x256², the same at B=2 and
   B=8, and a ragged scale 0 of 40x56, R1=R0=4), both on their wgmma kernels
   and, at the main shape, on the earlier mma.sync kernels (the private
   ``_launch(..., tile="mma")``); K4's 128-channel cluster tile alone (one
   block, by its residual branch) at 8x128x128² and at a ragged 1x128x70x100
   of two strips, where each of its nine taps and two K-blocks is also held
   alone;
4. the HQS bench problem through the port's entry points: PnP-HQS deblurring
   of a 1x3x256x256 image (BlurFFT, Gaussian blur sigma 1.5, Gaussian noise
   0.01) with a bf16 full-width DRUNet (nc=(64,128,256,512), nb=4, seeded
   random weights), 8 iterations, three times with the same weights: in the
   default ``fused="down"`` (K1), in ``"both"`` (K1 and K2/K3) and in
   ``"sandwich"`` (K1 and K4);
5. the PGD bench problems: PnP-PGD with a bf16 full-depth, full-width DnCNN
   (depth 20, nf 64, seeded random weights, the residual layer scaled to a
   denoiser's size), 8 iterations at stepsize 1.0 and denoiser level 0.05, on
   MRI (1x2x256x256, 30% random k-space mask) and on CT (1x1x256x256,
   Fourier-slice Tomography, 90 angles, normalized), each also at B=8, and
   the CT Toeplitz normal operator against ``A_adjoint(A(x))``.
   For each of the five reconstructions (4 and 5) the output must be finite,
   each of the path's kernels must have been launched once per iteration
   (its counter is set to 0 just before the run and read just after), each
   denoiser call must agree with the same call on the plain versions, and
   the output with the same reconstruction run on the plain versions on the
   card (PGD: and on the chain in f32 without rounding);
6. the TV problems, f32, through the entry points with the default device
   and ``TVPrior()`` (100 Chambolle steps per prox), on piecewise-constant
   phantoms of random discs: TV deblurring of 1x3x256² (BlurFFT, Gaussian blur
   sigma 2, noise 0.02) by PGD, FISTA, ADMM and Chambolle-Pock, 30 iterations
   each, and by PGD at B=8; TV-PGD on MRI (1x2x256², the 30% mask, 20
   iterations) and on CT (256², 90 angles, normalized, 30 iterations from the
   FBP); PnP-HQS with ``TVDenoiser(50)`` on the deblurring problem, 10
   iterations. Each must be finite, launch K7 once per iteration on its
   resident variant (``chambolle_prox.launches_by_variant``), agree with
   the same run on the plain prox (``use_pallas=False``) and be no worse than
   the naive estimate (``y``, the zero-filled ``A^T y``, the FBP) by more than
   0.5 dB of PSNR;
7. times, with CUDA events after warm-up, in turns: each kernel against its
   plain version (K1, K5, K2/K3, K4: and against the same stage as cuDNN
   bf16 layers; K1 and K5 on the wgmma tile, on the mma.sync tile and as
   cuDNN bf16 layers at 1x64x256² and 8x64x256², K2/K3 and K4 likewise on
   their wgmma kernels, their mma.sync kernels and as cuDNN layers at B=1
   and B=8, with TFLOP/s and the host's issue time a call; K7's resident variant in
   clusters of 8 and 16 and its global variant, in turns, at 1x3x256² and
   8x3x256², and the resident kernel's barrier floor on planes of one and
   two rows a CTA), each reconstruction's iterations
   per second on the kernel path and on the plain version, and the DRUNet
   forward and the HQS iterations per second in ``down``, ``both``,
   ``sandwich`` and ``"0"`` (no kernel) at B=1 and B=8, ``down`` at B=8 also
   on the mma.sync tile, ``both`` and ``sandwich`` at B=8 with K2/K3 and K4
   on their wgmma and on their mma.sync kernels, and PGD on MRI and CT at
   B=8 on the wgmma tile, the mma.sync tile and cuDNN layers;
8. where the time goes: ``torch.profiler`` over HQS in each DRUNet
   configuration at B=1 and B=8, over PGD on MRI and CT at B=1 and B=8 (the
   wgmma kernels must show by name; their launches a recon are printed
   beside those the path makes, HQS_TILE_LAUNCHES: ``down`` 64 conv tiles,
   ``both`` 128 and 8 projections, ``sandwich`` 128, 64 128-channel cluster
   tiles and 24 projections; PGD 144), over K7 alone (each variant and cluster
   size at 1x3x256² and 8x3x256²; the resident prox must be one kernel a
   call) and over TV-PGD deblurring at B=1 and B=8 (device time by kernel,
   kernels per call, and the device's idle share against the unprofiled
   wall time);
9. DnCNN training through ``Trainer.train()`` (the bench's train rows): a
   bf16 full-width DnCNN(1, 1) (depth 20, nf 64, seeded random weights) as
   ``ArtifactRemoval(autocast(...))`` denoising 256² images at sigma 0.1,
   ``SupLoss``, Adam(1e-4), one epoch of TRAIN_STEPS steps on a fixed set of
   random images, at B=1 and B=16, with ``fused_chains=False`` (the
   reference's configuration: the hidden layers as cuDNN convs under
   autograd) and ``True`` (the hidden chain on the stash kernel K6 and its
   stash backward), from the same weights. Checked: one K6 launch per step
   in ``True`` and none in ``False`` (no K5 in either), each step's loss
   within TRAIN_LOSS_RTOL of the other configuration's, the first step's
   gradients within GRAD_RTOL, and the last step's loss below the first's.
   The stash backward's kernels (head, L dX tiles, fold) launch L + 2 times
   a step in ``True`` and never in ``False``. Timed, in turns at B=1 and
   B=16: K6 on the wgmma tile, on the mma.sync tile (the private
   ``_launch_stash(..., tile="mma")``) and as the same stage of cuDNN bf16
   layers under autograd; the stash backward on its kernels, on the earlier
   cuDNN route (the private ``route="cudnn"``) and as autodiff through those
   layers; K5 and the plain versions at B=1; train steps per second in each
   configuration (a second epoch, in turns). Profiled: three steps at B=1
   and B=16 in each configuration, where a ``True`` step must show exactly
   2L ``conv3x3_wgmma`` launches (L forward, L dX);
10. self-supervised training (the bench's train_ssl rows): the same model on
   256² ``Inpainting`` (mask 0.7, sigma 0.1) with ``SureGaussianLoss(0.1)``
   + ``EILoss(Rotate())``, Adam(1e-4), at B=1 and B=16, in the reference
   configuration (SURE's forward-mode JVP needs the kernel gates closed):
   finite losses, SURE's JVP divergence within JVP_RTOL of a finite
   difference of the f32 model, and steps per second.

Phase 3 also holds K6 (the stash forward, on the wgmma tile) to its plain
version at the chain shapes, at the train batch (16x64x256², L=18) and at
TAP_SHAPE (two strips), every stash slot, and on the mma.sync tile at the
main shape; and the stash backward on its kernels from the card's stash to
its plain version (STASH_BWD_RTOL) at the same shapes, with L + 2 launches
a call and db the same bits in two calls. It prints the card line and a JSON line
``{"kernels": [...]}`` before the last line, and ends with ``{"ok": true, "device": {...}}``. It exits non-zero with
no result when there is no CUDA device. It imports no JAX.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import re
import subprocess
import sys
import time

SEED = 0
R_MAIN = 4                      # DRUNet nb: blocks in the scale-0 chain
MAX_ITER = 8                    # iterations of each reconstruction
KERNEL_SHAPES = [((1, 64, 256, 256), R_MAIN), ((2, 64, 256, 256), R_MAIN),
                 ((1, 64, 40, 56), 1)]
# K2/K3: (v shape, R); v is DRUNet's m_up1 input at 256² (Ci = nc[1] = 128)
UP_SHAPES = [((1, 128, 128, 128), R_MAIN), ((2, 128, 128, 128), R_MAIN),
             ((1, 128, 20, 28), 1)]
# K4: (B, H2, W2) of s2 (B, 256, H2, W2); d0 is (B, 64, 4 H2, 4 W2), R1 = R0 = 4
SANDWICH_SHAPES = [(1, 64, 64), (2, 64, 64), (1, 10, 14)]
# projection inputs past 256 channels, whose weights the wgmma projection
# streams in chunks of 256: K2/K3 at Ci = 272 ((v shape, R)) and K4 at Ci2 =
# 512 ((B, H2, W2, Ci2)), at ragged shapes
UP_WIDE = ((1, 272, 20, 28), 1)
SANDWICH_WIDE = (1, 10, 14, 512)
# DRUNet configurations run on the HQS bench problem; "0" (every stage on
# cuDNN layers) is timed beside them
HQS_CONFIGS = ("0", "down", "both", "sandwich")
HQS_BATCH = 8
L_MAIN = 18                     # DnCNN depth 20: hidden layers in the chain
CHAIN_SHAPES = [((1, 64, 256, 256), L_MAIN), ((2, 64, 256, 256), L_MAIN),
                ((1, 64, 40, 56), 3)]
# K1 and K5 on the wgmma tile are also held at the HQS batch (R=4, L=18),
# and each of the tile's nine taps alone at a ragged shape of two strips of
# 128 columns, the second partly outside the image
TILE_B8_SHAPE = (8, 64, 256, 256)
TAP_SHAPE = (1, 64, 20, 200)
# K6 and its stash backward are also held at the train batch of phase 9 and
# at TAP_SHAPE with L = 3
TRAIN_B16_SHAPE = (16, 64, 256, 256)
# the tile's kernels per call: K1 2R, K5 L (one launch a conv)
K1_TILE_LAUNCHES = 2 * R_MAIN
K5_TILE_LAUNCHES = L_MAIN
# K2/K3 and K4 on their wgmma kernels are also held at the HQS batch, and on
# the earlier mma.sync kernels at the main shape; K4's 128-channel cluster
# tile alone (R=1, held by its residual branch) at 8x128x128² and at a ragged
# shape of two 64-column strips with a short last band, where each of its
# nine taps and two K-blocks is also held alone
UP_B8_SHAPE = (8, 128, 128, 128)
SANDWICH_B8 = (8, 64, 64)
TILE128_SHAPES = ((8, 128, 128, 128), (1, 128, 70, 100))
# the wgmma kernels' launches a recon in each HQS configuration (8 DRUNet
# calls): K1 2R conv tiles a call; K2/K3 2R conv tiles and one projection;
# K4 2R0 conv tiles at 64 channels, 2R1 cluster tiles at 128 and three
# projections
HQS_TILE_LAUNCHES = {
    "down": {"conv3x3_wgmma": MAX_ITER * K1_TILE_LAUNCHES},
    "both": {"conv3x3_wgmma": 2 * MAX_ITER * K1_TILE_LAUNCHES, "proj2x2_wgmma": MAX_ITER},
    "sandwich": {"conv3x3_wgmma": 2 * MAX_ITER * K1_TILE_LAUNCHES,
                 "conv3x3_c128_wgmma": MAX_ITER * 2 * R_MAIN, "proj2x2_wgmma": 3 * MAX_ITER},
}
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
# K7 against its plain version: (shape, gamma per sample), 100 iterations.
# Both are f32 and differ only in FMA contraction and the order of a few
# sums: max error <= 1e-4 of the output's range at the gammas the TV problems
# use (<= 0.1). At gamma 0.3 on uniform noise the iteration (tau = 1/4, above
# the 1/8 of Chambolle's convergence proof) amplifies rounding: the plain
# version alone is ~1e-3 from the same loop in float64 (PERF.md, PR 3).
TV_SHAPES = [((1, 3, 256, 256), (0.05,)), ((1, 2, 256, 256), (0.02,)),
             ((2, 3, 256, 256), (0.05, 0.1)), ((1, 1, 37, 53), (0.1,)),
             ((1, 1, 1024, 1024), (0.05,)),
             ((8, 3, 256, 256), (0.02, 0.03, 0.04, 0.05, 0.06, 0.07, 0.08, 0.1)),
             ((1, 1, 512, 512), (0.05,)), ((1, 1, 500, 300), (0.1,))]
TV_ITERS = 100
TV_RTOL = 1e-4
# K7's layouts timed in turns (phase 7) and profiled (phase 8): (label,
# variant, cluster size) as tv._launch takes them
TV_LAYOUTS = (("global", "global", None), ("resident, cluster 8", "resident", 8),
              ("resident, cluster 16", "resident", 16))
TV_TIME_SHAPES = ((1, 3, 256, 256), (8, 3, 256, 256))
# the resident kernel's barrier floor: a 16x32 plane, one (cluster 16) or two
# (cluster 8) rows a CTA, timed at two step counts
TV_FLOOR_STEPS = (500, 1500)
# A TV reconstruction against the same run on the plain prox, relative L2.
TV_RECON_RTOL = 1e-4
# ... and its PSNR against the naive estimate's (demo_tv_minimisation.py:44).
TV_PSNR_SLACK_DB = 0.5
# K6's stash backward on the card (dX on the wgmma tile with the masks and
# db in its epilogue, dW a cuDNN wgrad) against its plain version (f32 convs
# of the same values): the same masks and rounding points, f32 sums in
# another order; dh is rounded to bf16 after each of the L layers. Relative
# max error of dh, dW and db.
STASH_BWD_RTOL = 3e-2
# Training (phases 9-10): steps per epoch, the batch sizes, and the bounds
# between the two train-step configurations, which round at other points
# (cuDNN's bf16 layers add the bias before one rounding, as the kernel does,
# but sum in another order): each step's loss (relative), the first step's
# whole parameter gradient (relative max error; the bf16 gradients of both
# lie 2-5% from the f32 one, tests/test_torch_training.py).
TRAIN_STEPS = 8
SSL_STEPS = 4
TRAIN_BATCHES = (1, 16)
TRAIN_LOSS_RTOL = 2e-2
GRAD_RTOL = 3e-2
# SURE's JVP divergence against (f(y + tau b) - f(y)) / tau of the f32 model.
JVP_TAU = 1e-3
JVP_RTOL = 5e-2
# queued_ms: calls a measurement (their launches, at most ~40 a call, stay
# within the launch queue's ~1000) and the spin in front of them (~50 ms at
# the H100's clock, longer than the host takes to issue those calls)
QUEUED_REPS = 20
# the tensor maps' memo (wg::encode keeps the last 64 maps by their
# arguments): K4 at B=1 issued on one set of inputs and packed weights, and
# on MAP_SETS sets in turn, whose input and weight maps (9 of a call's 20,
# 72 over the sets) the memo cannot keep; MAP_REPS calls a measurement
MAP_SETS = 8
MAP_REPS = 16
SPIN_CYCLES = 100_000_000
# profiler sessions a launch count may take: the profiler loses the records
# of some launches in a window, never adds any (one run of this script saw 9
# resident TV proxes of 10), so a count short of the launches made is taken
# again, and a count above them fails at once
PROFILE_TRIES = 3
# H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W) for the bounds.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


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


def queued_ms(fn, reps: int, warmup: int = 3) -> float:
    """Device time of ``fn`` in ms a call: ``reps`` calls enqueued while a
    spin kernel keeps the device busy, so that the device runs them back to
    back whatever the host's issue time; CUDA events around the calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
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


# the wgmma kernels each source's library code must hold (kernel name ->
# instances: one an epilogue or a projection mode; wg::resblocks<Tile64>
# launches two, kRelu and kResidual; conv_chain.cu three: kBiasRelu (K5,
# K6), kMaskDb and kRound (the stash backward's dX chain))
WGMMA_KERNELS = {
    "resblock_chain": {"conv3x3_wgmma": 2},                        # K1
    "conv_chain": {"conv3x3_wgmma": 3},                            # K5, K6, dX
    "up_resblock_chain": {"conv3x3_wgmma": 2, "proj2x2_wgmma": 1},  # K2/K3
    "up_sandwich": {"conv3x3_wgmma": 2, "conv3x3_c128_wgmma": 2, "proj2x2_wgmma": 2},  # K4
}


def source_of(fn: str):
    """The ``.cu`` file stem of a kernel in an unnamed namespace, from its
    mangled name (``_GLOBAL__N__<hash>_<len>_<stem>_cu_...``), or None. The
    matches may overlap: a hash of digits alone shares its last underscore
    with ``_<len>_``."""
    for m in re.finditer(r"(?=_(\d+)_)", fn):
        start = m.start() + len(m.group(1)) + 2
        name = fn[start:start + int(m.group(1))]
        if name.endswith("_cu"):
            return name[:-3]
    return None


def sass_tile_check(cuobjdump: str, so) -> dict:
    """``HGMMA``, ``UTMALDG`` and ``UTMASTG`` (TMA store) instructions in each
    wgmma kernel of the built library (``cuobjdump -sass``): the 64-channel
    conv tile (K1, K5, the scale-0 chains of K2/K3 and K4), the 128-channel
    cluster tile and the 2x2 projections (K2/K3, K4). Fails unless each
    source holds the kernels of WGMMA_KERNELS and each has all three."""
    out = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True,
                         check=True, timeout=300).stdout
    names = {k for kernels in WGMMA_KERNELS.values() for k in kernels}
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            if any(re.search(rf"\d{k}I", fn) for k in names):
                counts[fn] = {"HGMMA": 0, "UTMALDG": 0, "UTMASTG": 0}
        elif fn in counts:
            for op in counts[fn]:
                counts[fn][op] += op in line
    for fn, c in counts.items():
        print(f"  sass {fn[:110]}: {c}", flush=True)
    found = {}
    for fn in counts:
        kernel = next(k for k in names if re.search(rf"\d{k}I", fn))
        key = (source_of(fn), kernel)
        found[key] = found.get(key, 0) + 1
    want = {(src, k): n for src, kernels in WGMMA_KERNELS.items() for k, n in kernels.items()}
    check(found == want, f"the wgmma kernels in the library are {found}, not {want}")
    check(all(c["HGMMA"] > 0 and c["UTMALDG"] > 0 and c["UTMASTG"] > 0 for c in counts.values()),
          f"a wgmma kernel lacks HGMMA, UTMALDG or UTMASTG in its SASS: {counts}")
    return counts


def tile_turns(label: str, runs: dict, flop: float, reps: int, queued_reps: int = QUEUED_REPS):
    """Mean ms of each of ``runs`` (name -> fn), timed in turns (a, b, c, c,
    b, a), and TFLOP/s at ``flop`` a call; also the host's time to issue a
    call (where it is near the device time, the timing is host-bound) and
    the device's own time a call (:func:`queued_ms` over ``queued_reps``
    calls). Returns ``(ms, device ms)`` by name."""
    import torch

    times, host = {k: [] for k in runs}, {}
    with torch.no_grad():
        for k in list(runs) + list(runs)[::-1]:
            times[k].append(cuda_ms(runs[k], reps))
        for k, fn in runs.items():   # the host's time to issue a call, no sync inside
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            host[k] = (time.perf_counter() - t0) * 1e3 / reps
            torch.cuda.synchronize()
    ms = {k: sum(t) / len(t) for k, t in times.items()}
    print(f"time {label}, in turns: {times} ms; "
          + ", ".join(f"{k} {flop / v / 1e9:.1f} TFLOP/s" for k, v in ms.items())
          + f"; host issue ms a call {host}", flush=True)
    # the device's own time a call: the calls queued behind a spin kernel,
    # so that the host's issue time does not show (in turns as above)
    queued = {k: [] for k in runs}
    with torch.no_grad():
        for k in list(runs) + list(runs)[::-1]:
            queued[k].append(queued_ms(runs[k], queued_reps))
    busy = {k: sum(t) / len(t) for k, t in queued.items()}
    print(f"time {label}, calls queued behind a spin kernel, in turns: {queued} ms", flush=True)
    return ms, busy


def issue_turns(label: str, calls: dict, reps: int) -> dict:
    """The host's ms to issue one call of each of ``calls`` (name -> a list
    of fns, called in turn), no sync inside, in turns (a, b, b, a)."""
    import torch

    times = {k: [] for k in calls}
    with torch.no_grad():
        for k in list(calls) + list(calls)[::-1]:
            fns = calls[k]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(reps):
                fns[i % len(fns)]()
            times[k].append((time.perf_counter() - t0) * 1e3 / reps)
            torch.cuda.synchronize()
    print(f"host issue ms a call, {label}, in turns: {times}", flush=True)
    return {k: sum(t) / len(t) for k, t in times.items()}


def rates_in_turns(label: str, runs: dict, image_its: int, reps: int = 3) -> dict:
    """Image-iterations per second of each of ``runs`` (name -> one recon),
    timed in turns (a, b, c, c, b, a) with CUDA events over ``reps`` recons."""
    times = {k: [] for k in runs}
    for k in list(runs) + list(runs)[::-1]:
        times[k].append(cuda_ms(runs[k], reps, warmup=2))
    rates = {k: image_its * 1e3 * len(t) / sum(t) for k, t in times.items()}
    print(f"{label}, ms per recon in turns: {times}; image-it/s: "
          + ", ".join(f"{k} {v:.2f}" for k, v in rates.items()), flush=True)
    return rates


def counted_profile(label: str, run, calls: int, counted, want: float, top: int = 6):
    """``device_profile`` of ``run``, taken again (PROFILE_TRIES sessions at
    most) while the profiler saw no device time or fewer than ``want``
    launches a call of the kernels whose names ``counted`` accepts. Returns
    the last profile (None where no session saw device time) and the
    counted launches a call in it."""
    for attempt in range(PROFILE_TRIES):
        prof = device_profile(label, run, calls, top)
        n = None if prof is None else sum(k[1] for k in prof[3] if counted(k[2]))
        if n is not None and n >= want:
            break
        if attempt + 1 < PROFILE_TRIES:
            seen = "no device time" if n is None else f"{n:g} of {want:g} launches a call"
            print(f"profile {label}: the profiler saw {seen}; profiling again", flush=True)
    return prof, n


def tile_in_profile(label: str, run, wants: dict, top: int = 8) -> dict:
    """The wgmma kernels in a profile of three calls of ``run``: for each
    kernel name of ``wants`` (``conv3x3_wgmma``, ``conv3x3_c128_wgmma``,
    ``proj2x2_wgmma``) its device ms and launches a call beside the launches
    the path makes (phases 4-5 hold the ops' calls a recon exactly, each
    launching its kernels or raising; the profiler may drop events of a busy
    window, so a short count is profiled again); fails unless the profiler
    saw each kernel exactly as often as the path launches it."""
    prof, _ = counted_profile(label, run, 3, lambda name: any(k in name for k in wants),
                              sum(wants.values()), top)
    check(prof is not None, f"{label}: the profiler saw no device time")
    seen = {}
    for kernel, want in wants.items():
        found = [(ms, n) for ms, n, name in prof[3] if kernel in name]
        ms, n = sum(f[0] for f in found), sum(f[1] for f in found)
        print(f"profile {label}: {kernel} {ms:.4f} ms x{n:g} a call of {want} launched "
              f"({ms / prof[1]:.3f} of the summed kernel time)", flush=True)
        check(n == want, f"{label}: expected {want} {kernel} launches a call, the profiler "
              f"saw {n:g}")
        seen[kernel] = (ms, n)
    return seen


def bound_ms(ops: float, peak_ops: float, nbytes: float):
    """The least time in ms the card could take for work of ``ops``
    operations at ``peak_ops`` per second that moves ``nbytes`` (each input
    read once, each output written once), and which of the two bounds it."""
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_vs_plain(label: str, run, plain, x, bound: float, by_range: bool = False) -> float:
    """Max abs error of ``run(x)`` against ``plain(x)``, checked against
    ``bound`` times the plain output's max (or its range, max - min)."""
    import torch

    with torch.no_grad():
        got = run(x)
        torch.cuda.synchronize()
        want = plain(x)
    err = float((got.float() - want.float()).abs().max())
    w = want.float()
    scale = float(w.max() - w.min()) if by_range else float(w.abs().max())
    print(f"{label}: max_abs_err {err} (scale {scale}, rel {err / scale}, bound {bound})",
          flush=True)
    check(bool(torch.isfinite(got.float()).all()), f"non-finite kernel output: {label}")
    check(err <= bound * scale, f"kernel disagrees with plain: {label}")
    return err


def drive(name: str, model, y, physics, net, op, plain_chain, shape, exact_chain=None):
    """One reconstruction on the kernel path (the ``launches`` of ``op``, one
    kernel op or a tuple of them, set to 0 just before it and read just
    after), checked: finite output of ``shape``, one launch of each op and one
    denoiser call per iteration, each call of ``net`` against the same call
    on the plain chain, and the whole run against the plain chain's run.
    Returns ``(out, out_plain, launches)``, the launches of the first op.

    With ``exact_chain`` (a context that runs the chain in f32 with no
    rounding inside it; DnCNN), each call's residual is held too, and the
    whole run against the run on that unrounded chain."""
    import torch

    calls = []  # every denoiser input of the run, to replay on the plain chain
    hook = net.register_forward_pre_hook(
        lambda mod, args: calls.append((args[0].detach().clone(), args[1])))
    ops = op if isinstance(op, tuple) else (op,)
    torch.cuda.reset_peak_memory_stats()
    for o in ops:
        o.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        out = model(y, physics)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = [o.launches for o in ops]
    launches = counts[0]
    hook.remove()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{name} {MAX_ITER} it: first run {first_s:.3f} s, kernel launches "
          f"{dict(zip((o.__name__ for o in ops), counts))}, peak memory {peak_gib:.3f} GiB",
          flush=True)
    for o, n in zip(ops, counts):
        check(n == MAX_ITER, f"{name}: expected {MAX_ITER} launches of {o.__name__}, got {n}")
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
    launches_after = [o.launches for o in ops]
    with plain_chain(), torch.no_grad():
        out_plain = model(y, physics)
    torch.cuda.synchronize()
    check([o.launches for o in ops] == launches_after, f"{name}: the plain run launched a kernel")
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


def recon_rates(name: str, recon, recon_plain, iters: int = MAX_ITER, reps: int = 20,
                plain_reps: int = 20):
    """Iterations/s of the kernel path and the plain version, 4 rounds each
    in turns (a B=1 recon is host-bound and varies run to run)."""
    r_k, r_p = [], []
    for _ in range(2):
        for fn, times, n in ((recon, r_k, reps), (recon_plain, r_p, plain_reps),
                             (recon_plain, r_p, plain_reps), (recon, r_k, reps)):
            times.append(cuda_ms(fn, n, warmup=min(3, n)))
    rec_ms, rec_plain_ms = sorted(r_k)[len(r_k) // 2], sorted(r_p)[len(r_p) // 2]
    print(f"{name}, ms per recon: kernel path {r_k}, median {iters * 1e3 / rec_ms:.2f} it/s; "
          f"plain {r_p}, median {iters * 1e3 / rec_plain_ms:.2f} it/s", flush=True)


def time_chain(label: str, run_k, run_p, run_cudnn, flop: float):
    """Kernel, plain and cuDNN bf16 times in ms (plain, kernel, kernel, plain,
    then cuDNN). Returns the kernel's and the plain version's mean and the
    cuDNN time."""
    import torch

    with torch.no_grad():
        t_p = [cuda_ms(run_p, 50)]
        t_k = [cuda_ms(run_k, 50), cuda_ms(run_k, 50)]
        t_p.append(cuda_ms(run_p, 50))
        t_bf16 = cuda_ms(run_cudnn, 50)
    k_ms, p_ms = sum(t_k) / 2, sum(t_p) / 2
    print(f"time {label}: kernel {t_k} ms, plain f32 {t_p} ms, cuDNN bf16 layers {t_bf16} ms; "
          f"kernel {flop / k_ms / 1e9:.1f} TFLOP/s", flush=True)
    return k_ms, p_ms, t_bf16


def device_profile(label: str, run, calls: int, top: int = 6):
    """Device time by kernel over ``calls`` runs of ``run`` (torch.profiler),
    per call, beside the unprofiled wall time per call; the idle share is
    1 - device busy / wall, device busy being the union of the kernels'
    intervals. Returns ``(wall ms, kernel times summed ms, kernels, [(ms,
    launches, name)])`` per call, or None where the profiler saw no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    # a short spin kernel first and last: the profiler drops one launch of
    # the window, and it should be one of these, which are left out
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        for _ in range(calls):
            run()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    kernels = []  # (device ms per call, launches per call, name)
    for evt in prof.key_averages():
        if str(evt.device_type).endswith("CUDA") and "spin_kernel" not in evt.key:
            us = getattr(evt, "self_device_time_total", None)
            us = getattr(evt, "self_cuda_time_total", 0) if us is None else us
            kernels.append((us / 1e3 / calls, evt.count / calls, evt.key))
    busy = sum(k[0] for k in kernels)
    if busy <= 0:
        print(f"profile {label}: the profiler saw no device time; not measured", flush=True)
        return None
    n_kernels = sum(k[1] for k in kernels)
    # kernels launched with programmatic dependent launch (the wgmma conv
    # tile) start while the one before runs: the device is busy for the
    # union of the kernels' intervals, which their summed times overcount
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if str(e.device_type).endswith("CUDA") and "spin_kernel" not in e.name)
    union, end = 0.0, -math.inf
    for a, b in spans:
        union += max(0.0, b - max(a, end))
        end = max(end, b)
    busy_union = union / 1e3 / calls
    top_ = "; ".join(f"{name[:48]} {ms:.4f} ms x{n:g}"
                    for ms, n, name in sorted(kernels, reverse=True)[:top])
    print(f"profile {label}: wall {wall_ms:.3f} ms per call, device busy {busy_union:.3f} ms "
          f"(kernel times summed {busy:.3f} ms; {n_kernels:g} kernels), idle share "
          f"{1 - busy_union / wall_ms:.3f}; top: {top_}", flush=True)
    return wall_ms, busy, n_kernels, kernels


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def rel_max(a, b) -> float:
    """Max abs error of ``a`` over ``b``'s max magnitude."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def stash_vs_plain(label: str, h, ws, bs, cot, tile: str = "wgmma"):
    """K6 on ``tile`` against its plain version: one K6 launch and no K5
    launch per call, every stash slot within KERNEL_RTOL of its max. On the
    default tile also the stash backward on its kernels from the card's
    stash (cotangent ``cot``), for f32 and bf16 weights: L + 2 launches a
    call (``stash_backward.launches`` set to 0 just before), db the same bits
    in a second call, and dh, dW, db within STASH_BWD_RTOL of the plain
    backward. Returns the max abs error over the stash and the backward's
    max abs errors by output (bf16 weights; None on the mma.sync tile)."""
    import torch

    from deepinv_tpu_torch.ops.kernels.conv_chain import (
        _launch_stash, conv_chain, conv_chain_stash, conv_chain_stash_plain, pack_bias,
        pack_weights, stash_backward)

    conv_chain.launches = conv_chain_stash.launches = 0
    with torch.no_grad():
        got = (conv_chain_stash(h, ws, bs) if tile == "wgmma"
               else _launch_stash(h, pack_weights(ws), pack_bias(bs), tile))
        torch.cuda.synchronize()
        launches = (conv_chain_stash.launches, conv_chain.launches)
        want = conv_chain_stash_plain(h, ws, bs)
    check(launches == (1, 0), f"{label}: expected one K6 launch and no K5 launch, got {launches}")
    check(bool(torch.isfinite(got.float()).all()), f"non-finite stash: {label}")
    diff = (got.float() - want.float()).abs()
    slot_err = diff.amax(dim=(1, 2, 3, 4)) / want.float().abs().amax(dim=(1, 2, 3, 4))
    err = float(diff.max())
    print(f"{label}: max_abs_err {err}, per-slot relative max error max {float(slot_err.max())} "
          f"(bound {KERNEL_RTOL}), last slot {float(slot_err[-1])}", flush=True)
    check(float(slot_err.max()) <= KERNEL_RTOL, f"stash disagrees with plain: {label}")
    del want, diff
    if tile != "wgmma":
        return err, None
    L, bwd_err = ws.shape[0], {}
    # f32 weights (dW in f32, TF32) and bf16 weights (training under
    # autocast: dW as a bf16 cuDNN wgrad)
    for wdt in (torch.float32, torch.bfloat16):
        w = ws.to(wdt)
        stash_backward.launches = 0
        k = stash_backward(h, w, got, cot)
        torch.cuda.synchronize()
        n = stash_backward.launches
        check(n == L + 2, f"{label}: stash backward launched {n} kernels, not L + 2 = {L + 2}")
        again = stash_backward(h, w, got, cot)[2]
        check(torch.equal(again, k[2]), f"{label}: db differs between two runs on the same inputs")
        p = stash_backward(h, w, got, cot, plain=True)
        for name, a, b in zip(("dh", "dW", "db"), k, p):
            e, e2 = rel_max(a, b), rel_l2(a, b)
            print(f"{label} stash backward, {wdt} weights, {name}: relative max error {e} "
                  f"(bound {STASH_BWD_RTOL}), relative L2 {e2}", flush=True)
            check(bool(torch.isfinite(a.float()).all()) and e <= STASH_BWD_RTOL,
                  f"{label}: stash backward {name} disagrees with plain")
            if wdt == torch.bfloat16:
                bwd_err[name] = float((a.float() - b.float()).abs().max())
        print(f"{label} stash backward, {wdt} weights: {n} launches a call, db identical in two "
              "runs", flush=True)
    return err, bwd_err


def make_trainer(net, physics, xs, batch: int, fused: bool, losses=None):
    """``Trainer`` of ``ArtifactRemoval(autocast(copy of net))`` with Adam(1e-4)
    over ``xs`` in batches of ``batch``, online measurements, one epoch."""
    import torch

    from deepinv_tpu_torch.datasets import ArrayDataset, DataLoader
    from deepinv_tpu_torch.models import ArtifactRemoval, autocast
    from deepinv_tpu_torch.training import Trainer

    model = ArtifactRemoval(autocast(copy.deepcopy(net)))
    return Trainer(model, physics, optimizer=torch.optim.Adam(model.parameters(), lr=1e-4),
                   train_dataloader=DataLoader(ArrayDataset(xs), batch_size=batch),
                   losses=losses, epochs=1, online_measurements=True, verbose=False,
                   fused_chains=fused, seed=SEED)


def first_batch(trainer):
    """The trainer's first batch and its first step's measurement draw."""
    trainer.setup_train()
    batch = next(trainer.current_train_iterators[0])
    return trainer.get_samples(batch, trainer.physics[0], trainer.generator(0, 0, 0, 0))


def step_fn(trainer, x, y, physics):
    """One train step of ``trainer`` on a fixed batch, in its configuration."""
    def run():
        trainer.optimizer.zero_grad(set_to_none=True)
        with trainer._chains():
            loss, _ = trainer.compute_loss(trainer.model, x, y, physics)
            loss.backward()
        trainer.optimizer.step()
    return run


def first_step_grads(trainer):
    """The whole parameter gradient of the trainer's loss on its first batch."""
    import torch

    x, y, phys = first_batch(trainer)
    trainer.optimizer.zero_grad(set_to_none=True)
    with trainer._chains():
        trainer.compute_loss(trainer.model, x, y, phys)[0].backward()
    g = torch.cat([p.grad.reshape(-1).float() for p in trainer.model.parameters()])
    trainer.optimizer.zero_grad(set_to_none=True)
    return g


def train_epoch(trainer, epoch: int, dev) -> float:
    """Run epoch ``epoch`` of ``trainer`` through ``Trainer.train()``; wall s."""
    trainer.epoch_start, trainer.epochs = epoch, epoch + 1
    sync(dev)
    t0 = time.perf_counter()
    trainer.train()
    sync(dev)
    return time.perf_counter() - t0


def drunet_std(fan_in: int, gain: float = 1.0) -> float:
    """DRUNet's init scale: He-normal, with the 0.2 gain of its ResBlock convs."""
    return gain * (2.0 / fan_in) ** 0.5


def randn_on_card(gen, shape, std: float):
    """Normal draws from the CPU generator ``gen``, scaled, moved to the card."""
    import torch

    return (torch.randn(shape, generator=gen) * std).to("cuda")


def up_weights(gen, ci: int, R: int):
    """Random weights of DRUNet's m_up1 (Ci -> 64 transposed conv, R blocks)
    at its init scales, on the card."""
    def rn(shape, std):
        return randn_on_card(gen, shape, std)

    return (rn((ci, 64, 2, 2), drunet_std(4 * ci)), rn((R, 64, 64, 3, 3), drunet_std(576, 0.2)),
            rn((R, 64, 64, 3, 3), drunet_std(576, 0.2)))


def sandwich_weights(gen, R: int, ci2: int = 256):
    """Random weights of DRUNet's up tail at full width (m_up2 ci2 = 256 ->
    128 and R blocks at 128, m_down1's 64 -> 128 down conv, m_up1 128 -> 64
    and R blocks at 64) at its init scales, on the card, in up_sandwich's
    order."""
    def rn(shape, std):
        return randn_on_card(gen, shape, std)

    s1, s0 = drunet_std(128 * 9, 0.2), drunet_std(576, 0.2)
    return (rn((ci2, 128, 2, 2), drunet_std(4 * ci2)), rn((R, 128, 128, 3, 3), s1),
            rn((R, 128, 128, 3, 3), s1), rn((128, 64, 2, 2), drunet_std(256)),
            rn((128, 64, 2, 2), drunet_std(512)), rn((R, 64, 64, 3, 3), s0),
            rn((R, 64, 64, 3, 3), s0))


def up_ops(H2: int, W2: int, Ci: int, R: int, B: int = 1) -> float:
    """Operations of K2/K3: the projection GEMM and 2R 3x3 convs at 64."""
    H, W = 2 * H2, 2 * W2
    return B * (2 * H2 * W2 * Ci * 4 * 64 + R * 2 * (2 * H * W * 64 * 64 * 9))


def sandwich_ops(H2: int, W2: int, Ci2: int, R1: int, R0: int, B: int = 1) -> float:
    """Operations of K4 (``sandwich_cost``, deepinv_tpu/ops/pallas/
    resblock_chain.py:564): up2, the scale-1 chain at 128, the skip's down
    projection, up1, the scale-0 chain at 64."""
    p1 = 4 * H2 * W2   # scale-1 pixels
    return B * (2 * H2 * W2 * Ci2 * 4 * 128 + R1 * 2 * (2 * p1 * 128 * 128 * 9)
                + 2 * p1 * 256 * 128 + 2 * p1 * 128 * 256
                + R0 * 2 * (2 * 4 * p1 * 64 * 64 * 9))


def discs(rng, channels: int, size: int, n: int = 12):
    """Piecewise-constant phantom ``(channels, size, size)`` float32: random
    discs of random levels in each channel (like ``random_circles``,
    deepinv_tpu/datasets/phantoms.py:39)."""
    import numpy as np

    img = np.zeros((channels, size, size), np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    for _ in range(n):
        cy, cx = rng.integers(0, size, 2)
        r = rng.integers(size // 16, size // 4)
        img[:, (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = rng.random(channels)[:, None]
    return img


@contextlib.contextmanager
def plain_tv(priors):
    """Every ``TVPrior`` in ``priors`` on the plain prox inside the block."""
    old = [p.use_pallas for p in priors]
    for p in priors:
        p.use_pallas = False
    try:
        yield
    finally:
        for p, u in zip(priors, old):
            p.use_pallas = u


def tv_drive(name: str, model, y, physics, priors, x, naive, iters: int, op) -> int:
    """One TV reconstruction on the kernel path (``op.launches`` and
    ``op.launches_by_variant`` set to 0 just before it and read just after),
    checked: finite output shaped like ``x``, one prox launch per iteration,
    each on the resident variant, within TV_RECON_RTOL of the same run on the
    plain prox, and no worse than ``naive`` by more than TV_PSNR_SLACK_DB.
    Returns the launches."""
    import torch

    op.launches = 0
    for v in op.launches_by_variant:
        op.launches_by_variant[v] = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        out = model(y, physics)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches, by_variant = op.launches, dict(op.launches_by_variant)
    print(f"{name} {iters} it: first run {first_s:.3f} s, prox launches {launches} "
          f"{by_variant}", flush=True)
    check(launches == iters, f"{name}: expected {iters} prox launches, got {launches}")
    check(by_variant == {"resident": iters, "global": 0},
          f"{name}: expected {iters} resident prox launches, got {by_variant}")
    check(tuple(out.shape) == tuple(x.shape) and out.dtype == torch.float32,
          f"{name}: bad output shape/dtype")
    check(bool(torch.isfinite(out).all()), f"{name}: non-finite reconstruction")
    with plain_tv(priors), torch.no_grad():
        out_plain = model(y, physics)
    torch.cuda.synchronize()
    check(op.launches == launches, f"{name}: the plain run launched the kernel")
    rerr = float((out - out_plain).norm() / out_plain.norm())
    p_k, p_p, p_n = psnr(out, x), psnr(out_plain, x), psnr(naive, x)
    print(f"{name}: kernel vs plain prox relative L2 error {rerr} (bound {TV_RECON_RTOL}); "
          f"PSNR vs x: kernel {p_k:.4f} dB, plain {p_p:.4f} dB, naive {p_n:.4f} dB "
          f"(slack {TV_PSNR_SLACK_DB} dB)", flush=True)
    check(rerr <= TV_RECON_RTOL, f"{name}: reconstruction disagrees with the plain prox")
    check(p_k >= p_n - TV_PSNR_SLACK_DB, f"{name}: worse than the naive estimate")
    return launches


def build_tv_problems(dev, mask, size: int = 256, batch: int = 8):
    """The TV problems of phase 6, as the examples run them
    (examples/demo_tv_minimisation.py, demo_mri_tour.py, demo_ct_projectors.py,
    demo_basics.py), through the entry points with their default device.
    Returns ``[(name, model, y, physics, priors, x, naive, iterations)]``;
    ``priors`` are the ``TVPrior`` objects whose ``use_pallas`` selects the
    plain prox."""
    import numpy as np
    import torch

    from deepinv_tpu_torch.models import TVDenoiser
    from deepinv_tpu_torch.ops import gaussian_blur
    from deepinv_tpu_torch.optim import L2, PnP, TVPrior, optim_builder
    from deepinv_tpu_torch.physics import MRI, BlurFFT, GaussianNoise, Tomography

    rng = np.random.default_rng(SEED + 2)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    blur = BlurFFT((3, size, size), filter=gaussian_blur(sigma=2.0),
                   noise_model=GaussianNoise(0.02))
    x_blur = torch.from_numpy(discs(rng, 3, size)[None]).to(dev)
    x_batch = torch.from_numpy(np.stack([discs(rng, 3, size) for _ in range(batch)])).to(dev)
    mri = MRI(mask=mask, img_size=(size, size), noise_model=GaussianNoise(0.01))
    x_mri = torch.from_numpy(np.concatenate(
        [discs(rng, 1, size), np.zeros((1, size, size), np.float32)])[None]).to(dev)
    ct = Tomography(img_width=size, angles=90, method="slice", normalize=True,
                    noise_model=GaussianNoise(0.002))
    x_ct = torch.from_numpy(discs(rng, 1, size)[None]).to(dev)
    problems = []

    def add(name, algo, params, iters, phys, xt, naive_of, prior=None, **kw):
        tv = prior if prior is not None else TVPrior()
        model = optim_builder(algo, data_fidelity=L2(), prior=tv, params_algo=params,
                              max_iter=iters, **kw)
        yt = phys(xt, generator=gen)
        priors = [tv.denoiser.prior] if prior is not None else [tv]
        problems.append((name, model, yt, phys, priors, xt, naive_of(yt), iters))

    for algo, params in [("PGD", {"stepsize": 1.0, "lambda": 0.05}),
                         ("FISTA", {"stepsize": 1.0, "lambda": 0.05}),
                         ("ADMM", {"stepsize": 0.5, "lambda": 0.05}),
                         ("CP", {"stepsize": 0.5, "lambda": 0.05})]:
        add(f"TV-{algo} deblur 1x3x{size}²", algo, params, 30, blur, x_blur, lambda v: v)
    add(f"TV-PGD deblur {batch}x3x{size}²", "PGD", {"stepsize": 1.0, "lambda": 0.05}, 30, blur,
        x_batch, lambda v: v)
    add(f"TV-PGD MRI 1x2x{size}²", "PGD", {"stepsize": 1.0, "lambda": 0.002}, 20, mri, x_mri,
        mri.A_adjoint)
    add(f"TV-PGD CT {size}² from FBP", "PGD", {"stepsize": 1.0, "lambda": 5e-4}, 30, ct, x_ct,
        ct.A_dagger, custom_init=lambda v, p: p.A_dagger(v))
    add(f"PnP-HQS TVDenoiser(50) deblur 1x3x{size}²", "HQS", {"stepsize": 1.0, "g_param": 0.03},
        10, blur, x_blur, lambda v: v, prior=PnP(TVDenoiser(50)))
    return problems


def train_phase(dev, net, gen, size: int = 256, batches=TRAIN_BATCHES, steps: int = TRAIN_STEPS,
                profile: bool = True) -> int:
    """Phase 9: ``Trainer.train()`` of ``ArtifactRemoval(autocast(net))`` on
    ``Denoising(GaussianNoise(0.1))`` with ``SupLoss``, in both train-step
    configurations from the same weights, at each batch size: the launch
    counts (set to 0 just before each run, read just after), the losses and
    the first step's gradients checked; steps per second timed over a second
    and third epoch in turns; three steps profiled (a ``True`` step: 2L
    ``conv3x3_wgmma`` launches). Returns the K6 launches and the stash
    backward's kernel launches of the ``fused_chains=True`` runs."""
    import torch

    from deepinv_tpu_torch.ops.kernels.conv_chain import (conv_chain, conv_chain_stash,
                                                          stash_backward)
    from deepinv_tpu_torch.physics import Denoising, GaussianNoise

    physics = Denoising(GaussianNoise(0.1, device=dev))
    k6_launches = bwd_launches = 0
    for B in batches:
        xs = torch.rand((B, 1, size, size), generator=gen).to(dev).repeat(steps, 1, 1, 1)
        trainers = {f: make_trainer(net, physics, xs, B, f) for f in (False, True)}
        g_ref, g_k6 = first_step_grads(trainers[False]), first_step_grads(trainers[True])
        gerr = rel_max(g_k6, g_ref)
        print(f"train B={B}: first step's gradient, fused_chains=True vs False: relative max "
              f"error {gerr} (bound {GRAD_RTOL}), relative L2 {rel_l2(g_k6, g_ref)}", flush=True)
        check(gerr <= GRAD_RTOL, f"train B={B}: first-step gradients disagree")
        losses = {}
        for f, t in trainers.items():
            conv_chain.launches = conv_chain_stash.launches = stash_backward.launches = 0
            secs = train_epoch(t, 0, dev)
            n6, n5, nb = conv_chain_stash.launches, conv_chain.launches, stash_backward.launches
            losses[f] = t.logs_total_loss_train.vals
            print(f"train B={B} fused_chains={f}: {steps} steps in {secs:.3f} s (first epoch), "
                  f"K6 launches {n6}, K5 launches {n5}, stash backward launches {nb}, losses "
                  f"{losses[f]}", flush=True)
            want_b = steps * (L_MAIN + 2) if f else 0
            check((n6, n5, nb) == ((steps if f else 0), 0, want_b),
                  f"train B={B} fused_chains={f}: launches K6 {n6}, K5 {n5}, stash backward "
                  f"{nb} (expected {want_b})")
            check(len(losses[f]) == steps and all(math.isfinite(v) for v in losses[f]),
                  f"train B={B} fused_chains={f}: non-finite loss")
            check(losses[f][-1] < losses[f][0], f"train B={B} fused_chains={f}: loss did not fall")
            k6_launches += n6
            bwd_launches += nb
        lerr = max(abs(a - b) / abs(b) for a, b in zip(losses[True], losses[False]))
        print(f"train B={B}: per-step loss, fused_chains=True vs False: max relative error "
              f"{lerr} (bound {TRAIN_LOSS_RTOL})", flush=True)
        check(lerr <= TRAIN_LOSS_RTOL, f"train B={B}: losses of the two configurations disagree")
        times, epoch = {False: [], True: []}, {False: 1, True: 1}
        for f in (False, True, True, False):
            times[f].append(train_epoch(trainers[f], epoch[f], dev))
            epoch[f] += 1
        for f in (False, True):
            print(f"train B={B} fused_chains={f}: epochs of {steps} steps {times[f]} s; "
                  f"{steps * len(times[f]) / sum(times[f]):.2f} steps/s, "
                  f"{B * steps * len(times[f]) / sum(times[f]):.2f} images/s", flush=True)
        if profile:
            x, y, phys = first_batch(trainers[False])
            for f, t in trainers.items():
                label, run = f"train step B={B} fused_chains={f}", step_fn(t, x, y, phys)
                if f:   # K6's L layers and the backward's L dX layers on the tile
                    tile_in_profile(label, run, {"conv3x3_wgmma": 2 * L_MAIN}, top=8)
                else:
                    device_profile(label, run, 3, top=8)
    return k6_launches, bwd_launches


def ssl_phase(dev, net, gen, size: int = 256, batches=TRAIN_BATCHES, steps: int = SSL_STEPS):
    """Phase 10: ``Trainer.train()`` with ``SureGaussianLoss(0.1)`` +
    ``EILoss(Rotate())`` on 256² inpainting (mask 0.7, sigma 0.1) in the
    reference configuration: finite losses, no kernel launch (the gates are
    closed), steps per second over two more epochs; and SURE's JVP divergence
    against a finite difference of the f32 model."""
    import torch
    import torch.autograd.forward_ad as fwAD

    from deepinv_tpu_torch.loss import EILoss, SureGaussianLoss
    from deepinv_tpu_torch.models import ArtifactRemoval
    from deepinv_tpu_torch.ops.kernels.conv_chain import conv_chain, conv_chain_stash
    from deepinv_tpu_torch.physics import GaussianNoise, Inpainting
    from deepinv_tpu_torch.transform import Rotate

    physics = Inpainting((1, size, size), mask=0.7,
                         generator=torch.Generator().manual_seed(SEED + 10),
                         noise_model=GaussianNoise(0.1, device=dev), device=dev)
    for B in batches:
        xs = torch.rand((B * steps, 1, size, size), generator=gen).to(dev)
        t = make_trainer(net, physics, xs, B, False,
                         losses=[SureGaussianLoss(0.1), EILoss(Rotate())])
        conv_chain.launches = conv_chain_stash.launches = 0
        secs = train_epoch(t, 0, dev)
        vals = t.logs_total_loss_train.vals
        terms = [m.vals for m in t.logs_losses_train]
        print(f"EI+SURE B={B}: {steps} steps in {secs:.3f} s (first epoch), losses {vals}, "
              f"SURE {terms[0]}, EI {terms[1]}, launches K6 {conv_chain_stash.launches} "
              f"K5 {conv_chain.launches}", flush=True)
        check(len(vals) == steps and all(math.isfinite(v) for v in vals + terms[0] + terms[1]),
              f"EI+SURE B={B}: non-finite loss")
        check(conv_chain.launches == conv_chain_stash.launches == 0,
              f"EI+SURE B={B}: a kernel ran with the gates closed")
        times = [train_epoch(t, e, dev) for e in (1, 2)]
        print(f"EI+SURE B={B}: epochs of {steps} steps {times} s; "
              f"{steps * len(times) / sum(times):.2f} steps/s, "
              f"{B * steps * len(times) / sum(times):.2f} images/s", flush=True)

    # the divergence: forward-mode JVP (the loss's) vs a finite difference, f32
    model = ArtifactRemoval(copy.deepcopy(net))
    x = torch.rand((1, 1, size, size), generator=gen).to(dev)
    b = torch.randn((1, 1, size, size), generator=gen).to(dev)
    sure = SureGaussianLoss(0.1)
    with torch.no_grad():
        y = physics(x, generator=torch.Generator(device=dev).manual_seed(SEED + 11))
        f = lambda u: physics.A(model(u, physics))
        fy = f(y)
        mse = ((fy - y) ** 2).mean()
        div_jvp = float((sure(y=y, physics=physics, model=model, probe=b)[0] - mse + sure.sigma2)
                        / (2 * sure.sigma2))
        fd = (f(y + JVP_TAU * b) - fy) / JVP_TAU
        div_fd = float((b * fd).mean())
        with fwAD.dual_level():
            jvp = fwAD.unpack_dual(f(fwAD.make_dual(y, b))).tangent
    err = abs(div_jvp - div_fd) / abs(div_fd)
    print(f"SURE divergence (f32 model, 1x1x{size}²): JVP {div_jvp}, finite difference "
          f"(tau {JVP_TAU}) {div_fd}, relative error {err} (bound {JVP_RTOL}); JVP vs finite "
          f"difference relative L2 {rel_l2(jvp, fd)}", flush=True)
    check(err <= JVP_RTOL, "SURE's JVP divergence disagrees with the finite difference")


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
    from deepinv_tpu_torch.ops.kernels.conv_chain import _launch as cc_launch
    from deepinv_tpu_torch.ops.kernels.conv_chain import _launch_stash as cc_launch_stash
    from deepinv_tpu_torch.ops.kernels.conv_chain import (
        chain_f32, conv_chain, conv_chain_plain, conv_chain_stash, conv_chain_stash_plain,
        fused_chains_disabled, pack_bias, stash_backward)
    from deepinv_tpu_torch.ops.kernels.resblock_chain import _launch as rc_launch
    from deepinv_tpu_torch.ops.kernels.resblock_chain import (
        pack_weights, resblock_chain, resblock_chain_plain)
    from deepinv_tpu_torch.ops.kernels.tv import _launch as tv_launch
    from deepinv_tpu_torch.ops.kernels.tv import _resident_clusters as tv_clusters
    from deepinv_tpu_torch.ops.kernels.tv import chambolle_prox, chambolle_prox_plain, tv_plan
    from deepinv_tpu_torch.ops.kernels.conv_tile import conv128_tile_plan
    from deepinv_tpu_torch.ops.kernels.up_resblock_chain import _launch as up_launch
    from deepinv_tpu_torch.ops.kernels.up_resblock_chain import (
        pack_up_chain, up_resblock_chain, up_resblock_chain_plain)
    from deepinv_tpu_torch.ops.kernels.up_sandwich import _c128_clusters, _chain128
    from deepinv_tpu_torch.ops.kernels.up_sandwich import _launch as sw_launch
    from deepinv_tpu_torch.ops.kernels.up_sandwich import (
        pack_sandwich, up_sandwich, up_sandwich_plain)
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
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    sass_tile_check(build.cuda_tool("cuobjdump"), build.library_path())

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
            kernel_vs_plain(f"kernel (mma.sync tile) vs plain {shape} R={R}",
                            lambda v: rc_launch(v, pack_weights(w1), pack_weights(w2), "mma"),
                            lambda v: resblock_chain_plain(v, w1, w2), h, KERNEL_RTOL)
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
            kernel_vs_plain(f"conv_chain (mma.sync tile) vs plain {shape} L={L}",
                            lambda v: cc_launch(v, pack_weights(ws), pack_bias(bs), "mma"),
                            lambda v: conv_chain_plain(v, ws, bs), h, KERNEL_RTOL)
    # the wgmma tile at the HQS batch and tap by tap, on its own generator (the
    # later phases draw from g what they drew before)
    g_tile = torch.Generator().manual_seed(SEED + 14)
    h = torch.randn(TILE_B8_SHAPE, generator=g_tile).to(dev, torch.bfloat16)
    w1 = (torch.randn((R_MAIN, 64, 64, 3, 3), generator=g_tile) * std).to(dev)
    w2 = (torch.randn((R_MAIN, 64, 64, 3, 3), generator=g_tile) * std).to(dev)
    kernel_vs_plain(f"kernel vs plain {TILE_B8_SHAPE} R={R_MAIN}",
                    lambda v: resblock_chain(v, w1, w2),
                    lambda v: resblock_chain_plain(v, w1, w2), h, KERNEL_RTOL)
    ws = (torch.randn((L_MAIN, 64, 64, 3, 3), generator=g_tile) * he_std).to(dev)
    bs = (torch.randn((L_MAIN, 64), generator=g_tile) * 0.02).to(dev)
    kernel_vs_plain(f"conv_chain vs plain {TILE_B8_SHAPE} L={L_MAIN}",
                    lambda v: conv_chain(v, ws, bs), lambda v: conv_chain_plain(v, ws, bs), h,
                    KERNEL_RTOL)
    h = torch.randn(TAP_SHAPE, generator=g_tile).to(dev, torch.bfloat16)
    b0 = torch.zeros((1, 64), device=dev)
    for tap in range(9):
        wt = torch.zeros((1, 64, 64, 3, 3))
        wt[0, :, :, tap // 3, tap % 3] = torch.randn((64, 64), generator=g_tile) * 3 * he_std
        wt = wt.to(dev)
        kernel_vs_plain(f"conv_chain tap (dy, dx) = {divmod(tap, 3)} alone vs plain {TAP_SHAPE}",
                        lambda v: conv_chain(v, wt, b0), lambda v: conv_chain_plain(v, wt, b0),
                        h, KERNEL_RTOL)
    tv_err = None
    # its own generator: the later phases draw from g what they drew before K7
    g_tv = torch.Generator().manual_seed(SEED + 4)
    for shape, gammas in TV_SHAPES:
        xt = torch.rand(shape, generator=g_tv).to(dev)
        gam = torch.tensor(gammas).reshape(-1, 1, 1, 1).to(dev)
        plan = tv_plan(*shape[-2:], planes=math.prod(shape[:-2]))
        want = "global" if shape[-2:] == (1024, 1024) else "resident"
        check(plan.variant == want, f"tv_prox {shape}: the plan picks {plan}, not {want}")
        # the plan's layout through the op; at the main shape also phase 7's
        # other layouts, and 0 and 1 steps
        runs = [(plan, None, None, TV_ITERS)]
        if shape == TV_SHAPES[0][0]:
            runs += [(tv_plan(*shape[-2:], var, cl), var, cl, TV_ITERS)
                     for _, var, cl in TV_LAYOUTS]
            runs += [(plan, None, None, 0), (plan, None, None, 1)]
        for lay, var, cl, n in runs:
            before = dict(chambolle_prox.launches_by_variant)
            err = kernel_vs_plain(
                f"tv_prox vs plain {shape} gamma={gammas} n_iter={n}, {lay.variant} variant"
                + (f", cluster {lay.cluster}" if lay.variant == "resident" else ""),
                (lambda t: chambolle_prox(t, gam, n)) if var is None and cl is None else
                (lambda t: tv_launch(t, gam, n, var, cl)),
                lambda t: chambolle_prox_plain(t, gam, n),
                xt, TV_RTOL, by_range=True)
            ran = {k: chambolle_prox.launches_by_variant[k] - before[k] for k in before}
            check(ran[lay.variant] == 1 and sum(ran.values()) == 1,
                  f"tv_prox {shape}: expected one {lay.variant} launch, got {ran}")
            if lay.variant == "resident" and n == TV_ITERS:
                print(f"  {lay}: {tv_clusters(lay)} such clusters fit the card at once",
                      flush=True)
            if tv_err is None:
                tv_err = err
    # K2/K3 and K4 on their own generators, so that the later phases draw
    # from g and g_tv what they drew before
    g_up = torch.Generator().manual_seed(SEED + 5)
    up_err = None
    for shape, R in UP_SHAPES:
        v = torch.randn(shape, generator=g_up).to(dev, torch.bfloat16)
        wu, w1, w2 = up_weights(g_up, shape[1], R)
        err = kernel_vs_plain(f"up_resblock_chain vs plain {shape} R={R}",
                              lambda t: up_resblock_chain(t, wu, w1, w2),
                              lambda t: up_resblock_chain_plain(t, wu, w1, w2), v, KERNEL_RTOL)
        if up_err is None:
            up_err = err
    g_sw = torch.Generator().manual_seed(SEED + 6)
    sw_err = None
    for B, H2, W2 in SANDWICH_SHAPES:
        s2 = torch.randn((B, 256, H2, W2), generator=g_sw).to(dev, torch.bfloat16)
        d0 = torch.randn((B, 64, 4 * H2, 4 * W2), generator=g_sw).to(dev, torch.bfloat16)
        wts = sandwich_weights(g_sw, R_MAIN)
        err = kernel_vs_plain(f"up_sandwich vs plain s2 {tuple(s2.shape)} d0 {tuple(d0.shape)} "
                              f"R1=R0={R_MAIN}", lambda t: up_sandwich(t, d0, *wts),
                              lambda t: up_sandwich_plain(t, d0, *wts), s2, KERNEL_RTOL)
        if sw_err is None:
            sw_err = err
    # K2/K3 and K4 at the HQS batch, and on the earlier mma.sync kernels at
    # the main shape; own generator, so that the later phases draw what they
    # drew before
    g_b8 = torch.Generator().manual_seed(SEED + 17)
    v = torch.randn(UP_SHAPES[0][0], generator=g_b8).to(dev, torch.bfloat16)
    wu, w1, w2 = up_weights(g_b8, v.shape[1], R_MAIN)
    kernel_vs_plain(f"up_resblock_chain (mma.sync) vs plain {tuple(v.shape)} R={R_MAIN}",
                    lambda t: up_launch(t, *pack_up_chain(wu, w1, w2), "mma"),
                    lambda t: up_resblock_chain_plain(t, wu, w1, w2), v, KERNEL_RTOL)
    v = torch.randn(UP_B8_SHAPE, generator=g_b8).to(dev, torch.bfloat16)
    kernel_vs_plain(f"up_resblock_chain vs plain {UP_B8_SHAPE} R={R_MAIN}",
                    lambda t: up_resblock_chain(t, wu, w1, w2),
                    lambda t: up_resblock_chain_plain(t, wu, w1, w2), v, KERNEL_RTOL)
    wts = sandwich_weights(g_b8, R_MAIN)
    for (B, H2, W2), tile in ((SANDWICH_SHAPES[0], "mma"), (SANDWICH_B8, "wgmma")):
        s2 = torch.randn((B, 256, H2, W2), generator=g_b8).to(dev, torch.bfloat16)
        d0 = torch.randn((B, 64, 4 * H2, 4 * W2), generator=g_b8).to(dev, torch.bfloat16)
        kernel_vs_plain(f"up_sandwich ({tile}) vs plain s2 {tuple(s2.shape)} d0 "
                        f"{tuple(d0.shape)} R1=R0={R_MAIN}",
                        lambda t: sw_launch(t, d0, pack_sandwich(*wts), tile),
                        lambda t: up_sandwich_plain(t, d0, *wts), s2, KERNEL_RTOL)
    # projection inputs past 256 channels (the streamed weight chunks)
    g_wide = torch.Generator().manual_seed(SEED + 18)
    shape, R = UP_WIDE
    v = torch.randn(shape, generator=g_wide).to(dev, torch.bfloat16)
    wu, w1, w2 = up_weights(g_wide, shape[1], R)
    kernel_vs_plain(f"up_resblock_chain vs plain {shape} R={R} (Ci past 256)",
                    lambda t: up_resblock_chain(t, wu, w1, w2),
                    lambda t: up_resblock_chain_plain(t, wu, w1, w2), v, KERNEL_RTOL)
    B, H2, W2, ci2 = SANDWICH_WIDE
    wts = sandwich_weights(g_wide, R_MAIN, ci2)
    s2 = torch.randn((B, ci2, H2, W2), generator=g_wide).to(dev, torch.bfloat16)
    d0 = torch.randn((B, 64, 4 * H2, 4 * W2), generator=g_wide).to(dev, torch.bfloat16)
    kernel_vs_plain(f"up_sandwich vs plain s2 {tuple(s2.shape)} d0 {tuple(d0.shape)} "
                    f"R1=R0={R_MAIN} (Ci2 past 256)", lambda t: up_sandwich(t, d0, *wts),
                    lambda t: up_sandwich_plain(t, d0, *wts), s2, KERNEL_RTOL)
    # the 128-channel cluster tile alone: one block (R=1), held by its
    # residual branch out - h (the residual dominates the output); then each
    # tap and K-block alone (conv1 that one 64 x 64 block, conv2 the identity)
    clusters = _c128_clusters(dev.index)
    s1 = drunet_std(128 * 9)
    for shape in TILE128_SHAPES:
        plan = conv128_tile_plan(shape[0], *shape[2:], clusters)
        print(f"  128-channel tile plan at {shape}: {plan} ({clusters} clusters fit)", flush=True)
        h = torch.randn(shape, generator=g_b8).to(dev, torch.bfloat16)
        wc1, wc2 = randn_on_card(g_b8, (1, 128, 128, 3, 3), s1), randn_on_card(
            g_b8, (1, 128, 128, 3, 3), s1)
        pk1, pk2 = pack_weights(wc1), pack_weights(wc2)
        kernel_vs_plain(f"128-channel tile, one block, branch out - h, vs plain {shape}",
                        lambda t: _chain128(t, pk1, pk2).float() - t.float(),
                        lambda t: resblock_chain_plain(t, wc1, wc2).float() - t.float(), h,
                        KERNEL_RTOL)
    check(plan.strips == 2, f"the tap shape {shape} is not two strips: {plan}")
    print(f"  tap shape {shape}: last band {shape[2] - (plan.bands - 1) * plan.rows_per_cta} "
          f"rows of {plan.rows_per_cta}", flush=True)
    eye = torch.zeros((1, 128, 128, 3, 3))
    eye[0, :, :, 1, 1] = torch.eye(128)
    eye = eye.to(dev)
    for tap in range(9):
        for kb in range(2):
            wt = torch.zeros((1, 128, 128, 3, 3))
            wt[0, :, 64 * kb:64 * kb + 64, tap // 3, tap % 3] = torch.randn(
                (128, 64), generator=g_b8) * 3 * s1
            wt = wt.to(dev)
            pkt, pke = pack_weights(wt), pack_weights(eye)
            kernel_vs_plain(f"128-channel tile tap (dy, dx) = {divmod(tap, 3)} K-block {kb} "
                            f"alone, branch, vs plain {shape}",
                            lambda t: _chain128(t, pkt, pke).float() - t.float(),
                            lambda t: resblock_chain_plain(t, wt, eye).float() - t.float(), h,
                            KERNEL_RTOL)
    # K6 (the stash forward) and its stash backward, on its own generator; K6
    # also on the mma.sync tile at the main shape
    g_k6 = torch.Generator().manual_seed(SEED + 9)
    stash_err = bwd_err = None
    for shape, L in CHAIN_SHAPES + [(TRAIN_B16_SHAPE, L_MAIN), (TAP_SHAPE, 3)]:
        h = torch.randn(shape, generator=g_k6).to(dev, torch.bfloat16)
        ws = (torch.randn((L, 64, 64, 3, 3), generator=g_k6) * he_std).to(dev)
        bs = (torch.randn((L, 64), generator=g_k6) * 0.02).to(dev)
        cot = torch.randn(shape, generator=g_k6).to(dev)
        err, berr = stash_vs_plain(f"conv_chain_stash vs plain {shape} L={L}", h, ws, bs, cot)
        if stash_err is None:
            stash_err, bwd_err = err, berr
            stash_vs_plain(f"conv_chain_stash (mma.sync tile) vs plain {shape} L={L}", h, ws, bs,
                           cot, tile="mma")
        del h, cot

    # 4. the HQS bench problem, kernel path, then the plain chain on the card;
    # physics, models and reconstructors are on the GPU by default
    shape = (1, 3, 256, 256)
    physics = BlurFFT(shape[1:], filter=gaussian_blur(sigma=1.5),
                      noise_model=GaussianNoise(0.01))
    x = torch.rand(shape, generator=g).to(dev)
    y = physics(x, generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    denoiser = autocast(DRUNet(nc=(64, 128, 256, 512), nb=R_MAIN, generator=g))
    model = optim_builder("HQS", data_fidelity=L2(), prior=PnP(denoiser),
                          params_algo={"stepsize": 2.0, "g_param": 0.02}, max_iter=MAX_ITER)

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

    def plain_drunet():
        """Every DRUNet kernel op on its plain version instead of the kernel."""
        stack = contextlib.ExitStack()
        for name, fn in (("resblock_chain", resblock_chain_plain),
                         ("up_resblock_chain", up_resblock_chain_plain),
                         ("up_sandwich", up_sandwich_plain)):
            stack.enter_context(swapped(drunet_mod, name, lambda *a, fn=fn, packed=None: fn(*a)))
        return stack

    def hqs_in(mode: str):
        """The HQS model and denoiser with the same weights in configuration ``mode``."""
        den = copy.deepcopy(denoiser)
        den.denoiser.fused = mode
        return optim_builder("HQS", data_fidelity=L2(), prior=PnP(den),
                             params_algo={"stepsize": 2.0, "g_param": 0.02},
                             max_iter=MAX_ITER), den

    # the same problem and weights in the other configurations
    hqs_models = {"down": (model, denoiser), "0": hqs_in("0")}
    config_launches = {}
    for mode, op in (("both", up_resblock_chain), ("sandwich", up_sandwich)):
        m, den = hqs_in(mode)
        out_m, out_mp, config_launches[mode] = drive(
            f"HQS {mode}", m, y, physics, den.denoiser, (op, resblock_chain), plain_drunet,
            shape)
        pm_k, pm_p = psnr(out_m, x), psnr(out_mp, x)
        print(f"HQS {mode} PSNR vs x: kernel {pm_k:.4f} dB, plain {pm_p:.4f} dB; vs the down "
              f"run: relative L2 {float((out_m - out).norm() / out.norm())}", flush=True)
        check(abs(pm_k - pm_p) <= RECON_PSNR_DB, f"HQS {mode}: PSNR gap to the plain run too large")
        hqs_models[mode] = (m, den)

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
        "MRI": (MRI(mask=mask, img_size=(256, 256)),
                torch.randn((1, 2, 256, 256), generator=g).to(dev)),
        "CT": (Tomography(img_width=256, angles=90, method="slice", normalize=True),
               torch.rand((1, 1, 256, 256), generator=g).to(dev)),
    }
    pgd, pgd_models, chain_launches = {}, {}, 0
    for name, (phys, xt) in problems.items():
        c = xt.shape[1]
        net = DnCNN(c, c, depth=20, nf=64, generator=g)
        with torch.no_grad():
            net.out_conv.weight.mul_(DNCNN_RESIDUAL_SCALE)
        den = autocast(net)
        m = optim_builder("PGD", data_fidelity=L2(), prior=PnP(den), params_algo=PGD_PARAMS,
                          max_iter=MAX_ITER)
        yt = phys.A(xt)
        out, out_plain, n = drive(f"PGD {name}", m, yt, phys, den.denoiser, conv_chain,
                                  plain_conv_chain, tuple(xt.shape), exact_conv_chain)
        chain_launches += n
        print(f"PGD {name} PSNR vs x: kernel {psnr(out, xt):.4f} dB, plain "
              f"{psnr(out_plain, xt):.4f} dB, A^T y {psnr(phys.A_adjoint(yt), xt):.4f} dB; "
              f"max |x_hat| {float(out.abs().max())}, max |x| {float(xt.abs().max())}",
              flush=True)
        pgd[name] = recon(m, yt, phys)
        pgd_models[name] = (m, den, phys)
    # the same problems at B=8 (images on their own generator), held the same way
    g_pgd8 = torch.Generator().manual_seed(SEED + 15)
    pgd8 = {}
    for name, (m, den, phys) in pgd_models.items():
        xt = problems[name][1]
        xt8 = (torch.randn if name == "MRI" else torch.rand)(
            (HQS_BATCH,) + tuple(xt.shape[1:]), generator=g_pgd8).to(dev)
        yt8 = phys.A(xt8)
        drive(f"PGD {name} B={HQS_BATCH}", m, yt8, phys, den.denoiser, conv_chain,
              plain_conv_chain, tuple(xt8.shape), exact_conv_chain)
        pgd8[name] = recon(m, yt8, phys)
    ct, xct = problems["CT"]
    with torch.no_grad():
        fast, slow = ct.A_adjoint_A(xct), ct.A_adjoint(ct.A(xct))
    nerr = float((fast - slow).norm() / slow.norm())
    print(f"CT A_adjoint_A (Toeplitz) vs A_adjoint(A(x)): relative L2 error {nerr} "
          f"(bound {CT_NORMAL_RTOL})", flush=True)
    check(bool(torch.isfinite(fast).all()) and nerr <= CT_NORMAL_RTOL,
          "CT Toeplitz normal operator disagrees with A_adjoint(A(x))")

    # 6. the TV problems at the bench sizes, f32
    tv_problems = build_tv_problems(dev, mask)
    tv_launches = 0
    for name, tv_model, yt, phys, priors, xt, naive, iters in tv_problems:
        tv_launches += tv_drive(name, tv_model, yt, phys, priors, xt, naive, iters,
                                chambolle_prox)

    # 7. times, in turns; channels_last inputs, as DRUNet and DnCNN hand the chains
    h = torch.randn(KERNEL_SHAPES[0][0], generator=g).to(dev, torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    w1 = (torch.randn((R_MAIN, 64, 64, 3, 3), generator=g) * std).to(dev)
    w2 = (torch.randn((R_MAIN, 64, 64, 3, 3), generator=g) * std).to(dev)
    packed = (pack_weights(w1), pack_weights(w2))
    w1b, w2b = ([w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last) for w in ws]
                for ws in (w1, w2))

    def cudnn_bf16_resblocks(v):  # the chain as cuDNN bf16 layers, two roundings per block
        for r in range(R_MAIN):
            t = torch.relu(F.conv2d(v, w1b[r], padding=1))
            v = v + F.conv2d(t, w2b[r], padding=1)
        return v

    flop_conv = 2 * 256 * 256 * 64 * 64 * 9
    k_ms, p_ms, k_lib_ms = time_chain(
        f"(1,64,256,256) R={R_MAIN}", lambda: resblock_chain(h, w1, w2, packed),
        lambda: resblock_chain_plain(h, w1, w2), lambda: cudnn_bf16_resblocks(h),
        R_MAIN * 2 * flop_conv)

    ws = (torch.randn((L_MAIN, 64, 64, 3, 3), generator=g) * he_std).to(dev)
    bs = (torch.randn((L_MAIN, 64), generator=g) * 0.02).to(dev)
    chain_packed = (pack_weights(ws), pack_bias(bs))
    wsb = [w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last) for w in ws]
    bsb = bs.to(torch.bfloat16)

    def cudnn_bf16_chain(v):  # the chain as cuDNN bf16 layers, bias added by cuDNN
        for l in range(L_MAIN):
            v = torch.relu(F.conv2d(v, wsb[l], bsb[l], padding=1))
        return v

    ck_ms, cp_ms, ck_lib_ms = time_chain(
        f"(1,64,256,256) L={L_MAIN}", lambda: conv_chain(h, ws, bs, chain_packed),
        lambda: conv_chain_plain(h, ws, bs), lambda: cudnn_bf16_chain(h), L_MAIN * flop_conv)

    # K1 and K5 on the wgmma tile, on the mma.sync tile and as cuDNN bf16
    # layers, in turns, at B=1 and at the HQS batch (its own generator)
    g_t8 = torch.Generator().manual_seed(SEED + 16)
    h8 = torch.randn(TILE_B8_SHAPE, generator=g_t8).to(dev, torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    tiles = {}
    for b, xb in ((1, h), (HQS_BATCH, h8)):
        reps = 50 if b == 1 else 10
        tiles["K1", b] = tile_turns(
            f"resblock_chain {tuple(xb.shape)} R={R_MAIN}",
            {"wgmma": lambda: resblock_chain(xb, w1, w2, packed),
             "mma.sync": lambda: rc_launch(xb, *packed, "mma"),
             "cuDNN": lambda: cudnn_bf16_resblocks(xb)}, b * R_MAIN * 2 * flop_conv, reps)
        tiles["K5", b] = tile_turns(
            f"conv_chain {tuple(xb.shape)} L={L_MAIN}",
            {"wgmma": lambda: conv_chain(xb, ws, bs, chain_packed),
             "mma.sync": lambda: cc_launch(xb, *chain_packed, "mma"),
             "cuDNN": lambda: cudnn_bf16_chain(xb)}, b * L_MAIN * flop_conv, reps)

    # K7 at 1x3x256², 100 iterations: plain, kernel, kernel, plain
    tv_shape, tv_gamma = TV_SHAPES[0][0], TV_SHAPES[0][1][0]
    xt = torch.rand(tv_shape, generator=g_tv).to(dev)
    gam = torch.tensor(tv_gamma).to(dev)
    with torch.no_grad():
        t_p = [cuda_ms(lambda: chambolle_prox_plain(xt, gam, TV_ITERS), 3, warmup=1)]
        t_k = [cuda_ms(lambda: chambolle_prox(xt, gam, TV_ITERS), 50) for _ in range(2)]
        t_p.append(cuda_ms(lambda: chambolle_prox_plain(xt, gam, TV_ITERS), 3, warmup=1))
    tk_ms, tp_ms = sum(t_k) / 2, sum(t_p) / 2
    pixels = math.prod(tv_shape)
    # per pixel per iteration ~17 float32 operations and a sqrt (tv.py:58-63),
    # plus x / gamma and the output x - gamma div p once
    tv_ops = pixels * (18 * TV_ITERS + 5)
    tv_main = tv_plan(*tv_shape[-2:], planes=math.prod(tv_shape[:-2]))
    print(f"time tv_prox {tv_shape} n_iter={TV_ITERS} ({tv_main.variant} variant, cluster "
          f"{tv_main.cluster}): kernel {t_k} ms, plain {t_p} ms; "
          f"{tv_ops / tk_ms / 1e9:.3f} TFLOP/s", flush=True)
    # the layouts in turns on the same inputs: global, resident in clusters of
    # 8 and 16, then back; CUDA events over back-to-back proxes
    tv_layout_ms = {}
    for shp in TV_TIME_SHAPES:
        xs = torch.rand(shp, generator=g_tv).to(dev)
        times = {label: [] for label, _, _ in TV_LAYOUTS}
        with torch.no_grad():
            for label, var, cl in TV_LAYOUTS + TV_LAYOUTS[::-1]:
                times[label].append(cuda_ms(lambda: tv_launch(xs, gam, TV_ITERS, var, cl), 20))
        tv_layout_ms[shp] = {k: sum(t) / len(t) for k, t in times.items()}
        print(f"time tv_prox {shp} n_iter={TV_ITERS} by layout, in turns (ms): {times}; the "
              f"plan's: {tv_plan(*shp[-2:], planes=math.prod(shp[:-2]))}", flush=True)
    # the resident kernel's floor: a step on a plane of one (cluster 16) or two
    # (cluster 8) rows a CTA is little more than its two barriers
    x_floor = torch.rand((1, 1, 16, 32), generator=g_tv).to(dev)
    tv_floor_us = {}
    for cl in (8, 16):
        with torch.no_grad():
            t_lo, t_hi = (cuda_ms(lambda: tv_launch(x_floor, gam, n, "resident", cl), 20)
                          for n in TV_FLOOR_STEPS)
        tv_floor_us[cl] = (t_hi - t_lo) * 1e3 / (TV_FLOOR_STEPS[1] - TV_FLOOR_STEPS[0])
    print(f"tv_prox resident barrier floor (16x32 plane, per step): {tv_floor_us} µs; for "
          f"{TV_ITERS} steps {tv_floor_us[16] * TV_ITERS / 1e3:.4f} ms (cluster 16)", flush=True)

    # K2/K3 and K4 at the bench shapes, channels_last as DRUNet hands them
    g_t = torch.Generator().manual_seed(SEED + 7)

    def bf16_cl(t):
        return t.to(dev, torch.bfloat16).contiguous(memory_format=torch.channels_last)

    up_shape = UP_SHAPES[0][0]
    v = bf16_cl(torch.randn(up_shape, generator=g_t))
    wu, uw1, uw2 = up_weights(g_t, up_shape[1], R_MAIN)
    up_pk = pack_up_chain(wu, uw1, uw2)
    wub = wu.to(torch.bfloat16)
    uw1b, uw2b = ([w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last) for w in ws_]
                  for ws_ in (uw1, uw2))

    def cudnn_bf16_up(v):  # F.conv_transpose2d and 8 convs, two roundings per block
        t = F.conv_transpose2d(v, wub, stride=2)
        for r in range(R_MAIN):
            t = t + F.conv2d(torch.relu(F.conv2d(t, uw1b[r], padding=1)), uw2b[r], padding=1)
        return t

    def time_up(v):
        b, ci, h2, w2 = v.shape
        return time_chain(f"up_resblock_chain {tuple(v.shape)} R={R_MAIN}",
                          lambda: up_resblock_chain(v, wu, uw1, uw2, up_pk),
                          lambda: up_resblock_chain_plain(v, wu, uw1, uw2),
                          lambda: cudnn_bf16_up(v), up_ops(h2, w2, ci, R_MAIN, b))

    up_flop = up_ops(*up_shape[2:], up_shape[1], R_MAIN)
    uk_ms, up_ms, uk_lib_ms = time_up(v)

    b_s, h2s, w2s = SANDWICH_SHAPES[0]
    s2 = bf16_cl(torch.randn((b_s, 256, h2s, w2s), generator=g_t))
    d0 = bf16_cl(torch.randn((b_s, 64, 4 * h2s, 4 * w2s), generator=g_t))
    sw = sandwich_weights(g_t, R_MAIN)
    sw_pk = pack_sandwich(*sw)
    # bf16 channels_last weights for cuDNN; a stack of convs becomes a list of layers
    swb = [[bf16_cl(l) for l in w] if w.dim() == 5 else bf16_cl(w) for w in sw]

    def cudnn_bf16_sandwich(s2, d0):  # the up tail as cuDNN bf16 layers
        t = F.conv_transpose2d(s2, swb[0], stride=2)
        for r in range(R_MAIN):
            t = t + F.conv2d(torch.relu(F.conv2d(t, swb[1][r], padding=1)), swb[2][r], padding=1)
        t = F.conv_transpose2d(t + F.conv2d(d0, swb[3], stride=2), swb[4], stride=2)
        for r in range(R_MAIN):
            t = t + F.conv2d(torch.relu(F.conv2d(t, swb[5][r], padding=1)), swb[6][r], padding=1)
        return t

    def time_sandwich(s2, d0):
        label = f"up_sandwich s2 {tuple(s2.shape)} d0 {tuple(d0.shape)} R1=R0={R_MAIN}"
        return time_chain(label, lambda: up_sandwich(s2, d0, *sw, sw_pk),
                          lambda: up_sandwich_plain(s2, d0, *sw),
                          lambda: cudnn_bf16_sandwich(s2, d0),
                          sandwich_ops(*s2.shape[2:], 256, R_MAIN, R_MAIN, s2.shape[0]))

    sw_flop = sandwich_ops(h2s, w2s, 256, R_MAIN, R_MAIN)
    sk_ms, sp_ms, sk_lib_ms = time_sandwich(s2, d0)
    # K2/K3 and K4 on their wgmma kernels, on the earlier mma.sync kernels and
    # as cuDNN bf16 layers, in turns, at B=1 and at the HQS batch (the JAX
    # gates fuse at B = 1 only)
    v8 = bf16_cl(torch.randn((HQS_BATCH,) + up_shape[1:], generator=g_t))
    s2_8 = bf16_cl(torch.randn((HQS_BATCH,) + s2.shape[1:], generator=g_t))
    d0_8 = bf16_cl(torch.randn((HQS_BATCH,) + d0.shape[1:], generator=g_t))
    for b, vb, s2b, d0b in ((1, v, s2, d0), (HQS_BATCH, v8, s2_8, d0_8)):
        reps = 50 if b == 1 else 10
        tiles["K2/K3", b] = tile_turns(
            f"up_resblock_chain {tuple(vb.shape)} R={R_MAIN}",
            {"wgmma": lambda: up_resblock_chain(vb, wu, uw1, uw2, up_pk),
             "mma.sync": lambda: up_launch(vb, *up_pk, "mma"),
             "cuDNN": lambda: cudnn_bf16_up(vb)}, b * up_flop, reps)
        tiles["K4", b] = tile_turns(
            f"up_sandwich s2 {tuple(s2b.shape)} d0 {tuple(d0b.shape)} R1=R0={R_MAIN}",
            {"wgmma": lambda: up_sandwich(s2b, d0b, *sw, sw_pk),
             "mma.sync": lambda: sw_launch(s2b, d0b, sw_pk, "mma"),
             "cuDNN": lambda: cudnn_bf16_sandwich(s2b, d0b)}, b * sw_flop, reps)
    sets = [(s2.clone(), d0.clone(), pack_sandwich(*sw)) for _ in range(MAP_SETS)]
    issue_turns(f"K4 s2 {tuple(s2.shape)}: its maps memoised (one set) or not ({MAP_SETS} sets)",
                {"one set": [lambda: up_sandwich(s2, d0, *sw, sw_pk)],
                 f"{MAP_SETS} sets": [lambda a=a: up_sandwich(a[0], a[1], *sw, a[2])
                                      for a in sets]}, MAP_REPS)
    del sets

    # the DRUNet forward and HQS in each configuration, B=1 and B=8, in turns
    x8 = torch.rand((HQS_BATCH,) + shape[1:], generator=g_t).to(dev)
    y8 = physics(x8, generator=torch.Generator(device=dev).manual_seed(SEED + 8))
    turns = HQS_CONFIGS + HQS_CONFIGS[::-1]
    for b, xb, yb in ((1, x, y), (HQS_BATCH, x8, y8)):
        fwd, rec = {c: [] for c in HQS_CONFIGS}, {c: [] for c in HQS_CONFIGS}
        for c in turns:
            m, den = hqs_models[c]
            with torch.no_grad():
                fwd[c].append(cuda_ms(lambda: den(xb, 0.02), 20 if b == 1 else 5))
            rec[c].append(cuda_ms(recon(m, yb, physics), 10 if b == 1 else 3, warmup=2))
        for c in HQS_CONFIGS:
            print(f"DRUNet {c} B={b}: forward {fwd[c]} ms (mean {sum(fwd[c]) / 2:.4f}); HQS "
                  f"{MAX_ITER} it {rec[c]} ms per recon, "
                  f"{b * MAX_ITER * 2e3 / sum(rec[c]):.2f} image-it/s", flush=True)

    def on_mma_tile():
        """K1 and K5 on the earlier mma.sync tile inside the block."""
        stack = contextlib.ExitStack()
        stack.enter_context(swapped(drunet_mod, "resblock_chain", lambda v, w1s, w2s, packed=None:
                                    rc_launch(v, *(packed or (pack_weights(w1s),
                                                              pack_weights(w2s))), "mma")))
        stack.enter_context(swapped(dncnn_mod, "conv_chain", lambda v, ws_, bs_, packed=None:
                                    cc_launch(v, *(packed or (pack_weights(ws_),
                                                              pack_bias(bs_))), "mma")))
        return stack

    # at the HQS batch: HQS down on each tile beside "0", and PGD on each tile
    # beside the hidden layers as cuDNN layers (the gates closed), in turns
    down8 = recon(hqs_models["down"][0], y8, physics)
    rates_in_turns(f"HQS {MAX_ITER} it B={HQS_BATCH}", {
        "down (wgmma tile)": down8, "down (mma.sync tile)": on_plain(down8, on_mma_tile),
        '"0" (no kernel)': recon(hqs_models["0"][0], y8, physics)}, HQS_BATCH * MAX_ITER)
    def on_mma_up():
        """K2/K3 and K4 on the earlier mma.sync kernels inside the block."""
        stack = contextlib.ExitStack()
        stack.enter_context(swapped(
            drunet_mod, "up_resblock_chain", lambda v, w_up, w1s, w2s, packed=None: up_launch(
                v, *(packed or pack_up_chain(w_up, w1s, w2s)), "mma")))
        stack.enter_context(swapped(
            drunet_mod, "up_sandwich", lambda s2, d0, *ws, packed=None: sw_launch(
                s2, d0, packed or pack_sandwich(*ws), "mma")))
        return stack

    # at the HQS batch: HQS both and sandwich with K2/K3 and K4 on their wgmma
    # kernels and on the mma.sync kernels, in turns
    both8 = recon(hqs_models["both"][0], y8, physics)
    sand8 = recon(hqs_models["sandwich"][0], y8, physics)
    rates_in_turns(f"HQS {MAX_ITER} it B={HQS_BATCH}, K2/K3 and K4 by kernel", {
        "both (wgmma)": both8, "both (mma.sync)": on_plain(both8, on_mma_up),
        "sandwich (wgmma)": sand8, "sandwich (mma.sync)": on_plain(sand8, on_mma_up)},
        HQS_BATCH * MAX_ITER)
    for name, run in pgd8.items():
        rates_in_turns(f"PGD {name} {MAX_ITER} it B={HQS_BATCH}", {
            "wgmma tile": run, "mma.sync tile": on_plain(run, on_mma_tile),
            "cuDNN layers": on_plain(run, fused_chains_disabled)}, HQS_BATCH * MAX_ITER)

    recon_rates(f"HQS {MAX_ITER} it (1x3x256x256, DRUNet full width, bf16)", hqs,
                on_plain(hqs, plain_resblocks))
    for name, run in pgd.items():
        recon_rates(f"PGD {name} {MAX_ITER} it (B=1, 256x256, DnCNN depth 20 nf 64, bf16)",
                    run, on_plain(run, plain_conv_chain))
    for name, tv_model, yt, phys, priors, _, _, iters in tv_problems:
        run = recon(tv_model, yt, phys)
        recon_rates(f"{name} {iters} it (f32, TVPrior 100 steps)", run,
                    on_plain(run, lambda priors=priors: plain_tv(priors)), iters=iters, reps=5,
                    plain_reps=1)

    # 8. where the time goes: TV first (the K7 profiles need exact kernel
    # counts, and the more profiler sessions come before them, the more
    # events the profiler drops), then HQS in each DRUNet configuration, then
    # TV-PGD, then PGD
    def one_kernel(label, run, calls):
        """The resident prox is one kernel a call: the profiler saw device
        time, every kernel it saw is tv_resident, and exactly one a call (the
        spin kernels around the window take the launch it drops; a session
        that still lost one is taken again). Returns the kernels a call."""
        prof, n = counted_profile(label, run, calls, lambda name: True, 1)
        check(prof is not None, f"{label}: the profiler saw no device time, so the kernels a "
              f"call were not measured")
        names = {name for _, _, name in prof[3]}
        print(f"profile {label}: {n:g} kernels a call, device time a launch "
              f"{prof[1] / n:.4f} ms", flush=True)
        check(n == 1 and all("tv_resident" in name for name in names),
              f"{label}: the resident prox is not one kernel a call ({n:g}, {names})")
        return n

    label = f"tv_prox {tv_shape} n_iter={TV_ITERS} (the plan's layout)"
    check(tv_main.variant == "resident", f"{label}: the plan's variant is {tv_main.variant}")
    # the main shape's CUDA launches a prox, as the profiler counted them
    tv_per_prox = one_kernel(label, lambda: chambolle_prox(xt, gam, TV_ITERS), 10)
    for shp in TV_TIME_SHAPES:
        xs = torch.rand(shp, generator=g_tv).to(dev)
        for name, var, cl in TV_LAYOUTS:
            label = f"tv_prox {shp} n_iter={TV_ITERS} {name}"
            run = (lambda xs=xs, var=var, cl=cl: tv_launch(xs, gam, TV_ITERS, var, cl))
            if var == "resident":
                one_kernel(label, run, 5)
            else:
                device_profile(label, run, 5)
    for b, yb in ((1, y), (HQS_BATCH, y8)):
        for c in HQS_CONFIGS:
            label = f"HQS {c} B={b} {MAX_ITER} it"
            run = recon(hqs_models[c][0], yb, physics)
            if c in HQS_TILE_LAUNCHES:
                tile_in_profile(label, run, HQS_TILE_LAUNCHES[c], top=10)
            else:
                device_profile(label, run, 3, top=10)
    for name, tv_model, yt, phys, _, _, _, iters in tv_problems:
        if name.startswith("TV-PGD deblur"):
            device_profile(f"{name} {iters} it", recon(tv_model, yt, phys), 3)
    for b, runs in ((1, pgd), (HQS_BATCH, pgd8)):
        for name, run in runs.items():
            tile_in_profile(f"PGD {name} B={b} {MAX_ITER} it", run,
                            {"conv3x3_wgmma": MAX_ITER * K5_TILE_LAUNCHES})

    # 9. DnCNN training, both train-step configurations (weights and data on
    # their own generator); the bench's DnCNN(1, 1): depth 20, nf 64
    g_tr = torch.Generator().manual_seed(SEED + 12)
    train_net = DnCNN(1, 1, depth=20, nf=64, generator=g_tr)
    k6_launches, bwd_launches = train_phase(dev, train_net, g_tr)
    # K6 on the wgmma tile, on the mma.sync tile and as the same stage of
    # cuDNN bf16 layers under autograd (what the reference configuration
    # runs); the stash backward on its kernels, on the earlier cuDNN route
    # and as autodiff through those layers; in turns at B=1 and B=16, L=18,
    # channels_last, with a bf16 cotangent as the train step hands it; K5 and
    # the plain versions at B=1
    g9 = torch.Generator().manual_seed(SEED + 13)
    h9 = torch.randn(CHAIN_SHAPES[0][0], generator=g9).to(dev, torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    ws9 = (torch.randn((L_MAIN, 64, 64, 3, 3), generator=g9) * he_std).to(dev)
    bs9 = (torch.randn((L_MAIN, 64), generator=g9) * 0.02).to(dev)
    cot9 = torch.randn(CHAIN_SHAPES[0][0], generator=g9).to(dev, torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    pk9 = (pack_weights(ws9), pack_bias(bs9))
    wl9 = [w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last).requires_grad_()
           for w in ws9]
    bl9 = [b.to(torch.bfloat16).requires_grad_() for b in bs9]
    # bf16 weights, as the training path under autocast hands them
    wb9 = ws9.to(torch.bfloat16)
    train_chain = {}
    for B in TRAIN_BATCHES:
        if B == 1:
            hB, cotB = h9, cot9
        else:
            hB = torch.randn((B, 64, 256, 256), generator=g9).to(dev, torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            cotB = torch.randn((B, 64, 256, 256), generator=g9).to(dev, torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
        actsB = conv_chain_stash(hB, ws9, bs9, pk9)
        hBg = hB.detach().requires_grad_()

        def cudnn_train_chain(hBg=hBg):  # cuDNN bf16 layers, autograd keeping their inputs
            with torch.enable_grad():
                v = hBg
                for l in range(L_MAIN):
                    v = torch.relu(F.conv2d(v, wl9[l], bl9[l], padding=1))
            return v

        reps = 50 if B == 1 else 10
        fwd = tile_turns(f"conv_chain_stash {tuple(hB.shape)} L={L_MAIN}", {
            "wgmma": lambda: conv_chain_stash(hB, ws9, bs9, pk9),
            "mma.sync": lambda: cc_launch_stash(hB, *pk9, "mma"),
            "cuDNN": cudnn_train_chain}, B * L_MAIN * flop_conv, reps)
        outB = cudnn_train_chain()
        # the launch queue holds ~1000 launches: a backward makes ~60-80
        bwd = tile_turns(f"stash backward {tuple(hB.shape)} L={L_MAIN}", {
            "kernels": lambda: stash_backward(hB, wb9, actsB, cotB),
            "cuDNN route": lambda: stash_backward(hB, wb9, actsB, cotB, route="cudnn"),
            "autodiff": lambda: torch.autograd.grad(outB, [hBg] + wl9 + bl9, cotB,
                                                    retain_graph=True)},
            2 * B * L_MAIN * flop_conv, max(reps // 2, 5), queued_reps=8)
        train_chain[B] = (fwd, bwd)
        del outB, actsB
    acts9 = conv_chain_stash(h9, ws9, bs9, pk9)
    with torch.no_grad():
        s_p = [cuda_ms(lambda: conv_chain_stash_plain(h9, ws9, bs9), 5, warmup=1)]
        s_k = [cuda_ms(lambda: conv_chain_stash(h9, ws9, bs9, pk9), 50) for _ in range(2)]
        s_p.append(cuda_ms(lambda: conv_chain_stash_plain(h9, ws9, bs9), 5, warmup=1))
        s_k5 = cuda_ms(lambda: conv_chain(h9, ws9, bs9, pk9), 50)
    b_plain = cuda_ms(lambda: stash_backward(h9, wb9, acts9, cot9, plain=True), 5, warmup=1)
    k6_ms, k6_plain_ms = sum(s_k) / 2, sum(s_p) / 2
    print(f"time conv_chain_stash (1,64,256,256) L={L_MAIN}: K6 {s_k} ms, K5 {s_k5} ms, plain "
          f"{s_p} ms; K6 {L_MAIN * flop_conv / k6_ms / 1e9:.1f} TFLOP/s; stash backward plain "
          f"(TF32 off) {b_plain} ms", flush=True)

    # 10. EI + SURE training in the reference configuration, same weights
    ssl_phase(dev, train_net, g_tr)

    # bounds of the timed calls: (1, 64, 256, 256) bf16 in and out, bf16 weights
    act_bytes = 2 * 2 * math.prod(KERNEL_SHAPES[0][0])
    w_bytes = 9 * 64 * 64 * 2
    k1_bound = bound_ms(R_MAIN * 2 * flop_conv, PEAK_BF16, act_bytes + 2 * R_MAIN * w_bytes)
    k5_bound = bound_ms(L_MAIN * flop_conv, PEAK_BF16, act_bytes + L_MAIN * (w_bytes + 64 * 4))
    k1_bound_b8 = bound_ms(HQS_BATCH * R_MAIN * 2 * flop_conv, PEAK_BF16,
                           HQS_BATCH * act_bytes + 2 * R_MAIN * w_bytes)
    k5_bound_b8 = bound_ms(HQS_BATCH * L_MAIN * flop_conv, PEAK_BF16,
                           HQS_BATCH * act_bytes + L_MAIN * (w_bytes + 64 * 4))
    k7_bound = bound_ms(tv_ops, PEAK_F32, 2 * pixels * 4 + tv_shape[0] * 4)
    # K2/K3: v in, the scale-0 output out, the projection and chain weights
    k23_bound = bound_ms(up_flop, PEAK_BF16, 2 * (v.numel() + math.prod(KERNEL_SHAPES[0][0]))
                         + 2 * wu.numel() + 2 * R_MAIN * w_bytes)
    k23_bound_b8 = bound_ms(HQS_BATCH * up_flop, PEAK_BF16, 2 * HQS_BATCH * (
        v.numel() + math.prod(KERNEL_SHAPES[0][0])) + 2 * wu.numel() + 2 * R_MAIN * w_bytes)
    # K4: s2 and d0 in, the scale-0 output out, the seven weights
    k4_bound = bound_ms(sw_flop, PEAK_BF16, 2 * (s2.numel() + 2 * d0.numel())
                        + 2 * sum(w.numel() for w in sw))
    k4_bound_b8 = bound_ms(HQS_BATCH * sw_flop, PEAK_BF16, 2 * HQS_BATCH * (
        s2.numel() + 2 * d0.numel()) + 2 * sum(w.numel() for w in sw))
    # K6: the input in, the L stash slots out, the weights and biases
    k6_bound, k6_bound_b16 = (bound_ms(
        b * L_MAIN * flop_conv, PEAK_BF16,
        b * act_bytes // 2 * (1 + L_MAIN) + L_MAIN * (w_bytes + 64 * 4)) for b in TRAIN_BATCHES)
    # the stash backward: dX and dW convs; h, the bf16 cotangent and the L
    # stash slots in, the bf16 weights in and dW out, dh and db out
    bwd_bound, bwd_bound_b16 = (bound_ms(
        2 * b * L_MAIN * flop_conv, PEAK_BF16,
        b * act_bytes // 2 * (3 + L_MAIN) + L_MAIN * (2 * w_bytes + 64 * 4)) for b in TRAIN_BATCHES)
    (k6_b1, bwd_b1), (k6_b16, bwd_b16) = (train_chain[b] for b in TRAIN_BATCHES)

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
        "bound_ms": k1_bound[0],
        "bound_by": k1_bound[1],
        "library_ms": k_lib_ms,
        # the conv tile (csrc/conv3x3_wgmma.cuh), its times in turns with the
        # earlier mma.sync tile and the cuDNN layers (phase 7), and at B=8
        "tile": "wgmma",
        "prev_tile_ms": tiles["K1", 1][0]["mma.sync"],
        "ms_b8": tiles["K1", HQS_BATCH][0]["wgmma"],
        "library_ms_b8": tiles["K1", HQS_BATCH][0]["cuDNN"],
        "bound_ms_b8": k1_bound_b8[0],
        "prev_tile_ms_b8": tiles["K1", HQS_BATCH][0]["mma.sync"],
        # the device's own time a call, calls queued behind a spin kernel (at
        # B=1 the host issues a call in about the kernel's time, which the
        # CUDA-event times above include)
        "device_ms": tiles["K1", 1][1]["wgmma"],
        "device_ms_b8": tiles["K1", HQS_BATCH][1]["wgmma"],
    }, {
        "name": "conv_chain",
        "route": "cuda",
        "source": "deepinv_tpu_torch/csrc/conv_chain.cu",
        "replaces": "deepinv_tpu/ops/pallas/conv_chain.py:112",
        "launches": chain_launches,
        "max_abs_err": chain_err,
        "ms": ck_ms,
        "plain_ms": cp_ms,
        "bound_ms": k5_bound[0],
        "bound_by": k5_bound[1],
        "library_ms": ck_lib_ms,
        "tile": "wgmma",
        "prev_tile_ms": tiles["K5", 1][0]["mma.sync"],
        "ms_b8": tiles["K5", HQS_BATCH][0]["wgmma"],
        "library_ms_b8": tiles["K5", HQS_BATCH][0]["cuDNN"],
        "bound_ms_b8": k5_bound_b8[0],
        "prev_tile_ms_b8": tiles["K5", HQS_BATCH][0]["mma.sync"],
        # the device's own time a call, calls queued behind a spin kernel (at
        # B=1 the host issues a call in about the kernel's time, which the
        # CUDA-event times above include)
        "device_ms": tiles["K5", 1][1]["wgmma"],
        "device_ms_b8": tiles["K5", HQS_BATCH][1]["wgmma"],
    }, {
        "name": "tv_prox",
        "route": "cuda",
        "source": "deepinv_tpu_torch/csrc/tv_prox.cu",
        "replaces": "deepinv_tpu/ops/pallas/tv.py:53",
        "launches": tv_launches,
        "max_abs_err": tv_err,
        "ms": tk_ms,
        "plain_ms": tp_ms,
        "bound_ms": k7_bound[0],
        "bound_by": k7_bound[1],
        "library_ms": None,  # no single PyTorch call computes a TV prox
        # the main shape's variant and its CUDA launches a prox (profiled); the other
        # layouts' times (phase 7, in turns) and the barrier floor of its steps
        "variant": tv_main.variant,
        "cluster": tv_main.cluster,
        "launches_per_prox": tv_per_prox,
        "layout_ms": {f"{'x'.join(map(str, k))}": v for k, v in tv_layout_ms.items()},
        "barrier_floor_ms": tv_floor_us.get(tv_main.cluster, tv_floor_us[16]) * TV_ITERS / 1e3,
    }, {
        "name": "up_resblock_chain",
        "route": "cuda",
        "source": "deepinv_tpu_torch/csrc/up_resblock_chain.cu",
        "replaces": "deepinv_tpu/ops/pallas/resblock_chain.py:62",
        # K3, the TPU variant with the projection in XLA, computes the same function
        "also_replaces": "deepinv_tpu/ops/pallas/resblock_chain.py:97",
        "launches": config_launches["both"],
        "max_abs_err": up_err,
        "ms": uk_ms,
        "plain_ms": up_ms,
        "bound_ms": k23_bound[0],
        "bound_by": k23_bound[1],
        "library_ms": uk_lib_ms,
        # the projection and chain kernels, their times in turns with the
        # earlier mma.sync kernels and the cuDNN layers (phase 7), and at B=8
        "tile": "wgmma",
        "tile_sources": ["deepinv_tpu_torch/csrc/proj2x2_wgmma.cuh",
                         "deepinv_tpu_torch/csrc/conv3x3_wgmma.cuh"],
        "prev_tile_ms": tiles["K2/K3", 1][0]["mma.sync"],
        "ms_b8": tiles["K2/K3", HQS_BATCH][0]["wgmma"],
        "library_ms_b8": tiles["K2/K3", HQS_BATCH][0]["cuDNN"],
        "bound_ms_b8": k23_bound_b8[0],
        "prev_tile_ms_b8": tiles["K2/K3", HQS_BATCH][0]["mma.sync"],
        "device_ms": tiles["K2/K3", 1][1]["wgmma"],
        "device_ms_b8": tiles["K2/K3", HQS_BATCH][1]["wgmma"],
    }, {
        "name": "up_sandwich",
        "route": "cuda",
        "source": "deepinv_tpu_torch/csrc/up_sandwich.cu",
        "replaces": "deepinv_tpu/ops/pallas/resblock_chain.py:442",
        "launches": config_launches["sandwich"],
        "max_abs_err": sw_err,
        "ms": sk_ms,
        "plain_ms": sp_ms,
        "bound_ms": k4_bound[0],
        "bound_by": k4_bound[1],
        "library_ms": sk_lib_ms,
        "tile": "wgmma",
        "tile_sources": ["deepinv_tpu_torch/csrc/proj2x2_wgmma.cuh",
                         "deepinv_tpu_torch/csrc/conv3x3_c128_wgmma.cuh",
                         "deepinv_tpu_torch/csrc/conv3x3_wgmma.cuh"],
        "prev_tile_ms": tiles["K4", 1][0]["mma.sync"],
        "ms_b8": tiles["K4", HQS_BATCH][0]["wgmma"],
        "library_ms_b8": tiles["K4", HQS_BATCH][0]["cuDNN"],
        "bound_ms_b8": k4_bound_b8[0],
        "prev_tile_ms_b8": tiles["K4", HQS_BATCH][0]["mma.sync"],
        "device_ms": tiles["K4", 1][1]["wgmma"],
        "device_ms_b8": tiles["K4", HQS_BATCH][1]["wgmma"],
    }, {
        "name": "conv_chain_stash",
        "route": "cuda",
        "source": "deepinv_tpu_torch/csrc/conv_chain.cu",
        "replaces": "deepinv_tpu/ops/pallas/conv_chain.py:129",
        "launched_by": "deepinv_tpu/ops/pallas/conv_chain.py:328",
        "launches": k6_launches,
        "max_abs_err": stash_err,
        "ms": k6_ms,
        "plain_ms": k6_plain_ms,
        "bound_ms": k6_bound[0],
        "bound_by": k6_bound[1],
        # the same stage as 18 cuDNN bf16 layers under autograd (no single
        # library call computes the chain), timed in turns with the wgmma and
        # the mma.sync tile
        "library_ms": k6_b1[0]["cuDNN"],
        "tile": "wgmma",
        "prev_tile_ms": k6_b1[0]["mma.sync"],
        "ms_b16": k6_b16[0]["wgmma"],
        "library_ms_b16": k6_b16[0]["cuDNN"],
        "bound_ms_b16": k6_bound_b16[0],
        "prev_tile_ms_b16": k6_b16[0]["mma.sync"],
        "device_ms": k6_b1[1]["wgmma"],
        "device_ms_b16": k6_b16[1]["wgmma"],
        "k5_ms": s_k5,
    }, {
        "name": "stash_backward",
        "route": "cuda",
        "source": "deepinv_tpu_torch/csrc/conv_chain.cu",
        "tile_sources": ["deepinv_tpu_torch/csrc/conv3x3_wgmma.cuh"],
        "replaces": "deepinv_tpu/ops/pallas/conv_chain.py:405 (_bwd, XLA)",
        # the head, L dX tiles and the fold a step of phase 9's fused_chains=True runs
        "launches": bwd_launches,
        "max_abs_err": bwd_err["dh"],
        "max_abs_err_dW": bwd_err["dW"],
        "max_abs_err_db": bwd_err["db"],
        "ms": bwd_b1[0]["kernels"],
        "plain_ms": b_plain,
        "bound_ms": bwd_bound[0],
        "bound_by": bwd_bound[1],
        # autodiff through the 18 cuDNN bf16 layers (one torch.autograd.grad
        # call), and the earlier cuDNN route (dgrad, mask pass, sum), in turns
        "library_ms": bwd_b1[0]["autodiff"],
        "cudnn_route_ms": bwd_b1[0]["cuDNN route"],
        "ms_b16": bwd_b16[0]["kernels"],
        "library_ms_b16": bwd_b16[0]["autodiff"],
        "cudnn_route_ms_b16": bwd_b16[0]["cuDNN route"],
        "bound_ms_b16": bwd_bound_b16[0],
        "device_ms": bwd_b1[1]["kernels"],
        "device_ms_b16": bwd_b16[1]["kernels"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
