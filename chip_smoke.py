#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --gallery    # phases 1, 2, 23, 24 and 25 alone

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
   resident variant (the count ``kernel.chambolle_prox.launches.resident``),
   agree with the same run on the plain prox (``use_pallas=False``) and be no
   worse than the naive estimate (``y``, the zero-filled ``A^T y``, the FBP)
   by more than 0.5 dB of PSNR;
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
   difference of the f32 model, and steps per second;
11. diffusion and Langevin sampling through the samplers' entry points with
   a bf16 full-width DRUNet (nc=(64,128,256,512), nb=4, ``fused="down"``,
   seeded random weights) at 256² RGB (``bench.py:384-475``): DDRM on
   ``Inpainting(mask=0.7)`` with noise 0.05 at B=1 (12 steps) and B=8 (6),
   DPS and DiffPIR on 4x bicubic super-resolution (``Downsampling``, 256² to
   64², noise 0.05) at B=1 (12), and short runs of ULA (``ScorePrior``,
   deblurring) and of ``PosteriorDiffusion`` (VP SDE, ``DPSDataFidelity``).
   Each run must launch K1 once per denoiser call and make the JAX
   sampler's number of calls (DDRM n + 1, DPS n, DiffPIR max_iter - 1, ULA
   one a step, PosteriorDiffusion two a step), give a finite sample, hold
   its first denoiser calls within DENOISER_RTOL of K1's plain version and
   the sample within RECON_RTOL of the run on the plain version from the
   same generator seed. One DPS step's guidance gradient must be within
   SAMPLE_GRAD_RTOL of the plain path's, with K1's backward asked for dh
   alone and no weight gradient. Timed: the rates by the slope between n and
   4n steps under the bench's metric names (``rate:`` lines, with the card),
   and K1's backward at the DPS step's shape with TF32 (the op's) and
   without, beside cuDNN f32 layers under autograd; profiled: a DDRM and a
   DPS sample at B=1 (kernels and device busy a step);
12. the Krylov data step (``krylov_phase``): CG, BiCGStab, MINRES and LSQR
   on batched random systems (4 x 1024 unknowns) against a float64 solve on
   the card; ``Tomography.prox_l2`` (CG over the Toeplitz normal, the
   physics' defaults) at 1x and 8x1x256² with a scalar and a per-sample
   gamma, held by its normal-equation residual (PROX_RESIDUAL_TOLS x tol),
   the same bits with the stop flag read every iteration, with its CG
   iterations and host reads a prox; the implicit backward (y, z, gamma and
   a Blur filter) against a float64 central difference; PnP-ADMM on the CT
   bench problem (the full-depth bf16 DnCNN of phase 5) at B=1 and B=8, and
   DRS, Chambolle-Pock (identity K) and g-first PGD (a score-prior step to
   the denoiser's output) at B=1, each held as phase 5 holds PGD (K5 once an
   iteration, every denoiser call, the plain and the unrounded chain's
   runs) with its CG iterations and host reads a prox; TV-PGD on CT from
   the FBP with Anderson acceleration and with early stop, and TV-PGD
   deblurring with backtracking at a stepsize plain PGD diverges with, on
   K7 (one resident launch a loop body and a retry), each within 1e-4 of
   the run on the plain prox, stopping at its iteration and retrying as it
   does, and within 0.5 dB of the naive estimate. Timed: ADMM's rates in
   turns with PGD on CT at B=1 and B=8; profiled: an ADMM recon and its
   eight data steps replayed (kernels, device busy, idle share, the Krylov
   solves' share of device time);
13. the ops layer's CT projectors and blurs (``ct_breadth_phase``):
   ``Tomography`` by interp, fourier and slice and the fan beam, and the 2-D
   ``TomographyWithAstra`` fan beam, on 256² Shepp-Logan at 90 angles,
   normalized: adjointness within ADJOINT_RTOL, the FBP above its PSNR floor
   (FBP_PSNR_FLOOR_DB), ``A`` and ``A_adjoint`` timed in turns at B=1 and
   B=8; PnP-PGD with the full-depth bf16 DnCNN of phase 5 on the fan beam at
   B=1 and B=8 at stepsize 1 / ||A||², held as phase 5 holds PGD (K5 once an
   iteration, every denoiser call, the plain and the unrounded chain's
   runs), its rates in turns with the same PGD on the slice CT, and
   profiled (the projector's share of the device time); TV-PGD from the FBP
   on the interp and fourier projectors and TV-PGD on a ``SpaceVaryingBlur``
   (four Gaussian PSFs, smooth multipliers summing to one, 1x3x256²), each
   as phase 6 holds its runs (K7 once an iteration on its resident variant,
   within 1e-4 of the plain prox, within 0.5 dB of the naive estimate);
   cone-beam ``TomographyWithAstra`` on the 128³ ellipsoid phantom of
   ``examples/demo_conebeam_fdk.py`` (120 views, 128x192 detector):
   adjointness, the FDK and a CG ``A_dagger`` above their floors, with times;
   ``DownsamplingMatlab`` x2 adjointness, the 5-D ``Blur`` (conv3d) against
   ``conv3d_fft`` on 64x128x128, and the db4 wavelet and DCT round trips;
14. multi-coil MRI, the noise models and the physics generators
   (``mri_multicoil_phase``): ``MultiCoilMRI`` at 320² with 15 birdcage coil
   maps, a ``GaussianMaskGenerator`` (acceleration 4) mask a sample and
   ``GaussianNoise(0.01)`` on the sampled k-space: adjointness of the
   Cartesian and of a golden-angle radial (NUFFT) operator within
   ADJOINT_RTOL, ``||A||² <= 1`` by ``compute_norm``; PnP-PGD with a bf16
   full-depth ``DnCNN(2, 2)`` (the residual layer scaled as phase 5's) at B=1
   and B=8, held as phase 5 holds PGD (K5 once an iteration, each denoiser
   call within DENOISER_RTOL, the recon within RECON_RTOL of the plain and
   the unrounded chain's runs), again at B=1 from maps that ESPIRiT estimates
   from ``y`` (24² calibration, 6² kernels; timed, its magnitude PSNR beside
   the birdcage recon's); ``Trainer`` of ``ArtifactRemoval(DnCNN(2, 2))``
   with ``physics_generator = GaussianMaskGenerator + SigmaGenerator(0.005,
   0.05)``, Adam(MC_LR), 8 steps at B=1 and B=16 in both train-step
   configurations: one K6 launch a step (and L + 2 of the stash backward)
   with ``fused_chains=True``, none with ``False``, the first step's
   gradients within GRAD_RTOL (whole) and MC_GRAD_TENSOR_RTOL (each
   parameter tensor), losses within TRAIN_LOSS_RTOL; then each fault of
   MC_FAULTS planted in the stash backward's result, in a run of its own,
   must fail the gradient checks (and the loss check where marked); every
   noise model drawn on the card at 8x3x256² (``GaussianNoise`` also with a
   per-sample sigma), its sample mean and variance against the analytic ones
   (NOISE_MEAN_SE, NOISE_VAR_RTOL); every generator's ``step`` at B=8, timed:
   PSFs non-negative summing to 1, Random and Gaussian masks of exactly
   ``n_lines + n_center`` lines, splitting masks inside their input mask at
   their ratio. Timed and profiled: PGD's it/s at B=1 and image-it/s at B=8
   with the idle share and the FFTs' and K5's shares of the device time, and
   the generator-driven train steps/s with an epoch's idle share (``rate:``
   lines, with the card);
15. the rest of ``physics/`` (``operators_phase``): PnP-HQS on the
   ``SinglePixelCamera`` (16384 of the 256² Hadamard patterns, cake-cutting,
   noise 0.01) and PnP-PGD on fast ``CompressedSensing`` (16384
   measurements of 256², stepsize 1 / ||A||²) with phase 5's full-depth bf16
   DnCNN at B=1 and B=8, each held as phase 5 holds PGD (K5 once an
   iteration, every denoiser call, the plain and the unrounded chain's
   runs); the Hadamard round trip ``V(V_adjoint(x))`` within HADAMARD_RTOL
   with TF32 on and under a bf16 autocast; the DST-I of the flattened 256²
   image (an FFT of 2 x 65537) self-inverse and adjoint within DST_RTOL, its
   ms beside a power-of-two cuFFT; PnP-FISTA with ``TVDenoiser(20)`` on
   ``RadioInterferometry`` (512², 2 x 10^5 visibilities, stepsize 1 /
   ||A||², 40 iterations) and PnP-PGD with ``TVDenoiser(15)`` on
   ``Pansharpen((3, 512, 512), factor=4)`` from ``brovey`` (30 iterations),
   each held as phase 6 holds its TV runs (K7 once an iteration on its
   resident variant, within 1e-4 of the plain prox, within 0.5 dB of the
   naive estimate), with ``tv_plan``'s cluster; every other new operator
   once, adjoint within ADJOINT_RTOL with ``A``/``A_adjoint`` ms (PET's
   michelogram with ``osem``, ``StructuredRandom``, the phase-retrieval
   operators, the multiscalers, ``Decolorize``, ``HyperSpectralUnmixing``,
   ``CompressiveSpectralImaging``), the spectral method's seconds and cosine
   similarity at 64² with m = 4n, and the Lippmann-Schwinger solve against
   ``mie_theory`` at 96² and 192² (MIE_RTOL, MIE_REFINE). Timed and
   profiled: it/s at B=1, image-it/s at B=8, idle shares, and the
   device-time shares of K5, K7, the Hadamard products, the DST's and the
   Toeplitz NUFFT normal's FFTs (``rate:`` lines, with the card).
16. the rest of ``optim/`` and ``unfolded/`` (``optim_breadth_phase``):
   ``DPIR`` with the bf16 full-width DRUNet on the HQS bench problem at B=1
   and B=8, held as phase 4 holds HQS (K1 once a denoiser call, 8 a recon);
   PnP mirror descent (``optim_builder("MD", PoissonLikelihood, RED(DnCNN),
   bregman_potential=BurgEntropy())``, examples/demo_pnp_mirror_descent.py
   with phase 5's full-depth bf16 DnCNN) on 256² Poisson denoising at B=1
   and B=8, held as phase 5 holds PGD (K5 once an iteration), its iterate
   positive; MLEM (examples/demo_poisson_mlem.py) on 256² CT, non-negative
   with a rising likelihood; an unfolded PGD (``unfolded_builder``, 5
   iterations, the DnCNN) trained by ``Trainer`` on 256² inpainting at B=1
   and B=8 in both train-step configurations: K6 5 times and the stash
   backward 5 (L + 2) launches a step with ``fused_chains=True``, none with
   ``False``, the schedule's and the DnCNN's first-step gradients within
   GRAD_RTOL of each other; a DEQ (``DEQ_builder``, PGD with the contractive
   DnCNN of examples/demo_deq.py, 30 forward maps, 20 adjoint products) one
   train step at B=1 and B=8: K5 once a forward map, K6 once, L + 2
   stash-backward launches an adjoint product, its gradient within GRAD_RTOL
   of the step under ``fused_chains_disabled()``. Timed and profiled:
   recons/s, image-it/s, steps/s and idle shares (``rate:`` lines, with the
   card).
17. the models the unrolled, PnP and 3D demos build on (``models_phase``):
   ``MoDL`` (examples/demo_unfolded_mri.py: 3 HQS iterations over a bf16
   DnCNN(2, 2, depth 7)) on 320² single-coil MRI with a RandomMaskGenerator
   mask at B=1 and B=8, held as phase 5 holds PGD (K5 once a denoiser call, 3
   a recon, 5 tile launches a call in the profile); MoDL trained by
   ``Trainer`` at B=1 and B=8 in both train-step configurations: K6 3 times
   and the stash backward 3 (L + 2) launches a step with
   ``fused_chains=True``, none with ``False``, first-step gradients within
   GRAD_RTOL; the 3D DnCNN (depth 20) and full-width DRUNet on a 64³ volume
   with no kernel launch, bf16 within DENOISER_RTOL of f32, and a 3D DnCNN
   inflated axially from a 2D one equal to it slice by slice
   (INFLATE_RTOL); a 2D DnCNN and DRUNet rebuilt with ``pretrained=`` from
   upstream-named ``.pth`` files: the same output bits, K5 / K1 once a call,
   weights loaded after the first call used; ``VarNet`` (8 cascades) and
   ``PDNet`` on cuDNN with no kernel launch. Timed and profiled: recons/s,
   image-it/s, steps/s, idle shares and the phase's seconds (``rate:``
   lines, with the card).
18. the diffusion backbones and the attention models (``backbones_phase``),
   at their published widths with seeded random weights, none reaching a
   K1-K8 kernel (every count 0 through the phase): ``ADMUNet()`` (the FFHQ
   checkpoint's architecture, f32) as the network of phase 11's DDRM (B=1
   and B=8), DPS and DiffPIR problems at 256² RGB, with the JAX samplers'
   call counts, the first calls' noise prediction under a bf16 autocast
   within DENOISER_RTOL of f32, DPS's guidance gradient in bf16 (the
   network's part within SAMPLE_GRAD_RTOL of f32's, the last step's whole
   gradient within BB_GUIDANCE_RTOL) and ``pretrained=`` from a
   guided-diffusion-named ``.pt`` file giving the same output bits (ADM's
   zero modules redrawn by ``wake``); ``NCSNpp()`` (EDM's 64² configuration,
   its 1e-5 convs woken) under ``PosteriorDiffusion`` over a
   variance-exploding ``EDMDiffusionSDE`` with ``DPSDataFidelity`` on 64²
   inpainting at B=1 and B=8, held alike (bf16 bound BB_BF16_RTOL);
   ``EDMPrecond(DiffUNet())``, ``Restormer()``, ``SwinIR()``, ``SCUNet()``
   and ``PromptIR()`` as denoisers of 256² RGB at B=1 and B=8, bf16 within
   its bound of f32 (DENOISER_RTOL or BB_BF16_RTOL), their ``pretrained=``
   round trips; ``RAM()`` (its residual branches scaled by
   RAM_RESIDUAL_SCALE) on the denoising, inpainting and deblurring tasks of
   examples/demo_foundation_model.py at 256² RGB, B=1 and B=8, bf16 within
   DENOISER_RTOL of f32 and its round trip. Timed: the samplers' steps/s by
   the slope between n and 4n steps with idle shares, ms a call in f32 and
   bf16, recons/s and idle shares (``rate:`` lines, with the card).
19. adversarial training, the rest of ``models/`` and the metrics
   (``generative_phase``): examples/demo_adversarial_training.py at phase 9's
   width, an ``AdversarialTrainer`` of the bf16 DnCNN(1, 1) (depth 20)
   against a full-width f32 ``PatchGANDiscriminator(input_nc=1)`` on 256²
   denoising, ``SupLoss`` + ``SupAdversarialGeneratorLoss(0.01)``, at B=1 and
   B=16 in both train-step configurations: with ``fused_chains=True`` K6 once,
   the stash backward L + 2 and K5 once a step (the discriminator step's
   generator pass), none with ``False``, the first step's generator and
   discriminator gradients within GRAD_RTOL of the same step under
   ``fused_chains_disabled()``, D unchanged by a generator step; a B=1 run of
   ``UAIRGeneratorLoss`` (K6 twice a step); the trained generator scored by
   ``PSNR``, ``SSIM`` and ``LPIPS`` at B=16 (K5 once a batch), LPIPS's VGG16
   in bf16 within DENOISER_RTOL of f32; examples/demo_blind_deblur.py: a
   ``KernelIdentificationNetwork()`` (25 kernels of 33²) estimating a
   ``SpaceVaryingBlur`` from a 256² RGB image and PnP-PGD with a bf16
   DnCNN(3, 3) on it, held as phase 5 holds PGD (K5 8 a recon); DIP, CSGM,
   Poisson2Sparse, DEAL, BM3D, the ESRGAN and DCGAN discriminators and NIQE
   in f32 on the card against the same seeded calls on the CPU;
   ``pretrained=`` round trips of VGG16, the kernel network and DEAL; no
   K1-K4 or K7 launch. Timed: steps/s and idle shares of each
   configuration, the fused step's generator and discriminator halves,
   recons/s, ms a call (``rate:`` and ``time`` lines, with the card).
20. self-supervised training (``selfsup_phase``): phase 9's bf16 DnCNN(1, 1)
   (depth 20) trained through the ``Trainer`` at B=1 and B=16 in both
   train-step configurations with ``SplittingLoss`` (256² inpainting, mask
   0.7, split 0.8, examples/demo_splitting_loss.py), ``R2RLoss`` and
   ``Neighbor2Neighbor`` (sigma 0.1), ``SurePGLoss(second_derivative=True)``,
   ``MCLoss`` + ``EILoss(Rotate(multiples=1))``, ``MCLoss`` +
   ``MOEILoss(PanTiltRotate)``, ``EquivariantSplittingLoss`` over an
   ``EquivariantReconstructor``, ``Artifact2ArtifactLoss`` on 4-frame 256²
   ``DynamicMRI`` over a time-agnostic DnCNN(2, 2), and one
   ``WeightedSplittingLoss`` step on 320² MRI: K6, the stash backward and K5
   the times each path makes a step (``SSL_LAUNCHES``), none unfused, the
   first step within TRAIN_LOSS_RTOL / GRAD_RTOL of the cuDNN layers'
   (SURE-PG's loss alone: its finite differences amplify bf16 rounding),
   evaluation on K5 (SSL_EVAL_SAMPLES a splitting or R2R batch), SURE-PG's
   bf16 finite-difference divergences against f32, the warps timed, and a
   checkpoint saved and restored on the card (the same bits, a resumed epoch
   equal). Timed: steps/s of both configurations and idle shares.
21. serving, the parallel layer and the data pipeline (``serving_phase``):
   ``InferenceServer`` on loopback in this process, with a bearer key,
   hosting phase 4's PnP-HQS (bf16 DRUNet, ``fused="down"``) under
   ``"BlurFFT"`` and phase 5's PnP-PGD on MRI (bf16 DnCNN) under ``"MRI"``;
   the port's ``Client`` posts SERVE_REQUESTS requests of each, each with
   its own ``y``, from 1 and from 4 client threads: each ``x_hat`` within
   SERVE_RTOL of the same recon in-process on its ``y`` (0 expected), K1 and
   K5 MAX_ITER launches a request and no K6 (grad mode off in the handler
   threads), 401 on a bad key, 500 with its message on an unregistered
   physics; requests/s, p50 and p99 latency and
   the recon's own CUDA-event time. ``DistributedProcessing`` of that DRUNet
   in 2 bands over ``[card] * 2`` (K1 once a band, within DENOISER_RTOL of
   the tiling on K1's plain version); ``distribute`` of SERVE_MRI_OPS MRI
   operators inside PnP-PGD (K5 MAX_ITER a recon, within RECON_RTOL of the
   ``StackedLinearPhysics`` recon); ``PipelineParallel`` over ``[card] * 4``
   of 4 stages of PIPE_ITERS PnP-PGD iterations, 4 microbatches of 2 (K5
   once a stage's iteration and microbatch, within RECON_RTOL of the stages
   in sequence); ``RandomPatchSampler`` patches of .npy volumes through the
   ``DataLoader`` into phase 9's Trainer (``fused_chains=True``: K6 once and
   the stash backward L + 2 a step), its steps/s and idle share beside
   in-memory batches; the Trainer's ``data_parallel`` over ``[card] * 2``
   (SGD, the update within DENOISER_RTOL of one device's; K6 and the stash
   backward once a chunk). HDF5 and ``ImageFolder`` are held by the CPU tests
   only (the card's host has no h5py, and no libpng for the native decoder).
22. the named datasets (``datasets_phase``): LIDC-IDRI's layout written to a
   temporary directory (``metadata.csv`` over LIDC_SUBJECTS CT subjects of
   LIDC_SLICES 512² int16 DICOM slices, RescaleIntercept -1024, a seeded
   phantom in HU) and read by ``LidcIdriSliceDataset(hounsfield_units=True)``
   (each item equal to ``utils.load_dicom`` of its file), windowed to [0, 1]
   and pooled to 256², batched by the port's ``DataLoader`` (B=8) into phase
   5's CT PnP-PGD: each fed recon bit-identical to the recon of the same batch
   built in memory, K5 MAX_ITER launches a recon; ``utils.get_device()`` the
   card, ``utils.randn_like`` on the card by seed. Timed: fed and in-memory
   recons/s and the host's read ms a batch.
23. the gallery (``gallery_phase``): the 30 demos of the basics,
   plug-and-play, optimization, unfolded and sampling categories
   (``deepinv_tpu_torch/examples``), each ``main(device="cuda")`` at its full
   size (GALLERY_FAST names those run at their fast size to keep the phase
   within GALLERY_BUDGET_S), each held to its JAX demo's claim
   (GALLERY_CLAIMS); K7 counted around each demo, and launched by each of
   GALLERY_K7, whose reconstructions on the card lie within TV_RTOL
   (relative L2), and whose PSNRs within GALLERY_CPU_DB, of the same demo's
   on the CPU (the plain prox) at the same size, from the same CPU draws. ``demo_custom_dataset`` writes HDF5 and runs where the host
   has h5py. Timed: each demo's seconds. Every kernel's launches are counted
   around each demo and printed on its line;
24. the gallery's other 32 demos (``gallery_phase(..., 24)``): physics,
   blind, transforms, metrics, models, remote sensing and performance, as
   phase 23 runs its own (GALLERY24_FAST, GALLERY24_CLAIMS); the demos of
   GALLERY24_K7 launch K7 and lie within TV_RTOL and GALLERY_CPU_DB of their
   CPU runs (run in the worker groups of GALLERY_CPU_GROUPS, started before
   phase 23); batched_throughput's images/s at
   B=8 above B=1. Timed: each demo's seconds;
25. the gallery's last 21 demos (``gallery_phase(..., 25)``): the
   self-supervised, adversarial, distributed and datasets categories, as
   phase 23 runs its own (GALLERY25_FAST, GALLERY25_CLAIMS), none of them on
   a kernel (their DnCNNs are f32 of 8 or 16 features, the fused chains'
   gate asks for bf16 at 64): every kernel's launches are counted around each
   demo and summed on the phase's line. The distributed demos run on 8 mesh
   entries on the card (``devices=[card] * 8``, as the JAX demos run on 8
   virtual CPU devices). A demo that needs a package the host lacks
   (GALLERY_PACKAGES: PIL, h5py or scipy) or the native image decoder
   (GALLERY_NATIVE, where libpng or libjpeg is missing) is not run, and the
   phase names it and what is missing. Timed: each demo's seconds.

Phase 3 also holds K6 (the stash forward, on the wgmma tile) to its plain
version at the chain shapes, at the train batch (16x64x256², L=18) and at
TAP_SHAPE (two strips), every stash slot, and on the mma.sync tile at the
main shape; and the stash backward on its kernels from the card's stash to
its plain version (STASH_BWD_RTOL) at the same shapes, with L + 2 launches
a call and db the same bits in two calls; K5, K6 and the stash backward
also at BALANCED_SHAPES (16x64x320², L=18, and 5x64x50x300, L=3, on the
balanced schedule with the narrow product on the last strip). Each call's
launches of K5, K6 and the stash backward's dX chain are counted by the
tile's plan form (``kernel.conv_tile.launches.banded`` / ``.balanced``): L
a call, all of the form ``conv_tile_plan`` gives. It prints the card line and a JSON line
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
# K5, K6 and the stash backward on the tile's balanced schedule, with the
# narrow product on the last strip: the MRI benchmark cell's K5 and a ragged
# width of three strips, the last of 44 columns (CHAIN_SHAPES take the
# banded plan)
BALANCED_SHAPES = [((16, 64, 320, 320), L_MAIN), ((5, 64, 50, 300), 3)]
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
# Sampling (phase 11): steps of the checked runs and the short end of the
# rates' slope (bench.py's n_short at B=1: max(N_ITER // 4, 8) with N_ITER
# 48; at B=8 half of it), the DDRM batch, the denoiser calls of each run held
# against the plain version (the first ones), the short ULA and
# PosteriorDiffusion runs, and DPS's guidance gradient against the plain
# path's, relative L2 (the gradient of a bf16 net: each call's bf16
# differences pass through the backward)
SAMPLE_STEPS = 12
SAMPLE_BATCH = 8
SAMPLE_CHECKED_CALLS = 3
ULA_STEPS = 4
PD_STEPS = 3
SAMPLE_GRAD_RTOL = 3e-2
# Phase 12: the Krylov solvers on B batched systems of N unknowns (SPD for CG,
# BiCGStab and MINRES, eigenvalues in [1, 5]; for LSQR 2N x N, singular
# values in [0.29, 1.71]) at tol 1e-6, against a float64 solve on the card:
# the error is at most the condition number times the tolerance (~6e-6)
# plus f32 rounding; bound on the relative L2 error
KRYLOV_SYSTEM = (4, 1024)
KRYLOV_TOL = 1e-6
KRYLOV_RTOL = 1e-4
# Tomography.prox_l2 at the physics' defaults (CG, 50 iterations, tol 1e-4)
# stops once each sample's recurrence residual is within tol of its right-hand
# side; the true residual of (gamma A^T A + I) x = gamma A^T y + z drifts from
# the recurrence by f32 rounding only: bound PROX_RESIDUAL_TOLS x tol
PROX_RESIDUAL_TOLS = 2.0
# the implicit backward (f32, CG at tol 1e-6) against a float64 central
# difference (CG at tol 1e-12) of sum(w * prox_l2(z, y, gamma)) on a Blur,
# directional derivatives in y, z, gamma and the filter, relative error
GRAD_FD_SIZE = 64
GRAD_FD_EPS = 1e-3
GRAD_FD_RTOL = 1e-3
# the loop options on K7: TV-PGD on CT from the FBP (phase 6's problem) with
# Anderson acceleration (30 iterations) and with early stop at a relative
# change the run reaches (at most TV_EARLY_MAX iterations); TV-PGD deblurring
# (phase 6's) with backtracking at a stepsize plain PGD diverges with
TV_EARLY_THRES = 1e-3
TV_EARLY_MAX = 100
TV_BACKTRACK_STEP = 2.5
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
# Phase 13: the CT projectors on 256² Shepp-Logan at 90 angles, normalized
# (the bench's CT size), timed at B=1 and PROJ_BATCH; each one's FBP PSNR
# floor, 1 dB under what the CPU gives at 256² (deepinv_tpu_torch on the
# CPU: interp 25.64, fourier 22.72, slice 22.71, the fan beam at its
# default geometry 13.35, the 2-D TomographyWithAstra fan of ASTRA_FAN 19.40 dB),
# and the adjointness bound |<Ax, y> - <x, A^T y>| / (||Ax|| ||y||)
CT_ANGLES = 90
PROJ_BATCH = 8
FBP_PSNR_FLOOR_DB = {"interp": 24.6, "fourier": 21.7, "slice": 21.7, "fan": 12.3,
                     "astra fan": 18.4}
ADJOINT_RTOL = 1e-5
# the 2-D TomographyWithAstra fan beam: the source two image widths from the
# centre, the detector one, its cells 1.5 pixels wide, views over 360 degrees
ASTRA_FAN = dict(geometry_type="fanbeam", angular_range=(0, 360), detector_spacing=1.5,
                 geometry_parameters=dict(source_radius=512.0, detector_radius=256.0))
# cone beam (examples/demo_conebeam_fdk.py at 128³: its radii 90 and 30 and
# detector (48, 64) at 32³ scaled by 4 to (128, 192) with the cells 1.5
# voxels wide), 120 views over 360 degrees; the FDK and a CG A_dagger of
# CONE_CG_ITERS iterations held above a PSNR floor 1 dB under the first run
# on the card (FDK 25.78 dB, CG 23.38 dB; the CPU at 64³ and 60 views gives
# an FDK of 23.18 dB)
CONE_SIZE = 128
CONE_VIEWS = 120
CONE_DETECTOR = (128, 192)
CONE_RADII = (90.0, 30.0)      # the demo's at 32³, scaled by size / 32
CONE_CG_ITERS = 8
CONE_FDK_FLOOR_DB = 24.7
CONE_CG_FLOOR_DB = 22.3
# the 3-D Blur of a 64x128x128 volume: conv3d (circular) against conv3d_fft,
# and the round trips of the wavelet transform and the DCT (max error over
# the input's max)
BLUR3D_SHAPE = (1, 1, 64, 128, 128)
BLUR3D_RTOL = 1e-4
ROUND_TRIP_RTOL = 1e-5
# phase 14: 15-coil Cartesian MRI at the fastMRI knee's 320², masks of
# GaussianMaskGenerator(acceleration=4) a sample, GaussianNoise(0.01); the
# recon's bounds are phase 5's (DENOISER_RTOL, RECON_RTOL)
MC_SIZE = 320
MC_COILS = 15
MC_ACCEL = 4
MC_SIGMA = 0.01
MC_ESPIRIT = dict(calib_size=24, kernel_size=6)
MC_SPOKES = 64                  # golden-angle spokes of the non-Cartesian adjointness check
MC_NORM_SLACK = 1e-3            # ||A||² <= 1 + slack (RSS-normalised maps, orthonormal FFT)
MC_TRAIN_SIGMAS = (0.005, 0.05)
# Adam's learning rate in phase 14's train steps. Adam's first step moves
# every weight by lr times the sign of its gradient; where the two
# configurations' bf16 gradients differ in sign the weights part by 2 lr, and
# the losses of the 20-layer DnCNN(2, 2) part with them. At phase 9's lr of
# 1e-4 the two configurations' B=1 losses on this MRI problem lay 1.97e-2
# apart (bound 2e-2); at 1e-5, 8.2e-3 (H100 runs). At MC_LR the losses see
# only a gross fault (MC_FAULTS); the first step's gradients, which the lr
# does not touch, are the check of K6 and the stash backward at these shapes.
MC_LR = 1e-5
# phase 14's first-step gradients, fused_chains=True against False: the
# largest relative L2 error of one parameter tensor's gradient (GRAD_RTOL
# bounds the whole gradient's relative max error, as in phase 9)
MC_GRAD_TENSOR_RTOL = 5e-2
# Faults planted in the stash backward's result (dX, dW, db) at phase 14's
# shapes, each in a run of its own from fresh weights and Adam state, to show
# that the checks of the train step can fail: each must miss GRAD_RTOL or
# MC_GRAD_TENSOR_RTOL, and those marked True must also miss TRAIN_LOSS_RTOL.
# Adam's step is unchanged by a constant scale of a tensor's gradient, so a
# scaled dX (it reaches only the first conv's weights) moves no weight
# differently and no loss can show it. Nor, at MC_LR, does a zero dX: the
# losses lay 6.2e-3 (B=1) and 5.4e-3 (B=16) from False's, under the sound
# runs' 8.2e-3 and 8.6e-3, while its first conv's gradient was 1.0 off in
# relative L2 (sound: at most 4.5e-3). Reversed dW: losses 2.9 and 4.6 off.
MC_FAULTS = {
    "dX x 0.5": (lambda dx, dw, db: (0.5 * dx, dw, db), False),
    "dX = 0": (lambda dx, dw, db: (0 * dx, dw, db), False),
    "dW of the layers reversed": (lambda dx, dw, db: (dx, dw.flip(0), db), True),
}
# every noise model's draws on the card at NOISE_SHAPE of a constant 0.5:
# the mean within NOISE_MEAN_SE standard errors, the variance within
# NOISE_VAR_RTOL of the analytic moments
NOISE_SHAPE = (8, 3, 256, 256)
NOISE_MEAN_SE = 5.0
NOISE_VAR_RTOL = 0.03
GEN_BATCH = 8
SPLIT_RATIO_TOL = 0.02          # Bernoulli splits drawn alone: kept fraction within this
# phase 15, the rest of physics/: (a) PnP-HQS on the single-pixel camera
# (SPC_M of the 256² Hadamard patterns, cake-cutting, noise 0.01: the 4x
# undersampling of examples/demo_single_pixel.py) and (b) PnP-PGD on fast
# compressed sensing (CS_M measurements of 256², stepsize 1 / ||A||²), each
# over K5 with phase 5's DnCNN at B=1 and B=HQS_BATCH and held as phase 5
# holds PGD; (c) PnP-FISTA with TVDenoiser(20) on radio interferometry
# (RADIO_SIZE², RADIO_VIS visibilities drawn as
# examples/demo_radio_interferometry.py:36-37 draws them, noise 0.01,
# RADIO_ITERS iterations) and (d) PnP-PGD with TVDenoiser(15) on
# pansharpening (3 x PAN_SIZE², factor 4, from the Brovey estimate, PAN_ITERS
# iterations), each over K7 and held as phase 6 holds its TV runs
OPS_SIZE = 256
SPC_M = 16384
CS_M = 16384
OPS_NOISE = 0.01
SPC_PARAMS = {"stepsize": 1.0, "g_param": 0.02}       # demo_single_pixel.py:55-61
RADIO_SIZE = 512
RADIO_VIS = 200_000
RADIO_ITERS = 40
RADIO_TV = (20, 0.002)          # TVDenoiser(n_it_max)(u, ths) of the radio demo
PAN_SIZE = 512
PAN_ITERS = 30
PAN_TV = (15, 0.001)            # demo_pansharpening.py:39-43
# V(V_adjoint(x)) = x on the card, with TF32 on and under a bf16 autocast:
# the Hadamard products are pinned to f32
HADAMARD_RTOL = 1e-5
# the DST-I of the fast form at 256² (an FFT of 2 x 65537, Bluestein's path in
# cuFFT): self-inverse and adjoint within these (max error over the max)
DST_RTOL = 1e-5
# the other operators once on the card: PET's michelogram (PET_SIZE, three
# segments) with osem at PET_OSEM_ITERS; RandomPhaseRetrieval at
# PR_SIZE² with m = 4n (a 512 MB complex matrix at 64²) and the spectral
# method's start; Ptychography at PTYCHO_SIZE² with 25 probes; the Mie check
# at MIE_SIZES and k = MIE_K (tests/test_physics.py:763-792), its relative
# error below MIE_RTOL and below MIE_REFINE times it on the 2x grid
# the spectral method's 50 default power steps on B^H diag(T(y)) B + 10 I do
# not converge at these sizes (cosine 0.20-0.41 on the CPU at 16²-48²; 200
# steps: 0.82-0.85): the check runs SPECTRAL_ITERS and holds the cosine
# similarity above SPECTRAL_COS
SPECTRAL_ITERS = 200
SPECTRAL_COS = 0.5
PET_SIZE = (16, 128, 128)
PET_OSEM_ITERS = 4
PR_SIZE = 64
PTYCHO_SIZE = 128
MIE_SIZES = (96, 192)
MIE_K = 20.0
MIE_RTOL = 0.08
MIE_REFINE = 0.62
# phase 16 (optim_breadth_phase): DPIR on the HQS bench problem (BlurFFT +
# GaussianNoise(0.01), phase 4); PnP mirror descent and MLEM as
# examples/demo_pnp_mirror_descent.py and demo_poisson_mlem.py set them; the
# unfolded network and the DEQ on the inpainting problem of
# demo_custom_prior_unfolded.py (mask, noise) and demo_deq.py (schedule, depth
# of the loops)
DPIR_SIGMA = 0.01
MD_GAIN = 0.01
MD_PARAMS = {"stepsize": 0.01, "g_param": 0.05, "lambda": 1.0}
MLEM_GAIN = 0.01
MLEM_ITERS = (1, 10, 30)
UNFOLD_ITERS = 5
UNFOLD_STEPS = 3
UNFOLD_MASK = 0.5
UNFOLD_NOISE = 0.03
DEQ_PARAMS = {"stepsize": 0.5, "g_param": 0.05}
DEQ_ITERS = 30
DEQ_BACKWARD = 20
# phase 17 (models_phase): MoDL on single-coil MRI as examples/demo_unfolded_mri.py
# sets it (a RandomMaskGenerator acceleration-4 mask, GaussianNoise(0.01),
# MoDL(num_iter=3) over DnCNN(2, 2, depth 7)) at 320², the fastMRI knee
# width of phase 14; the 3D models of examples/demo_3d_cnn_denoisers.py at full
# width on a 64³ volume; VarNet's default 8 cascades on the same MRI problem
# and PDNet as examples/demo_learned_primal_dual.py builds it (5 iterations)
MODL_SIZE = 320
MODL_ACCEL = 4
MODL_SIGMA = 0.01
MODL_ITERS = 3
MODL_DEPTH = 7
MODL_STEPS = 3
MODL_LR = 1e-4
VOL_SIZE = 64
INFLATE_RTOL = 1e-5             # the axially inflated 3D DnCNN against the 2D one, f32
# H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W) for the bounds.
# phase 18 (backbones_phase): the diffusion backbones under the samplers of
# phase 11 and the attention models as denoisers, all at their published
# widths with seeded random weights; none reaches a K1-K8 kernel
BB_RATE_STEPS = (3, 1)          # the slope's n at B=1 and at B=SAMPLE_BATCH
BB_PD_STEPS = 4                 # PosteriorDiffusion steps over the NCSN++ (two calls a step)
BB_SIGMA_MAX = 2.0              # the EDM SDE's sigma(t) = BB_SIGMA_MAX * t
# bf16 bounds of the phase's own, where a model's bf16 output (relative max
# error against f32) sits past DENOISER_RTOL, each 1.5x the largest gap
# measured on an H100 (PERF.md, phase 18), with its reason: these deep
# networks at random weights grow their activations block by block
# (Restormer's output ~5e2, SCUNet's ~7e13; NCSN++'s residual convs woken
# from their 1e-5 start), and each of their 28-44 residual blocks adds its
# bf16 rounding (2^-9 of its branch) to what the later ones amplify
BB_BF16_RTOL = {
    "NCSN++": (7e-2, ": 4 blocks a level and attention at 16², the first call at sigma "
                     "2 passes 0.70 of F's error to D; 2.7e-2 at B=1, 4.8e-2 at B=8"),
    "Restormer": (7e-2, ": 44 transformer blocks, output ~5e2; 4.0e-2 / 4.2e-2"),
    "SCUNet": (7e-2, ": 28 Swin-conv blocks, output ~7e13; 3.4e-2 / 4.3e-2"),
}
# the whole DPS guidance gradient over ADM at the last step, bf16 against
# f32: its loss ||A(x0) - y|| takes x0 rounded to bf16 at the autocast's
# output, and the residual cancels most of A(x0): a network predicting a
# noise of exactly 0 sits 5.0e-2-5.8e-2 apart on the CPU at 32² (3.3e-2 on
# an H100 with the network woken, PERF.md); the network's own
# part of the gradient is held to SAMPLE_GRAD_RTOL
BB_GUIDANCE_RTOL = 0.1
# RAM's random residual branches (conv2 and the conditioning's gain of each of
# its 28 blocks) scaled as phase 5 scales DnCNN's out_conv: at He-normal
# weights they grow the output to ~1e15 (7.3e15 on a 64² CPU probe, ~50
# scaled), and the bf16 check would compare the rounding of that
RAM_RESIDUAL_SCALE = 0.1
# phase 19 (generative_phase): examples/demo_adversarial_training.py at phase
# 9's width, the blind deblurring demo, the rest of models/ and the metrics
ADV_STEPS = 4                   # train steps of each configuration at each batch
ADV_WEIGHT = 0.01               # SupAdversarialGeneratorLoss's weight (the demo's, the paper's)
ADV_LR = 1e-4                   # both optimizers (AdversarialOptimizer's default)
ADV_EVAL_BATCHES = 2            # eval batches of TRAIN_BATCHES[-1] images
BLIND_PARAMS = {"stepsize": 1.0, "g_param": 0.03}     # examples/demo_blind_deblur.py
BLIND_SIGMAS = (1.0, 2.5)       # the true blur's two Gaussian PSFs, mixed left to right
BLIND_PSF = 17
DIP_ITERS = 100                 # DeepImagePrior's Adam steps on the card
DIP_MASK = 0.3                  # the share of pixels the inpainting hides
CSGM_M = 3 * 64 * 64 // 4       # compressed-sensing measurements of the 3x64² image
PSF_NOISE_GAIN = 0.05           # Poisson2Sparse's data: gain * Poisson(x / gain)
# NIQE's pristine statistics, fitted on noisy disc phantoms: on flat ones the
# 36x36 covariance is near singular and its pseudo-inverse amplifies a
# score's f32 rounding past any bound between the card and the CPU
NIQE_PHANTOMS = 32
NIQE_SHARPNESS = 0.0            # create_weights' sharpness threshold: every patch
NIQE_NOISE = 0.05
# the card against the same seeded call on the CPU, f32 with TF32 off: the
# fits are held after a few steps (cuDNN's and oneDNN's sums round apart, and
# Adam's and CG's steps carry that on), the full runs only on the card
GEN_CHECK_STEPS = {"DIP": 3, "CSGM": 10, "Poisson2Sparse": 2}
GEN_FWD_RTOL = 1e-4             # a forward: 8-13 conv layers of f32 sums
GEN_FIT_RTOL = 1e-3             # a few Adam, heavy-ball or CG steps on top
NIQE_CPU_RTOL = 1e-3            # features, then a float64 pseudo-inverse
BM3D_PSNR_DB = 0.05             # BM3D's aggregation adds with atomics on the card
# Phase 20, self-supervised training: train steps of each configuration
# in each case, Adam's rate, examples/demo_splitting_loss.py's mask and
# split, the evaluation's splits (K5 launches a batch), the noise levels,
# the dynamic-MRI frames and the weighted splitting's MRI size and draws
SSL_TRAIN_STEPS = 2
SSL_LR = 1e-4
SSL_MASK = 0.7
SSL_SPLIT = 0.8
SSL_EVAL_SAMPLES = 5
SSL_SIGMA = 0.1
PG_GAIN, PG_SIGMA = 0.05, 0.05
A2A_FRAMES = 4
WSPLIT_SIZE = 320
WSPLIT_AVERAGE = 2000
# (K6, K5, stash backwards) a train step with fused_chains=True: the
# Trainer's reconstruction (one K6, no backward where the loss does not use
# it) and the loss's own model calls
SSL_LAUNCHES = {"splitting": (2, 0, 1), "R2R": (2, 0, 1), "Neighbor2Neighbor": (2, 1, 1),
                "SURE-PG": (5, 0, 4), "EI Rotate": (2, 0, 2), "MOEI PanTiltRotate": (2, 0, 2),
                "equivariant splitting": (2, 0, 1), "Artifact2Artifact": (2, 0, 1),
                "WeightedSplitting": (2, 0, 1)}
# cases whose loss is a finite difference of the network: the first step's
# loss is held to the layers', its gradient and its gap to f32 printed
SSL_FD_CASES = ("SURE-PG",)


# phase 21: the inference server, the parallel layer and the data pipeline
SERVE_KEY = "chip-smoke"
SERVE_REQUESTS = 16             # requests of each model from each client-thread count
SERVE_THREADS = (1, 4)
SERVE_MRI_OPS = 4               # single-coil MRI operators distributed over [card] * 2
# a served x_hat against the same recon in-process on its own y: the same
# code on the same card, so the same bits are expected (relative L2)
SERVE_RTOL = 1e-6
PIPE_ITERS = 2                  # unrolled PnP-PGD iterations a pipeline stage
DATA_VOLUME = 512               # the .npy volumes' side
DATA_PATCH = 256                # RandomPatchSampler's patch side
DATA_STEPS = 4                  # train steps of the data-fed Trainer
# phase 22: LIDC-IDRI's layout in a temporary directory: LIDC_SUBJECTS CT
# subjects of LIDC_SLICES slices each, LIDC_SIDE² int16 with RescaleSlope 1 and
# RescaleIntercept -1024, as LIDC-IDRI's CT slices are; the HU window mapped to
# [0, 1] before the 2x2 average pool to phase 5's 256²; LIDC_REPS timed passes
# over the slices, fed and in memory in turns
LIDC_SUBJECTS = 2
LIDC_SLICES = 8
LIDC_SIDE = 512
LIDC_WINDOW = (-1000.0, 1000.0)
LIDC_REPS = 3
# phase 23: the gallery's demos (deepinv_tpu_torch/examples GALLERY)
GALLERY_BUDGET_S = 60.0
# the demos that run at their fast size on the card, to keep the phase
# within GALLERY_BUDGET_S (PERF.md §6): DIP's 800 Adam steps took 8.4-13.8
# s alone, and inside the whole smoke, where every demo ran ~1.5x slower, the
# phase took 66.0 s with DIP alone at its fast size; the three training demos
# whose claims hold at their fast sizes (fewer steps, the same problem) follow
GALLERY_FAST = ("dip", "vanilla_unfolded", "custom_prior_unfolded", "unfolded_constrained_lista")
# the demos whose TV prox reaches K7 (TVPrior's or TVDenoiser's prox): each
# must launch it; demo_custom_prior's exact TV is driven by gradient descent
# through TVPrior.grad, autograd of the TV cost, and launches none
GALLERY_K7 = ("basics", "pnp_dpir_deblur", "wavelet_prior", "tv_minimisation",
              "ct_fbp_unfolded")
# the K7 demos on the card against the same demo on the CPU (the plain
# prox), at the size the phase runs them, from the same CPU draws: each
# reconstruction within TV_RTOL (relative L2; 4.1e-8 to 9.8e-7 seen on the H100),
# each PSNR within GALLERY_CPU_DB (0 to 3.8e-6 dB seen, one or two float32
# steps of a PSNR near 25 dB)
GALLERY_CPU_DB = 2e-5
# each demo's claim, as its JAX demo prints or asserts it, at its full size
GALLERY_CLAIMS = {
    "quickstart": ("PnP-PGD beats y", lambda o: o["psnr_xhat"] > o["psnr_y"]),
    "basics": ("TV-PGD and PnP-HQS beat y",
               lambda o: min(o["psnr_tv"], o["psnr_pnp"]) > o["psnr_y"]),
    "custom_physics": ("adjointness < 1e-4, A A_dagger A = A within 1e-3",
                       lambda o: o["adjointness_error"] < 1e-4 and o["dagger_residual"] < 1e-3),
    "custom_optim": ("heavy ball > PGD > y",
                     lambda o: o["psnr_heavy_ball"] > o["psnr_pgd"] > o["psnr_y"]),
    "custom_dataset": ("32/8 HDF5 pairs, the loss falls",
                       lambda o: (o["n_train"], o["n_test"]) == (32, 8)
                       and o["loss_history"][-1] < o["loss_history"][0]),
    "pnp_dpir_deblur": ("DPIR beats y", lambda o: o["psnr_xhat"] > o["psnr_y"]),
    "vanilla_pnp": ("PnP beats y", lambda o: o["psnr_xhat"] > o["psnr_y"]),
    "pnp_mirror_descent": ("PnP-MD beats y", lambda o: o["psnr_xhat"] > o["psnr_y"]),
    "red_sr": ("RED beats the zero fill", lambda o: o["psnr_xhat"] > o["psnr_naive"]),
    "pnp_multiscale": ("coarse to fine beats single scale",
                       lambda o: o["psnr_c2f"] > o["psnr_fine"]),
    "wavelet_prior": ("each prior beats the masked input",
                      lambda o: min(o["psnr_db4"], o["psnr_haar"], o["psnr_tv"])
                      > o["psnr_masked"]),
    "tv_minimisation": ("PGD, ADMM, CP > y - 0.5 dB",
                        lambda o: min(o["psnr_pgd"], o["psnr_admm"], o["psnr_cp"])
                        > o["psnr_y"] - 0.5),
    "custom_prior": ("exact and Huber TV beat y",
                     lambda o: min(o["psnr_tv"], o["psnr_huber_tv"]) > o["psnr_y"]),
    "patch_priors": ("EPLL beats y", lambda o: o["psnr_xhat"] > o["psnr_y"]),
    "poisson_mlem": ("MLEM beats the FBP", lambda o: o["psnr_mlem"] > o["psnr_fbp"]),
    "dip": ("DIP beats y", lambda o: o["psnr_xhat"] > o["psnr_y"]),
    "3d_denoising": ("dictionary > 3D > 2D > noisy",
                     lambda o: o["psnr_dict"] > o["psnr_3d"] > o["psnr_2d"] > o["psnr_noisy"]),
    "ct_fbp_unfolded": ("unfolded PGD-TV beats the FBP", lambda o: o["psnr_xhat"] > o["psnr_fbp"]),
    "unfolded_mri": ("the loss falls, the PSNR rises",
                     lambda o: o["loss_history"][-1] < o["loss_history"][0]
                     and o["psnr_after"] > o["psnr_before"]),
    "deq": ("the loss falls, the DEQ beats y",
            lambda o: o["losses"][-1] < o["losses"][0] and o["psnr_xhat"] > o["psnr_y"]),
    "lista": ("the loss falls", lambda o: o["losses"][-1] < o["losses"][0]),
    # the JAX demo asserts an absolute 1e-4 on gradients of ~1e5 (its random
    # network grows over 24 iterations): the same bits on the CPU, rounding
    # on the card, where cuDNN's recompute sums in its own order
    "unfolded_constant_memory": ("gradients within 1e-4 of the largest, less peak memory "
                                 "with remat",
                                 lambda o: o["max_grad_rel_difference"] < 1e-4
                                 and (not o["peak_bytes"]  # measured on a card only
                                      or o["peak_bytes"]["True"] < o["peak_bytes"]["False"])),
    "learned_primal_dual": ("learned PD beats the FBP", lambda o: o["psnr_xhat"] > o["psnr_fbp"]),
    "vanilla_unfolded": ("the test PSNR rises", lambda o: o["psnr_final"] > o["psnr_initial"]),
    "custom_prior_unfolded": ("the test PSNR rises",
                              lambda o: o["psnr_after"] > o["psnr_before"]),
    "unfolded_constrained_lista": ("CP beats the zero fill",
                                   lambda o: o["psnr_xhat"] > o["psnr_zero_fill"]),
    "diffusion_sampling": ("DDRM, DiffPIR beat the adjoint; DPS's mean within 0.05 of the prior's",
                           lambda o: min(o["psnr_ddrm"], o["psnr_diffpir"]) > o["psnr_adjoint"]
                           and abs(o["dps_sample_mean"] - o["prior_mean"]) < 0.05),
    "sde_sampling": ("each sample mean within 0.3 of 0.5",
                     lambda o: all(abs(o[k] - 0.5) < 0.3 for k in (
                         "ve_euler_mean", "vp_euler_mean", "ve_heun_mean",
                         "flow_matching_mean"))),
    # SKRock: the JAX demo's 0.2 is a max over 256 pixels of a ~100-sample
    # mean, which either package's chain passes or not by its seed (JAX
    # 0.155-0.239 over keys 0-5, the port 0.165-0.254 over seeds 0-5 on the CPU)
    "mcmc_sampling": ("ULA's mean error < 0.2, SKRock's < 0.3",
                      lambda o: o["ula_mean_error"] < 0.2 and o["skrock_mean_error"] < 0.3),
    "custom_mcmc_kernel": ("mean error < 0.15, variance error < 50%",
                           lambda o: o["mean_error"] < 0.15 and o["var_rel_error"] < 0.5),
}

# phase 24: the gallery's physics, blind, transforms, metrics, models,
# remote-sensing and performance demos (deepinv_tpu_torch/examples
# CATEGORIES), within GALLERY_BUDGET_S as phase 23's; phase 23 runs the rest
GALLERY_23 = ("basics", "plug-and-play", "optimization", "unfolded", "sampling")
# the demos of phase 24 that run at their fast size on the card: none
GALLERY24_FAST = ()
# the phase-24 demos whose TV prox reaches K7 (TVPrior's or TVDenoiser's)
GALLERY24_K7 = ("mri_tour", "ct_projectors", "radio_interferometry", "anscombe",
                "pansharpening", "classic_denoisers", "denoiser_tour")
# the PSNRs of the K7 demos that are not held to the CPU's within
# GALLERY_CPU_DB: BM3D aggregates with index_add_ (atomic adds on the card),
# and EPLL's GMM is fitted on the card by float32 EM
GALLERY24_CPU_DB_SKIP = {"classic_denoisers": ("psnr[BM3D]",),
                         "denoiser_tour": ("psnr[BM3D]", "psnr[EPLL (fitted GMM)]")}
# the CPU runs of the gallery phases' K7 demos: (demos, threads), one worker
# process a group, started before phase 23 and run beside both phases' card
# demos. CT's three backends at 128² take an autograd adjoint on the CPU and
# go alone: started with phase 24 on 3 threads, they held it to 106.6 s
# against 36.7 s of card demos (NVIDIA H100 80GB HBM3, 700.00 W, PERF.md §6)
GALLERY_CPU_GROUPS = {23: ((GALLERY_K7, 2),),
                      24: ((("ct_projectors",), 4),
                           (("mri_tour", "radio_interferometry", "anscombe", "pansharpening",
                             "classic_denoisers", "denoiser_tour"), 1))}
GALLERY24_CLAIMS = {
    "mri_tour": ("TV-PGD beats the zero fill, dynamic adjointness < 1e-3",
                 lambda o: o["psnr_tv"] > o["psnr_zero_filled"]
                 and o["dynamic_adjointness"] < 1e-3),
    "ct_projectors": ("TV-PGD beats the FBP on each backend",
                      lambda o: all(o[f"psnr_tv_{m}"] > o[f"psnr_fbp_{m}"]
                                    for m in ("interp", "fourier", "slice"))),
    # the order the JAX demo prints at its fast size (its CG did not finish
    # on the CPU at this size, where it prints FDK 20.59 dB)
    "conebeam_fdk": ("FDK beats CG, CG the zero volume by 3 dB",
                     lambda o: o["psnr_fdk"] > o["psnr_cg"] > o["psnr_zero"] + 3),
    "radio_interferometry": ("PnP-FISTA beats the dirty image",
                             lambda o: o["psnr_xhat"] > o["psnr_dirty"]),
    "physics_tour": ("adjointness < 1e-3, dagger residual < 0.5",
                     lambda o: o["max_adjointness"] < 1e-3 and o["max_dagger_residual"] < 0.5),
    "phase_retrieval": ("refined cosine > spectral, > 0.9",
                        lambda o: o["cosine_refined"] > max(o["cosine_spectral"], 0.9)),
    # the JAX demo asserts 1e-2 and fails it itself (1.75e-01, cosine
    # 0.98491): the card's run is held to JAX's numbers, within rounding
    # over 1500 steps
    "ptychography": ("JAX's result: relative error 0.175, cosine 0.98491",
                     lambda o: abs(o["rel_error"] - 0.175) < 5e-3
                     and abs(o["cosine"] - 0.98491) < 5e-4),
    "scattering": ("Born < 0.1 of the full model, inversion < 0.6, more at strong contrast",
                   lambda o: o["born_error"] < 0.1 and o["inversion_error"] < 0.6
                   and o["strong_born_error"] > o["born_error"]),
    "blur_tour": ("space-varying adjointness < 1e-4", lambda o: o["svb_adjointness"] < 1e-4),
    "lidar": ("depth MAE < 1.5 bins, reflectivity < 0.3",
              lambda o: o["depth_mae"] < 1.5 and o["reflectivity_rel_error"] < 0.3),
    "spatial_unwrapping": ("> 20% wrapped, Itoh < 1e-4, noisy < 0.1",
                           lambda o: o["wrapped_share"] > 0.2 and o["max_error"] < 1e-4
                           and o["noisy_rel_error"] < 0.1),
    "anscombe": ("std in (0.7, 1.3), round trip < 1e-2, +3 dB",
                 lambda o: 0.7 < o["stabilized_std"] < 1.3 and o["round_trip_error"] < 1e-2
                 and o["psnr_xhat"] > o["psnr_y"] + 3.0),
    "pet": ("MLEM beats the backprojection, 3-D adjointness < 1e-4",
            lambda o: o["psnr_mlem"] > o["psnr_backprojection"] and o["adjointness_3d"] < 1e-4),
    "single_pixel": ("PnP beats the dagger, sequency the worst ordering",
                     lambda o: o["psnr_pnp"] > o["psnr_dagger"]
                     and o["psnr_dagger_sequency"] < min(
                         o[f"psnr_dagger_{k}"] for k in ("cake_cutting", "zig_zag", "xy"))),
    "liu_jia_padding": ("Liu-Jia padding beats no padding, Wiener and inverse",
                        lambda o: all(o[f"psnr_{k}_liu_jia"] > o[f"psnr_{k}_no_pad"]
                                      for k in ("wiener", "inverse"))),
    "microscopy_3d": ("adjointness < 1e-4, PGD beats the widefield image",
                      lambda o: o["adjointness"] < 1e-4 and o["psnr_xhat"] > o["psnr_y"]),
    "blind_deblur": ("4 33x33 kernels and multipliers, a finite recon",
                     lambda o: o["filters_shape"] == [1, 1, 4, 33, 33]
                     and o["multipliers_shape"] == [1, 1, 4, 64, 64] and o["xhat_finite"]),
    "blind_denoising": ("each estimate within 35%, +2 dB",
                        lambda o: max(o["rel_error"].values()) < 0.35
                        and o["psnr_xhat"] > o["psnr_y"] + 2.0),
    "optimize_physics_parameter": ("kernel error below half its start",
                                   lambda o: o["kernel_error"] < 0.5 * o["kernel_error_start"]),
    "transforms": ("shift round trip < 1e-5", lambda o: o["shift_round_trip"] < 1e-5),
    "ei_projective": ("each EI training lowers its loss",
                      lambda o: all(h[-1] < h[0] for h in o["loss_history"].values())),
    "metrics": ("LPIPS ranks the mild noise below the heavy",
                lambda o: o["LPIPS_mild"] < o["LPIPS_heavy"]),
    "custom_niqe": ("NIQE scores the clean image below the noisy",
                    lambda o: o["niqe"]["clean"] < o["niqe"]["noisy"]),
    "classic_denoisers": ("noisy < median < db4 < TV < BM3D",
                          lambda o: o["psnr_y"] < o["psnr"]["median 3x3"]
                          < o["psnr"]["wavelet db4"] < o["psnr"]["TV (Chambolle)"]
                          < o["psnr"]["BM3D"]),
    "denoiser_tour": ("each beats the noisy input, TV the best",
                      lambda o: min(o["psnr"].values()) > o["psnr_y"]
                      and max(o["psnr"], key=o["psnr"].get) == "TV"),
    "deal_reconstruction": ("denoised in [0, 1], a finite recon",
                            lambda o: 0.0 <= o["denoised_min"] <= o["denoised_max"] <= 1.0
                            and o["xhat_finite"]),
    "training": ("the resumed test PSNR within 1e-3, the loss falls",
                 lambda o: abs(o["psnr_resumed"] - o["psnr"]) < 1e-3
                 and o["loss_history"][-1] < o["loss_history"][0]),
    "foundation_model": ("three finite outputs of their inputs' shapes",
                         lambda o: all(o["shape_ok"].values()) and all(o["finite"].values())),
    "super_resolution": ("dagger >= adjoint, PnP-HQS beats the dagger",
                         lambda o: all(o[f"psnr_dagger_{k}"] >= o[f"psnr_adjoint_{k}"] - 1e-4
                                       for k in ("gaussian", "bicubic", "none"))
                         and o["psnr_xhat"] > o["psnr_dagger"]),
    "3d_cnn_denoisers": ("inflation within 1e-5, fine-tuned 3-D > slice-wise 2-D > noisy",
                         lambda o: o["inflation_max_diff"] < 1e-5
                         and o["psnr_3d_finetuned"] > o["psnr_2d"] > o["psnr_noisy"]),
    "batched_throughput": ("images/s at B=8 above B=1, the first image batch-independent",
                           lambda o: o["images_per_s"][max(o["images_per_s"], key=int)]
                           > o["images_per_s"]["1"] and o["first_image_rel_diff"] < 1e-5),
    "pansharpening": ("PnP-TV beats the Brovey fusion",
                      lambda o: o["psnr_xhat"] > o["psnr_brovey"]),
}

# phase 25: the gallery's self-supervised, adversarial, distributed and
# datasets demos (deepinv_tpu_torch/examples CATEGORIES), within
# GALLERY_BUDGET_S as phases 23 and 24; none reaches a kernel
GALLERY_24 = ("physics", "blind-inverse-problems", "transforms-equivariance", "metrics",
              "models", "remote sensing", "performance")
GALLERY_25 = ("self-supervised-learning", "adversarial-learning", "distributed", "datasets")
# the demos of phase 25 that run at their fast size on the card: none
GALLERY25_FAST = ()
# the packages beyond the port's own that a gallery demo imports where it
# runs: a demo whose package the host lacks is not run, and its phase says so
GALLERY_PACKAGES = {"custom_dataset": ("h5py",), "microscopy_denoising": ("PIL",),
                    "native_dataloader": ("PIL",), "io": ("PIL", "h5py", "scipy"),
                    "hdf5_convention": ("h5py",)}
# the demos that need the port's native image decoder (g++, libpng and
# libjpeg on the host): ``ImageFolder.batches`` has no other path
GALLERY_NATIVE = ("native_dataloader",)
# the JAX demo's K-weight range (WeightedSplittingLoss, demo_scan_specific),
# and how far the port's may lie from its top: both are Monte-Carlo means of
# 2000 mask draws, and the top, ~(0.4 P)^-1/2, comes from the least sampled
# column, whose density P ~ 0.07 such a mean knows to ~8%, so the top to ~4%
# (5.87 on the port's seeded draws, 1.9% from JAX's)
SCAN_K_WEIGHT = (1.00, 5.76)
SCAN_K_WEIGHT_RTOL = 0.05


def _falls_and_rises(o):
    """A Trainer demo's claim: the last epoch's loss below the first's and
    its train PSNR above the first's."""
    return (o["loss_history"][-1] < o["loss_history"][0]
            and o["psnr_history"][-1] > o["psnr_history"][0])


GALLERY25_CLAIMS = {
    "selfsup_ei": ("the loss falls, the train PSNR rises", _falls_and_rises),
    "splitting_loss": ("the loss falls, the train PSNR rises, a finite test PSNR",
                       lambda o: _falls_and_rises(o) and math.isfinite(o["psnr_test"])),
    "sure_denoising": ("mean SURE within 0.01 of the mean MSE",
                       lambda o: abs(o["sure_mean"] - o["true_mse_mean"]) < 0.01
                       and math.isfinite(o["sure_poisson_mean"])),
    "r2r_denoising": ("the loss falls, the train PSNR rises", _falls_and_rises),
    "n2n_denoising": ("the loss falls, the train PSNR rises", _falls_and_rises),
    "multioperator_imaging": ("3 operators, the loss falls, the train PSNR rises",
                              lambda o: o["operators"] == 3 and _falls_and_rises(o)),
    "artifact2artifact": ("the loss falls", lambda o: o["losses"][-1] < o["losses"][0]),
    "unsure": ("the closest sigma nearer 0.1 than the start",
               lambda o: abs(o["sigma_closest"] - o["sigma_true"])
               < abs(o["sigmas"][0] - o["sigma_true"])),
    "equivariant_splitting": ("the loss falls, the train PSNR rises, a finite test PSNR",
                              lambda o: _falls_and_rises(o) and math.isfinite(o["psnr_test"])),
    "poisson2sparse": ("Poisson2Sparse and Anscombe + median beat y",
                       lambda o: min(o["psnr_poisson2sparse"], o["psnr_anscombe_median"])
                       > o["psnr_y"]),
    "scan_specific": ("the MoDL loss falls, the K-weight range JAX's [1.00, 5.76]",
                      lambda o: o["finetune_losses"][-1] < o["finetune_losses"][0]
                      and abs(o["k_weight_min"] - SCAN_K_WEIGHT[0]) < 1e-3
                      and abs(o["k_weight_max"] / SCAN_K_WEIGHT[1] - 1) < SCAN_K_WEIGHT_RTOL),
    "microscopy_denoising": ("8 frames, denoised beats noisy",
                             lambda o: o["n_frames"] == 8
                             and o["psnr_denoised"] > o["psnr_noisy"]),
    "lowfieldmri": ("R2R beats one repetition and the 3-average",
                    lambda o: o["psnr_r2r"] > max(o["psnr_single"], o["psnr_average"])),
    "adversarial_training": ("a finite loss an epoch, the last below the first",
                             lambda o: len(o["loss_history"]) == o["epochs"]
                             and all(math.isfinite(v) for v in o["loss_history"])
                             and o["loss_history"][-1] < o["loss_history"][0]),
    "csgm": ("residual < 0.25 residual_0",
             lambda o: o["residual"] < 0.25 * o["residual_start"]),
    "distributed_pnp": ("8 entries, mse < 0.5 mse_0",
                        lambda o: o["mesh"] == 8 and o["mse"] < 0.5 * o["mse_zero"]),
    "physics_distributed": ("8 entries, adjointness < 1e-4, A_dagger rel < 0.5",
                            lambda o: o["mesh"] == 8 and o["adjointness_gap"] < 1e-4
                            and o["rel"] < 0.5),
    "denoiser_distributed": ("halo < 1e-5 < basic, micro-batched < 1e-5",
                             lambda o: o["err_halo"] < 1e-5 < o["err_basic"]
                             and o["err_microbatch"] < 1e-5),
    "native_dataloader": ("4 batches of (8, 3, 64, 64)",
                          lambda o: o["batch_shapes"] == [[8, 3, 64, 64]] * 4
                          and o["item_shape"] == [3, 64, 64]),
    "io": ("the four readers' shapes, the errors within the printed",
           lambda o: o["npy_maxerr"] == 0.0 and o["mat_keys"] == ["img", "pixel_size"]
           and o["tiff_dtype"] == "uint16" and o["tiff_maxerr"] < 1e-5
           and o["h5_shape"] == [1, 1, 64, 64] and o["img_shape"] == [1, 1, 64, 64]),
    "hdf5_convention": ("the members, the NaN ground truth, the transform on x only",
                        lambda o: o["members"] == ["sigma_test", "sigma_train", "x_test",
                                                   "x_train", "y_test", "y_train"]
                        and o["deploy_x_nan"] and o["stacked_parts"] == [[1, o["H"], o["H"]]] * 2
                        and o["transform"] == {"x": [1, o["H"] // 2, o["H"] // 2],
                                               "y": [1, o["H"], o["H"]]}),
}
# each gallery phase: its categories, its fast demos, its K7 demos, its
# claims, its label and the PSNRs its K7 demos need not match on the CPU
GALLERY_PHASES = {
    23: (GALLERY_23, GALLERY_FAST, GALLERY_K7, GALLERY_CLAIMS, "gallery", {}),
    24: (GALLERY_24, GALLERY24_FAST, GALLERY24_K7, GALLERY24_CLAIMS, "gallery 24",
         GALLERY24_CPU_DB_SKIP),
    25: (GALLERY_25, GALLERY25_FAST, (), GALLERY25_CLAIMS, "gallery 25", {}),
}

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12


def kernel_launches(op) -> int:
    """The launches of kernel op ``op`` (a function of ``ops/kernels/``) in
    the library's counter registry."""
    from deepinv_tpu_torch.utils.profiling import counters

    return counters[f"kernel.{op.__name__}.launches"]


def kernel_launches_by_variant(op) -> dict:
    """K7's launches by variant, ``{"resident": n, "global": n}``."""
    from deepinv_tpu_torch.utils.profiling import counters

    return {v: counters[f"kernel.{op.__name__}.launches.{v}"] for v in ("resident", "global")}


def tile_launches_by_form() -> dict:
    """The 64-channel tile's layer launches by plan form, ``{"banded": n,
    "balanced": n}``."""
    from deepinv_tpu_torch.utils.profiling import counters

    return {f: counters[f"kernel.conv_tile.launches.{f}"] for f in ("banded", "balanced")}


def tile_form(shape) -> str:
    """The plan form the 64-channel tile takes for the activation ``shape``
    (B, 64, H, W) on this card."""
    from deepinv_tpu_torch.ops.kernels.conv_tile import conv_tile_plan
    from deepinv_tpu_torch.ops.kernels.resblock_chain import _sms

    return "balanced" if conv_tile_plan(shape[0], *shape[2:], _sms(0)).balanced else "banded"


def check_tile_launches(label: str, before: dict, form: str, n: int) -> None:
    """Since ``before`` (:func:`tile_launches_by_form`), ``n`` layer launches
    of the tile, all of plan form ``form``."""
    ran = {k: v - before[k] for k, v in tile_launches_by_form().items()}
    want = {k: n if k == form else 0 for k in ran}
    check(ran == want, f"{label}: tile launches by plan form {ran}, expected {want}")


def reset_kernel_launches(*ops) -> None:
    """Set the launches of the kernel ops ``ops``, by variant too, to 0."""
    from deepinv_tpu_torch.utils.profiling import counters

    counters.reset(*(k for k in list(counters) for op in ops
                     if k.startswith(f"kernel.{op.__name__}.launches")))


def loop_count(name: str) -> int:
    """A count of the device loops (``device_while``) in the library's counter
    registry: ``loops``, ``host_reads`` or ``bodies``."""
    from deepinv_tpu_torch.utils.profiling import counters

    return counters[f"loop.{name}"]


def reset_loops() -> None:
    """Set the device loops' counts to 0: the registry's and the moved
    iterations that ``loop_stats`` sums on the device."""
    from deepinv_tpu_torch.core import loop_stats
    from deepinv_tpu_torch.utils.profiling import counters

    loop_stats.reset()
    counters.reset("loop.loops", "loop.host_reads", "loop.bodies")


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
# instances: one an epilogue or a projection mode, and the 64-channel tile's
# epilogues each twice, with and without the narrow product of a ragged last
# strip, but kMaskDb; wg::resblocks<Tile64> launches kRelu and kResidual;
# conv_chain.cu kBiasRelu (K5, K6), kMaskDb and kRound (the stash
# backward's dX chain))
WGMMA_KERNELS = {
    "resblock_chain": {"conv3x3_wgmma": 4},                        # K1
    "conv_chain": {"conv3x3_wgmma": 5},                            # K5, K6, dX
    "up_resblock_chain": {"conv3x3_wgmma": 4, "proj2x2_wgmma": 1},  # K2/K3
    "up_sandwich": {"conv3x3_wgmma": 4, "conv3x3_c128_wgmma": 2, "proj2x2_wgmma": 2},  # K4
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


def drive(name: str, model, y, physics, net, op, plain_chain, shape, exact_chain=None,
          residual_of=None, iters: int = MAX_ITER):
    """One reconstruction on the kernel path (the launches of ``op``, one
    kernel op or a tuple of them, set to 0 just before it and read just
    after: :func:`kernel_launches`), checked: finite output of ``shape``,
    one launch of each op and one denoiser call per iteration, each call of
    ``net`` against the same call on the plain chain, and the whole run
    against the plain chain's run, of ``iters`` iterations. Returns
    ``(out, out_plain, launches)``, the launches of the first op.

    With ``exact_chain`` (a context that runs the chain in f32 with no
    rounding inside it; DnCNN), each call's residual is held too, and the
    whole run against the run on that unrounded chain. The residual is the
    output minus the input, or, with ``residual_of``, the output of that
    submodule (DnCNN's ``out_conv``): the residual before it is added to the
    input and rounded at the image's scale, where one bf16 ulp of an image
    near 1 is a large share of a small residual (phase 15)."""
    import torch

    calls = []  # every denoiser input of the run, to replay on the plain chain
    hook = net.register_forward_pre_hook(
        lambda mod, args: calls.append((args[0].detach().clone(), args[1])))
    ops = op if isinstance(op, tuple) else (op,)
    cuda = y.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for o in ops:
        reset_kernel_launches(o)
    t0 = time.perf_counter()
    with torch.no_grad():
        out = model(y, physics)
    sync(y.device)
    first_s = time.perf_counter() - t0
    counts = [kernel_launches(o) for o in ops]
    launches = counts[0]
    hook.remove()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0
    print(f"{name} {iters} it: first run {first_s:.3f} s, kernel launches "
          f"{dict(zip((o.__name__ for o in ops), counts))}, peak memory {peak_gib:.3f} GiB",
          flush=True)
    for o, n in zip(ops, counts):
        check(n == iters, f"{name}: expected {iters} launches of {o.__name__}, got {n}")
    check(tuple(out.shape) == shape and out.dtype == torch.float32,
          f"{name}: bad output shape/dtype")
    check(bool(torch.isfinite(out).all()), f"{name}: non-finite reconstruction")
    check(len(calls) == iters, f"{name}: expected {iters} denoiser calls, got {len(calls)}")
    res = []
    res_hook = None if residual_of is None else residual_of.register_forward_hook(
        lambda mod, args, out: res.append(out.float()))
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
            r_k, r_p = (res[-2], res[-1]) if res_hook is not None else (d_k - xin, d_p - xin)
            rl2 = float((r_k - r_p).norm() / r_p.norm())
            line += f"; residual relative L2 {rl2}"
            ok = ok and rl2 <= DENOISER_RTOL
        print(line, flush=True)
        check(ok, f"{name}: denoiser call {i} disagrees with the plain chain")
    if res_hook is not None:
        res_hook.remove()
    launches_after = [kernel_launches(o) for o in ops]
    with plain_chain(), torch.no_grad():
        out_plain = model(y, physics)
    sync(y.device)
    check([kernel_launches(o) for o in ops] == launches_after,
          f"{name}: the plain run launched a kernel")
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
    launches, name)], device busy ms)`` per call, or None where the profiler
    saw no device time."""
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
    return wall_ms, busy, n_kernels, kernels, busy_union


def plain_conv_chain():
    """DnCNN's hidden chain on the plain version instead of the kernel."""
    import deepinv_tpu_torch.models.dncnn as dncnn_mod
    from deepinv_tpu_torch.ops.kernels.conv_chain import conv_chain_plain

    return swapped(dncnn_mod, "conv_chain",
                   lambda h, ws, bs, packed=None: conv_chain_plain(h, ws, bs))


def exact_conv_chain():
    """DnCNN's hidden chain in f32 with no rounding inside it (bf16 weights
    and input, one rounding of the output)."""
    import torch

    import deepinv_tpu_torch.models.dncnn as dncnn_mod
    from deepinv_tpu_torch.ops.kernels.conv_chain import chain_f32

    return swapped(dncnn_mod, "conv_chain", lambda h, ws, bs, packed=None: chain_f32(
        h, ws.to(torch.bfloat16), bs).to(torch.bfloat16))


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
    call (``kernel.stash_backward.launches`` set to 0 just before), db the same bits
    in a second call, and dh, dW, db within STASH_BWD_RTOL of the plain
    backward. Returns the max abs error over the stash and the backward's
    max abs errors by output (bf16 weights; None on the mma.sync tile)."""
    import torch

    from deepinv_tpu_torch.ops.kernels.conv_chain import (
        _launch_stash, conv_chain, conv_chain_stash, conv_chain_stash_plain, pack_bias,
        pack_weights, stash_backward)

    reset_kernel_launches(conv_chain, conv_chain_stash)
    L, form, tiles = ws.shape[0], tile_form(h.shape), tile_launches_by_form()
    with torch.no_grad():
        got = (conv_chain_stash(h, ws, bs) if tile == "wgmma"
               else _launch_stash(h, pack_weights(ws), pack_bias(bs), tile))
        torch.cuda.synchronize()
        launches = (kernel_launches(conv_chain_stash), kernel_launches(conv_chain))
        want = conv_chain_stash_plain(h, ws, bs)
    check(launches == (1, 0), f"{label}: expected one K6 launch and no K5 launch, got {launches}")
    check_tile_launches(f"{label} (K6)", tiles, form, L if tile == "wgmma" else 0)
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
    bwd_err = {}
    # f32 weights (dW in f32, TF32) and bf16 weights (training under
    # autocast: dW as a bf16 cuDNN wgrad)
    for wdt in (torch.float32, torch.bfloat16):
        w = ws.to(wdt)
        reset_kernel_launches(stash_backward)
        tiles = tile_launches_by_form()
        k = stash_backward(h, w, got, cot)
        torch.cuda.synchronize()
        n = kernel_launches(stash_backward)
        check(n == L + 2, f"{label}: stash backward launched {n} kernels, not L + 2 = {L + 2}")
        check_tile_launches(f"{label} stash backward's dX chain", tiles, form, L)
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


def make_trainer(net, physics, xs, batch: int, fused: bool, losses=None,
                 physics_generator=None, lr: float = 1e-4):
    """``Trainer`` of ``ArtifactRemoval(autocast(copy of net))`` with Adam(``lr``)
    over ``xs`` in batches of ``batch``, online measurements (with the
    operator's parameters from ``physics_generator``, if given), one epoch."""
    import torch

    from deepinv_tpu_torch.datasets import ArrayDataset, DataLoader
    from deepinv_tpu_torch.models import ArtifactRemoval, autocast
    from deepinv_tpu_torch.training import Trainer

    model = ArtifactRemoval(autocast(copy.deepcopy(net)))
    return Trainer(model, physics, optimizer=torch.optim.Adam(model.parameters(), lr=lr),
                   train_dataloader=DataLoader(ArrayDataset(xs), batch_size=batch),
                   losses=losses, epochs=1, online_measurements=True, verbose=False,
                   fused_chains=fused, seed=SEED, physics_generator=physics_generator)


def first_batch(trainer):
    """The trainer's first batch and its first step's measurement draws (and
    physics parameters, with a physics generator)."""
    trainer.setup_train()
    batch = next(trainer.current_train_iterators[0])
    return trainer.get_samples(batch, trainer.physics[0], *trainer._sample_generators(0, 0, 0, 0))


def step_fn(trainer, x, y, physics):
    """One train step of ``trainer`` on a fixed batch, in its configuration."""
    def run():
        trainer.optimizer.zero_grad(set_to_none=True)
        with trainer._chains():
            loss, _ = trainer.compute_loss(trainer.model, x, y, physics)
            loss.backward()
        trainer.optimizer.step()
    return run


def first_step_grads(trainer) -> list:
    """The parameter gradients of the trainer's loss on its first batch, one
    flat f32 vector a parameter tensor."""
    x, y, phys = first_batch(trainer)
    trainer.optimizer.zero_grad(set_to_none=True)
    with trainer._chains():
        trainer.compute_loss(trainer.model, x, y, phys)[0].backward()
    gs = [p.grad.reshape(-1).float() for p in trainer.model.parameters()]
    trainer.optimizer.zero_grad(set_to_none=True)
    return gs


def grad_errors(gs, refs) -> tuple:
    """The whole gradient's relative max error (phase 9's) and the largest
    relative L2 error of one parameter tensor's, of ``gs`` against ``refs``."""
    import torch

    return rel_max(torch.cat(gs), torch.cat(refs)), max(rel_l2(a, b) for a, b in zip(gs, refs))


def loss_error(losses, refs) -> float:
    """The largest relative error of a step's loss."""
    return max(abs(a - b) / abs(b) for a, b in zip(losses, refs))


@contextlib.contextmanager
def planted_fault(fault):
    """Inside the block, the chain's autograd backward gets
    ``fault(dX, dW, db)`` of the stash backward's result: a mutation check of
    the checks, in this process only (the module's function is restored on
    exit)."""
    import deepinv_tpu_torch.ops.kernels.conv_chain as ck

    real = ck.stash_backward

    def faulty(*args, **kwargs):
        return fault(*real(*args, **kwargs))

    ck.stash_backward = faulty
    try:
        yield
    finally:
        ck.stash_backward = real


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
    """One TV reconstruction on the kernel path (``op``'s launches and
    launches by variant set to 0 just before it and read just after),
    checked: finite output shaped like ``x``, one prox launch per iteration,
    each on the resident variant, within TV_RECON_RTOL of the same run on the
    plain prox, and no worse than ``naive`` by more than TV_PSNR_SLACK_DB.
    Returns the launches."""
    import torch

    reset_kernel_launches(op)
    t0 = time.perf_counter()
    with torch.no_grad():
        out = model(y, physics)
    sync(x.device)
    first_s = time.perf_counter() - t0
    launches, by_variant = kernel_launches(op), kernel_launches_by_variant(op)
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
    sync(x.device)
    check(kernel_launches(op) == launches, f"{name}: the plain run launched the kernel")
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
        g_ref, g_k6 = (torch.cat(first_step_grads(trainers[f])) for f in (False, True))
        gerr = rel_max(g_k6, g_ref)
        print(f"train B={B}: first step's gradient, fused_chains=True vs False: relative max "
              f"error {gerr} (bound {GRAD_RTOL}), relative L2 {rel_l2(g_k6, g_ref)}", flush=True)
        check(gerr <= GRAD_RTOL, f"train B={B}: first-step gradients disagree")
        losses = {}
        for f, t in trainers.items():
            reset_kernel_launches(conv_chain, conv_chain_stash, stash_backward)
            secs = train_epoch(t, 0, dev)
            n6, n5, nb = (kernel_launches(conv_chain_stash), kernel_launches(conv_chain),
                          kernel_launches(stash_backward))
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
        lerr = loss_error(losses[True], losses[False])
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
        reset_kernel_launches(conv_chain, conv_chain_stash)
        secs = train_epoch(t, 0, dev)
        vals = t.logs_total_loss_train.vals
        terms = [m.vals for m in t.logs_losses_train]
        print(f"EI+SURE B={B}: {steps} steps in {secs:.3f} s (first epoch), losses {vals}, "
              f"SURE {terms[0]}, EI {terms[1]}, launches K6 {kernel_launches(conv_chain_stash)} "
              f"K5 {kernel_launches(conv_chain)}", flush=True)
        check(len(vals) == steps and all(math.isfinite(v) for v in vals + terms[0] + terms[1]),
              f"EI+SURE B={B}: non-finite loss")
        check(kernel_launches(conv_chain) == kernel_launches(conv_chain_stash) == 0,
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


def plain_k1():
    """DRUNet's scale-0 chain on K1's plain version instead of the kernel
    (differentiable: DPS's plain gradient runs through it)."""
    import deepinv_tpu_torch.models.drunet as drunet_mod
    from deepinv_tpu_torch.ops.kernels.resblock_chain import resblock_chain_plain

    return swapped(drunet_mod, "resblock_chain",
                   lambda h, w1s, w2s, packed=None: resblock_chain_plain(h, w1s, w2s))


def sample_drive(name: str, run, net, calls: int, dev):
    """One sampler run on the kernel path (K1's ``launches`` set to 0 just
    before it and read just after), checked: K1 launched once per denoiser
    call and ``calls`` calls, each of the first SAMPLE_CHECKED_CALLS calls of
    ``net`` against the same call on K1's plain version, finite output, and
    the whole sample against the run on the plain version from the same
    generator seed. ``run()`` makes its own generator. Returns the launches."""
    import torch

    from deepinv_tpu_torch.ops.kernels.resblock_chain import resblock_chain

    seen, kept = [], []   # every call; the first calls' inputs

    def keep(mod, args):
        seen.append(1)
        if len(kept) < SAMPLE_CHECKED_CALLS:
            kept.append((args[0].detach().clone(), args[1]))

    hook = net.register_forward_pre_hook(keep)
    reset_kernel_launches(resblock_chain)
    t0 = time.perf_counter()
    with torch.no_grad():
        out = run()
    sync(dev)
    first_s = time.perf_counter() - t0
    launches = kernel_launches(resblock_chain)
    hook.remove()
    print(f"{name}: first run {first_s:.3f} s, K1 launches {launches}, denoiser calls "
          f"{len(seen)} (expected {calls})", flush=True)
    check(launches == calls and len(seen) == calls,
          f"{name}: {launches} K1 launches and {len(seen)} denoiser calls, expected {calls}")
    check(bool(torch.isfinite(out).all()), f"{name}: non-finite sample")
    for i, (xin, sigma) in enumerate(kept):
        with torch.no_grad():
            d_k = net(xin, sigma).float()
            with plain_k1():
                d_p = net(xin, sigma).float()
        err, scale = float((d_k - d_p).abs().max()), float(d_p.abs().max())
        print(f"{name} denoiser call {i}: kernel vs plain max_abs_err {err} (scale {scale}, "
              f"rel {err / scale}, bound {DENOISER_RTOL})", flush=True)
        check(err <= DENOISER_RTOL * scale, f"{name}: denoiser call {i} disagrees with plain")
    reset_kernel_launches(resblock_chain)
    with torch.no_grad(), plain_k1():
        out_plain = run()
    check(kernel_launches(resblock_chain) == 0, f"{name}: the plain run launched K1")
    rerr = rel_l2(out, out_plain)
    print(f"{name} kernel vs plain: relative L2 error {rerr} (bound {RECON_RTOL}), max |x| "
          f"{float(out.abs().max())}, plain {float(out_plain.abs().max())}", flush=True)
    check(rerr <= RECON_RTOL, f"{name}: the sample disagrees with the plain run")
    return launches


def slope_rate(label: str, make_run, n_short: int, reps: int = 3):
    """Seconds a step by the slope between runs of ``n_short`` and
    ``4 n_short`` steps (``bench.py``'s ``_timed_slope``: set-up and the
    first and last phases cancel), each the least of ``reps`` CUDA-event
    times, in turns (n, 4n, 4n, n); returns steps per second."""
    import torch

    runs = {n: make_run(n) for n in (n_short, 4 * n_short)}
    times = {n: [] for n in runs}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for n in (n_short, 4 * n_short, 4 * n_short, n_short):
        runs[n]()
        for _ in range(reps):
            start.record()
            runs[n]()
            end.record()
            torch.cuda.synchronize()
            times[n].append(start.elapsed_time(end))
    t_short, t_long = min(times[n_short]), min(times[4 * n_short])
    per_step = (t_long - t_short) / (3 * n_short)
    print(f"{label}: ms per sample {times}; slope {per_step:.4f} ms a step, "
          f"{1e3 / per_step:.2f} steps/s", flush=True)
    return 1e3 / per_step


def sampling_phase(dev, card: str, size: int = 256, nc=(64, 128, 256, 512)) -> dict:
    """Phase 11: the samplers through their entry points with a bf16
    full-width DRUNet in ``down`` (K1) at 256² (``bench.py:384-475``): DDRM
    on inpainting at B=1 and B=8, DPS and DiffPIR on 4x bicubic
    super-resolution at B=1, short ULA and PosteriorDiffusion runs; the
    guidance gradient of a DPS step against the plain path, with K1's
    backward asked for dh alone and no weight gradient; rates by the slope
    between n and 4n steps under the bench's metric names; K1's backward
    timed with TF32 (the op's) and without, beside cuDNN f32 layers under
    autograd; a DDRM and a DPS sample profiled. Returns the numbers of the
    kernels line. On the CPU (``dev``), at a small ``size`` and ``nc``, it
    rehearses the checks and stops before the times."""
    import numpy as np
    import torch

    import deepinv_tpu_torch.ops.kernels.resblock_chain as rc_mod
    from deepinv_tpu_torch.models import DRUNet, autocast
    from deepinv_tpu_torch.ops import gaussian_blur
    from deepinv_tpu_torch.ops.kernels.resblock_chain import pack_weights, resblock_chain
    from deepinv_tpu_torch.optim import L2, ScorePrior
    from deepinv_tpu_torch.physics import BlurFFT, Downsampling, GaussianNoise, Inpainting
    from deepinv_tpu_torch.sampling import (DDRM, DPS, ULA, DiffPIR, DPSDataFidelity,
                                            EulerSolver, PosteriorDiffusion,
                                            VariancePreservingDiffusion)

    g = torch.Generator().manual_seed(SEED + 19)
    net = DRUNet(nc=nc, nb=R_MAIN, generator=g, device=dev)
    den = autocast(net)
    shape = (1, 3, size, size)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    inp = Inpainting(shape[1:], mask=0.7, generator=torch.Generator().manual_seed(SEED + 20),
                     noise_model=GaussianNoise(0.05, device=dev), device=dev)
    sr = Downsampling(img_size=shape[1:], filter="bicubic", factor=4,
                      noise_model=GaussianNoise(0.05, device=dev), device=dev)
    x1 = torch.rand(shape, generator=g).to(dev)
    x8 = torch.rand((SAMPLE_BATCH,) + shape[1:], generator=g).to(dev)
    y1, y8 = inp(x1, generator=gen(SEED + 21)), inp(x8, generator=gen(SEED + 22))
    ys = sr(x1, generator=gen(SEED + 23))
    check(tuple(ys.shape) == (1, 3, size // 4, size // 4), f"SR measurement {tuple(ys.shape)}")
    out = {"launches": {}}

    def sample(m, *args, seed):
        """One sample of ``m`` under ``torch.no_grad()``, as a caller runs it
        (DPS differentiates its guidance inside), on a fresh generator."""
        def run():
            with torch.no_grad():
                return m(*args, generator=gen(seed))
        return run

    def ddrm(n, y):
        return sample(DDRM(den, sigmas=np.linspace(1, 0, n + 1)), y, inp, seed=SEED + 24)

    def dps(n):
        return sample(DPS(den, max_iter=n), ys, sr, seed=SEED + 25)

    def diffpir(n):
        return sample(DiffPIR(den, sigma=0.05, max_iter=n), ys, sr, seed=SEED + 26)

    n1, n8 = SAMPLE_STEPS, SAMPLE_STEPS // 2
    out["launches"]["DDRM B=1"] = sample_drive(f"DDRM B=1 n={n1}", ddrm(n1, y1), net, n1 + 1, dev)
    out["launches"][f"DDRM B={SAMPLE_BATCH}"] = sample_drive(
        f"DDRM B={SAMPLE_BATCH} n={n8}", ddrm(n8, y8), net, n8 + 1, dev)
    out["launches"]["DPS B=1"] = sample_drive(f"DPS B=1 n={n1}", dps(n1), net, n1, dev)
    out["launches"]["DiffPIR B=1"] = sample_drive(f"DiffPIR B=1 max_iter={n1}", diffpir(n1), net,
                                                  n1 - 1, dev)

    # DPS's guidance gradient for one step, kernel path against plain; K1's
    # backward is asked for dh alone and no weight gets a gradient
    m = DPS(den, max_iter=n1)
    at = m._sched[n1 // 2][0]
    xg = torch.randn(shape, generator=gen(SEED + 27), device=dev)
    asked = []
    f32_chain = rc_mod.resblocks_f32
    with swapped(rc_mod, "resblocks_f32",
                 lambda *a: asked.append([v.requires_grad for v in a]) or f32_chain(*a)):
        reset_kernel_launches(resblock_chain)
        g_k, _, _ = m.guidance(xg, ys, sr, at)
        sync(dev)
    check(kernel_launches(resblock_chain) == 1, "DPS guidance: K1 not launched once")
    check(asked == [[True, False, False]], f"DPS guidance: K1's backward asked for {asked}")
    check(all(p.grad is None and p.requires_grad for p in den.parameters()),
          "DPS guidance: a weight got a gradient, or its flag was not restored")
    with plain_k1():
        g_p, _, _ = m.guidance(xg, ys, sr, at)
    with swapped(rc_mod, "_tf32_convs", contextlib.nullcontext):
        g_k32, _, _ = m.guidance(xg, ys, sr, at)
    gerr, gerr32 = rel_l2(g_k, g_p), rel_l2(g_k32, g_p)
    print(f"DPS guidance gradient (alpha_bar {at}): kernel path vs plain relative L2 {gerr} "
          f"(K1 backward in TF32, the op's; bound {SAMPLE_GRAD_RTOL}), {gerr32} with TF32 off; "
          f"TF32 vs off {rel_l2(g_k, g_k32)}", flush=True)
    check(gerr <= SAMPLE_GRAD_RTOL, "DPS guidance gradient disagrees with the plain path")
    out["grad_err"], out["grad_err_tf32_off"] = gerr, gerr32

    # short runs: ULA (ScorePrior) on deblurring, PosteriorDiffusion (VP SDE
    # with DPS guidance) on super-resolution
    blur = BlurFFT(shape[1:], filter=gaussian_blur(sigma=1.5),
                   noise_model=GaussianNoise(0.05, device=dev), device=dev)
    yb = blur(x1, generator=gen(SEED + 28))
    ula = ULA(ScorePrior(den), L2(sigma=0.05), step_size=1e-4, sigma=0.05, max_iter=ULA_STEPS,
              thinning=1, burnin_ratio=0.0)
    out["launches"]["ULA B=1"] = sample_drive(f"ULA B=1 {ULA_STEPS} steps",
                                              sample(ula, yb, blur, seed=SEED + 29), net,
                                              ULA_STEPS, dev)
    pd = PosteriorDiffusion(VariancePreservingDiffusion(den), DPSDataFidelity(den),
                            solver=EulerSolver(np.linspace(1.0, 0.05, PD_STEPS + 1)))
    out["launches"]["PosteriorDiffusion B=1"] = sample_drive(
        f"PosteriorDiffusion (VP) B=1 {PD_STEPS} steps",
        sample(pd, ys, sr, seed=SEED + 30), net, 2 * PD_STEPS, dev)
    check(all(p.grad is None for p in den.parameters()), "a sampler gave a weight a gradient")
    if dev.type != "cuda":
        return out

    # rates: the slope between n and 4n steps (bench.py:434-436)
    rates = {
        "ddrm_drunet_inpainting_256px_steps_per_sec_chip":
            (1, slope_rate("DDRM B=1", lambda n: ddrm(n, y1), n1)),
        f"ddrm_drunet_inpainting_256px_steps_per_sec_chip_b{SAMPLE_BATCH}":
            (SAMPLE_BATCH, slope_rate(f"DDRM B={SAMPLE_BATCH}", lambda n: ddrm(n, y8), n8)),
        "dps_drunet_sr4_256px_steps_per_sec_chip": (1, slope_rate("DPS B=1", dps, n1)),
    }
    for metric, (b, v) in rates.items():
        row = {"metric": metric, "value": v, "unit": "step/s", "card": card}
        if b > 1:
            row.update(batch=b, images_per_sec=v * b)
        print(f"rate: {json.dumps(row)}", flush=True)
    out["rates"] = {k: v for k, (_, v) in rates.items()}

    # K1's backward at the DPS step's shape (dh only): TF32 (the op's) and
    # off, in turns, beside cuDNN f32 layers under autograd (their dgrad)
    w1 = torch.stack([b.conv1.weight for b in net.m_down1[:-1]]).detach().to(torch.bfloat16)
    w2 = torch.stack([b.conv2.weight for b in net.m_down1[:-1]]).detach().to(torch.bfloat16)
    hk = torch.randn((1, 64, 256, 256), generator=gen(SEED + 31), device=dev).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last).requires_grad_()
    ok = resblock_chain(hk, w1, w2, (pack_weights(w1), pack_weights(w2)))
    gk = torch.randn(ok.shape, generator=gen(SEED + 32), device=dev).to(torch.bfloat16)
    hf = hk.detach().float().requires_grad_()
    with torch.enable_grad():
        of = rc_mod.resblocks_f32(hf, w1.float(), w2.float())

    def bwd():
        return torch.autograd.grad(ok, hk, gk, retain_graph=True)

    def bwd_off():
        with swapped(rc_mod, "_tf32_convs", contextlib.nullcontext):
            return bwd()

    flop_conv = 2 * 256 * 256 * 64 * 64 * 9
    bwd_flop = 4 * R_MAIN * flop_conv   # the recompute and dX: 4R convs
    ms, dev_ms = tile_turns("K1 backward (dh) 1x64x256² R=4", {
        "TF32 (the op)": bwd, "TF32 off": bwd_off,
        "cuDNN f32 layers under autograd": lambda: torch.autograd.grad(
            of, hf, gk.float(), retain_graph=True)}, bwd_flop, 20, queued_reps=10)
    prof = device_profile("K1 backward (dh) 1x64x256² R=4, TF32", bwd, 5)
    out["k1_bwd"] = {"ms": ms, "device_ms": dev_ms, "flop": bwd_flop,
                     "profile_ms": None if prof is None else prof[4]}

    # where a step's time goes: a DDRM and a DPS sample at B=1
    for label, run, steps in ((f"DDRM B=1 n={n1}", ddrm(n1, y1), n1 + 1),
                              (f"DPS B=1 n={n1}", dps(n1), n1)):
        prof = device_profile(label, run, 2, top=10)
        if prof is not None:
            print(f"profile {label}: {prof[2] / steps:.1f} kernels a step, device busy "
                  f"{prof[4] / steps:.4f} ms a step", flush=True)
    return out


def tv_option_drive(name: str, model, y, physics, prior, x, naive, op, expect: str) -> dict:
    """One TV reconstruction with a loop option on K7 (``op``'s launches and
    launches by variant set to 0 just before it and read just after),
    against the same run on the plain prox: finite output shaped like ``x``,
    every prox on the resident variant, within TV_RECON_RTOL of the plain
    run, the same iterations (early stop) and retries (backtracking), and no
    worse than ``naive`` by more than TV_PSNR_SLACK_DB. ``expect`` names the
    launches the run must make: ``"iterations"`` one a loop body
    (``max_iter`` with Anderson; under early stop the bodies, frozen ones
    included, fewer than ``check_every`` past the stop), ``"retries"`` one an
    iteration and one a retry. Returns the run's numbers."""
    import torch

    fp = model.fixed_point
    reset_kernel_launches(op)
    reset_loops()
    with torch.no_grad():
        out = model(y, physics)
    sync(y.device)
    launches, by_variant = kernel_launches(op), kernel_launches_by_variant(op)
    its, retries = int(fp.last_run["iterations"]), fp.last_run["retries"]
    bodies = loop_count("bodies")
    want = fp.max_iter + retries if expect == "retries" else (bodies if fp.early_stop else
                                                              fp.max_iter)
    print(f"{name}: {its} iterations (of {fp.max_iter}), {retries} retries, {bodies} loop bodies, "
          f"{loop_count('host_reads')} host reads; prox launches {launches} {by_variant} "
          f"(expected {want})", flush=True)
    check(launches == want and by_variant == {"resident": want, "global": 0},
          f"{name}: {launches} prox launches {by_variant}, expected {want} resident")
    check(not fp.early_stop or its <= bodies < its + fp.check_every,
          f"{name}: {bodies} loop bodies for {its} iterations")
    check(tuple(out.shape) == tuple(x.shape) and bool(torch.isfinite(out).all()),
          f"{name}: bad or non-finite reconstruction")
    with plain_tv([prior]), torch.no_grad():
        out_plain = model(y, physics)
    sync(y.device)
    check(kernel_launches(op) == launches, f"{name}: the plain run launched the kernel")
    its_p, retries_p = int(fp.last_run["iterations"]), fp.last_run["retries"]
    rerr = rel_l2(out, out_plain)
    p_k, p_p, p_n = psnr(out, x), psnr(out_plain, x), psnr(naive, x)
    print(f"{name}: kernel vs plain prox relative L2 error {rerr} (bound {TV_RECON_RTOL}); plain "
          f"run {its_p} iterations, {retries_p} retries; PSNR vs x: kernel {p_k:.4f} dB, plain "
          f"{p_p:.4f} dB, naive {p_n:.4f} dB (slack {TV_PSNR_SLACK_DB} dB)", flush=True)
    check(rerr <= TV_RECON_RTOL, f"{name}: reconstruction disagrees with the plain prox")
    check((its, retries) == (its_p, retries_p),
          f"{name}: {its} iterations and {retries} retries, the plain run {its_p} and {retries_p}")
    check(p_k >= p_n - TV_PSNR_SLACK_DB, f"{name}: worse than the naive estimate")
    return {"launches": launches, "iterations": its, "retries": retries, "rel_l2": rerr,
            "psnr_db": p_k, "naive_psnr_db": p_n}


def krylov_phase(dev, card: str, size: int = 256, depth: int = 20, batch: int = HQS_BATCH,
                 pgd_ct=None) -> dict:
    """Phase 12: the Krylov data step and the loop options. CG, BiCGStab,
    MINRES and LSQR on batched random systems against float64;
    ``Tomography.prox_l2`` at 1x and ``batch``x1x``size``² with a scalar and a
    per-sample gamma, by its normal-equation residual, with its CG
    iterations and host reads; the implicit backward against a float64
    central difference; PnP-ADMM on the bench's CT problem (a bf16 DnCNN of
    ``depth`` layers, 64 channels, the residual layer scaled as phase 5's) at
    B=1 and B=``batch`` and DRS, Chambolle-Pock and g-first PGD at B=1, each
    held as phase 5 holds PGD (``drive``: K5 once an iteration, every
    denoiser call, the plain and the unrounded chain's runs); the TV runs
    with Anderson acceleration, early stop and backtracking on K7
    (``tv_option_drive``). Then, on the card only: the ADMM rates in turns
    with PGD on CT (``pgd_ct``: batch -> one recon), profiles of an ADMM
    recon and of its eight data steps replayed (the Krylov share of device
    time). Returns the numbers of the kernels line. On the CPU, at a small
    ``size`` and ``depth``, it rehearses the checks and stops before the
    times (count the plain K5 and K7 calls as launches by wrapping
    ``deepinv_tpu_torch.models.dncnn.conv_chain`` and
    ``deepinv_tpu_torch.optim.prior.chambolle_prox``)."""
    import numpy as np
    import torch

    import deepinv_tpu_torch.models.dncnn as dncnn_mod
    import deepinv_tpu_torch.optim.prior as prior_mod
    from deepinv_tpu_torch.core import loop_stats
    from deepinv_tpu_torch.models import DnCNN, autocast
    from deepinv_tpu_torch.ops import gaussian_blur
    from deepinv_tpu_torch.optim import (L2, PnP, ScorePrior, TVPrior, bicgstab,
                                         conjugate_gradient, lsqr, minres, optim_builder)
    from deepinv_tpu_torch.physics import Blur, BlurFFT, GaussianNoise, Tomography

    g = torch.Generator().manual_seed(SEED + 40)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    out = {"launches": {"K5": {}, "K7": {}}}

    # 12.1 the four solvers on batched random systems, against float64
    B, N = KRYLOV_SYSTEM
    M = (torch.randn((N, N), generator=g) / N ** 0.5).to(dev)
    S = M.T @ M + torch.eye(N, device=dev)
    A = (torch.randn((2 * N, N), generator=g) / (2 * N) ** 0.5).to(dev)
    xs = torch.randn((B, N), generator=g).to(dev)
    b, ya = xs @ S.T, xs @ A.T
    exact = torch.linalg.solve(S.double(), b.double().T).T
    A64 = A.double()
    exact_ls = torch.linalg.solve(A64.T @ A64, A64.T @ ya.double().T).T
    runs = {"CG": lambda: conjugate_gradient(lambda v: v @ S.T, b, max_iter=200, tol=KRYLOV_TOL),
            "BiCGStab": lambda: bicgstab(lambda v: v @ S.T, b, max_iter=200, tol=KRYLOV_TOL),
            "MINRES": lambda: minres(lambda v: v @ S.T, b, max_iter=200, tol=KRYLOV_TOL),
            "LSQR": lambda: lsqr(lambda v: v @ A.T, lambda u: u @ A, ya, max_iter=200,
                                 tol=KRYLOV_TOL)}
    out["solvers"] = {}
    for name, run in runs.items():
        reset_loops()
        x_hat = run()
        sync(dev)
        err = rel_l2(x_hat, exact_ls if name == "LSQR" else exact)
        its = loop_stats.iterations
        print(f"{name} on {B} systems of {N} unknowns, tol {KRYLOV_TOL}: relative L2 error vs "
              f"float64 {err} (bound {KRYLOV_RTOL}), {its} iterations, {loop_count('host_reads')} "
              f"host reads", flush=True)
        check(bool(torch.isfinite(x_hat).all()) and err <= KRYLOV_RTOL,
              f"{name} disagrees with the float64 solve")
        out["solvers"][name] = {"rel_l2": err, "iterations": its}

    # 12.2 the CT prox at B=1 and B=batch, a scalar and a per-sample gamma
    ct = Tomography(img_width=size, angles=90, method="slice", normalize=True, device=dev)
    out["prox"] = {}
    for nb in (1, batch):
        x = torch.rand((nb, 1, size, size), generator=g).to(dev)
        y = ct.A(x)
        z = ct.A_dagger(y)    # the FBP
        for gamma in (1.0, torch.linspace(0.5, 4.0, nb).to(dev)):
            label = f"Tomography.prox_l2 {nb}x1x{size}², gamma " + (
                f"{gamma}" if isinstance(gamma, float) else "per sample")
            reset_loops()
            with torch.no_grad():
                xp = ct.prox_l2(z, y, gamma)
            sync(dev)
            its, reads = loop_stats.iterations, loop_count("host_reads")
            with torch.no_grad():
                gb = gamma if isinstance(gamma, float) else gamma[:, None, None, None]
                rhs = gb * ct.A_adjoint(y) + z
                res = (gb * ct.A_adjoint_A(xp) + xp - rhs).flatten(1).norm(dim=1)
                rel = float((res / rhs.flatten(1).norm(dim=1)).max())
                # the backprojection in A^T y adds with atomics (index_add_), so
                # two prox calls may differ in the last bits; the loop itself,
                # on the prox's system, gives the same bits for every read interval
                cg = [conjugate_gradient(lambda v: gb * ct.A_adjoint_A(v) + v, rhs, init=z,
                                         max_iter=ct.max_iter, tol=ct.tol, check_every=k)
                      for k in (1, 8)]
                same = torch.equal(*cg)
            print(f"{label}: normal-equation residual {rel} (bound {PROX_RESIDUAL_TOLS} x tol "
                  f"{ct.tol}), {its} CG iterations, {reads} host reads a prox; CG on its system "
                  f"the same bits with the flag read every iteration and every 8: {same}",
                  flush=True)
            check(bool(torch.isfinite(xp).all()) and rel <= PROX_RESIDUAL_TOLS * ct.tol,
                  f"{label}: residual {rel}")
            check(same, f"{label}: a host read every iteration changes the result")
            out["prox"][label] = {"residual": rel, "cg_iterations": its, "host_reads": reads}

    # 12.3 the implicit backward against a float64 central difference
    s_ = GRAD_FD_SIZE
    blur = Blur(gaussian_blur(sigma=1.0), padding="reflect", device=dev)
    f0 = blur.filter.detach().clone()
    y0, z0, w = (torch.randn((2, 1, s_, s_), generator=g).to(dev) for _ in range(3))
    g0 = torch.tensor([0.7, 3.0], device=dev)
    dirs = {"y": torch.randn(y0.shape, generator=g).to(dev),
            "z": torch.randn(z0.shape, generator=g).to(dev),
            "gamma": torch.randn(g0.shape, generator=g).to(dev),
            "filter": torch.randn(f0.shape, generator=g).to(dev) * 0.01}
    blur.filter.requires_grad_(True)
    ins = {"y": y0.clone().requires_grad_(), "z": z0.clone().requires_grad_(),
           "gamma": g0.clone().requires_grad_()}
    (blur.prox_l2(ins["z"], ins["y"], ins["gamma"], max_iter=200, tol=1e-6) * w).sum().backward()
    grads = {k: v.grad for k, v in ins.items()}
    grads["filter"] = blur.filter.grad
    blur.filter.requires_grad_(False)
    blur64 = Blur(gaussian_blur(sigma=1.0), padding="reflect", device=dev).double()

    def loss64(e, k):
        v = {"y": y0.double(), "z": z0.double(), "gamma": g0.double(), "filter": f0.double()}
        v[k] = v[k] + e * dirs[k].double()
        p = blur64.update(filter=v["filter"])
        with torch.no_grad():
            return float((p.prox_l2(v["z"], v["y"], v["gamma"], max_iter=500, tol=1e-12)
                          * w.double()).sum())

    out["grad_fd"] = {}
    for k, d in dirs.items():
        ad = float((grads[k].double() * d.double()).sum())
        fd = (loss64(GRAD_FD_EPS, k) - loss64(-GRAD_FD_EPS, k)) / (2 * GRAD_FD_EPS)
        rel = abs(ad - fd) / abs(fd)
        print(f"implicit backward d/d{k}: {ad} vs float64 central difference {fd}, relative "
              f"error {rel} (bound {GRAD_FD_RTOL})", flush=True)
        check(rel <= GRAD_FD_RTOL, f"implicit backward: d/d{k} disagrees with float64")
        out["grad_fd"][k] = rel

    # 12.4-12.5 PnP-ADMM on CT at B=1 and B=batch; DRS, CP, g-first PGD at B=1
    net = DnCNN(1, 1, depth=depth, nf=64, generator=g, device=dev)
    with torch.no_grad():
        net.out_conv.weight.mul_(DNCNN_RESIDUAL_SCALE)
    den = autocast(net)
    op = dncnn_mod.conv_chain
    x1 = torch.rand((1, 1, size, size), generator=g).to(dev)
    x8 = torch.rand((batch, 1, size, size), generator=g).to(dev)
    y1, y8 = ct.A(x1), ct.A(x8)
    models = {
        "ADMM": optim_builder("ADMM", data_fidelity=L2(), prior=PnP(den), params_algo=PGD_PARAMS,
                              max_iter=MAX_ITER, device=dev),
        "DRS": optim_builder("DRS", data_fidelity=L2(), prior=PnP(den), params_algo=PGD_PARAMS,
                             max_iter=MAX_ITER, device=dev),
        "CP": optim_builder("CP", data_fidelity=L2(), prior=PnP(den), params_algo=PGD_PARAMS,
                            max_iter=MAX_ITER, device=dev),
        # a gradient step on the score prior at lambda = g_param^2 steps to
        # the denoiser's output; then the prox of f
        "PGD g-first": optim_builder(
            "PGD", data_fidelity=L2(), prior=ScorePrior(den), g_first=True, device=dev,
            params_algo={**PGD_PARAMS, "lambda": PGD_PARAMS["g_param"] ** 2}, max_iter=MAX_ITER),
    }
    problems = [("ADMM", y1, x1), ("ADMM", y8, x8), ("DRS", y1, x1), ("CP", y1, x1),
                ("PGD g-first", y1, x1)]
    out["recon"] = {}
    for name, y, x in problems:
        label = f"{name} CT B={y.shape[0]}"
        res, res_plain, n = drive(label, models[name], y, ct, net, op, plain_conv_chain,
                                  tuple(x.shape), exact_conv_chain)
        out["launches"]["K5"][label] = n
        reset_loops()
        with torch.no_grad():
            models[name](y, ct)
        sync(dev)
        its = loop_stats.iterations
        print(f"{label}: PSNR vs x kernel {psnr(res, x):.4f} dB, plain {psnr(res_plain, x):.4f} "
              f"dB, FBP {psnr(ct.A_dagger(y), x):.4f} dB; data steps {loop_count('loops')}, CG "
              f"iterations {its} ({its / MAX_ITER:.2f} a prox), host reads "
              f"{loop_count('host_reads')} ({loop_count('host_reads') / MAX_ITER:.2f} a prox), loop "
              f"bodies {loop_count('bodies')}", flush=True)
        check(loop_count("loops") == MAX_ITER, f"{label}: {loop_count('loops')} Krylov solves")
        out["recon"][label] = {"cg_iterations_per_prox": its / MAX_ITER,
                               "host_reads_per_prox": loop_count("host_reads") / MAX_ITER,
                               "rel_l2_plain": rel_l2(res, res_plain)}

    # 12.6 the loop options on K7
    rng = np.random.default_rng(SEED + 41)
    tv_op = prior_mod.chambolle_prox
    ct_tv = Tomography(img_width=size, angles=90, method="slice", normalize=True,
                       noise_model=GaussianNoise(0.002, device=dev), device=dev)
    x_ct = torch.from_numpy(discs(rng, 1, size)[None]).to(dev)
    y_ct = ct_tv(x_ct, generator=gen(SEED + 42))
    blur_tv = BlurFFT((3, size, size), filter=gaussian_blur(sigma=2.0),
                      noise_model=GaussianNoise(0.02, device=dev), device=dev)
    x_bl = torch.from_numpy(discs(rng, 3, size)[None]).to(dev)
    y_bl = blur_tv(x_bl, generator=gen(SEED + 43))
    ct_params = {"stepsize": 1.0, "lambda": 5e-4}
    fbp_init = lambda v, p: p.A_dagger(v)   # noqa: E731
    options = [
        ("TV-PGD CT from FBP, Anderson", ct_tv, y_ct, x_ct, ct_tv.A_dagger(y_ct), "iterations",
         dict(params_algo=ct_params, max_iter=30, custom_init=fbp_init,
              anderson_acceleration=True)),
        ("TV-PGD CT from FBP, early stop", ct_tv, y_ct, x_ct, ct_tv.A_dagger(y_ct), "iterations",
         dict(params_algo=ct_params, max_iter=TV_EARLY_MAX, custom_init=fbp_init,
              early_stop=True, thres_conv=TV_EARLY_THRES)),
        (f"TV-PGD deblur 1x3x{size}², backtracking", blur_tv, y_bl, x_bl, y_bl, "retries",
         dict(params_algo={"stepsize": TV_BACKTRACK_STEP, "lambda": 0.05}, max_iter=30,
              backtracking=True)),
    ]
    out["loop_options"] = {}
    for name, phys, y, x, naive, expect, kw in options:
        prior = TVPrior()
        model = optim_builder("PGD", data_fidelity=L2(), prior=prior, device=dev, **kw)
        res = tv_option_drive(name, model, y, phys, prior, x, naive, tv_op, expect)
        out["launches"]["K7"][name] = res["launches"]
        out["loop_options"][name] = res
    # the same deblurring without backtracking: the stepsize is past 2 / L
    plain_step = optim_builder("PGD", data_fidelity=L2(), prior=TVPrior(), device=dev,
                               params_algo={"stepsize": TV_BACKTRACK_STEP, "lambda": 0.05},
                               max_iter=30)
    with torch.no_grad():
        div = plain_step(y_bl, blur_tv)
    p_div = psnr(div, x_bl)
    print(f"TV-PGD deblur at stepsize {TV_BACKTRACK_STEP} without backtracking: PSNR {p_div:.4f} "
          f"dB, max |x| {float(div.abs().max())}", flush=True)
    check(p_div < out["loop_options"][options[2][0]]["psnr_db"] - 1.0,
          "plain PGD at the backtracking stepsize does not diverge")
    if dev.type != "cuda":
        return out

    # 12.7 rates in turns beside PGD on CT, and where an ADMM recon's time goes
    def recon(m, v):
        def run():
            with torch.no_grad():
                return m(v, ct)
        return run

    out["rates"] = {}
    for nb, y in ((1, y1), (batch, y8)):
        r = rates_in_turns(f"ADMM vs PGD, CT B={nb}", {"ADMM": recon(models["ADMM"], y),
                                                       "PGD": pgd_ct[nb]}, nb * MAX_ITER)
        out["rates"][f"B={nb}"] = r
        print(f"rate: ADMM CT B={nb} {r['ADMM'] / nb:.2f} it/s, {r['ADMM']:.2f} image-it/s; PGD "
              f"CT {r['PGD'] / nb:.2f} it/s, {r['PGD']:.2f} image-it/s ({card})", flush=True)
    out["profile"] = {}
    for nb, y in ((1, y1), (batch, y8)):
        steps = []
        orig = ct.prox_l2

        def record(z, yy, gamma, **kw):
            steps.append((z.detach().clone(), yy, gamma))
            return orig(z, yy, gamma, **kw)

        ct.prox_l2 = record
        try:
            with torch.no_grad():
                models["ADMM"](y, ct)
        finally:
            del ct.prox_l2
        check(len(steps) == MAX_ITER, f"ADMM CT B={nb}: {len(steps)} data steps recorded")

        def data_steps():
            with torch.no_grad():
                for z, yy, gamma in steps:
                    ct.prox_l2(z, yy, gamma)

        prof = device_profile(f"ADMM CT B={nb} recon", recon(models["ADMM"], y), 3, top=8)
        prof_k = device_profile(f"ADMM CT B={nb} its {MAX_ITER} data steps replayed",
                                data_steps, 3, top=8)
        if prof is not None and prof_k is not None:
            share = prof_k[4] / prof[4]
            print(f"profile ADMM CT B={nb}: {prof[2]:g} kernels a recon, device busy {prof[4]:.3f} "
                  f"ms, idle share {1 - prof[4] / prof[0]:.3f}; the Krylov solves {prof_k[4]:.3f} "
                  f"ms of device time ({share:.3f} of it), {prof_k[2]:g} kernels", flush=True)
            out["profile"][f"B={nb}"] = {
                "wall_ms": prof[0], "device_busy_ms": prof[4], "idle_share": 1 - prof[4] / prof[0],
                "kernels": prof[2], "krylov_device_ms": prof_k[4], "krylov_share": share}
    return out


def ellipsoids(n: int):
    """The 3-D phantom of examples/demo_conebeam_fdk.py: four ellipsoids on
    an ``n³`` grid, float32 in [-0.5, 1.4]."""
    import numpy as np

    zz, yy, xx = np.meshgrid(*(np.linspace(-1, 1, n),) * 3, indexing="ij")
    return (1.0 * ((xx / 0.7) ** 2 + (yy / 0.9) ** 2 + (zz / 0.8) ** 2 < 1)
            - 0.5 * ((xx / 0.55) ** 2 + (yy / 0.75) ** 2 + (zz / 0.65) ** 2 < 1)
            + 0.4 * (((xx - 0.2) / 0.15) ** 2 + (yy / 0.2) ** 2 + (zz / 0.3) ** 2 < 1)
            + 0.4 * (((xx + 0.2) / 0.15) ** 2 + (yy / 0.25) ** 2 + (zz / 0.3) ** 2 < 1)
            ).astype(np.float32)


def adjointness(A, At, x, y) -> float:
    """``|<Ax, y> - <x, A^T y>| / (||Ax|| ||y||)``, the sums in float64."""
    Ax = A(x).double()
    return abs(float((Ax * y.double()).sum() - (x.double() * At(y).double()).sum())) / float(
        Ax.norm() * y.double().norm())


def ct_breadth_phase(dev, card: str, size: int = 256, depth: int = 20, batch: int = PROJ_BATCH,
                     cone: int = CONE_SIZE, cone_views: int = CONE_VIEWS,
                     cone_det=CONE_DETECTOR) -> dict:
    """Phase 13: the CT projectors and blurs of the ops layer through the
    entry points with the default device.

    13.1 ``Tomography`` interp, fourier, slice and the fan beam, and the 2-D
    ``TomographyWithAstra`` fan beam on ``shepp_logan(size)`` at 90 angles,
    normalized: adjointness, the FBP's PSNR, ``A`` and ``A_adjoint`` timed in
    turns at B=1 and B=``batch``. 13.2 PnP-PGD with a bf16 DnCNN of ``depth``
    layers (64 channels, the residual layer scaled as phase 5's) on the fan
    beam at B=1 and B=``batch``, held as phase 5 holds PGD (``drive``), its
    rates in turns with the same PGD on the slice CT, and profiled.
    13.3 TV-PGD from the FBP on the interp and fourier projectors
    (``tv_drive``). 13.4 cone-beam ``TomographyWithAstra`` on the ellipsoid
    phantom: adjointness, the FDK and a CG ``A_dagger`` above their floors,
    times. 13.5 ``SpaceVaryingBlur`` (adjointness, TV-PGD), ``DownsamplingMatlab``
    (adjointness), the 5-D ``Blur`` against ``conv3d_fft``, the wavelet and
    DCT round trips. Returns the numbers of the kernels line. On the CPU, at a
    small ``size``, it rehearses the checks (count the plain K5 and K7 calls
    as launches by wrapping ``deepinv_tpu_torch.models.dncnn.conv_chain`` and
    ``deepinv_tpu_torch.optim.prior.chambolle_prox``) and skips the times and
    profiles."""
    import warnings

    import numpy as np
    import torch

    import deepinv_tpu_torch.models.dncnn as dncnn_mod
    import deepinv_tpu_torch.optim.prior as prior_mod
    from deepinv_tpu_torch.datasets import shepp_logan
    from deepinv_tpu_torch.models import DnCNN, autocast
    from deepinv_tpu_torch.ops import WaveletTransform, conv3d_fft, dct2, gaussian_blur, idct2
    from deepinv_tpu_torch.optim import L2, PnP, TVPrior, optim_builder
    from deepinv_tpu_torch.physics import (Blur, DownsamplingMatlab, GaussianNoise,
                                           SpaceVaryingBlur, Tomography, TomographyWithAstra)

    cuda = dev.type == "cuda"
    g = torch.Generator().manual_seed(SEED + 50)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    out = {"launches": {"K5": {}, "K7": {}}, "projectors": {}}
    x1 = torch.from_numpy(shepp_logan(size))[None, None].to(dev)
    x8 = torch.cat([x1, torch.rand((batch - 1, 1, size, size), generator=g).to(dev)])

    # 13.1 the projectors
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        projs = {m: Tomography(angles=CT_ANGLES, img_width=size, method=m, normalize=True)
                 for m in ("interp", "fourier", "slice")}
        projs["fan"] = Tomography(angles=CT_ANGLES, img_width=size, normalize=True,
                                  fan_beam=True)
        projs["astra fan"] = TomographyWithAstra((size, size), angles=CT_ANGLES,
                                                 normalize=True, **ASTRA_FAN)
    for name, phys in projs.items():
        with torch.no_grad():
            y = phys.A(x1)
            v = torch.randn(y.shape, generator=g).to(dev)
            adj = adjointness(phys.A, phys.A_adjoint, x1, v)
            fbp = phys.A_dagger(y, fbp=True) if name == "astra fan" else phys.A_dagger(y)
        sync(dev)
        p_fbp = psnr(fbp, x1)
        ms = {}
        if cuda:
            y8 = phys.A(x8)
            runs = {f"A B={b}": (lambda u=u: phys.A(u)) for b, u in ((1, x1), (batch, x8))}
            runs.update({f"A_adjoint B={b}": (lambda u=u: phys.A_adjoint(u))
                         for b, u in ((1, y), (batch, y8))})
            with torch.no_grad():
                for k in list(runs) + list(runs)[::-1]:
                    ms.setdefault(k, []).append(cuda_ms(runs[k], 10, warmup=2))
            ms = {k: sum(t) / len(t) for k, t in ms.items()}
        print(f"projector {name} {size}², {CT_ANGLES} angles: sinogram {tuple(y.shape)}, "
              f"adjointness {adj:.3e} (bound {ADJOINT_RTOL}), FBP PSNR {p_fbp:.4f} dB (floor "
              f"{FBP_PSNR_FLOOR_DB[name]}); ms a call in turns: "
              + ", ".join(f"{k} {t:.4f}" for k, t in ms.items()) + f" ({card})", flush=True)
        check(adj <= ADJOINT_RTOL, f"projector {name}: adjointness {adj}")
        # the floors are for 256² (a CPU rehearsal at a smaller size holds finiteness)
        check(bool(torch.isfinite(fbp).all()) and (size != 256 or p_fbp >= FBP_PSNR_FLOOR_DB[name]),
              f"projector {name}: FBP PSNR {p_fbp}")
        out["projectors"][name] = {"adjointness": adj, "fbp_psnr_db": p_fbp, "ms": ms}

    # 13.2 PnP-PGD on the fan beam over K5
    fan = projs["fan"]
    with torch.no_grad():
        lip = float(fan.compute_norm(torch.randn(x1.shape, generator=g).to(dev), max_iter=30))
    params = {"stepsize": 1.0 / lip, "g_param": PGD_PARAMS["g_param"]}
    net = DnCNN(1, 1, depth=depth, nf=64, generator=g, device=dev)
    with torch.no_grad():
        net.out_conv.weight.mul_(DNCNN_RESIDUAL_SCALE)
    model = optim_builder("PGD", data_fidelity=L2(), prior=PnP(autocast(net)), params_algo=params,
                          max_iter=MAX_ITER, device=dev)
    y1, y8 = fan.A(x1), fan.A(x8)
    out["pgd"] = {"lipschitz": lip}
    print(f"fan-beam CT {size}²: ||A||² {lip:.6f}, PGD stepsize {params['stepsize']:.6f}",
          flush=True)
    for y, x in ((y1, x1), (y8, x8)):
        label = f"PnP-PGD fan-beam CT B={y.shape[0]}"
        res, res_plain, n = drive(label, model, y, fan, net, dncnn_mod.conv_chain,
                                  plain_conv_chain, tuple(x.shape), exact_conv_chain)
        with torch.no_grad():
            p_fbp = psnr(fan.A_dagger(y)[:1], x[:1])
        print(f"{label}: PSNR of the phantom kernel {psnr(res[:1], x[:1]):.4f} dB, plain "
              f"{psnr(res_plain[:1], x[:1]):.4f} dB, FBP {p_fbp:.4f} dB", flush=True)
        out["launches"]["K5"][label] = n
        out["pgd"][label] = {"rel_l2_plain": rel_l2(res, res_plain)}

    # 13.3 TV-PGD from the FBP on the interp and fourier projectors over K7
    tv_op = prior_mod.chambolle_prox
    for m in ("interp", "fourier"):
        phys = Tomography(angles=CT_ANGLES, img_width=size, method=m, normalize=True,
                          noise_model=GaussianNoise(0.002))
        y = phys(x1, generator=gen(SEED + 51))
        prior = TVPrior()
        tv = optim_builder("PGD", data_fidelity=L2(), prior=prior,
                           params_algo={"stepsize": 1.0, "lambda": 5e-4}, max_iter=30,
                           custom_init=lambda v, p: p.A_dagger(v))
        name = f"TV-PGD {m} CT {size}² from FBP"
        with torch.no_grad():
            naive = phys.A_dagger(y)
        out["launches"]["K7"][name] = tv_drive(name, tv, y, phys, [prior], x1, naive, 30, tv_op)

    # 13.4 cone beam
    vol = torch.from_numpy(ellipsoids(cone))[None, None].to(dev)
    scale = cone / 32      # the demo's geometry is for 32³
    t0 = time.perf_counter()
    cb = TomographyWithAstra((cone,) * 3, angles=cone_views, angular_range=(0, 360),
                             geometry_type="conebeam", n_detector_pixels=cone_det,
                             detector_spacing=(1.5, 1.5), normalize=True,
                             geometry_parameters=dict(source_radius=CONE_RADII[0] * scale,
                                                      detector_radius=CONE_RADII[1] * scale))
    sync(dev)
    t_plan = time.perf_counter() - t0
    with torch.no_grad():
        yc = cb.A(vol)
        vc = torch.randn(yc.shape, generator=g).to(dev)
    adj = adjointness(cb.A, cb.A_adjoint, vol, vc)
    cone_ms = {}

    def clock(name, fn):
        sync(dev)
        t = time.perf_counter()
        with torch.no_grad():
            r = fn()
        sync(dev)
        cone_ms[name] = (time.perf_counter() - t) * 1e3
        return r

    clock("A", lambda: cb.A(vol))
    clock("A_adjoint", lambda: cb.A_adjoint(yc))
    fdk = clock("FDK", lambda: cb.A_dagger(yc, fbp=True))
    cg = clock("CG", lambda: cb.A_dagger(yc, max_iter=CONE_CG_ITERS, tol=1e-12))
    p_fdk, p_cg = psnr(fdk, vol), psnr(cg, vol)
    print(f"cone beam {cone}³, {cone_views} views, detector {cone_det}: radiographs "
          f"{tuple(yc.shape)}, plan and normalize {t_plan:.2f} s, ||A|| "
          f"{float(cb.operator_norm):.4f}, adjointness {adj:.3e} (bound {ADJOINT_RTOL}); FDK "
          f"PSNR {p_fdk:.4f} dB (floor {CONE_FDK_FLOOR_DB}), CG {CONE_CG_ITERS} it PSNR "
          f"{p_cg:.4f} dB (floor {CONE_CG_FLOOR_DB}); ms (host clock): "
          + ", ".join(f"{k} {t:.2f}" for k, t in cone_ms.items()) + f" ({card})", flush=True)
    check(adj <= ADJOINT_RTOL, f"cone beam: adjointness {adj}")
    check(bool(torch.isfinite(fdk).all()) and bool(torch.isfinite(cg).all()),
          "cone beam: non-finite FDK or CG")
    if cone == CONE_SIZE:
        check(p_fdk >= CONE_FDK_FLOOR_DB and p_cg >= CONE_CG_FLOOR_DB,
              f"cone beam: FDK {p_fdk} dB, CG {p_cg} dB under the floors")
    out["cone"] = {"adjointness": adj, "fdk_psnr_db": p_fdk, "cg_psnr_db": p_cg,
                   "ms": cone_ms, "plan_s": t_plan}

    # 13.5 the blurs
    rng = np.random.default_rng(SEED + 52)
    xb = torch.from_numpy(discs(rng, 3, size)[None]).to(dev)
    sigmas = (0.5, 1.0, 2.0, 3.0)
    h = torch.cat([gaussian_blur(sigma=s, psf_size=15) for s in sigmas], dim=1)[:, None]
    t = torch.linspace(0, 1, size)[:, None].expand(size, size)
    w = torch.stack([(1 - t) ** 3, 3 * t * (1 - t) ** 2, 3 * t ** 2 * (1 - t), t ** 3])[None, None]
    svb = SpaceVaryingBlur(filters=h, multipliers=w, padding="circular",
                           noise_model=GaussianNoise(0.02))
    yb = svb(xb, generator=gen(SEED + 53))
    vb = torch.randn(yb.shape, generator=g).to(dev)
    adj_svb = adjointness(svb.A, svb.A_adjoint, xb, vb)
    check(adj_svb <= ADJOINT_RTOL, f"SpaceVaryingBlur: adjointness {adj_svb}")
    prior = TVPrior()
    tv = optim_builder("PGD", data_fidelity=L2(), prior=prior,
                       params_algo={"stepsize": 1.0, "lambda": 0.05}, max_iter=30)
    name = f"TV-PGD SpaceVaryingBlur 1x3x{size}²"
    out["launches"]["K7"][name] = tv_drive(name, tv, yb, svb, [prior], xb, yb, 30, tv_op)
    dm = DownsamplingMatlab(img_size=(3, size, size), factor=2)
    adj_dm = adjointness(dm.A, dm.A_adjoint, xb, torch.randn((1, 3, size // 2, size // 2),
                                                                generator=g).to(dev))
    check(adj_dm <= ADJOINT_RTOL, f"DownsamplingMatlab: adjointness {adj_dm}")
    shape3 = BLUR3D_SHAPE if size == 256 else (1, 1, size // 4, size // 2, size // 2)
    v3 = torch.rand(shape3, generator=g).to(dev)
    psf3 = gaussian_blur(sigma=(1.0, 2.0, 2.0))
    blur3 = Blur(filter=psf3, padding="circular")
    with torch.no_grad():
        b_direct, b_fft = blur3.A(v3), conv3d_fft(v3, psf3.to(dev))
    err3 = rel_max(b_direct, b_fft)
    check(err3 <= BLUR3D_RTOL, f"5-D Blur: conv3d vs conv3d_fft {err3}")
    wt = WaveletTransform("db4", 3)
    with torch.no_grad():
        err_w = rel_max(wt.idwt2(wt.dwt2(xb)), xb)
        err_d = rel_max(idct2(dct2(xb)), xb)
    check(err_w <= ROUND_TRIP_RTOL and err_d <= ROUND_TRIP_RTOL,
          f"round trips: wavelet {err_w}, DCT {err_d}")
    blur_ms = {}
    if cuda:
        with torch.no_grad():
            for k, fn in (("SpaceVaryingBlur A", lambda: svb.A(xb)),
                          ("SpaceVaryingBlur A_adjoint", lambda: svb.A_adjoint(yb)),
                          ("DownsamplingMatlab A", lambda: dm.A(xb)),
                          ("5-D Blur (conv3d)", lambda: blur3.A(v3)),
                          ("conv3d_fft", lambda: conv3d_fft(v3, psf3.to(dev))),
                          ("db4 dwt2 + idwt2", lambda: wt.idwt2(wt.dwt2(xb))),
                          ("dct2 + idct2", lambda: idct2(dct2(xb)))):
                blur_ms[k] = cuda_ms(fn, 10, warmup=2)
    print(f"blurs: SpaceVaryingBlur adjointness {adj_svb:.3e}, DownsamplingMatlab x2 "
          f"{adj_dm:.3e} (bound {ADJOINT_RTOL}); 5-D Blur {shape3} conv3d vs conv3d_fft {err3:.3e}"
          f" (bound {BLUR3D_RTOL}); round trips db4 level 3 {err_w:.3e}, DCT {err_d:.3e} (bound "
          f"{ROUND_TRIP_RTOL}); ms a call: "
          + ", ".join(f"{k} {t:.4f}" for k, t in blur_ms.items()) + f" ({card})", flush=True)
    out["blurs"] = {"adjointness_svb": adj_svb, "adjointness_matlab": adj_dm,
                    "conv3d_vs_fft": err3, "wavelet_round_trip": err_w, "dct_round_trip": err_d,
                    "ms": blur_ms}
    if not cuda:
        return out

    # 13.2, timed and profiled: fan-beam PGD in turns with the same PGD on the
    # slice CT (phase 5's problem)
    def recon(y, phys=fan):
        def run():
            with torch.no_grad():
                return model(y, phys)
        return run

    out["rates"] = {}
    ct = projs["slice"]
    for nb, y, x in ((1, y1, x1), (batch, y8, x8)):
        r = rates_in_turns(f"PGD fan-beam vs slice CT, B={nb}",
                           {"fan": recon(y), "slice": recon(ct.A(x), ct)}, nb * MAX_ITER)
        out["rates"][f"B={nb}"] = r
        print(f"rate: PGD fan-beam CT B={nb} {r['fan'] / nb:.2f} it/s, {r['fan']:.2f} image-it/s;"
              f" PGD slice CT {r['slice'] / nb:.2f} it/s, {r['slice']:.2f} image-it/s ({card})",
              flush=True)
    out["profile"] = {}
    for nb, y, x in ((1, y1, x1), (batch, y8, x8)):
        z = fan.A_dagger(y)

        def data_steps(z=z, y=y):
            with torch.no_grad():
                for _ in range(MAX_ITER):
                    fan.A_adjoint(fan.A(z) - y)

        prof = device_profile(f"PnP-PGD fan-beam CT B={nb} recon", recon(y), 3, top=8)
        prof_d = device_profile(f"PnP-PGD fan-beam CT B={nb}: {MAX_ITER} gradients "
                                f"A^T(Ax - y)", data_steps, 3, top=8)
        if prof is not None and prof_d is not None:
            share = prof_d[4] / prof[4]
            print(f"profile PnP-PGD fan-beam CT B={nb}: {prof[2]:g} kernels a recon, device busy "
                  f"{prof[4]:.3f} ms, idle share {1 - prof[4] / prof[0]:.3f}; the projector "
                  f"{prof_d[4]:.3f} ms of device time ({share:.3f} of it), {prof_d[2]:g} "
                  f"kernels", flush=True)
            out["profile"][f"B={nb}"] = {
                "wall_ms": prof[0], "device_busy_ms": prof[4], "idle_share": 1 - prof[4] / prof[0],
                "kernels": prof[2], "projector_device_ms": prof_d[4], "projector_share": share}
    return out


def golden_radial(size: int, spokes: int):
    """``(2, spokes * 2 size)`` golden-angle radial k-space points in radians,
    off the Toeplitz grid (no spoke at angle 0)."""
    import numpy as np

    r = (np.arange(2 * size) - size + 0.5) * (np.pi / size)
    th = 0.1 + np.arange(spokes) * np.deg2rad(111.246)
    return np.stack([np.outer(np.cos(th), r).ravel(),
                     np.outer(np.sin(th), r).ravel()]).astype(np.float32)


def noise_moments(name: str, kw: dict, x: float):
    """The analytic mean and variance of noise model ``name`` (keywords
    ``kw``) at the constant level ``x``; None for the variance where the
    level is drawn a sample (``UniformGaussianNoise``: its range instead)."""
    import torch

    sp = torch.special
    if name == "ZeroNoise":
        return x, 0.0
    if name == "GaussianNoise":
        return x, kw["sigma"] ** 2
    if name == "UniformGaussianNoise":
        return x, (kw["sigma_min"] ** 2, kw["sigma_max"] ** 2)
    if name == "PoissonNoise":
        return x, kw["gain"] * x
    if name == "GammaNoise":
        return x, x * x / kw["l"]
    if name == "PoissonGaussianNoise":
        return x, kw["gain"] * x + kw["sigma"] ** 2
    if name == "UniformNoise":
        return x, kw["a"] ** 2 / 3
    if name == "LogPoissonNoise":
        lam = kw["N0"] * math.exp(-x * kw["mu"])
        n = torch.arange(0, int(lam + 40 * lam ** 0.5), dtype=torch.float64)
        pmf = torch.exp(n * math.log(lam) - lam - torch.lgamma(n + 1))
        f = -torch.log(n.clamp_min(1e-8) / kw["N0"]) / kw["mu"]
        m = float((pmf * f).sum())
        return m, float((pmf * (f - m) ** 2).sum())
    if name == "SaltPepperNoise":
        p, s = kw["p"], kw["s"]
        m = (1 - p - s) * x + s
        return m, (1 - p - s) * x * x + s - m * m
    if name == "FisherTippettNoise":
        l = torch.tensor(kw["l"], dtype=torch.float64)
        return x + float(sp.digamma(l)) - math.log(kw["l"]), float(sp.polygamma(1, l))
    if name == "RicianNoise":
        s, t = kw["sigma"], -x * x / (2 * kw["sigma"] ** 2)
        z = torch.tensor(-t / 2, dtype=torch.float64)
        # the Laguerre L_{1/2}(t) by the scaled Bessel functions
        lag = (1 - t) * float(sp.i0e(z)) - t * float(sp.i1e(z))
        m = s * math.sqrt(math.pi / 2) * lag
        return m, 2 * s * s + x * x - m * m
    if name == "LaplaceNoise":
        return x, 2 * kw["b"] ** 2
    raise KeyError(name)


# the card's noise models: keywords, as tests/test_torch_noise.py draws them
NOISE_MODELS = {
    "ZeroNoise": {}, "GaussianNoise": {"sigma": 0.1},
    "UniformGaussianNoise": {"sigma_min": 0.05, "sigma_max": 0.3}, "PoissonNoise": {"gain": 0.1},
    "GammaNoise": {"l": 3.0}, "PoissonGaussianNoise": {"gain": 0.1, "sigma": 0.05},
    "UniformNoise": {"a": 0.2}, "LogPoissonNoise": {"N0": 512.0, "mu": 0.5},
    "SaltPepperNoise": {"p": 0.1, "s": 0.15}, "FisherTippettNoise": {"l": 2.0},
    "RicianNoise": {"sigma": 0.1}, "LaplaceNoise": {"b": 0.1}}


def noise_checks(dev, card: str, shape=NOISE_SHAPE) -> dict:
    """Phase 14.5: every noise model drawn on the card from a CUDA generator
    on a constant 0.5 of ``shape``: sample mean and variance against the
    analytic ones (``GaussianNoise`` also with a per-sample ``(B,)`` sigma,
    held sample by sample), and the time a draw."""
    import torch

    import deepinv_tpu_torch.physics.noise as noise_mod

    x = torch.full(shape, 0.5, device=dev)
    B = shape[0]
    out = {}
    cases = [(n, kw, None) for n, kw in NOISE_MODELS.items()]
    cases.append(("GaussianNoise", {"sigma": torch.linspace(0.02, 0.3, B)}, "per-sample"))
    for name, kw, tag in cases:
        model = getattr(noise_mod, name)(**kw)
        gen = torch.Generator(device=dev).manual_seed(SEED + 60)
        with torch.no_grad():
            y = model(x, generator=gen).double()
        check(bool(torch.isfinite(y).all()), f"noise {name}: non-finite draw")
        label = name + (f" ({tag})" if tag else "")
        if tag:   # one level a sample
            per = y.reshape(B, -1)
            sig = model.sigma.double()
            se = (per.mean(1) - 0.5).abs() / (sig / per.shape[1] ** 0.5)
            vr = (per.var(1) / sig ** 2 - 1).abs()
            ok = bool((se <= NOISE_MEAN_SE).all() and (vr <= NOISE_VAR_RTOL).all())
            stats = {"max_mean_se": float(se.max()), "max_var_rel": float(vr.max())}
        else:
            m, v = noise_moments(name, kw, 0.5)
            mean = float(y.mean())
            if name == "UniformGaussianNoise":
                per = y.reshape(B, -1).var(1)
                ok = bool(((per >= v[0] * (1 - NOISE_VAR_RTOL))
                           & (per <= v[1] * (1 + NOISE_VAR_RTOL))).all()) and \
                    abs(mean - m) <= NOISE_MEAN_SE * (v[1] / y.numel()) ** 0.5
                stats = {"mean": mean, "var_range": [float(per.min()), float(per.max())]}
            elif v == 0.0:
                ok = bool((y == m).all())
                stats = {"mean": mean}
            else:
                var = float(y.var())
                ok = abs(mean - m) <= NOISE_MEAN_SE * (v / y.numel()) ** 0.5 and \
                    abs(var - v) <= NOISE_VAR_RTOL * v
                stats = {"mean": mean, "mean_want": m, "var": var, "var_want": v}
        ms = None
        if dev.type == "cuda":
            with torch.no_grad():
                ms = cuda_ms(lambda: model(x, generator=gen), 10, warmup=2)
        print(f"noise {label} on {tuple(shape)}: {stats}, draw {ms} ms ({card})", flush=True)
        check(ok, f"noise {label}: moments {stats} off the analytic ones")
        out[label] = dict(stats, ms=ms)
    return out


def generator_checks(dev, card: str, size: int = 256, batch: int = GEN_BATCH,
                     psf: int = 31, pupil: int = 256) -> dict:
    """Phase 14.6: every physics generator's ``step`` at B=``batch`` on the
    card, timed and checked: PSFs non-negative and summing to 1; Random and
    Gaussian masks with exactly ``n_lines + n_center`` lines; splitting masks
    inside their input mask, at the fraction they keep."""
    import torch

    import deepinv_tpu_torch.physics.generator as pg

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    out = {}

    def run(label, g, ok_fn, **kw):
        seed = SEED + 70 + 2 * len(out)     # a stream of its own for each generator
        p = g.step(batch, generator=gen(seed), **kw)
        ms = None
        if dev.type == "cuda":
            ms = cuda_ms(lambda: g.step(batch, generator=gen(seed + 1), **kw), 3, warmup=1)
        ok, stats = ok_fn(p)
        print(f"generator {label} B={batch}: {stats}, {ms} ms a step ({card})", flush=True)
        check(ok, f"generator {label}: {stats}")
        out[label] = dict(stats, ms=ms)
        return p

    def psf_ok(p, key="filter"):
        f = p[key]
        s = f.sum(dim=tuple(range(2, f.dim())))
        err = float((s - 1).abs().max())
        return float(f.min()) >= 0.0 and err <= 1e-5, {
            "shape": list(f.shape), "min": float(f.min()), "sum_err": err}

    def tiles_ok(p):
        f = p["filters"]
        err = float((f.sum((-2, -1)) - 1).abs().max())
        return float(f.min()) >= 0.0 and err <= 1e-5, {"shape": list(f.shape), "sum_err": err}

    mask_size = (2, size, size)
    for name in ("RandomMaskGenerator", "GaussianMaskGenerator"):
        g = getattr(pg, name)(mask_size, acceleration=MC_ACCEL)
        want = g.n_lines + g.n_center

        def lines_ok(p, want=want):
            cols = p["mask"][:, 0, 0]
            n = cols.sum(-1)
            return bool((n == want).all()), {"lines": sorted({int(v) for v in n}), "want": want}

        masks = run(name, g, lines_ok)["mask"]
    run("EquispacedMaskGenerator (k-t)", pg.EquispacedMaskGenerator(
        (2, 8, size, size), acceleration=MC_ACCEL),
        lambda p: (tuple(p["mask"].shape) == (batch, 2, 8, size, size),
                   {"shape": list(p["mask"].shape), "fraction": float(p["mask"].mean())}))
    run("PolyOrderMaskGenerator", pg.PolyOrderMaskGenerator(mask_size, acceleration=MC_ACCEL),
        lambda p: (abs(float(p["mask"].mean()) - 1 / MC_ACCEL) <= 0.05,
                   {"fraction": float(p["mask"].mean()), "want": 1 / MC_ACCEL}))
    n_in = masks.reshape(batch, 2, -1)[:, 0].sum(1)

    def split_ok(ratio, exact):
        def ok(p):
            m = p["mask"]
            inside = bool((m <= masks).all())
            kept = m.reshape(batch, 2, -1)[:, 0].sum(1) / n_in
            err = float((kept - ratio).abs().max())
            bound = 1.0 / float(n_in.min()) if exact else SPLIT_RATIO_TOL
            return inside and err <= bound, {"inside": inside, "kept": float(kept.mean()),
                                             "ratio": ratio, "max_err": err}
        return ok

    run("BernoulliSplittingMaskGenerator (input mask)", pg.BernoulliSplittingMaskGenerator(
        mask_size, split_ratio=0.6), split_ok(0.6, True), input_mask=masks)
    run("BernoulliSplittingMaskGenerator", pg.BernoulliSplittingMaskGenerator(
        mask_size, split_ratio=0.6),
        lambda p: (abs(float(p["mask"].mean()) - 0.6) <= SPLIT_RATIO_TOL,
                   {"kept": float(p["mask"].mean()), "ratio": 0.6}))
    # Gaussian splitting removes ceil(n (1 - ratio)) points off its centre block
    run("GaussianSplittingMaskGenerator (input mask)", pg.GaussianSplittingMaskGenerator(
        mask_size, split_ratio=0.6), split_ok(0.6, True), input_mask=masks)
    split_gen = pg.GaussianMaskGenerator(mask_size, acceleration=2)
    run("MultiplicativeSplittingMaskGenerator (input mask)",
        pg.MultiplicativeSplittingMaskGenerator(mask_size, split_gen),
        lambda p: (bool((p["mask"] <= masks).all()), {"kept": float(
            (p["mask"].sum() / masks.sum()))}), input_mask=masks)
    run("Phase2PhaseSplittingMaskGenerator", pg.Phase2PhaseSplittingMaskGenerator(
        (2, 8, size // 4, size // 4)),
        lambda p: (float(p["mask"].mean()) == 0.5, {"kept": float(p["mask"].mean())}))
    run("Artifact2ArtifactSplittingMaskGenerator", pg.Artifact2ArtifactSplittingMaskGenerator(
        (2, 8, size // 4, size // 4), split_size=2),
        lambda p: (float(p["mask"].mean()) == 0.25, {"kept": float(p["mask"].mean())}))
    run("SigmaGenerator", pg.SigmaGenerator(*MC_TRAIN_SIGMAS),
        lambda p: (bool(((p["sigma"] >= MC_TRAIN_SIGMAS[0]) & (p["sigma"] < MC_TRAIN_SIGMAS[1]))
                        .all()), {"sigma": [round(float(v), 5) for v in p["sigma"]]}))
    run("GainGenerator", pg.GainGenerator(),
        lambda p: (bool(((p["gain"] >= 0.1) & (p["gain"] < 0.4)).all()), {}))
    # the bicubic filter has negative lobes: each filter sums to 1, one factor a batch
    run("DownsamplingGenerator", pg.DownsamplingGenerator(psf_size=(31, 31)),
        lambda p: (float((p["filter"].sum((-2, -1)) - 1).abs().max()) <= 1e-5
                   and len(set(p["factor"].tolist())) == 1,
                   {"factor": int(p["factor"][0]), "sum_err": float(
                       (p["filter"].sum((-2, -1)) - 1).abs().max())}))
    run("MotionBlurGenerator", pg.MotionBlurGenerator((psf, psf)), psf_ok)
    run("GaussianBlurGenerator", pg.GaussianBlurGenerator((psf, psf), isotropic=False), psf_ok)
    diff = pg.DiffractionBlurGenerator((psf, psf), pupil_size=pupil)
    run("DiffractionBlurGenerator", diff, psf_ok)
    run("DiffractionBlurGenerator (3 channels)", pg.DiffractionBlurGenerator(
        (psf, psf), fc=(0.18, 0.2, 0.22), zernike_perturbation_amplitude=0.05,
        pupil_size=pupil), psf_ok)
    run("DiffractionBlurGenerator3D", pg.DiffractionBlurGenerator3D(
        (9, psf, psf), pupil_size=pupil), psf_ok)
    run("ConfocalBlurGenerator3D", pg.ConfocalBlurGenerator3D((9, psf, psf), pupil_size=pupil),
        psf_ok)
    small = pg.DiffractionBlurGenerator((15, 15), pupil_size=pupil // 2)
    run("ProductConvolutionBlurGenerator", pg.ProductConvolutionBlurGenerator(
        small, img_size=(size, size), n_eigen_psf=8),
        lambda p: (bool(torch.isfinite(p["multipliers"]).all()), {
            "filters": list(p["filters"].shape), "multipliers": list(p["multipliers"].shape)}))
    run("TiledBlurGenerator", pg.TiledBlurGenerator(small, patch_size=64, stride=32), tiles_ok,
        img_size=(size, size))
    return out


def mri_multicoil_phase(dev, card: str, size: int = MC_SIZE, coils: int = MC_COILS,
                        depth: int = 20, batch: int = HQS_BATCH, train_batches=TRAIN_BATCHES,
                        steps: int = TRAIN_STEPS, noise_shape=NOISE_SHAPE,
                        gen_size: int = 256, pupil: int = 256,
                        espirit: dict = MC_ESPIRIT) -> dict:
    """Phase 14: multi-coil MRI, the noise models and the physics generators
    through the entry points with the default device.

    14.1 ``MultiCoilMRI`` with ``birdcage_maps(coils, (size, size))``, a
    ``GaussianMaskGenerator`` mask a sample and ``GaussianNoise(0.01)`` on the
    sampled k-space: adjointness of the Cartesian and of a golden-angle
    radial (NUFFT) operator, and ``||A||² <= 1`` by ``compute_norm``.
    14.2 PnP-PGD with a bf16 ``DnCNN(2, 2)`` of ``depth`` layers (the
    residual layer scaled as phase 5's) at B=1 and B=``batch``, held as phase
    5 holds PGD (``drive``: K5 once an iteration, every denoiser call, the
    plain and the unrounded chain's runs); rates in turns and profiled (the
    FFTs' and K5's shares of the device time, the idle share). 14.3 the same
    recon from maps that ESPIRiT estimates from ``y``, timed, its magnitude's
    PSNR beside the birdcage recon's. 14.4 ``Trainer`` of
    ``ArtifactRemoval(DnCNN(2, 2))`` on the same physics with
    ``physics_generator = GaussianMaskGenerator + SigmaGenerator``, ``steps``
    steps at each of ``train_batches`` in both train-step configurations: K6
    once a step with ``fused_chains=True`` and never with ``False``, the
    first step's gradients within GRAD_RTOL and MC_GRAD_TENSOR_RTOL, losses
    within TRAIN_LOSS_RTOL, each of MC_FAULTS caught (``planted_fault``),
    steps/s and the idle share of an epoch.
    14.5 ``noise_checks``; 14.6 ``generator_checks``. Returns the numbers of
    the kernels line. On the CPU, at small sizes, it rehearses the checks
    (count the plain K5 calls as launches by wrapping
    ``deepinv_tpu_torch.models.dncnn.conv_chain``; the K6 counts are checked
    on the card only) and skips the times and profiles."""
    import numpy as np
    import torch

    import deepinv_tpu_torch.models.dncnn as dncnn_mod
    from deepinv_tpu_torch.datasets import shepp_logan
    from deepinv_tpu_torch.models import DnCNN, autocast
    from deepinv_tpu_torch.ops.kernels.conv_chain import (conv_chain, conv_chain_stash,
                                                          stash_backward)
    from deepinv_tpu_torch.optim import L2, PnP, optim_builder
    from deepinv_tpu_torch.physics import GaussianNoise, MultiCoilMRI, birdcage_maps
    from deepinv_tpu_torch.physics.generator import GaussianMaskGenerator, SigmaGenerator

    cuda = dev.type == "cuda"
    g = torch.Generator().manual_seed(SEED + 80)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def mag(v):
        return v.pow(2).sum(1, keepdim=True).sqrt()

    out = {"launches": {"K5": {}}}
    rng = np.random.default_rng(SEED + 81)
    sl = torch.from_numpy(shepp_logan(size))
    x1 = torch.stack([sl, 0.2 * sl.flip(-1)])[None].to(dev)
    x8 = torch.cat([x1] + [torch.from_numpy(discs(rng, 2, size))[None].to(dev)
                           for _ in range(batch - 1)])
    maps = birdcage_maps(coils, (size, size))[None]
    masks = GaussianMaskGenerator((2, size, size), acceleration=MC_ACCEL)
    t0 = time.perf_counter()
    physics = MultiCoilMRI(coil_maps=maps, img_size=(size, size),
                           noise_model=GaussianNoise(MC_SIGMA))
    sync(dev)
    t_phys = time.perf_counter() - t0

    # 14.1 the operators
    phys1 = physics.update(**masks.step(1, generator=gen(SEED + 82)))
    v = torch.randn((1, 2, coils, size, size), generator=g).to(dev)
    with torch.no_grad():
        adj_c = adjointness(phys1.A, phys1.A_adjoint, x1, v)
        lip = float(phys1.compute_norm(torch.randn(x1.shape, generator=g).to(dev), max_iter=30))
    t0 = time.perf_counter()
    radial = MultiCoilMRI(coil_maps=maps, img_size=(size, size),
                          kspace_trajectory=golden_radial(size, MC_SPOKES))
    sync(dev)
    t_plan = time.perf_counter() - t0
    with torch.no_grad():
        yr = radial.A(x1)
        adj_r = adjointness(radial.A, radial.A_adjoint, x1,
                            torch.randn(yr.shape, generator=g).to(dev))
        normal_err = rel_l2(radial.A_adjoint_A(x1), radial.A_adjoint(radial.A(x1)))
    print(f"multi-coil MRI {size}², {coils} coils: adjointness Cartesian {adj_c:.3e}, radial "
          f"({MC_SPOKES} spokes, {yr.shape[-1]} points) {adj_r:.3e} (bound {ADJOINT_RTOL}); "
          f"||A||² {lip:.6f} (bound 1 + {MC_NORM_SLACK}); the radial Toeplitz normal vs "
          f"A^H A relative L2 {normal_err:.3e}; set-up {t_phys:.3f} s, NUFFT plan and Toeplitz "
          f"spectrum {t_plan:.3f} s ({card})", flush=True)
    check(adj_c <= ADJOINT_RTOL and adj_r <= ADJOINT_RTOL,
          f"multi-coil MRI: adjointness {adj_c}, {adj_r}")
    check(lip <= 1.0 + MC_NORM_SLACK, f"multi-coil MRI: ||A||² = {lip} > 1")
    out["operators"] = {"adjointness_cartesian": adj_c, "adjointness_radial": adj_r,
                        "norm_sq": lip, "radial_normal_rel_l2": normal_err}

    # 14.2 PnP-PGD over K5 at B=1 and B=batch
    net = DnCNN(2, 2, depth=depth, nf=64, generator=g)
    with torch.no_grad():
        net.out_conv.weight.mul_(DNCNN_RESIDUAL_SCALE)
    model = optim_builder("PGD", data_fidelity=L2(), prior=PnP(autocast(net)),
                          params_algo=PGD_PARAMS, max_iter=MAX_ITER)
    phys8 = physics.update(**masks.step(batch, generator=gen(SEED + 83)))
    y1 = phys1(x1, generator=gen(SEED + 84))
    y8 = phys8(x8, generator=gen(SEED + 85))
    out["pgd"] = {}
    recons = {}
    for y, x, phys in ((y1, x1, phys1), (y8, x8, phys8)):
        label = f"PnP-PGD {coils}-coil MRI B={y.shape[0]}"
        res, res_plain, n = drive(label, model, y, phys, net, dncnn_mod.conv_chain,
                                  plain_conv_chain, tuple(x.shape), exact_conv_chain)
        with torch.no_grad():
            zf = phys.A_adjoint(y)
        p_rec, p_zf = psnr(mag(res[:1]), mag(x[:1])), psnr(mag(zf[:1]), mag(x[:1]))
        print(f"{label}: magnitude PSNR recon {p_rec:.4f} dB, plain "
              f"{psnr(mag(res_plain[:1]), mag(x[:1])):.4f} dB, zero-filled {p_zf:.4f} dB",
              flush=True)
        out["launches"]["K5"][label] = n
        out["pgd"][label] = {"rel_l2_plain": rel_l2(res, res_plain), "psnr_db": p_rec,
                             "zero_filled_psnr_db": p_zf}
        recons[y.shape[0]] = res

    # 14.3 the recon from ESPIRiT's maps
    sync(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        est = MultiCoilMRI.estimate_coil_maps(y1, **espirit)
    sync(dev)
    t_esp = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0
    kept = float((est.abs().sum(1) > 0).float().mean())
    phys_e = phys1.update(coil_maps=est)
    label = f"PnP-PGD {coils}-coil MRI B=1 from ESPIRiT maps"
    res_e, _, n = drive(label, model, y1, phys_e, net, dncnn_mod.conv_chain, plain_conv_chain,
                        tuple(x1.shape))
    out["launches"]["K5"][label] = n
    p_e, p_b = psnr(mag(res_e), mag(x1)), psnr(mag(recons[1]), mag(x1))
    print(f"ESPIRiT {espirit} on y {tuple(y1.shape)}: {t_esp:.3f} s (host clock, first call), "
          f"maps kept on {kept:.4f} of the pixels, peak memory {peak:.3f} GiB; recon magnitude "
          f"PSNR from ESPIRiT maps {p_e:.4f} dB, from birdcage maps {p_b:.4f} dB ({card})",
          flush=True)
    check(bool(torch.isfinite(est).all()) and kept > 0.2, "ESPIRiT: maps non-finite or empty")
    out["espirit"] = {"s": t_esp, "kept": kept, "psnr_db": p_e, "birdcage_psnr_db": p_b,
                      "peak_gib": peak}

    # 14.4 generator-driven training
    pgen = GaussianMaskGenerator((2, size, size), acceleration=MC_ACCEL) + \
        SigmaGenerator(*MC_TRAIN_SIGMAS)
    tnet = DnCNN(2, 2, depth=depth, nf=64, generator=g)
    out["train"] = {}
    k6 = 0
    for B in train_batches:
        xs = torch.cat([x1] + [torch.from_numpy(discs(rng, 2, size))[None].to(dev)
                               for _ in range(B * steps - 1)])
        def trainer(f):
            return make_trainer(tnet, physics, xs, B, f, physics_generator=pgen, lr=MC_LR)

        trainers = {f: trainer(f) for f in (False, True)}
        g_ref = first_step_grads(trainers[False])
        gerr, terr = grad_errors(first_step_grads(trainers[True]), g_ref)
        print(f"generator train B={B}: first step's gradient, fused_chains=True vs False: "
              f"relative max error {gerr} (bound {GRAD_RTOL}), largest relative L2 error of a "
              f"parameter tensor's {terr} (bound {MC_GRAD_TENSOR_RTOL})", flush=True)
        check(gerr <= GRAD_RTOL and terr <= MC_GRAD_TENSOR_RTOL,
              f"generator train B={B}: first-step gradients disagree")
        losses = {}
        for f, t in trainers.items():
            reset_kernel_launches(conv_chain, conv_chain_stash, stash_backward)
            secs = train_epoch(t, 0, dev)
            n6, n5, nb = (kernel_launches(conv_chain_stash), kernel_launches(conv_chain),
                          kernel_launches(stash_backward))
            losses[f] = t.logs_total_loss_train.vals
            print(f"generator train B={B} fused_chains={f}: {steps} steps in {secs:.3f} s (first "
                  f"epoch), K6 launches {n6}, K5 {n5}, stash backward {nb}, losses {losses[f]}",
                  flush=True)
            check(len(losses[f]) == steps and all(math.isfinite(l) for l in losses[f]),
                  f"generator train B={B} fused_chains={f}: non-finite loss")
            if cuda:   # a step: the head, the depth - 2 dX tiles and the fold
                want_b = steps * depth if f else 0
                check((n6, n5, nb) == ((steps if f else 0), 0, want_b),
                      f"generator train B={B} fused_chains={f}: launches K6 {n6}, K5 {n5}, "
                      f"stash backward {nb} (expected {want_b})")
            if f:
                k6 += n6
        lerr = loss_error(losses[True], losses[False])
        print(f"generator train B={B}: per-step loss, fused_chains=True vs False: max relative "
              f"error {lerr} (bound {TRAIN_LOSS_RTOL})", flush=True)
        check(lerr <= TRAIN_LOSS_RTOL, f"generator train B={B}: the configurations disagree")
        entry = {"loss_rel_err": lerr, "losses": losses[True], "grad_rel_max": gerr,
                 "grad_tensor_rel_l2": terr, "faults": {}}
        for name, (fault, loss_sees) in MC_FAULTS.items():
            t = trainer(True)
            with planted_fault(fault):
                ferr = grad_errors(first_step_grads(t), g_ref)
                train_epoch(t, 0, dev)
            fl = loss_error(t.logs_total_loss_train.vals, losses[False])
            print(f"generator train B={B}, planted fault '{name}': first step's gradient "
                  f"relative max error {ferr[0]}, largest tensor relative L2 {ferr[1]}; per-step "
                  f"loss max relative error {fl} (bounds {GRAD_RTOL}, {MC_GRAD_TENSOR_RTOL}, "
                  f"{TRAIN_LOSS_RTOL}; the loss check must see it: {loss_sees})", flush=True)
            entry["faults"][name] = {"grad_rel_max": ferr[0], "grad_tensor_rel_l2": ferr[1],
                                     "loss_rel_err": fl}
        for name, (fault, loss_sees) in MC_FAULTS.items():
            e = entry["faults"][name]
            check(e["grad_rel_max"] > GRAD_RTOL or e["grad_tensor_rel_l2"] > MC_GRAD_TENSOR_RTOL,
                  f"generator train B={B}: the gradient checks miss the planted fault '{name}'")
            check(not loss_sees or e["loss_rel_err"] > TRAIN_LOSS_RTOL,
                  f"generator train B={B}: the loss check misses the planted fault '{name}'")
        if cuda:
            times, epoch = {False: [], True: []}, {False: 1, True: 1}
            for f in (False, True, True, False):
                times[f].append(train_epoch(trainers[f], epoch[f], dev))
                epoch[f] += 1
            for f in (False, True):
                rate = steps * len(times[f]) / sum(times[f])
                e = epoch[f]
                prof = device_profile(f"generator train epoch B={B} fused_chains={f}",
                                      lambda t=trainers[f], e=e: train_epoch(t, e, dev), 1, top=8)
                idle = None if prof is None else 1 - prof[4] / prof[0]
                print(f"rate: generator-driven train B={B} fused_chains={f} {rate:.2f} steps/s, "
                      f"{B * rate:.2f} images/s, idle share {idle} ({card})", flush=True)
                entry[f"fused={f}"] = {"steps_per_s": rate, "idle_share": idle,
                                       "epoch_s": times[f]}
        out["train"][f"B={B}"] = entry
    out["k6_launches"] = k6

    # 14.5 and 14.6
    out["noise"] = noise_checks(dev, card, noise_shape)
    out["generators"] = generator_checks(dev, card, gen_size, pupil=pupil)
    if not cuda:
        return out

    # 14.2, timed and profiled
    def recon(y, phys):
        def run():
            with torch.no_grad():
                return model(y, phys)
        return run

    out["rates"] = {}
    for nb, y, phys in ((1, y1, phys1), (batch, y8, phys8)):
        r = rates_in_turns(f"PGD {coils}-coil MRI, B={nb}", {"mc": recon(y, phys)},
                           nb * MAX_ITER, reps=5)["mc"]
        out["rates"][f"B={nb}"] = r
        prof = device_profile(f"PnP-PGD {coils}-coil MRI B={nb} recon", recon(y, phys), 3, top=8)
        entry = {"image_it_per_s": r}
        if prof is not None:
            fft = sum(k[0] for k in prof[3] if "fft" in k[2].lower())
            k5 = sum(k[0] for k in prof[3] if "conv3x3_wgmma" in k[2])
            entry.update(idle_share=1 - prof[4] / prof[0], device_busy_ms=prof[4],
                         fft_share=fft / prof[1], k5_share=k5 / prof[1], kernels=prof[2])
        print(f"rate: PGD {coils}-coil MRI {size}² B={nb} {r / nb:.2f} it/s, {r:.2f} image-it/s; "
              f"idle share {entry.get('idle_share')}, device time FFTs "
              f"{entry.get('fft_share')}, K5 {entry.get('k5_share')} ({card})", flush=True)
        out["rates"][f"B={nb}"] = entry
    return out


def adjointness_c(A, At, x, y) -> float:
    """``|<Ax, y> - <x, A^H y>| / (||Ax|| ||y||)`` in complex128; the real
    part of the pairing where ``x`` is real (a real image under complex
    measurements)."""
    import torch

    Ax = A(x).to(torch.complex128)
    d = (torch.vdot(Ax.flatten(), y.flatten().to(torch.complex128))
         - torch.vdot(x.flatten().to(torch.complex128), At(y).flatten().to(torch.complex128)))
    d = d if x.is_complex() else d.real
    return float(d.abs()) / float(Ax.abs().norm() * y.abs().to(torch.float64).norm())


def shares(prof, groups: dict) -> dict:
    """Each group's share of a profile's summed kernel time: ``groups`` maps
    a name to a predicate on the kernel's name."""
    if prof is None:
        return {}
    return {g: sum(k[0] for k in prof[3] if fn(k[2])) / prof[1] for g, fn in groups.items()}


def operators_phase(dev, card: str, size: int = OPS_SIZE, depth: int = 20,
                    batch: int = HQS_BATCH, radio_size: int = RADIO_SIZE,
                    n_vis: int = RADIO_VIS, pan_size: int = PAN_SIZE, pet_size=PET_SIZE,
                    pr_size: int = PR_SIZE, ptycho_size: int = PTYCHO_SIZE,
                    mie_sizes=MIE_SIZES, mie_k: float = MIE_K) -> dict:
    """Phase 15: the rest of ``physics/`` through the entry points with the
    default device.

    15.1 PnP-HQS on ``SinglePixelCamera(SPC_M, (1, size, size),
    "cake_cutting")`` and 15.2 PnP-PGD on ``CompressedSensing(CS_M, (1, size,
    size), fast=True)`` at stepsize 1 / ||A||², each with a bf16 ``DnCNN(1,
    1)`` of ``depth`` layers (the residual layer scaled as phase 5's) at B=1
    and B=``batch``, held as phase 5 holds PGD (``drive``: K5 once an
    iteration, every denoiser call, the plain and the unrounded chain's
    runs); the Hadamard round trip ``V(V_adjoint(x))`` with TF32 on and under
    a bf16 autocast; the DST-I of the flattened image (self-inverse,
    adjointness, its ms beside a power-of-two cuFFT). 15.3 PnP-FISTA with
    ``TVDenoiser(20)`` on ``RadioInterferometry`` (``n_vis`` visibilities,
    ``radio_size``²) and 15.4 PnP-PGD with ``TVDenoiser(15)`` on
    ``Pansharpen((3, pan_size, pan_size), factor=4)`` from ``brovey``, each
    held as phase 6 holds its TV runs (``tv_drive``: K7 once an iteration on
    its resident variant, within 1e-4 of the plain prox, within 0.5 dB of
    the naive estimate). 15.5 every other new operator once: adjointness and
    ``A``/``A_adjoint`` ms, ``osem``, the spectral method's seconds and cosine
    similarity, the Lippmann-Schwinger solve against ``mie_theory``.
    Returns the numbers of the kernels line. On the CPU, at small sizes, it
    rehearses the checks (count the plain K5 and K7 calls as launches by
    wrapping ``deepinv_tpu_torch.models.dncnn.conv_chain`` and
    ``deepinv_tpu_torch.optim.prior.chambolle_prox``) and skips the times,
    the profiles and the full-size bounds."""
    import numpy as np
    import torch

    import deepinv_tpu_torch.models.dncnn as dncnn_mod
    import deepinv_tpu_torch.optim.prior as prior_mod
    from deepinv_tpu_torch.datasets import shepp_logan
    from deepinv_tpu_torch.models import DnCNN, TVDenoiser, autocast
    from deepinv_tpu_torch.ops import dst1, gaussian_blur
    from deepinv_tpu_torch.ops.kernels.tv import _launch as tv_launch
    from deepinv_tpu_torch.ops.kernels.tv import tv_plan
    from deepinv_tpu_torch.optim import L2, PnP, optim_builder
    from deepinv_tpu_torch.physics import (PET, BlurFFT, CompressedSensing,
                                           CompressiveSpectralImaging, Decolorize,
                                           GaussianNoise, HyperSpectralUnmixing, Inpainting,
                                           Pansharpen, Ptychography, RadioInterferometry,
                                           RandomPhaseRetrieval, Scattering, SinglePixelCamera,
                                           StructuredRandom, StructuredRandomPhaseRetrieval,
                                           to_multiscale)
    from deepinv_tpu_torch.physics.phase_retrieval import (correct_global_phase,
                                                           cosine_similarity, spectral_methods)
    from deepinv_tpu_torch.physics.scattering import circular_sensors, mie_theory
    from deepinv_tpu_torch.physics.singlepixel import _hadamard

    cuda = dev.type == "cuda"
    g = torch.Generator().manual_seed(SEED + 90)
    rng = np.random.default_rng(SEED + 91)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def ms_of(fns: dict, reps: int = 10) -> dict:
        """CUDA-event ms a call of each of ``fns``, in turns (a, b, b, a)."""
        if not cuda:
            return {}
        t = {}
        with torch.no_grad():
            for k in list(fns) + list(fns)[::-1]:
                t.setdefault(k, []).append(cuda_ms(fns[k], reps, warmup=2))
        return {k: sum(v) / len(v) for k, v in t.items()}

    def recon(model, y, phys):
        def run():
            with torch.no_grad():
                return model(y, phys)
        return run

    out = {"launches": {"K5": {}, "K7": {}}, "operators": {}}
    x1 = torch.from_numpy(shepp_logan(size))[None, None].to(dev)
    x8 = torch.cat([x1] + [torch.from_numpy(discs(rng, 1, size))[None].to(dev)
                           for _ in range(batch - 1)])
    net = DnCNN(1, 1, depth=depth, nf=64, generator=g)
    with torch.no_grad():
        net.out_conv.weight.mul_(DNCNN_RESIDUAL_SCALE)
    k5_runs = {}

    # 15.1 PnP-HQS on the single-pixel camera over K5
    spc = SinglePixelCamera(m=SPC_M * size * size // OPS_SIZE ** 2, img_size=(1, size, size),
                            ordering="cake_cutting", noise_model=GaussianNoise(OPS_NOISE))
    Hn = _hadamard(size, dev) / math.sqrt(size)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.no_grad(), torch.autocast(dev.type, dtype=torch.bfloat16):
            back = spc.V(spc.V_adjoint(x8))
            raw = Hn @ (Hn @ x8 @ Hn) @ Hn        # the same products, not pinned
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    had_err, raw_err = rel_max(back, x8), rel_max(raw, x8)
    print(f"single-pixel camera {size}², m {spc.m}: V(V_adjoint(x)) with TF32 on and a bf16 "
          f"autocast, pinned to f32: max error {had_err:.3e} (bound {HADAMARD_RTOL}); the same "
          f"products unpinned: {raw_err:.3e}", flush=True)
    check(back.dtype == torch.float32 and had_err <= HADAMARD_RTOL,
          f"single-pixel camera: V(V_adjoint(x)) error {had_err}")
    out["hadamard_round_trip"] = {"pinned": had_err, "unpinned": raw_err}
    model_spc = optim_builder("HQS", data_fidelity=L2(), prior=PnP(autocast(net)),
                              params_algo=SPC_PARAMS, max_iter=MAX_ITER)
    out["spc"] = {}
    for x in (x1, x8):
        y = spc(x, generator=gen(SEED + 92 + x.shape[0]))
        label = f"PnP-HQS single-pixel camera B={x.shape[0]}"
        res, res_plain, n = drive(label, model_spc, y, spc, net, dncnn_mod.conv_chain,
                                  plain_conv_chain, tuple(x.shape), exact_conv_chain,
                                  residual_of=net.out_conv)
        with torch.no_grad():
            p_dag = psnr(spc.A_dagger(y)[:1], x[:1])
        print(f"{label}: PSNR {psnr(res[:1], x[:1]):.4f} dB (random weights), A_dagger "
              f"{p_dag:.4f} dB", flush=True)
        out["launches"]["K5"][label] = n
        out["spc"][label] = {"rel_l2_plain": rel_l2(res, res_plain)}
        k5_runs[("spc", x.shape[0])] = recon(model_spc, y, spc)

    # 15.2 PnP-PGD on fast compressed sensing over K5
    cs = CompressedSensing(m=CS_M * size * size // OPS_SIZE ** 2, img_size=(1, size, size),
                           fast=True, generator=g, noise_model=GaussianNoise(OPS_NOISE))
    n_cs = size * size
    v1 = torch.randn((batch, n_cs), generator=g).to(dev)
    v2 = torch.randn((batch, 2 * n_cs), generator=g).to(dev)
    with torch.no_grad():
        dst_inv = rel_max(dst1(dst1(v1, axes=(-1,)), axes=(-1,)), v1)
        w1 = torch.randn((batch, n_cs), generator=g).to(dev)
        dst_adj = abs(float((dst1(v1, axes=(-1,)).double() * w1.double()).sum()
                            - (v1.double() * dst1(w1, axes=(-1,)).double()).sum())) / float(
            v1.double().norm() * w1.double().norm())
        ycs = cs.A(x8)
        cs_adj = adjointness(cs.A, cs.A_adjoint, x8, torch.randn(ycs.shape, generator=g).to(dev))
        lip = float(cs.compute_norm(torch.randn(x1.shape, generator=g).to(dev), max_iter=30))
    dst_ms = ms_of({f"DST-I n={n_cs} B={b}": (lambda b=b: dst1(v1[:b], axes=(-1,)))
                    for b in (1, batch)}
                   | {f"cuFFT n={2 * n_cs} B={b}": (lambda b=b: torch.fft.fft(v2[:b]))
                      for b in (1, batch)}, reps=20)
    print(f"compressed sensing (fast) {size}², m {cs.m}: the DST-I of n = {n_cs} (an FFT of "
          f"{2 * (n_cs + 1)} = 2 x {n_cs + 1}): self-inverse {dst_inv:.3e}, adjointness "
          f"{dst_adj:.3e} (bound {DST_RTOL}); A adjointness {cs_adj:.3e} (bound {ADJOINT_RTOL}); "
          f"||A||² {lip:.6f}; ms a call in turns: "
          + ", ".join(f"{k} {t:.4f}" for k, t in dst_ms.items()) + f" ({card})", flush=True)
    check(dst_inv <= DST_RTOL and dst_adj <= DST_RTOL, f"DST-I: {dst_inv}, {dst_adj}")
    check(cs_adj <= ADJOINT_RTOL, f"compressed sensing: adjointness {cs_adj}")
    out["cs"] = {"dst_self_inverse": dst_inv, "dst_adjointness": dst_adj, "adjointness": cs_adj,
                 "norm_sq": lip, "dst_ms": dst_ms}
    model_cs = optim_builder("PGD", data_fidelity=L2(), prior=PnP(autocast(net)),
                             params_algo={"stepsize": 1.0 / lip,
                                          "g_param": PGD_PARAMS["g_param"]},
                             max_iter=MAX_ITER)
    for x in (x1, x8):
        y = cs(x, generator=gen(SEED + 102 + x.shape[0]))
        label = f"PnP-PGD compressed sensing B={x.shape[0]}"
        res, res_plain, n = drive(label, model_cs, y, cs, net, dncnn_mod.conv_chain,
                                  plain_conv_chain, tuple(x.shape), exact_conv_chain,
                                  residual_of=net.out_conv)
        with torch.no_grad():
            p_adj = psnr(cs.A_adjoint(y)[:1], x[:1])
        print(f"{label}: PSNR {psnr(res[:1], x[:1]):.4f} dB (random weights), A^T y "
              f"{p_adj:.4f} dB", flush=True)
        out["launches"]["K5"][label] = n
        out["cs"][label] = {"rel_l2_plain": rel_l2(res, res_plain)}
        k5_runs[("cs", x.shape[0])] = recon(model_cs, y, cs)

    # 15.3 PnP-FISTA on radio interferometry over K7
    tv_op = prior_mod.chambolle_prox
    xr = torch.from_numpy(shepp_logan(radio_size))[None, None].to(dev)
    uv = np.clip(np.random.default_rng(SEED).normal(size=(2, n_vis)) * (np.pi / 3),
                 -np.pi * 0.95, np.pi * 0.95).astype(np.float32)
    t0 = time.perf_counter()
    radio = RadioInterferometry((radio_size, radio_size), uv, noise_model=GaussianNoise(OPS_NOISE))
    sync(dev)
    t_plan = time.perf_counter() - t0
    yr = radio(xr, generator=gen(SEED + 110))
    with torch.no_grad():
        nrm = float(radio.compute_norm(xr, max_iter=20))
        radio_adj = adjointness_c(radio.A, radio.A_adjoint, xr, yr)
        dirty = radio.A_adjoint(yr) / nrm
        normal_err = rel_l2(radio.A_adjoint_A(xr), radio.A_adjoint(radio.A(xr)))
    plan = tv_plan(radio_size, radio_size, planes=1)
    print(f"radio interferometry {radio_size}², {n_vis} visibilities: plan and Toeplitz "
          f"spectrum {t_plan:.3f} s (host clock), ||A||² {nrm:.4f}, adjointness "
          f"{radio_adj:.3e} (bound {ADJOINT_RTOL}), Toeplitz normal vs A^H A relative L2 "
          f"{normal_err:.3e}; K7's plan at {radio_size}²: {plan} ({card})", flush=True)
    check(radio_adj <= ADJOINT_RTOL, f"radio: adjointness {radio_adj}")
    den_r = TVDenoiser(n_it_max=RADIO_TV[0])
    model_r = optim_builder("FISTA", data_fidelity=L2(),
                            prior=PnP(lambda u, s: den_r(u, RADIO_TV[1])),
                            params_algo={"stepsize": 1.0 / nrm, "g_param": 0.05},
                            max_iter=RADIO_ITERS, custom_init=lambda v, p: p.A_adjoint(v) / nrm)
    name = f"PnP-FISTA radio {radio_size}² B=1"
    out["launches"]["K7"][name] = tv_drive(name, model_r, yr, radio, [den_r.prior], xr, dirty,
                                           RADIO_ITERS, tv_op)
    out["radio"] = {"plan_s": t_plan, "norm_sq": nrm, "adjointness": radio_adj,
                    "normal_rel_l2": normal_err, "tv_plan": str(plan)}

    # 15.4 PnP-PGD on pansharpening over K7
    base = shepp_logan(pan_size)
    xp = torch.from_numpy(np.stack([base, np.roll(base, 3, 0), np.roll(base, -3, 1)]))[None]
    xp = xp.to(dev)
    pan = Pansharpen((3, pan_size, pan_size), factor=4)
    with torch.no_grad():
        yp = pan.A(xp)
        brovey = pan.brovey(yp)
        vp = type(yp)([torch.randn(t.shape, generator=g).to(dev) for t in yp])
        pan_adj = abs(float(sum((a.double() * b.double()).sum() for a, b in zip(pan.A(xp), vp))
                            - (xp.double() * pan.A_adjoint(vp).double()).sum())) / float(
            math.sqrt(sum(float(a.norm()) ** 2 for a in pan.A(xp)))
            * math.sqrt(sum(float(b.norm()) ** 2 for b in vp)))
    plan_p = tv_plan(pan_size, pan_size, planes=3)
    print(f"pansharpening 3x{pan_size}², factor 4: adjointness {pan_adj:.3e} (bound "
          f"{ADJOINT_RTOL}); K7's plan: {plan_p}", flush=True)
    check(pan_adj <= ADJOINT_RTOL, f"pansharpening: adjointness {pan_adj}")
    den_p = TVDenoiser(n_it_max=PAN_TV[0])
    model_p = optim_builder("PGD", data_fidelity=L2(),
                            prior=PnP(lambda u, s: den_p(u, PAN_TV[1])),
                            params_algo={"stepsize": 0.9, "g_param": 0.05}, max_iter=PAN_ITERS,
                            custom_init=lambda v, p: p.brovey(v))
    name = f"PnP-PGD pansharpening 3x{pan_size}² B=1"
    out["launches"]["K7"][name] = tv_drive(name, model_p, yp, pan, [den_p.prior], xp, brovey,
                                           PAN_ITERS, tv_op)
    out["pansharpen"] = {"adjointness": pan_adj, "tv_plan": str(plan_p)}

    # 15.5 every other new operator once
    ops = out["operators"]

    def linear(name, phys, x):
        with torch.no_grad():
            y = phys.A(x)
            v = (torch.randn(y.shape, generator=g, dtype=y.dtype) if y.is_complex() else
                 torch.randn(y.shape, generator=g)).to(dev)
            adj = adjointness_c(phys.A, phys.A_adjoint, x, v)
        t = ms_of({"A": lambda: phys.A(x), "A_adjoint": lambda: phys.A_adjoint(v)})
        print(f"{name}: x {tuple(x.shape)}, y {tuple(y.shape)}, adjointness {adj:.3e} (bound "
              f"{ADJOINT_RTOL}); ms a call: "
              + ", ".join(f"{k} {u:.4f}" for k, u in t.items()) + f" ({card})", flush=True)
        check(adj <= ADJOINT_RTOL, f"{name}: adjointness {adj}")
        ops[name] = {"adjointness": adj, "ms": t}
        return y

    D = pet_size[0]
    xv = torch.from_numpy(np.stack([shepp_logan(pet_size[-1])] * D))[None, None].to(dev) * 4
    t0 = time.perf_counter()
    pet = PET(pet_size, ring_differences=(0, -1, 1), normalize=True)
    sync(dev)
    t_pet = time.perf_counter() - t0
    yv = linear(f"PET michelogram {pet_size}", pet, xv)
    sync(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        rec = pet.osem(yv, n_iter=PET_OSEM_ITERS)
    sync(dev)
    t_osem = time.perf_counter() - t0
    p_osem = psnr(rec / 4, xv / 4)
    print(f"PET: set-up and norm {t_pet:.3f} s, ||A|| {float(pet.operator_norm):.4f}; osem "
          f"{PET_OSEM_ITERS} it {t_osem:.3f} s (host clock, first call), PSNR {p_osem:.4f} dB "
          f"({card})", flush=True)
    check(bool(torch.isfinite(rec).all()), "PET: non-finite osem")
    ops["PET osem"] = {"s": t_osem, "psnr_db": p_osem, "setup_s": t_pet}
    xs = x8[:2]
    linear(f"StructuredRandom {size}²", StructuredRandom((1, size, size), n_layers=2,
                                                         generator=g), xs)
    xc = xs.to(torch.complex64)
    srpr = StructuredRandomPhaseRetrieval((1, size, size), n_layers=2, generator=g)
    linear(f"StructuredRandomPhaseRetrieval's B {size}²", srpr.B, xc)
    xpt = torch.from_numpy(shepp_logan(ptycho_size))[None, None].to(dev)
    linear(f"Ptychography's B {ptycho_size}², 25 probes", Ptychography(
        (1, ptycho_size, ptycho_size), n_img=25).B, xpt.to(torch.complex64))
    for kind, base_p in (("BlurFFT", BlurFFT((1, size, size), filter=gaussian_blur(sigma=2.0))),
                         ("Inpainting", Inpainting((1, size, size), mask=0.5, generator=g))):
        ms_p = to_multiscale(base_p, img_size=(1, size, size), factors=(2, 4))
        for s in (1, 2):
            linear(f"{kind} multiscaler scale {s}", ms_p.with_scale(s), x8[:2, :, ::2 ** s,
                                                                          ::2 ** s].contiguous())
    xrgb = x8[:2].expand(2, 3, size, size).contiguous()
    linear(f"Decolorize {size}²", Decolorize(), xrgb)
    hsu = HyperSpectralUnmixing(E=4, C=8, generator=g)
    linear(f"HyperSpectralUnmixing {size}²", hsu, x8[:2].expand(2, 4, size, size).contiguous())
    cassi = CompressiveSpectralImaging((8, size, size), generator=g)
    linear(f"CompressiveSpectralImaging {size}²", cassi,
           x8[:2].expand(2, 8, size, size).contiguous())
    # RandomPhaseRetrieval at m = 4n, the spectral method
    xpr = torch.from_numpy(shepp_logan(pr_size))[None, None].to(dev).to(torch.complex64)
    t0 = time.perf_counter()
    rpr = RandomPhaseRetrieval(m=4 * pr_size ** 2, img_size=(1, pr_size, pr_size), generator=g)
    sync(dev)
    t_mat = time.perf_counter() - t0
    linear(f"RandomPhaseRetrieval's B {pr_size}², m = 4n", rpr.B, xpr)
    cos, t_spec = {}, {}
    with torch.no_grad():
        ypr = rpr.A(xpr)
        for it in (50, SPECTRAL_ITERS):
            sync(dev)
            t0 = time.perf_counter()
            x0 = spectral_methods(ypr, rpr, n_iter=it, generator=gen(SEED + 120))
            sync(dev)
            t_spec[it] = time.perf_counter() - t0
            cos[it] = float(cosine_similarity(correct_global_phase(x0, xpr), xpr))
    print(f"RandomPhaseRetrieval {pr_size}², m {rpr.m}: matrix {rpr.B.mat.numel() * 8 / 2 ** 20:.0f}"
          f" MiB made in {t_mat:.3f} s; spectral method, seconds (host clock, the first call "
          f"first) by power steps {t_spec}, cosine similarity {cos} ({card})", flush=True)
    check(math.isfinite(cos[SPECTRAL_ITERS]) and cos[SPECTRAL_ITERS] > SPECTRAL_COS,
          f"spectral method: cosine similarity {cos}")
    ops["spectral_methods"] = {"s": t_spec, "cosine": cos, "matrix_s": t_mat}
    # the Lippmann-Schwinger solve against the Mie series
    L, a, contrast = 1.0, 0.2, 0.6
    tx, rx = circular_sensors(3, radius=1.0)
    ang = np.arctan2(tx[1], tx[0])
    rels, secs = [], []
    for n in mie_sizes:
        phys = Scattering(img_width=n, transmitters=tx, receivers=rx, background_wavenumber=mie_k,
                          box_length=L, wave_type="plane_wave")
        grid = np.linspace(-L / 2, L / 2, n)
        yy, xx = np.meshgrid(-grid, grid, indexing="ij")
        c = torch.from_numpy(((xx ** 2 + yy ** 2) < a ** 2).astype(np.float32) * contrast)
        c = c[None, None].to(dev)
        with torch.no_grad():
            phys.compute_total_field(c)      # warm-up: cuFFT plans
            sync(dev)
            t0 = time.perf_counter()
            u = phys.compute_total_field(c)
            sync(dev)
            secs.append(time.perf_counter() - t0)
        u_mie, _ = mie_theory(mie_k, a, contrast, n, ang, box_length=L, device=dev)
        rels.append(float((u - u_mie).norm() / u_mie.norm()))
    print(f"Lippmann-Schwinger field vs Mie (k {mie_k}, radius {a}, contrast {contrast}, 3 "
          f"plane waves): relative error {dict(zip(mie_sizes, rels))} (bound {MIE_RTOL}, then "
          f"{MIE_REFINE}x on refinement); solve seconds {dict(zip(mie_sizes, secs))} (host "
          f"clock, CG on the normal equations to tol 1e-5) ({card})", flush=True)
    check(all(math.isfinite(r) for r in rels), "Mie: non-finite field")
    if tuple(mie_sizes) == MIE_SIZES:
        check(rels[0] < MIE_RTOL and rels[1] < MIE_REFINE * rels[0], f"Mie: errors {rels}")
    ops["mie"] = {"rel_err": dict(zip(mie_sizes, rels)), "solve_s": dict(zip(mie_sizes, secs))}
    if not cuda:
        return out

    # 15.1-15.4 timed in turns and profiled
    out["rates"] = {}
    for key, label in (("spc", "PnP-HQS single-pixel camera"),
                       ("cs", "PnP-PGD compressed sensing")):
        for nb in (1, batch):
            run = k5_runs[key, nb]
            r = rates_in_turns(f"{label}, B={nb}", {key: run}, nb * MAX_ITER, reps=5)[key]
            prof = device_profile(f"{label} B={nb} recon", run, 3, top=8)
            sh = shares(prof, {"K5": lambda k: "conv3x3_wgmma" in k,
                               "gemm (Hadamard)": lambda k: "gemm" in k.lower(),
                               "FFT (DST-I)": lambda k: "fft" in k.lower()})
            idle = None if prof is None else 1 - prof[4] / prof[0]
            print(f"rate: {label} {size}² B={nb} {r / nb:.2f} it/s, {r:.2f} image-it/s; idle "
                  f"share {idle}; device-time shares {sh} ({card})", flush=True)
            out["rates"][f"{label} B={nb}"] = {"image_it_per_s": r, "idle_share": idle,
                                               "shares": sh}
    for label, model, y, phys, iters in (
            (f"PnP-FISTA radio {radio_size}²", model_r, yr, radio, RADIO_ITERS),
            (f"PnP-PGD pansharpening 3x{pan_size}²", model_p, yp, pan, PAN_ITERS)):
        run = recon(model, y, phys)
        r = rates_in_turns(f"{label}, B=1", {"tv": run}, iters, reps=3)["tv"]
        prof = device_profile(f"{label} B=1 recon", run, 3, top=8)
        sh = shares(prof, {"K7": lambda k: "tv_resident" in k,
                           "FFT (Toeplitz NUFFT normal)": lambda k: "fft" in k.lower()})
        idle = None if prof is None else 1 - prof[4] / prof[0]
        print(f"rate: {label} B=1 {r:.2f} it/s; idle share {idle}; device-time shares {sh} "
              f"({card})", flush=True)
        out["rates"][label] = {"it_per_s": r, "idle_share": idle, "shares": sh}
    # K7 at the TV denoisers' size: the plan's resident layout (a plane a
    # cluster of 16, the only cluster that holds a 512² plane: 16 of the SMs
    # for one plane) against the global variant (every SM, a launch a step),
    # in turns
    gam = torch.full((1, 1, 1, 1), RADIO_TV[1], device=dev)
    k7 = {}
    for planes in (1, 3):
        xt = torch.rand((1, planes, radio_size, radio_size), generator=g).to(dev)
        k7.update(ms_of({f"{planes}x{radio_size}² {v}" + (f" cluster {c}" if c else ""):
                         (lambda t=xt, v=v, c=c: tv_launch(t, gam, RADIO_TV[0], v, c))
                         for v, c in (("resident", 16), ("global", None))},
                        reps=20))
    print(f"K7 at {radio_size}², {RADIO_TV[0]} steps, ms a prox in turns: "
          + ", ".join(f"{k} {t:.4f}" for k, t in k7.items()) + f" ({card})", flush=True)
    out["k7_512_ms"] = k7
    return out


def grads_of(trainer, x, y, phys, chains):
    """Named gradients of one loss on a fixed batch, in ``chains``."""
    model = trainer.model
    model.zero_grad(set_to_none=True)
    with chains:
        trainer.compute_loss(model, x, y, phys)[0].backward()
    gs = {n: p.grad.reshape(-1).float().clone() for n, p in model.named_parameters()
          if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return gs


def grad_gaps(label, a, b):
    """The relative L2 gaps of the schedule's (``param_*``) and the
    network's gradients between two configurations; fails past GRAD_RTOL."""
    import torch

    check(set(a) == set(b), f"{label}: the gradients' parameters differ: {set(a) ^ set(b)}")
    groups = {"schedule": [k for k in a if k.startswith("param_")],
              "DnCNN": [k for k in a if not k.startswith("param_")]}
    gaps = {}
    for name, keys in groups.items():
        ga, gb = torch.cat([a[k] for k in keys]), torch.cat([b[k] for k in keys])
        gaps[name] = rel_l2(ga, gb)
    whole = rel_max(torch.cat(list(a.values())), torch.cat([b[k] for k in a]))
    print(f"{label}: first step's gradients, kernels vs layers: relative L2 {gaps} (bound "
          f"{GRAD_RTOL}), whole relative max {whole}; entries "
          f"{sorted(k for k in a if k.startswith('param_'))}", flush=True)
    check(all(v <= GRAD_RTOL for v in gaps.values()), f"{label}: gradients disagree: {gaps}")
    return gaps


def train_in_both(label: str, trainers: dict, steps: int, iters: int, L: int, dev, card: str,
                  size, out: dict):
    """``steps`` train steps of ``trainers[True]`` and ``trainers[False]`` (the
    two ``fused_chains`` configurations of one model on one loader), checked:
    the first step's gradients within GRAD_RTOL of each other, finite losses,
    and on the card K6 ``iters`` times and the stash backward ``iters`` (L +
    2) launches a step with ``True``, none with ``False``. Their launches go
    to ``out["launches"]``; on the card the steps/s of both in turns and the
    idle share of a ``True`` step to ``out["rates"]``. Returns the gradient
    gaps and the first batch ``(x, y, physics)``."""
    import deepinv_tpu_torch.models.dncnn as dncnn_mod
    from deepinv_tpu_torch.ops.kernels.conv_chain import (conv_chain_stash, fused_chains_disabled,
                                                          stash_backward)

    cuda = dev.type == "cuda"
    x0, y0, p0 = first_batch(trainers[True])
    gaps = grad_gaps(label, grads_of(trainers[True], x0, y0, p0, contextlib.nullcontext()),
                     grads_of(trainers[False], x0, y0, p0, fused_chains_disabled()))
    secs = {}
    for f, t in trainers.items():
        reset_kernel_launches(dncnn_mod.conv_chain, conv_chain_stash)
        reset_kernel_launches(stash_backward)
        secs[f] = [train_epoch(t, 0, dev)]
        n5, n6, nb_ = (kernel_launches(dncnn_mod.conv_chain), kernel_launches(conv_chain_stash),
                       kernel_launches(stash_backward))
        losses = t.logs_total_loss_train.vals
        print(f"{label} fused_chains={f}: {steps} steps, K6 launches {n6}, K5 {n5}, stash "
              f"backward {nb_}, losses {losses}", flush=True)
        check(len(losses) == steps and all(math.isfinite(v) for v in losses),
              f"{label} fused_chains={f}: non-finite loss")
        if cuda:
            want = (iters * steps, 0, iters * (L + 2) * steps) if f else (0, 0, 0)
            check((n6, n5, nb_) == want, f"{label} fused_chains={f}: launches K6 {n6}, K5 "
                  f"{n5}, stash backward {nb_} (expected {want})")
        if f:
            out["launches"]["K6"][label] = n6
            out["launches"]["stash_backward"][label] = nb_
    if cuda:
        for f in (False, True, True, False):
            secs[f].append(train_epoch(trainers[f], len(secs[f]), dev))
        prof = device_profile(f"{label} step fused_chains=True",
                              step_fn(trainers[True], x0, y0, p0), 2, top=8)
        idle = None if prof is None else 1 - prof[4] / prof[0]
        rates = {f: steps * (len(v) - 1) / sum(v[1:]) for f, v in secs.items()}
        print(f"rate: {label} {size}² {rates[True]:.3f} steps/s fused_chains=True, "
              f"{rates[False]:.3f} steps/s False; idle share (True) {idle} ({card})", flush=True)
        out["rates"][label] = {"steps_per_s": rates, "idle_share": idle}
    return gaps, (x0, y0, p0)


def rate_of(label: str, run, image_its: int, B: int, iters: int, size, card: str,
            rates: dict, calls: int = 3) -> None:
    """A ``rate:`` line of one recon ``run`` (recons/s, image-it/s and the
    idle share from a profile of ``calls`` recons), kept in ``rates``."""
    r = rates_in_turns(f"{label}, B={B}", {"kernel": run}, image_its, reps=calls)["kernel"]
    prof = device_profile(f"{label} B={B} recon", run, calls, top=8)
    idle = None if prof is None else 1 - prof[4] / prof[0]
    print(f"rate: {label} {size} B={B} {r / (B * iters):.3f} recons/s, {r:.2f} image-it/s; "
          f"idle share {idle} ({card})", flush=True)
    rates[f"{label} B={B}"] = {"image_it_per_s": r, "recons_per_s": r / (B * iters),
                               "idle_share": idle}


def optim_breadth_phase(dev, card: str, size: int = 256, depth: int = 20, batch: int = HQS_BATCH,
                        nc=(64, 128, 256, 512), nb: int = R_MAIN, steps: int = UNFOLD_STEPS,
                        deq_iters: int = DEQ_ITERS, deq_backward: int = DEQ_BACKWARD) -> dict:
    """Phase 16: the rest of ``optim/`` and ``unfolded/`` through the entry
    points with the default device.

    16.1 ``DPIR(DPIR_SIGMA, denoiser=autocast(DRUNet(nc, nb)))`` on the HQS
    bench problem (phase 4's BlurFFT and noise, 3 channels) at B=1 and
    B=``batch``, held as phase 4 holds HQS (``drive``: K1 once a denoiser call,
    8 a recon, every call and the run against the plain chain). 16.2
    ``optim_builder("MD", PoissonLikelihood(MD_GAIN), RED(autocast(DnCNN)),
    bregman_potential=BurgEntropy())`` on ``Denoising(PoissonNoise(MD_GAIN))``
    at B=1 and B=``batch``, held as phase 5 holds PGD (K5 once an iteration);
    MLEM on ``Tomography`` (CT_ANGLES views, ``PoissonNoise(MLEM_GAIN)``) of the
    Shepp-Logan phantom: non-negative, its negative log-likelihood falling
    over MLEM_ITERS. 16.3 ``unfolded_builder("PGD", L2(), PnP(autocast(DnCNN)),
    max_iter=UNFOLD_ITERS)`` trained by ``Trainer`` on ``Inpainting`` (a mask
    from a generator) at B=1 and B=``batch``, ``steps`` steps in each
    train-step configuration from the same weights: K6 UNFOLD_ITERS times a
    step and the stash backward UNFOLD_ITERS (L + 2) launches a step with
    ``fused_chains=True``, none with ``False``; the first step's gradients of
    the schedule and of the DnCNN within GRAD_RTOL (relative L2) of each
    other. 16.4 ``DEQ_builder("PGD", L2(), PnP(contractive DnCNN),
    max_iter=deq_iters, max_iter_backward=deq_backward)``, one train step at
    B=1 and B=``batch``: K5 once a forward map, K6 once (the graph step at the
    equilibrium), L + 2 stash-backward launches a vector-Jacobian product,
    and the parameter gradient within GRAD_RTOL of the same step under
    ``fused_chains_disabled()``. Timed (``rate:`` lines, with the card):
    recons/s and image-it/s with idle shares (16.1, 16.2), steps/s (16.3,
    16.4). Returns the numbers of the kernels line. On the CPU, at small
    sizes, it rehearses the checks (count the plain K1 and K5 calls as
    launches by wrapping ``deepinv_tpu_torch.models.drunet.resblock_chain`` and
    ``deepinv_tpu_torch.models.dncnn.conv_chain``; the K6 and stash-backward
    counts are checked on the card only) and skips the times and profiles."""
    import numpy as np
    import torch

    import deepinv_tpu_torch.models.dncnn as dncnn_mod
    import deepinv_tpu_torch.models.drunet as drunet_mod
    from deepinv_tpu_torch.core import loop_stats
    from deepinv_tpu_torch.datasets import ArrayDataset, DataLoader, shepp_logan
    from deepinv_tpu_torch.models import DnCNN, DRUNet, autocast
    from deepinv_tpu_torch.models.base import Denoiser
    from deepinv_tpu_torch.ops import gaussian_blur
    from deepinv_tpu_torch.ops.kernels.conv_chain import (conv_chain_stash, fused_chains_disabled,
                                                          stash_backward)
    from deepinv_tpu_torch.ops.kernels.resblock_chain import resblock_chain_plain
    from deepinv_tpu_torch.optim import (DPIR, L2, RED, BurgEntropy, PnP, PoissonLikelihood,
                                         Zero, optim_builder)
    from deepinv_tpu_torch.physics import (BlurFFT, Denoising, GaussianNoise, Inpainting,
                                           PoissonNoise, Tomography)
    from deepinv_tpu_torch.training import Trainer
    from deepinv_tpu_torch.unfolded import DEQ_builder, unfolded_builder

    cuda = dev.type == "cuda"
    g = torch.Generator().manual_seed(SEED + 160)
    rng = np.random.default_rng(SEED + 161)
    L = depth - 2
    out = {"launches": {"K1": {}, "K5": {}, "K6": {}, "stash_backward": {}}, "rates": {}}

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def recon(model, y, phys):
        def run():
            with torch.no_grad():
                return model(y, phys)
        return run

    def plain_resblocks():
        return swapped(drunet_mod, "resblock_chain",
                       lambda h, w1s, w2s, packed=None: resblock_chain_plain(h, w1s, w2s))

    # 16.1 DPIR over K1
    shape1 = (1, 3, size, size)
    blur = BlurFFT(shape1[1:], filter=gaussian_blur(sigma=1.5),
                   noise_model=GaussianNoise(DPIR_SIGMA))
    den = autocast(DRUNet(nc=nc, nb=nb, generator=g))
    model_dpir = DPIR(DPIR_SIGMA, denoiser=den, max_iter=MAX_ITER)
    for B in (1, batch):
        x = torch.from_numpy(np.stack([discs(rng, 3, size) for _ in range(B)])).to(dev)
        y = blur(x, generator=gen(SEED + 162 + B))
        label = f"DPIR B={B}"
        res, res_plain, n = drive(label, model_dpir, y, blur, den.denoiser,
                                  drunet_mod.resblock_chain, plain_resblocks, tuple(x.shape))
        print(f"{label}: PSNR {psnr(res[:1], x[:1]):.4f} dB (random weights), y "
              f"{psnr(y[:1], x[:1]):.4f} dB", flush=True)
        out["launches"]["K1"][label] = n
        out[label] = {"rel_l2_plain": rel_l2(res, res_plain)}
        if cuda:
            rate_of("DPIR", recon(model_dpir, y, blur), B * MAX_ITER, B, MAX_ITER, f"{size}²",
                    card, out["rates"])

    # 16.2 PnP mirror descent over K5, and MLEM
    net = DnCNN(1, 1, depth=depth, nf=64, generator=g)
    with torch.no_grad():
        net.out_conv.weight.mul_(DNCNN_RESIDUAL_SCALE)
    pois = Denoising(PoissonNoise(gain=MD_GAIN))
    fid = PoissonLikelihood(gain=MD_GAIN)
    model_md = optim_builder("MD", data_fidelity=fid, prior=RED(autocast(net)),
                             bregman_potential=BurgEntropy(), params_algo=MD_PARAMS,
                             max_iter=MAX_ITER)
    for B in (1, batch):
        x = torch.from_numpy(np.stack([discs(rng, 1, size) for _ in range(B)]) * 0.7 + 0.2).to(dev)
        y = pois(x, generator=gen(SEED + 170 + B))
        label = f"PnP-MD B={B}"
        res, res_plain, n = drive(label, model_md, y, pois, net, dncnn_mod.conv_chain,
                                  plain_conv_chain, tuple(x.shape), exact_conv_chain,
                                  residual_of=net.out_conv)
        with torch.no_grad():
            nll = [float(fid.fn(v, y, pois).sum()) for v in (y, res)]
        print(f"{label}: PSNR {psnr(res[:1], x[:1]):.4f} dB, y {psnr(y[:1], x[:1]):.4f} dB; min "
              f"{float(res.min()):.4f}; negative log-likelihood y {nll[0]:.6g}, recon "
              f"{nll[1]:.6g}", flush=True)
        check(bool((res > 0).all()), f"{label}: the Burg-entropy iterate left the positive orthant")
        out["launches"]["K5"][label] = n
        out[label] = {"rel_l2_plain": rel_l2(res, res_plain), "nll": nll}
        if cuda:
            rate_of("PnP-MD", recon(model_md, y, pois), B * MAX_ITER, B, MAX_ITER, f"{size}²",
                    card, out["rates"])
    xct = torch.from_numpy(shepp_logan(size))[None, None].to(dev) + 0.05
    ct = Tomography(img_width=size, angles=CT_ANGLES, normalize=True,
                    noise_model=PoissonNoise(gain=MLEM_GAIN))
    yct = ct(xct, generator=gen(SEED + 180))
    # bkg 1e-6: a ray that misses the phantom has y = 0 and A x = 0
    nll_of = PoissonLikelihood(gain=MLEM_GAIN, bkg=1e-6)
    nlls, t_mlem = [], {}
    for n_it in MLEM_ITERS:
        mlem = optim_builder("MLEM", data_fidelity=PoissonLikelihood(gain=MLEM_GAIN), prior=Zero(),
                             params_algo={"stepsize": 1.0}, max_iter=n_it)
        sync(dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            xm = mlem(yct, ct)
        sync(dev)
        t_mlem[n_it] = time.perf_counter() - t0
        with torch.no_grad():
            nlls.append(float(nll_of.fn(xm, yct, ct).sum()))
        check(bool(torch.isfinite(xm).all()) and float(xm.min()) >= 0,
              f"MLEM {n_it} it: non-finite or negative")
    with torch.no_grad():
        p_fbp = psnr(ct.A_dagger(yct), xct)
    print(f"MLEM {size}², {CT_ANGLES} views, Poisson gain {MLEM_GAIN}: negative log-likelihood by "
          f"iterations {dict(zip(MLEM_ITERS, nlls))}, PSNR {psnr(xm, xct):.4f} dB (FBP "
          f"{p_fbp:.4f} dB), seconds (host clock, first calls) {t_mlem} ({card})", flush=True)
    check(all(a > b for a, b in zip(nlls, nlls[1:])), f"MLEM: the likelihood did not rise: {nlls}")
    out["mlem"] = {"nll": dict(zip(MLEM_ITERS, nlls)), "s": t_mlem}

    # 16.3 unfolded PGD trained on K6 and its stash backward
    inp = Inpainting((1, size, size), mask=UNFOLD_MASK, generator=g,
                     noise_model=GaussianNoise(UNFOLD_NOISE))
    net_c = DnCNN(1, 1, depth=depth, nf=64, generator=g)
    with torch.no_grad():
        net_c.out_conv.weight.mul_(DNCNN_RESIDUAL_SCALE)

    def trainer_of(model, xs, B, fused):
        return Trainer(model, inp, optimizer=torch.optim.Adam(model.parameters(), lr=1e-4),
                       train_dataloader=DataLoader(ArrayDataset(xs), batch_size=B), epochs=1,
                       online_measurements=True, verbose=False, fused_chains=fused, seed=SEED)

    class Contractive(Denoiser):
        """``0.9 x + 0.1 net(x)``, the contraction of examples/demo_deq.py:26-40."""

        def __init__(self, inner):
            super().__init__()
            self.net = inner

        def forward(self, x, sigma=None, **kwargs):
            return 0.9 * x + 0.1 * self.net(x, sigma)

    out["unfolded"], out["deq"] = {}, {}
    for B in (1, batch):
        xs = torch.from_numpy(np.stack([discs(rng, 1, size) for _ in range(B * steps)])).to(dev)
        trainers = {f: trainer_of(unfolded_builder(
            "PGD", data_fidelity=L2(), prior=PnP(autocast(copy.deepcopy(net_c))),
            params_algo=PGD_PARAMS, max_iter=UNFOLD_ITERS), xs, B, f) for f in (True, False)}
        label = f"unfolded PGD train B={B}"
        gaps, (x0, y0, p0) = train_in_both(label, trainers, steps, UNFOLD_ITERS, L, dev, card,
                                           size, out)
        out["unfolded"][label] = {"grad_gaps": gaps}

        # 16.4 DEQ: the forward on K5, the backward's graph step on K6 and its
        # products on the stash backward
        model = DEQ_builder("PGD", data_fidelity=L2(),
                            prior=PnP(Contractive(autocast(copy.deepcopy(net_c)))),
                            params_algo=DEQ_PARAMS, max_iter=deq_iters,
                            max_iter_backward=deq_backward)
        t_deq = trainer_of(model, xs[:B], B, True)
        label = f"DEQ train B={B}"
        gaps = grad_gaps(label, grads_of(t_deq, x0, y0, p0, contextlib.nullcontext()),
                         grads_of(t_deq, x0, y0, p0, fused_chains_disabled()))
        reset_kernel_launches(dncnn_mod.conv_chain, conv_chain_stash, stash_backward)
        secs = train_epoch(t_deq, 0, dev)
        n5, n6, nb_ = (kernel_launches(dncnn_mod.conv_chain), kernel_launches(conv_chain_stash),
                       kernel_launches(stash_backward))
        st = model.last_run
        fwd, bwd = int(st["forward_iterations"]), int(st["backward_iterations"])
        print(f"{label}: forward {fwd} maps of {deq_iters} ({st['forward_maps']} evaluated), "
              f"adjoint {bwd} products of {deq_backward} ({st['backward_products']} evaluated, "
              f"the parameters' cotangents included); launches K5 {n5}, K6 {n6}, stash backward "
              f"{nb_}; loss {t_deq.logs_total_loss_train.vals}; {secs:.3f} s a step (first, "
              f"host clock)", flush=True)
        if cuda:
            want = (st["forward_maps"], 1, st["backward_products"] * (L + 2))
            check((n5, n6, nb_) == want, f"{label}: launches K5 {n5}, K6 {n6}, stash backward "
                  f"{nb_} (expected {want})")
            run = step_fn(t_deq, x0, y0, p0)
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(2):
                run()
            sync(dev)
            rate = 2 / (time.perf_counter() - t0)
            prof = device_profile(f"{label} step", run, 1, top=8)
            idle = None if prof is None else 1 - prof[4] / prof[0]
            print(f"rate: {label} {size}² {rate:.3f} steps/s; idle share {idle} ({card})",
                  flush=True)
            out["rates"][label] = {"steps_per_s": rate, "idle_share": idle}
        out["launches"]["K5"][label] = n5
        out["launches"]["K6"][label] = n6
        out["launches"]["stash_backward"][label] = nb_
        out["deq"][label] = {"grad_gaps": gaps, "forward": fwd, "backward": bwd}
    return out


def models_phase(dev, card: str, size: int = MODL_SIZE, batch: int = HQS_BATCH,
                 depth: int = MODL_DEPTH, steps: int = MODL_STEPS, vol: int = VOL_SIZE,
                 depth_3d: int = 20, nc=(64, 128, 256, 512), nb: int = R_MAIN,
                 cascades: int = 8, ct_size: int = 256, image: int = 256) -> dict:
    """Phase 17: the models the unrolled, PnP and 3D demos build on, through
    the entry points with the default device.

    17.1 ``MoDL(autocast(DnCNN(2, 2, depth)), num_iter=MODL_ITERS)`` (its
    residual conv scaled by DNCNN_RESIDUAL_SCALE, as phase 5's) on ``size``²
    single-coil ``MRI`` with a ``RandomMaskGenerator`` mask, under
    ``torch.no_grad()`` at B=1 and B=``batch``, held as phase 5 holds PGD
    (``drive``: K5 once a denoiser call, MODL_ITERS a recon, each call within
    DENOISER_RTOL and the recon within RECON_RTOL of the plain chain's); the
    B=1 profile holds ``depth - 2`` tile launches a call. 17.2 the same MoDL
    trained by ``Trainer`` at B=1 and B=``batch``, ``steps`` steps in each
    train-step configuration from the same weights: K6 MODL_ITERS times and
    the stash backward MODL_ITERS (L + 2) launches a step with
    ``fused_chains=True``, none with ``False``; the first step's gradients of
    the schedule and of the DnCNN within GRAD_RTOL of each other. 17.3 a 3D
    ``DnCNN(1, 1, depth_3d, dim=3)`` and a full-width ``DRUNet(1, 1, dim=3)``,
    one forward each on a 1x1x``vol``³ volume in bf16 and f32: no kernel
    launch (the gates refuse 5D activations), finite, bf16 within
    DENOISER_RTOL of f32; a 3D DnCNN inflated axially from a 2D one
    (``pretrained=`` its state dict) equal to it slice by slice on a
    depth-constant volume within INFLATE_RTOL in f32. 17.4 that 2D DnCNN and
    a full-width 2D DRUNet written to ``.pth`` files under upstream's names
    and rebuilt with ``pretrained=``: the same weights and, in bf16, the same
    output bits, K5 / K1 launched once a call; a model loaded after its first
    call gives the new weights' output bits. 17.5 ``VarNet(num_cascades)`` on
    the MRI problem at B=1 and B=``batch`` and ``PDNet()`` on ``ct_size``²
    ``Tomography``, f32 on cuDNN with no kernel launch. Timed (``rate:`` lines,
    with the card): recons/s, image-it/s, steps/s and idle shares, and the
    phase's seconds. Returns the numbers of the kernels line. On the CPU, at
    small sizes, it rehearses the checks (count the plain K5 and K1 calls as
    launches by wrapping ``deepinv_tpu_torch.models.dncnn.conv_chain`` and
    ``deepinv_tpu_torch.models.drunet.resblock_chain``; the K6 and
    stash-backward counts are checked on the card only) and skips the times
    and profiles."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    import deepinv_tpu_torch.models.dncnn as dncnn_mod
    import deepinv_tpu_torch.models.drunet as drunet_mod
    from deepinv_tpu_torch.datasets import ArrayDataset, DataLoader, shepp_logan
    from deepinv_tpu_torch.models import DnCNN, DRUNet, MoDL, PDNet, VarNet, autocast
    from deepinv_tpu_torch.models.convert import (dncnn_names, drunet_names, port_dncnn,
                                                  port_drunet, upstream_state_dict)
    from deepinv_tpu_torch.ops.kernels.conv_chain import (conv_chain, conv_chain_stash,
                                                          stash_backward)
    from deepinv_tpu_torch.ops.kernels.resblock_chain import resblock_chain
    from deepinv_tpu_torch.ops.kernels.tv import chambolle_prox
    from deepinv_tpu_torch.ops.kernels.up_resblock_chain import up_resblock_chain
    from deepinv_tpu_torch.ops.kernels.up_sandwich import up_sandwich
    from deepinv_tpu_torch.physics import MRI, GaussianNoise, Tomography
    from deepinv_tpu_torch.physics.generator import RandomMaskGenerator
    from deepinv_tpu_torch.training import Trainer

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    g = torch.Generator().manual_seed(SEED + 190)
    rng = np.random.default_rng(SEED + 191)
    L = depth - 2
    out = {"launches": {"K1": {}, "K5": {}, "K6": {}, "stash_backward": {}}, "rates": {}}
    kernel_ops = (conv_chain, conv_chain_stash, stash_backward, resblock_chain,
                  up_resblock_chain, up_sandwich, chambolle_prox)

    def launched():
        return sum(kernel_launches(o) for o in kernel_ops)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def recon(model, y, phys):
        def run():
            with torch.no_grad():
                return model(y, phys)
        return run

    sl = torch.from_numpy(shepp_logan(size))

    def images(n):
        xs = [torch.stack([sl, 0.2 * sl.flip(-1)])]
        xs += [torch.from_numpy(discs(rng, 2, size)) for _ in range(n - 1)]
        return torch.stack(xs).to(dev)

    # 17.1 MoDL's reconstruction over K5
    mask = RandomMaskGenerator((size, size), acceleration=MODL_ACCEL).step(
        1, generator=gen(SEED + 192))["mask"][0]
    mri = MRI(mask=mask, img_size=(size, size), noise_model=GaussianNoise(MODL_SIGMA))
    net = DnCNN(2, 2, depth=depth, nf=64, generator=g)
    with torch.no_grad():
        net.out_conv.weight.mul_(DNCNN_RESIDUAL_SCALE)
    modl = MoDL(denoiser=autocast(net), num_iter=MODL_ITERS)
    for B in (1, batch):
        x = images(B)
        y = mri(x, generator=gen(SEED + 193 + B))
        label = f"MoDL B={B}"
        res, res_plain, n = drive(label, modl, y, mri, net, dncnn_mod.conv_chain,
                                  plain_conv_chain, tuple(x.shape), exact_conv_chain,
                                  residual_of=net.out_conv, iters=MODL_ITERS)
        with torch.no_grad():
            zf = mri.A_adjoint(y)
        print(f"{label}: PSNR {psnr(res[:1], x[:1]):.4f} dB (random weights), zero-filled "
              f"{psnr(zf[:1], x[:1]):.4f} dB", flush=True)
        out["launches"]["K5"][label] = n
        out[label] = {"rel_l2_plain": rel_l2(res, res_plain)}
        if cuda:
            run = recon(modl, y, mri)
            if B == 1:
                out["tile"] = tile_in_profile(f"{label} recon", run,
                                              {"conv3x3_wgmma": MODL_ITERS * L})
            rate_of("MoDL", run, B * MODL_ITERS, B, MODL_ITERS, f"{size}²", card, out["rates"])

    # 17.2 MoDL trained on K6 and its stash backward
    def trainer_of(model, xs, B, fused):
        return Trainer(model, mri, optimizer=torch.optim.Adam(model.parameters(), lr=MODL_LR),
                       train_dataloader=DataLoader(ArrayDataset(xs), batch_size=B), epochs=1,
                       online_measurements=True, verbose=False, fused_chains=fused, seed=SEED)

    out["train"] = {}
    for B in (1, batch):
        xs = torch.cat([images(B) for _ in range(steps)])
        trainers = {f: trainer_of(MoDL(denoiser=autocast(copy.deepcopy(net)),
                                       num_iter=MODL_ITERS), xs, B, f) for f in (True, False)}
        label = f"MoDL train B={B}"
        gaps, _ = train_in_both(label, trainers, steps, MODL_ITERS, L, dev, card, size, out)
        out["train"][label] = {"grad_gaps": gaps}

    # 17.3 the 3D models: their layers, no kernel
    x3 = torch.rand((1, 1, vol, vol, vol), generator=g).to(dev)
    dn2 = DnCNN(1, 1, depth=depth_3d, nf=64, generator=g)
    for name, model, call in (
            ("DnCNN 3D", DnCNN(1, 1, depth=depth_3d, dim=3, generator=g), lambda m, v: m(v)),
            ("DRUNet 3D", DRUNet(1, 1, nc=nc, nb=nb, dim=3, generator=g),
             lambda m, v: m(v, 0.05))):
        before = launched()
        sync(dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            f32 = call(model, x3)
            bf16 = call(autocast(model), x3)
        sync(dev)
        secs = time.perf_counter() - t0
        err = rel_max(bf16, f32)
        print(f"{name} 1x1x{vol}³: kernel launches {launched() - before}, bf16 vs f32 relative "
              f"max error {err} (bound {DENOISER_RTOL}), output max {float(f32.abs().max())}; "
              f"{secs:.3f} s for both (first calls, host clock)", flush=True)
        check(launched() == before, f"{name}: a kernel was launched on 5D activations")
        check(tuple(f32.shape) == tuple(x3.shape) and bool(torch.isfinite(f32).all())
              and bool(torch.isfinite(bf16).all()), f"{name}: bad or non-finite output")
        check(err <= DENOISER_RTOL, f"{name}: bf16 disagrees with f32")
        out[name] = {"bf16_vs_f32": err, "s": secs}
    inflated = DnCNN(1, 1, depth=depth_3d, dim=3, pretrained=dn2.state_dict())
    x2 = torch.rand((1, 1, vol, vol), generator=g).to(dev)
    with torch.no_grad():
        slices = inflated(x2[:, :, None].expand(1, 1, vol, vol, vol).contiguous())
        want = dn2(x2)
    # each 3x3x3 conv reaches one slice further from a face
    inner = slices[:, :, depth_3d:vol - depth_3d]
    err = rel_max(inner, want[:, :, None].expand_as(inner))
    print(f"DnCNN 3D inflated axially from 2D, depth-constant {vol}³: the {inner.shape[2]} "
          f"inner slices against the 2D output, relative max error {err} (bound "
          f"{INFLATE_RTOL})", flush=True)
    check(err <= INFLATE_RTOL, "the inflated 3D DnCNN disagrees with the 2D one")
    out["inflated_rel_max"] = err

    # 17.4 pretrained= from upstream-named checkpoints, on K5 and K1
    dr2 = DRUNet(1, 1, nc=nc, nb=nb, generator=g)
    img = torch.rand((1, 1, image, image), generator=g).to(dev)
    tmp = tempfile.mkdtemp()
    # output bits are compared: cuDNN's split-K dgrad (DRUNet's transposed
    # convs) sums in a varying order unless deterministic algorithms are asked for
    def cudnn():
        return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                          allow_tf32=torch.backends.cudnn.allow_tf32)

    try:
        for name, src, names, make, port, op, call in (
                ("DnCNN", dn2, dncnn_names,
                 lambda p: DnCNN(1, 1, depth=depth_3d, pretrained=p, generator=g),
                 port_dncnn, dncnn_mod.conv_chain, lambda m: m(img)),
                ("DRUNet", dr2, drunet_names,
                 lambda p: DRUNet(1, 1, nc=nc, nb=nb, pretrained=p, generator=g),
                 port_drunet, drunet_mod.resblock_chain, lambda m: m(img, 0.05))):
            path = os.path.join(tmp, f"{name}.pth")
            torch.save(upstream_state_dict(src, names(src)), path)
            rebuilt = make(path)
            same_w = all(torch.equal(a, b) for a, b in zip(src.state_dict().values(),
                                                           rebuilt.state_dict().values()))
            with torch.no_grad(), cudnn():
                a = call(autocast(src))
                reset_kernel_launches(op)
                b = call(autocast(rebuilt))
                n = kernel_launches(op)
                # another model's weights loaded after the rebuilt one's first call
                other = make(None)
                port(rebuilt, upstream_state_dict(other, names(other)))
                c = call(autocast(rebuilt))
                d = call(autocast(other))
            print(f"{name} pretrained= from {os.path.basename(path)} ({len(names(src))} "
                  f"upstream names): weights equal {same_w}, bf16 output bits equal "
                  f"{torch.equal(a, b)}, {op.__name__} launches a call {n}; loaded after the "
                  f"first call: new weights' bits {torch.equal(c, d)}, changed "
                  f"{not torch.equal(b, c)}", flush=True)
            check(same_w and torch.equal(a, b), f"{name}: pretrained= changed the model")
            check(torch.equal(c, d) and not torch.equal(b, c),
                  f"{name}: weights loaded after the first call were not used")
            if cuda:
                check(n == 1, f"{name}: expected one {op.__name__} launch a call, got {n}")
            out["launches"]["K5" if name == "DnCNN" else "K1"][f"{name} pretrained="] = n
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 17.5 VarNet and PDNet on cuDNN
    varnet = VarNet(num_cascades=cascades, generator=g)
    for B in (1, batch):
        x = images(B)
        y = mri(x, generator=gen(SEED + 195 + B))
        before = launched()
        with torch.no_grad():
            res = varnet(y, mri)
        check(launched() == before and tuple(res.shape) == tuple(x.shape)
              and bool(torch.isfinite(res).all()), f"VarNet B={B}: a kernel launch or a bad output")
        print(f"VarNet ({cascades} cascades) B={B}: PSNR {psnr(res[:1], x[:1]):.4f} dB (random "
              f"weights)", flush=True)
        if cuda:
            rate_of("VarNet", recon(varnet, y, mri), B * cascades, B, cascades, f"{size}²", card,
                    out["rates"])
    ct = Tomography(img_width=ct_size, angles=CT_ANGLES, normalize=True,
                    noise_model=GaussianNoise(MODL_SIGMA))
    pdnet = PDNet(generator=g)
    xct = torch.from_numpy(shepp_logan(ct_size))[None, None].to(dev)
    yct = ct(xct, generator=gen(SEED + 197))
    before = launched()
    with torch.no_grad():
        res = pdnet(yct, ct)
    check(launched() == before and tuple(res.shape) == tuple(xct.shape)
          and bool(torch.isfinite(res).all()), "PDNet: a kernel launch or a bad output")
    n_pd = len(pdnet.primal_blocks)
    print(f"PDNet ({n_pd} iterations) {ct_size}², {CT_ANGLES} views: PSNR "
          f"{psnr(res, xct):.4f} dB (random weights)", flush=True)
    if cuda:
        rate_of("PDNet", recon(pdnet, yct, ct), n_pd, 1, n_pd, f"{ct_size}²", card, out["rates"])
    out["s"] = time.perf_counter() - t_phase
    print(f"phase 17: {out['s']:.3f} s ({card})", flush=True)
    return out


def wake(model, gen) -> int:
    """Redraw, normal over ``sqrt(fan_in)``, every weight tensor that the
    initialization leaves at zero or near it (ADM's and DiffUNet's zero
    modules, NCSN++'s 1e-5 output convs): a fresh ADMUNet predicts a noise of
    exactly 0, and a bf16 check of it would compare nothing. Returns how
    many tensors were redrawn."""
    import torch

    n = 0
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() > 1 and float(p.abs().max()) < 1e-3:
                p.copy_(torch.randn(p.shape, generator=gen).to(p.device) / p[0].numel() ** 0.5)
                n += 1
    return n


def backbone_drive(name: str, run, net, calls: int, kernel_ops, dev, at_network=None,
                   rtol: float = None) -> dict:
    """One sampler run over ``net`` in f32 (the kernels' launch counts set to
    0 just before it and read just after), checked: no kernel launched,
    ``calls`` network calls, a finite sample, and each of the first
    SAMPLE_CHECKED_CALLS calls of ``net`` under a bf16 ``autocast`` within
    ``rtol`` (DENOISER_RTOL by default) of the f32 call on the same input.
    ``at_network(x, sigma)``
    gives ``(x', sigma', kwargs)``, where the two are compared instead (ADM:
    its noise prediction at the call's timestep). ``run()`` makes its own
    generator. Returns the bf16 gaps and the sample's largest magnitude."""
    import torch

    from deepinv_tpu_torch.models import autocast

    seen, kept = [], []

    def keep(mod, args, kwargs):
        seen.append(1)
        if len(kept) < SAMPLE_CHECKED_CALLS:
            sigma = args[1] if len(args) > 1 else kwargs.get("sigma")
            kept.append((args[0].detach().clone(), sigma))

    hook = net.register_forward_pre_hook(keep, with_kwargs=True)
    for op in kernel_ops:
        reset_kernel_launches(op)
    t0 = time.perf_counter()
    try:
        with torch.no_grad():
            out = run()
        sync(dev)
    finally:
        hook.remove()
    first_s = time.perf_counter() - t0
    launches = sum(kernel_launches(op) for op in kernel_ops)
    big = float(out.abs().max())
    print(f"{name}: first run {first_s:.3f} s, kernel launches {launches}, network calls "
          f"{len(seen)} (expected {calls}), max |x| {big}", flush=True)
    check(launches == 0, f"{name}: a K1-K8 kernel was launched ({launches})")
    check(len(seen) == calls, f"{name}: {len(seen)} network calls, expected {calls}")
    check(bool(torch.isfinite(out).all()), f"{name}: non-finite sample")
    gaps = []
    half = autocast(net)
    rtol = DENOISER_RTOL if rtol is None else rtol
    for i, (xin, sigma) in enumerate(kept):
        with torch.no_grad():
            d32, d16 = net(xin, sigma).float(), half(xin, sigma).float()
            whole = rel_max(d16, d32)
            if at_network is not None:
                xin, sigma, kw = at_network(xin, sigma)
                d32, d16 = net(xin, sigma, **kw).float(), half(xin, sigma, **kw).float()
        err, scale = float((d16 - d32).abs().max()), float(d32.abs().max())
        gaps.append(err / scale)
        print(f"{name} network call {i}: bf16 vs f32 max_abs_err {err} (scale {scale}, rel "
              f"{err / scale}, bound {rtol})"
              + ("" if at_network is None else f"; the whole call's output {whole}"), flush=True)
        check(err <= rtol * scale, f"{name}: bf16 call {i} disagrees with f32")
    return {"bf16_vs_f32": gaps, "max_abs": big, "first_s": first_s}


def bits_round_trip(name: str, src, names, make, call, tmp: str) -> bool:
    """``src`` written to a ``.pt`` file under upstream's ``names`` and rebuilt
    by ``make(path)`` (its ``pretrained=``): checked to give the same output
    bits as ``src`` from ``call(model)`` (cuDNN asked for deterministic
    algorithms)."""
    import os

    import torch

    from deepinv_tpu_torch.models.convert import upstream_state_dict

    path = os.path.join(tmp, f"{name}.pt")
    torch.save(upstream_state_dict(src, names(src)), path)
    rebuilt = make(path)
    with torch.no_grad(), torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True,
            allow_tf32=torch.backends.cudnn.allow_tf32):
        a, b = call(src), call(rebuilt)
    same = torch.equal(a, b)
    print(f"{name} pretrained= from {os.path.basename(path)} ({len(names(src))} upstream names):"
          f" output bits equal {same}", flush=True)
    check(same, f"{name}: pretrained= changed the output")
    return same


def backbones_phase(dev, card: str, size: int = 256, batch: int = SAMPLE_BATCH,
                    steps: int = SAMPLE_STEPS, ncsn_size: int = 64, ncsn: dict = None,
                    nets: dict = None, ram: dict = None, rate_steps=BB_RATE_STEPS) -> dict:
    """Phase 18: the diffusion backbones under the samplers and the attention
    models, through the entry points with the default device; no K1-K8
    kernel is launched anywhere in it.

    18.1 ``ADMUNet()`` (the FFHQ checkpoint's architecture, f32, seeded random
    weights, its zero modules redrawn by ``wake``) as the network of DDRM on
    ``Inpainting(mask=0.7)`` with noise 0.05 at B=1 (``steps``) and
    B=``batch`` (``steps // 2``), DiffPIR and DPS on 4x bicubic
    super-resolution at B=1, on ``size``² RGB (phase 11's problems): the JAX
    samplers' call counts, each sampler's first calls' noise prediction under
    a bf16 ``autocast`` within DENOISER_RTOL of f32 (``backbone_drive``), DPS's
    guidance gradient in bf16 against f32 (the network's part within
    SAMPLE_GRAD_RTOL, the last step's whole gradient within
    BB_GUIDANCE_RTOL), an ``ADMUNet`` rebuilt with ``pretrained=`` from a
    guided-diffusion-named ``.pt`` file the same output bits. 18.2
    ``NCSNpp()`` (EDM's 64² configuration, its 1e-5 convs woken) as the
    denoiser of ``PosteriorDiffusion`` over a variance-exploding
    ``EDMDiffusionSDE`` with ``DPSDataFidelity`` on ``ncsn_size``² RGB
    inpainting at B=1 and B=``batch``, BB_PD_STEPS steps (two network calls
    a step), with the same checks (bf16 bound BB_BF16_RTOL). 18.3
    ``EDMPrecond(DiffUNet())``, ``Restormer()``, ``SwinIR()``, ``SCUNet()``
    and ``PromptIR()`` at their published widths as denoisers of ``size``²
    RGB at B=1 and B=``batch``: bf16 within its bound of f32 (DENOISER_RTOL,
    or BB_BF16_RTOL where stated), ms a call in each, the ``pretrained=``
    round trips. 18.4 ``RAM()`` at full width (its residual branches scaled
    by RAM_RESIDUAL_SCALE) on the three tasks of
    examples/demo_foundation_model.py at ``size``² RGB, B=1 and B=``batch``:
    finite, bf16 (``torch.autocast``: the physics' FFTs have no bf16 path)
    within DENOISER_RTOL of f32, recons/s and idle shares, the ``pretrained=``
    round trip. Timed (``rate:`` lines, with the card): the samplers' steps/s
    by the slope between ``rate_steps`` and 4 ``rate_steps`` steps, idle
    shares, ms a call, recons/s, and the phase's seconds. On the CPU (``dev``),
    at small sizes and widths (``ncsn``, ``nets``, ``ram``), it rehearses the
    checks and skips the times."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from deepinv_tpu_torch.models import (ADMUNet, RAM, DiffUNet, EDMPrecond, NCSNpp, PromptIR,
                                          Restormer, SCUNet, SwinIR, autocast)
    from deepinv_tpu_torch.models.convert import (adm_names, ncsnpp_names, ram_names,
                                                  restormer_names, scunet_names, swinir_names)
    from deepinv_tpu_torch.models.ram import RAMResBlock
    from deepinv_tpu_torch.ops import gaussian_blur
    from deepinv_tpu_torch.ops.kernels.conv_chain import (conv_chain, conv_chain_stash,
                                                          stash_backward)
    from deepinv_tpu_torch.ops.kernels.resblock_chain import resblock_chain
    from deepinv_tpu_torch.ops.kernels.tv import chambolle_prox
    from deepinv_tpu_torch.ops.kernels.up_resblock_chain import up_resblock_chain
    from deepinv_tpu_torch.ops.kernels.up_sandwich import up_sandwich
    from deepinv_tpu_torch.physics import (BlurFFT, Denoising, Downsampling, GaussianNoise,
                                           Inpainting)
    from deepinv_tpu_torch.sampling import (DDRM, DPS, DiffPIR, DPSDataFidelity,
                                            EDMDiffusionSDE, PosteriorDiffusion)
    from deepinv_tpu_torch.sampling.utils import frozen

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    g = torch.Generator().manual_seed(SEED + 200)
    kernel_ops = (conv_chain, conv_chain_stash, stash_backward, resblock_chain,
                  up_resblock_chain, up_sandwich, chambolle_prox)
    for op in kernel_ops:
        reset_kernel_launches(op)
    out = {"rates": {}, "bf16": {}, "ms": {}}
    tmp = tempfile.mkdtemp()

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def sample(m, *args, seed):
        def run():
            with torch.no_grad():
                return m(*args, generator=gen(seed))
        return run

    try:
        # 18.1 ADMUNet under DDRM, DiffPIR and DPS
        shape = (1, 3, size, size)
        adm = ADMUNet(generator=g)
        print(f"ADMUNet: {wake(adm, g)} zero-initialized tensors redrawn", flush=True)

        def at_timestep(x, sigma):
            xs, _, t = adm.diffusion_inputs(x, sigma)
            return xs, t, {"type_t": "timestep"}
        inp = Inpainting(shape[1:], mask=0.7, generator=torch.Generator().manual_seed(SEED + 201),
                         noise_model=GaussianNoise(0.05))
        sr = Downsampling(img_size=shape[1:], filter="bicubic", factor=4,
                          noise_model=GaussianNoise(0.05))
        x1 = torch.rand(shape, generator=g).to(dev)
        x8 = torch.rand((batch,) + shape[1:], generator=g).to(dev)
        y1, y8 = inp(x1, generator=gen(SEED + 202)), inp(x8, generator=gen(SEED + 203))
        ys = sr(x1, generator=gen(SEED + 204))

        def ddrm(n, y):
            return sample(DDRM(adm, sigmas=np.linspace(1, 0, n + 1)), y, inp, seed=SEED + 205)

        def dps(n):
            return sample(DPS(adm, max_iter=n), ys, sr, seed=SEED + 206)

        def diffpir(n):
            return sample(DiffPIR(adm, sigma=0.05, max_iter=n), ys, sr, seed=SEED + 207)

        n1, n8 = steps, steps // 2
        for label, run, calls in ((f"ADM DDRM B=1 n={n1}", ddrm(n1, y1), n1 + 1),
                                  (f"ADM DDRM B={batch} n={n8}", ddrm(n8, y8), n8 + 1),
                                  (f"ADM DPS B=1 n={n1}", dps(n1), n1),
                                  (f"ADM DiffPIR B=1 max_iter={n1}", diffpir(n1), n1 - 1)):
            out["bf16"][label] = backbone_drive(label, run, adm, calls, kernel_ops, dev,
                                                at_network=at_timestep)
        # DPS's guidance gradient in bf16 against f32: at the last step, where
        # the x0 estimate's division by sqrt(ac) is near 1, the whole gradient;
        # at the middle step the network's part of it, the input gradient of its
        # noise prediction for a seeded cotangent (the x0 estimate there divides
        # the network's error by sqrt(ac) and clips: that gap is printed)
        m, m16 = DPS(adm, max_iter=n1), DPS(autocast(adm), max_iter=n1)
        xg = torch.randn(shape, generator=gen(SEED + 208), device=dev)
        gaps = {}
        for k in (n1 - 1, n1 // 2):
            at = m._sched[k][0]
            g32, _, _ = m.guidance(xg, ys, sr, at)
            g16, _, _ = m16.guidance(xg, ys, sr, at)
            check(bool(torch.isfinite(g32).all()), "ADM DPS guidance: non-finite gradient")
            gaps[f"step {k}"] = rel_l2(g16, g32)
        xs, _, t = adm.diffusion_inputs((xg / math.sqrt(at) + 1) / 2,
                                        math.sqrt(1 - at) / math.sqrt(at) / 2)
        cot = torch.randn((1, adm.out_channels, size, size), generator=gen(SEED + 216),
                          device=dev)
        vjp = {}
        with frozen(adm):
            for dt, model in ((torch.float32, adm), (torch.bfloat16, autocast(adm))):
                xv = xs.to(dt).requires_grad_()
                with torch.enable_grad():
                    e = model(xv, t, type_t="timestep")
                    (vjp[dt],) = torch.autograd.grad(e, xv, cot.to(e.dtype))
        gaps["network at the middle step"] = rel_l2(vjp[torch.bfloat16], vjp[torch.float32])
        print(f"ADM DPS guidance gradient, bf16 vs f32 relative L2: {gaps} (bounds: the "
              f"network's {SAMPLE_GRAD_RTOL}, the last step's whole gradient "
              f"{BB_GUIDANCE_RTOL}; the middle step's whole gradient is not held: its x0 "
              f"estimate divides the network's error by sqrt(alpha_bar) = {math.sqrt(at):.4f} "
              f"and clips)", flush=True)
        check(gaps[f"step {n1 - 1}"] <= BB_GUIDANCE_RTOL
              and gaps["network at the middle step"] <= SAMPLE_GRAD_RTOL,
              "ADM DPS guidance: bf16 gradient disagrees with f32")
        check(all(p.grad is None for p in adm.parameters()), "DPS gave the ADMUNet a gradient")
        out["adm_grad_bf16_vs_f32"] = gaps
        bits_round_trip("ADMUNet", adm, adm_names,
                        lambda p: ADMUNet(pretrained=p), lambda net: net(x1, 0.1), tmp)
        if cuda:
            for metric, b, make, n in (
                    ("ddrm_adm_inpainting_256px_steps_per_sec_chip", 1,
                     lambda n: ddrm(n, y1), rate_steps[0]),
                    (f"ddrm_adm_inpainting_256px_steps_per_sec_chip_b{batch}", batch,
                     lambda n: ddrm(n, y8), rate_steps[1]),
                    ("dps_adm_sr4_256px_steps_per_sec_chip", 1, dps, rate_steps[0])):
                v = slope_rate(f"{metric} (B={b})", make, n, reps=1)
                prof = device_profile(f"{metric} sample n={n}", make(n), 1, top=8)
                idle = None if prof is None else 1 - prof[4] / prof[0]
                row = {"metric": metric, "value": v, "unit": "step/s", "idle_share": idle,
                       "card": card}
                if b > 1:
                    row.update(batch=b, images_per_sec=v * b)
                print(f"rate: {json.dumps(row)}", flush=True)
                out["rates"][metric] = row
        del adm

        print(f"phase 18.1: {time.perf_counter() - t_phase:.3f} s into the phase", flush=True)
        # 18.2 NCSN++ under PosteriorDiffusion over the EDM SDE
        net = NCSNpp(generator=g, **(ncsn or {}))
        print(f"NCSNpp: {wake(net, g)} near-zero-initialized tensors redrawn", flush=True)
        nshape = (3, ncsn_size, ncsn_size)
        ninp = Inpainting(nshape, mask=0.7, generator=torch.Generator().manual_seed(SEED + 209))
        ts = np.linspace(1.0, 0.05, BB_PD_STEPS + 1)

        def posterior(den):
            sde = EDMDiffusionSDE(sigma_t=lambda t: BB_SIGMA_MAX * t,
                                  sigma_prime_t=lambda t: BB_SIGMA_MAX, variance_exploding=True,
                                  denoiser=den)
            return PosteriorDiffusion(sde, DPSDataFidelity(den), timesteps=ts)

        for B in (1, batch):
            xn = torch.rand((B,) + nshape, generator=g).to(dev)
            yn = ninp(xn)
            label = f"NCSN++ PosteriorDiffusion B={B} {BB_PD_STEPS} steps"
            out["bf16"][label] = backbone_drive(label, sample(posterior(net), yn, ninp,
                                                              seed=SEED + 210 + B),
                                                net, 2 * BB_PD_STEPS, kernel_ops, dev,
                                                rtol=BB_BF16_RTOL["NCSN++"][0])
            check(all(p.grad is None for p in net.parameters()),
                  "PosteriorDiffusion gave the NCSN++ a gradient")
            if cuda:
                # CUDA events only: a profile of one B=8 run holds ~15000 kernels
                # and takes longer to read than the runs
                r = rates_in_turns(f"NCSN++ PosteriorDiffusion B={B}",
                                   {"f32": sample(posterior(net), yn, ninp, seed=SEED + 212)},
                                   B * BB_PD_STEPS, reps=1)["f32"]
                print(f"rate: NCSN++ PosteriorDiffusion {ncsn_size}² B={B} "
                      f"{r / (B * BB_PD_STEPS):.3f} recons/s, {r:.2f} image-it/s ({card})",
                      flush=True)
                out["rates"][f"NCSN++ PosteriorDiffusion B={B}"] = r
        xn = torch.rand((1,) + nshape, generator=g).to(dev)
        cn = torch.full((1,), -0.5, device=dev)
        bits_round_trip("NCSNpp", net, ncsnpp_names, lambda p: NCSNpp(pretrained=p, **(ncsn or {})),
                        lambda m: m.forward_unet(xn, cn), tmp)
        del net

        print(f"phase 18.2: {time.perf_counter() - t_phase:.3f} s into the phase", flush=True)
        # 18.3 the denoisers at their published widths
        nets = nets or {}
        builds = {
            "EDMPrecond(DiffUNet)": (lambda p=None: EDMPrecond(DiffUNet(
                generator=g, **nets.get("DiffUNet", {}))), None),
            "Restormer": (lambda p=None: Restormer(pretrained=p, generator=g,
                                                   **nets.get("Restormer", {})), restormer_names),
            "SwinIR": (lambda p=None: SwinIR(pretrained=p, generator=g, **nets.get("SwinIR", {})),
                       swinir_names),
            "SCUNet": (lambda p=None: SCUNet(pretrained=p, generator=g, **nets.get("SCUNet", {})),
                       scunet_names),
            "PromptIR": (lambda p=None: PromptIR(generator=g, **nets.get("PromptIR", {})), None),
        }
        for name, (make, names) in builds.items():
            model = make()
            woken = wake(model, g)
            bound = BB_BF16_RTOL.get(name, (DENOISER_RTOL, ""))
            for B in (1, batch):
                x = torch.rand((B, 3, size, size), generator=g).to(dev)
                before = sum(kernel_launches(op) for op in kernel_ops)
                with torch.no_grad():
                    f32 = model(x, 0.1)
                    bf16 = autocast(model)(x, 0.1)
                err = rel_max(bf16, f32)
                print(f"{name} B={B} {size}²: bf16 vs f32 relative max error {err} (bound "
                      f"{bound[0]}{bound[1]}), output max {float(f32.abs().max())}; "
                      f"{woken} zero-initialized tensors redrawn", flush=True)
                check(sum(kernel_launches(op) for op in kernel_ops) == before,
                      f"{name}: a K1-K8 kernel was launched")
                check(tuple(f32.shape) == tuple(x.shape) and bool(torch.isfinite(f32).all())
                      and bool(torch.isfinite(bf16).all()), f"{name} B={B}: bad output")
                check(err <= bound[0], f"{name} B={B}: bf16 disagrees with f32")
                out["bf16"][f"{name} B={B}"] = err
                if cuda:
                    half = autocast(model)
                    with torch.no_grad():
                        ms32 = cuda_ms(lambda: model(x, 0.1), 2, warmup=1)
                        ms16 = cuda_ms(lambda: half(x, 0.1), 3, warmup=1)
                    row = {"model": name, "batch": B, "size": size, "f32_ms": ms32,
                           "bf16_ms": ms16, "images_per_sec_bf16": B * 1e3 / ms16, "card": card}
                    print(f"rate: {json.dumps(row)}", flush=True)
                    out["ms"][f"{name} B={B}"] = row
            xs = torch.rand((1, 3, size, size), generator=g).to(dev)
            if names is not None:
                bits_round_trip(name, model, names, make, lambda m: m(xs, 0.1), tmp)
            elif name == "PromptIR":
                import os

                path = os.path.join(tmp, "promptir.sd")
                torch.save(model.state_dict(), path)
                rebuilt = make().load_pretrained(path)
                with torch.no_grad():
                    same = torch.equal(model(xs), rebuilt(xs))
                print(f"PromptIR load_pretrained from its state dict: output bits equal {same}",
                      flush=True)
                check(same, "PromptIR: load_pretrained changed the output")
            del model

        print(f"phase 18.3: {time.perf_counter() - t_phase:.3f} s into the phase", flush=True)
        # 18.4 RAM on the foundation-model demo's three tasks
        rnet = RAM(generator=g, **(ram or {}))
        with torch.no_grad():
            for blk in rnet.modules():
                if isinstance(blk, RAMResBlock):
                    blk.conv2.weight.mul_(RAM_RESIDUAL_SCALE)
                    blk.gain.mul_(RAM_RESIDUAL_SCALE)
        rshape = (3, size, size)
        tasks = {
            "Denoising": Denoising(noise_model=GaussianNoise(0.1)),
            "Inpainting": Inpainting(rshape, mask=0.5, noise_model=GaussianNoise(0.05),
                                     generator=torch.Generator().manual_seed(SEED + 213)),
            "BlurFFT": BlurFFT(rshape, filter=gaussian_blur(sigma=1.5),
                               noise_model=GaussianNoise(0.02)),
        }
        for task, phys in tasks.items():
            for B in (1, batch):
                x = torch.rand((B,) + rshape, generator=g).to(dev)
                y = phys(x, generator=gen(SEED + 214))
                before = sum(kernel_launches(op) for op in kernel_ops)
                with torch.no_grad():
                    f32 = rnet(y, phys)
                    with torch.autocast(dev.type, dtype=torch.bfloat16):
                        bf16 = rnet(y, phys)
                err = rel_max(bf16, f32)
                print(f"RAM {task} B={B} {size}²: bf16 vs f32 relative max error {err} (bound "
                      f"{DENOISER_RTOL}), PSNR {psnr(f32[:1], x[:1]):.4f} dB (random weights)",
                      flush=True)
                check(sum(kernel_launches(op) for op in kernel_ops) == before,
                      "RAM: a K1-K8 kernel was launched")
                check(tuple(f32.shape) == tuple(x.shape) and bool(torch.isfinite(f32).all()),
                      f"RAM {task} B={B}: bad output")
                check(err <= DENOISER_RTOL, f"RAM {task} B={B}: bf16 disagrees with f32")
                out["bf16"][f"RAM {task} B={B}"] = err
                if cuda:
                    def recon(y=y, phys=phys):
                        with torch.no_grad():
                            return rnet(y, phys)
                    rate_of(f"RAM {task}", recon, B, B, 1, f"{size}²", card, out["rates"],
                            calls=1)
        yr = tasks["Denoising"](torch.rand((1,) + rshape, generator=g).to(dev),
                                generator=gen(SEED + 215))
        bits_round_trip("RAM", rnet, ram_names, lambda p: RAM(pretrained=p, **(ram or {})),
                        lambda m: m(yr, tasks["Denoising"]), tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    total = sum(kernel_launches(op) for op in kernel_ops)
    check(total == 0, f"phase 18 launched K1-K8 kernels ({total})")
    out["s"] = time.perf_counter() - t_phase
    print(f"phase 18: {out['s']:.3f} s, no K1-K8 launch ({card})", flush=True)
    return out


class _HeldOptimizer:
    """An optimizer's stand-in that clears its parameters' gradients and
    steps nothing: a train step's gradients are read without a weight
    changing."""

    def __init__(self, params):
        self.params = list(params)

    def zero_grad(self, set_to_none: bool = True):
        for p in self.params:
            p.grad = None

    def step(self):
        pass


def adversarial_first_grads(trainer, chains) -> tuple:
    """The generator's and the discriminator's gradients (flat f32) of the
    trainer's first batch, through its own ``generator_step`` and
    ``discriminator_step`` inside ``chains``, the weights held."""
    import torch

    x, y, phys = first_batch(trainer)
    real = trainer.optimizer, trainer.optimizer_d
    trainer.optimizer = _HeldOptimizer(trainer.model.parameters())
    trainer.optimizer_d = _HeldOptimizer(trainer.D.parameters())
    try:
        with chains:
            trainer.generator_step(x, y, phys, (0, 0, 0))
            gg = torch.cat([p.grad.reshape(-1).float() for p in trainer.model.parameters()])
            trainer.discriminator_step(x, y, phys, (0, 0, 0))
            gd = torch.cat([p.grad.reshape(-1).float() for p in trainer.D.parameters()])
    finally:
        trainer.optimizer.zero_grad()
        trainer.optimizer_d.zero_grad()
        trainer.optimizer, trainer.optimizer_d = real
    return gg, gd


def generative_phase(dev, card: str, size: int = 256, batches=TRAIN_BATCHES,
                     steps: int = ADV_STEPS, depth: int = 20, ndf: int = 64,
                     small: int = 64, kin_size: int = None, niqe_patch: int = 96) -> dict:
    """Phase 19: adversarial training of the DnCNN chain, the blind deblurring
    demo, the rest of ``models/`` and the metrics, through the entry points
    with the default device.

    19.1 examples/demo_adversarial_training.py at phase 9's width: an
    ``AdversarialTrainer`` of ``ArtifactRemoval(autocast(DnCNN(1, 1,
    depth)))`` (seeded, phase 9's) against ``PatchGANDiscriminator(input_nc=1,
    ndf)`` in f32 on ``Denoising(GaussianNoise(0.1))`` at ``size``², with
    ``SupLoss`` + ``SupAdversarialGeneratorLoss(ADV_WEIGHT)`` and the default
    discriminator loss, Adam(ADV_LR) for both, ``steps`` steps at each of
    ``batches`` in each train-step configuration from the same weights: the
    first step's generator and discriminator gradients within GRAD_RTOL of
    the same step under ``fused_chains_disabled()``; with
    ``fused_chains=True`` K6 once, the stash backward L + 2 and K5 once a step
    (the discriminator step's generator pass), with ``False`` none; D's
    weights unchanged by a generator step; then ``UAIRGeneratorLoss`` with
    ``UnsupAdversarialDiscriminatorLoss`` at B=1 (K6 twice and the stash
    backward 2 (L + 2) times a step, K5 once). 19.2 the trained generator
    evaluated by ``Trainer.test`` with ``PSNR``, ``SSIM`` and
    ``LPIPS(allow_random_weights=True)`` at the last batch size (K5 once a
    batch); LPIPS's VGG16 on ``size``² RGB in bf16 within DENOISER_RTOL of
    f32 (each stage's features). 19.3 examples/demo_blind_deblur.py: a
    ``KernelIdentificationNetwork()`` (25 kernels of 33²) estimates a
    ``SpaceVaryingBlur`` from a ``size``² RGB image blurred by two Gaussian
    PSFs, and PnP-PGD with a bf16 ``DnCNN(3, 3, depth)`` (its residual conv
    scaled by DNCNN_RESIDUAL_SCALE) reconstructs on it, held as phase 5
    holds PGD (``drive``: K5 once an iteration). 19.4 the other models in
    f32 on the card, each against the same seeded call on the CPU
    (GEN_FWD_RTOL, GEN_FIT_RTOL after GEN_CHECK_STEPS steps, NIQE_CPU_RTOL,
    BM3D_PSNR_DB) and timed: ``DeepImagePrior`` (``ConvDecoder`` at
    1x``size``², DIP_ITERS iterations) on inpainting, ``CSGMGenerator(
    DCGANGenerator())`` on 3x64² ``CompressedSensing`` (its residual falling),
    ``Poisson2Sparse()`` on ``size``² Poisson noise, ``DEAL()`` denoising
    ``size``² (the card alone) and ``small``² and on ``small``² inpainting
    (outer and CG iterations and host reads printed), ``BM3D()`` on
    1x1x``size``² at sigma 0.1, ``ESRGANDiscriminator()`` and
    ``DCGANDiscriminator()``, ``NIQE`` fitted by ``create_weights`` on
    NIQE_PHANTOMS phantoms. 19.5 VGG16, the kernel network and DEAL rebuilt
    from upstream-named files (``pretrained=``, ``port_deal``): the same
    output bits. No K1-K4 or K7 launch through the phase. Timed (``rate:``
    lines, with the card): steps/s and idle shares of each configuration,
    recons/s, ms a call, and the phase's seconds. On the CPU, at small sizes
    and widths, it rehearses the checks (count the plain chain calls as
    launches by wrapping ``deepinv_tpu_torch.models.dncnn.conv_chain``; the
    K6 and stash-backward counts are checked on the card only) and skips the
    times and profiles."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    import deepinv_tpu_torch.models.dncnn as dncnn_mod
    from deepinv_tpu_torch.core.linalg import loop_stats
    from deepinv_tpu_torch.datasets import ArrayDataset, DataLoader
    from deepinv_tpu_torch.loss import (LPIPS, NIQE, PSNR, SSIM, SupAdversarialGeneratorLoss,
                                        SupLoss, UAIRGeneratorLoss,
                                        UnsupAdversarialDiscriminatorLoss)
    from deepinv_tpu_torch.models import (BM3D, DEAL, ArtifactRemoval, ConvDecoder,
                                          CSGMGenerator, DCGANDiscriminator, DCGANGenerator,
                                          DeepImagePrior, DnCNN, ESRGANDiscriminator,
                                          KernelIdentificationNetwork, PatchGANDiscriminator,
                                          Poisson2Sparse, VGG16Features, autocast)
    from deepinv_tpu_torch.models.convert import (deal_names, kernel_network_names, port_deal,
                                                  vgg16_names)
    from deepinv_tpu_torch.ops import gaussian_blur
    from deepinv_tpu_torch.ops.kernels.conv_chain import (conv_chain_stash,
                                                          fused_chains_disabled, stash_backward)
    from deepinv_tpu_torch.ops.kernels.resblock_chain import resblock_chain
    from deepinv_tpu_torch.ops.kernels.tv import chambolle_prox
    from deepinv_tpu_torch.ops.kernels.up_resblock_chain import up_resblock_chain
    from deepinv_tpu_torch.ops.kernels.up_sandwich import up_sandwich
    from deepinv_tpu_torch.optim import L2, PnP, optim_builder
    from deepinv_tpu_torch.physics import (CompressedSensing, Denoising, GaussianNoise,
                                           Inpainting, PoissonNoise, SpaceVaryingBlur)
    from deepinv_tpu_torch.training import AdversarialTrainer

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(SEED + 220)
    rng = np.random.default_rng(SEED + 221)
    L = depth - 2
    others = (resblock_chain, up_resblock_chain, up_sandwich, chambolle_prox)
    for op in others:
        reset_kernel_launches(op)
    out = {"launches": {"K5": {}, "K6": {}, "stash_backward": {}}, "rates": {}, "ms": {},
           "cpu": {}}
    tmp = tempfile.mkdtemp()

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def cg(seed):
        return torch.Generator().manual_seed(seed)

    def counts():
        return (kernel_launches(conv_chain_stash), kernel_launches(stash_backward),
                kernel_launches(dncnn_mod.conv_chain))

    def zero_counts():
        reset_kernel_launches(conv_chain_stash, stash_backward, dncnn_mod.conv_chain)

    def timed(label, fn, reps=3):
        """ms a call of ``fn`` on the card (CUDA events), kept in out["ms"]."""
        if cuda:
            ms = cuda_ms(fn, reps, warmup=1)
            out["ms"][label] = ms
            print(f"time {label}: {ms:.3f} ms a call ({card})", flush=True)

    def twin(label, a, b, rtol):
        """The card's result ``a`` against the CPU's ``b``, within ``rtol``."""
        err = rel_max(a.detach().to(cpu), b.detach())
        print(f"{label}: card vs CPU relative max error {err} (bound {rtol})", flush=True)
        check(bool(torch.isfinite(a).all()), f"{label}: non-finite output")
        check(err <= rtol, f"{label}: the card disagrees with the CPU")
        out["cpu"][label] = err
        return err

    try:
        # 19.1 adversarial training on K6, the stash backward and K5
        net = DnCNN(1, 1, depth=depth, nf=64, generator=g)
        D0 = PatchGANDiscriminator(input_nc=1, ndf=ndf, generator=g)
        physics = Denoising(GaussianNoise(0.1))

        def trainer_of(xs, B, fused, losses, losses_d=None):
            model = ArtifactRemoval(autocast(copy.deepcopy(net)))
            D = copy.deepcopy(D0)
            return AdversarialTrainer(
                model, physics, D=D, losses=losses, losses_d=losses_d,
                optimizer=torch.optim.Adam(model.parameters(), lr=ADV_LR),
                optimizer_d=torch.optim.Adam(D.parameters(), lr=ADV_LR),
                train_dataloader=DataLoader(ArrayDataset(xs), batch_size=B), epochs=1,
                online_measurements=True, verbose=False, fused_chains=fused, seed=SEED)

        def adv_step(t):
            x, y, phys = first_batch(t)

            def run():
                t.generator_step(x, y, phys, (0, 0, 0))
                t.discriminator_step(x, y, phys, (0, 0, 0))
            return run, (x, y, phys)

        sup = [SupLoss(), SupAdversarialGeneratorLoss(ADV_WEIGHT)]
        trained = None
        for B in batches:
            xs = torch.rand((B * steps, 1, size, size), generator=g).to(dev)
            trainers = {f: trainer_of(xs, B, f, sup) for f in (True, False)}
            label = f"adversarial B={B}"
            gg, gd = adversarial_first_grads(trainers[True], contextlib.nullcontext())
            rg, rd = adversarial_first_grads(trainers[True], fused_chains_disabled())
            e_g, e_d = rel_max(gg, rg), rel_max(gd, rd)
            print(f"{label}: first step's gradients, kernels vs layers: generator relative max "
                  f"{e_g} (L2 {rel_l2(gg, rg)}), discriminator relative max {e_d} (L2 "
                  f"{rel_l2(gd, rd)}), bound {GRAD_RTOL}", flush=True)
            check(e_g <= GRAD_RTOL and e_d <= GRAD_RTOL, f"{label}: first-step gradients disagree")
            secs = {}
            for f, t in trainers.items():
                zero_counts()
                secs[f] = [train_epoch(t, 0, dev)]
                n6, nb, n5 = counts()
                lg, ld = t.logs_total_loss_train.vals, t.logs_total_loss_d.vals
                print(f"{label} fused_chains={f}: {steps} steps, K6 {n6}, stash backward {nb}, K5 "
                      f"{n5}; generator losses {lg}, discriminator losses {ld}", flush=True)
                check(len(lg) == steps and all(math.isfinite(v) for v in lg + ld),
                      f"{label} fused_chains={f}: non-finite loss")
                want = (steps, steps * (L + 2), steps) if f else (0, 0, 0)
                if cuda:
                    check((n6, nb, n5) == want, f"{label} fused_chains={f}: launches K6 {n6}, "
                          f"stash backward {nb}, K5 {n5} (expected {want})")
                else:
                    check(n5 == (2 * steps if f else 0), f"{label}: plain chain calls {n5}")
                if f:
                    out["launches"]["K6"][label] = n6
                    out["launches"]["stash_backward"][label] = nb
                    out["launches"]["K5"][label] = n5
            # D's weights do not move in a generator step, and move in its own
            t = trainers[True]
            run, (x, y, phys) = adv_step(t)
            d_before = copy.deepcopy(t.D.state_dict())
            t.generator_step(x, y, phys, (0, 0, 0))
            same = all(torch.equal(v, d_before[k]) for k, v in t.D.state_dict().items())
            t.discriminator_step(x, y, phys, (0, 0, 0))
            moved = not all(torch.equal(v, d_before[k]) for k, v in t.D.state_dict().items())
            print(f"{label}: D unchanged by a generator step {same}, changed by its own {moved}",
                  flush=True)
            check(same and moved, f"{label}: the generator step moved D, or D's step did not")
            trained = t
            if cuda:
                for f in (False, True, True, False):
                    secs[f].append(train_epoch(trainers[f], len(secs[f]), dev))
                rates = {f: steps * (len(v) - 1) / sum(v[1:]) for f, v in secs.items()}
                idle = {}
                for f in (True, False):
                    prof = device_profile(f"{label} step fused_chains={f}",
                                          adv_step(trainers[f])[0], 2, top=8)
                    idle[f] = None if prof is None else 1 - prof[4] / prof[0]
                x, y, phys = first_batch(trainers[True])
                tg = trainers[True]
                halves = {"generator step": lambda: tg.generator_step(x, y, phys, (0, 0, 0)),
                          "discriminator step": lambda: tg.discriminator_step(x, y, phys,
                                                                               (0, 0, 0))}
                ms = {k: [] for k in halves}
                for k in list(halves) + list(halves)[::-1]:
                    ms[k].append(cuda_ms(halves[k], 3, warmup=1))
                ms = {k: sum(v) / len(v) for k, v in ms.items()}
                print(f"rate: {label} {size}² {rates[True]:.3f} steps/s fused_chains=True, "
                      f"{rates[False]:.3f} steps/s False; idle share {idle}; fused step halves "
                      f"ms {ms} ({card})", flush=True)
                out["rates"][label] = {"steps_per_s": rates, "idle_share": idle,
                                       "halves_ms": ms}

        # UAIR: the model called twice a generator step, K6 twice
        xs = torch.rand((steps, 1, size, size), generator=g).to(dev)
        uair = trainer_of(xs, 1, True, [UAIRGeneratorLoss()], [UnsupAdversarialDiscriminatorLoss()])
        zero_counts()
        secs = [train_epoch(uair, 0, dev)]
        n6, nb, n5 = counts()
        label = "UAIR B=1"
        print(f"{label} fused_chains=True: {steps} steps, K6 {n6}, stash backward {nb}, K5 {n5}; "
              f"losses {uair.logs_total_loss_train.vals}, {uair.logs_total_loss_d.vals}",
              flush=True)
        check(all(math.isfinite(v) for v in uair.logs_total_loss_train.vals
                  + uair.logs_total_loss_d.vals), f"{label}: non-finite loss")
        if cuda:
            want = (2 * steps, 2 * steps * (L + 2), steps)
            check((n6, nb, n5) == want, f"{label}: launches {(n6, nb, n5)} (expected {want})")
            secs += [train_epoch(uair, 1, dev), train_epoch(uair, 2, dev)]
            prof = device_profile(f"{label} step", adv_step(uair)[0], 2, top=8)
            idle = None if prof is None else 1 - prof[4] / prof[0]
            r = steps * 2 / sum(secs[1:])
            print(f"rate: {label} {size}² {r:.3f} steps/s fused_chains=True; idle share {idle} "
                  f"({card})", flush=True)
            out["rates"][label] = {"steps_per_s": r, "idle_share": idle}
        out["launches"]["K6"][label], out["launches"]["stash_backward"][label] = n6, nb
        out["launches"]["K5"][label] = n5

        print(f"phase 19.1: {time.perf_counter() - t_phase:.3f} s into the phase", flush=True)
        # 19.2 the trained generator scored: PSNR, SSIM, LPIPS on K5
        lpips = LPIPS(allow_random_weights=True, generator=cg(SEED + 222))
        B = batches[-1]
        trained.metrics = [PSNR(), SSIM(), lpips]
        xe = torch.rand((B * ADV_EVAL_BATCHES, 1, size, size), generator=g).to(dev)
        zero_counts()
        t0 = time.perf_counter()
        scores = trained.test(DataLoader(ArrayDataset(xe), batch_size=B))
        sync(dev)
        n5 = counts()[2]
        print(f"eval B={B}, {ADV_EVAL_BATCHES} batches: {scores}; K5 {n5}; "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        check(all(math.isfinite(v) for v in scores.values()), "eval: non-finite metric")
        check(n5 == ADV_EVAL_BATCHES, f"eval: K5 {n5} (expected one a batch)")
        out["launches"]["K5"][f"eval B={B}"] = n5
        out["eval"] = scores
        xa = torch.rand((B, 3, size, size), generator=g).to(dev)
        xb = (xa + 0.1 * torch.rand((B, 3, size, size), generator=g).to(dev)).clamp(0, 1)
        with torch.no_grad():
            f32 = lpips.backbone(xa)
            f16 = lpips.backbone(xa.to(torch.bfloat16))
            d32, d16 = lpips(xb, xa), lpips(xb.to(torch.bfloat16), xa.to(torch.bfloat16))
        errs = [rel_max(a, b) for a, b in zip(f16, f32)]
        print(f"LPIPS VGG16 B={B} {size}² RGB: bf16 vs f32 features, relative max by stage "
              f"{errs} (bound {DENOISER_RTOL}); distances f32 {d32[:4].tolist()}, bf16 "
              f"{d16[:4].tolist()}", flush=True)
        check(max(errs) <= DENOISER_RTOL, "LPIPS: bf16 VGG16 features disagree with f32")
        out["lpips_bf16"] = errs
        with torch.no_grad():
            timed(f"LPIPS B={B} f32", lambda: lpips(xb, xa))
            timed(f"LPIPS B={B} bf16", lambda: lpips(xb.to(torch.bfloat16),
                                                     xa.to(torch.bfloat16)))

        print(f"phase 19.2: {time.perf_counter() - t_phase:.3f} s into the phase", flush=True)
        # 19.3 blind deblurring: the kernel network's SpaceVaryingBlur, PnP-PGD on K5
        ks = kin_size or size
        x = torch.from_numpy(discs(rng, 3, ks))[None].to(dev)
        ramp = torch.linspace(0, 1, ks, device=dev)[None, :].expand(ks, ks)
        psfs = torch.cat([gaussian_blur(sigma=s, psf_size=BLIND_PSF) for s in BLIND_SIGMAS])
        true = SpaceVaryingBlur(filters=psfs.reshape(1, 1, 2, BLIND_PSF, BLIND_PSF),
                                multipliers=torch.stack([ramp, 1 - ramp])[None, None],
                                padding="reflect", noise_model=GaussianNoise(0.01))
        y = true(x, generator=gen(SEED + 223))
        kin = KernelIdentificationNetwork(generator=g)
        with torch.no_grad():
            est = kin(y)
        kf, km = est["filters"], est["multipliers"]
        print(f"KernelIdentificationNetwork {ks}² RGB: filters {tuple(kf.shape)} (sums "
              f"{float(kf.sum((-2, -1)).min()):.6f}-{float(kf.sum((-2, -1)).max()):.6f}), "
              f"multipliers {tuple(km.shape)}", flush=True)
        check(tuple(kf.shape) == (1, 1, 25, 33, 33) and tuple(km.shape) == (1, 1, 25, ks, ks),
              "kernel network: bad output shapes")
        check(torch.allclose(kf.sum((-2, -1)), torch.ones_like(kf[..., 0, 0]), atol=1e-4)
              and torch.allclose(km.sum(2), torch.ones_like(km[:, :, 0]), atol=1e-4),
              "kernel network: kernels or multipliers do not sum to 1")
        with torch.no_grad():
            timed(f"KernelIdentificationNetwork {ks}²", lambda: kin(y))
        blur = SpaceVaryingBlur(padding="reflect").update(**est)
        net3 = DnCNN(3, 3, depth=depth, nf=64, generator=g)
        with torch.no_grad():
            net3.out_conv.weight.mul_(DNCNN_RESIDUAL_SCALE)
        pgd = optim_builder("PGD", data_fidelity=L2(), prior=PnP(autocast(net3)),
                            params_algo=BLIND_PARAMS, max_iter=MAX_ITER)
        label = "blind PnP-PGD B=1"
        res, _, n5 = drive(label, pgd, y, blur, net3, dncnn_mod.conv_chain, plain_conv_chain,
                           tuple(x.shape), exact_conv_chain, residual_of=net3.out_conv)
        print(f"{label}: PSNR {psnr(res, x):.4f} dB (random weights), blurred "
              f"{psnr(y, x):.4f} dB", flush=True)
        out["launches"]["K5"][label] = n5
        if cuda:
            def recon():
                with torch.no_grad():
                    return pgd(y, blur)
            rate_of("blind PnP-PGD", recon, MAX_ITER, 1, MAX_ITER, f"{ks}²", card, out["rates"])

        print(f"phase 19.3: {time.perf_counter() - t_phase:.3f} s into the phase", flush=True)
        # 19.4 the other models in f32, the card against the CPU
        mask = (torch.rand((1, size, size), generator=g) > DIP_MASK).float()
        xg = torch.from_numpy(discs(rng, 1, size))[None]

        def dip_of(device, iters):
            dec = ConvDecoder((1, size, size), generator=cg(SEED + 224), device=device)
            return DeepImagePrior(dec, iterations=iters)

        inp = {d: Inpainting((1, size, size), mask=mask, device=d) for d in (dev, cpu)}
        z = dip_of(cpu, 1).generator.latent_shape(1)
        z = torch.randn(z, generator=g) * 0.1
        yd = xg * mask
        n = GEN_CHECK_STEPS["DIP"]
        twin(f"DeepImagePrior {size}² {n} it", dip_of(dev, n)(yd.to(dev), inp[dev], z=z.to(dev)),
             dip_of(cpu, n)(yd, inp[cpu], z=z), GEN_FIT_RTOL)
        dip = dip_of(dev, DIP_ITERS)
        t0 = time.perf_counter()
        xd = dip(yd.to(dev), inp[dev], z=z.to(dev))
        sync(dev)
        s = time.perf_counter() - t0
        with torch.no_grad():
            r0 = float((inp[dev].A(dip.generator(z.to(dev))) - yd.to(dev)).norm())
        r1 = float((inp[dev].A(xd) - yd.to(dev)).norm())
        print(f"DeepImagePrior {size}², {DIP_ITERS} it: {s:.3f} s ({DIP_ITERS / s:.2f} it/s), "
              f"data residual {r0:.4f} -> {r1:.4f}, PSNR {psnr(xd.cpu(), xg):.4f} dB ({card})",
              flush=True)
        check(r1 < r0, "DeepImagePrior: the data residual did not fall")
        out["ms"][f"DeepImagePrior {size}² {DIP_ITERS} it"] = s * 1e3

        def csgm_of(device, iters):
            G = DCGANGenerator(generator=cg(SEED + 225), device=device)
            return CSGMGenerator(G, inf_max_iter=iters)

        cs = {d: CompressedSensing(m=CSGM_M, img_size=(3, 64, 64), fast=True,
                                   generator=cg(SEED + 226), device=d) for d in (dev, cpu)}
        m_cpu = csgm_of(cpu, GEN_CHECK_STEPS["CSGM"])
        with torch.no_grad():
            xt = m_cpu.G(torch.randn((1, 100), generator=g))
        yc = cs[cpu].A(xt)
        z0 = torch.randn((1, 100), generator=g)
        twin(f"CSGMGenerator {GEN_CHECK_STEPS['CSGM']} steps",
             csgm_of(dev, GEN_CHECK_STEPS["CSGM"])(yc.to(dev), cs[dev], z0=z0.to(dev)),
             m_cpu(yc, cs[cpu], z0=z0), GEN_FIT_RTOL)
        csgm = csgm_of(dev, 100)
        t0 = time.perf_counter()
        zf = csgm.optimize_z(z0.to(dev), yc.to(dev), cs[dev])
        sync(dev)
        s = time.perf_counter() - t0
        with torch.no_grad():
            r0 = float((cs[dev].A(csgm.G(z0.to(dev))) - yc.to(dev)).norm())
            r1 = float((cs[dev].A(csgm.G(zf)) - yc.to(dev)).norm())
        print(f"CSGMGenerator(DCGANGenerator()) 3x64², {CSGM_M} measurements, 100 steps: "
              f"{s:.3f} s, residual {r0:.4f} -> {r1:.4f} ({card})", flush=True)
        check(r1 < r0, "CSGM: the residual did not fall")
        out["ms"]["CSGM 100 steps"] = s * 1e3

        xp = torch.from_numpy(discs(rng, 1, size))[None] * 0.9 + 0.05
        yp = PoissonNoise(PSF_NOISE_GAIN, device=cpu)(xp, generator=cg(SEED + 227))
        half = (1, 1, size // 2, size // 2)
        n = GEN_CHECK_STEPS["Poisson2Sparse"]
        draws = []
        for _ in range(n):
            draws += [torch.randint(0, 4, half, generator=g), torch.randint(1, 4, half, generator=g)]

        def p2s_of(device, steps_):
            return Poisson2Sparse(train_steps=steps_, generator=cg(SEED + 228), device=device)

        twin(f"Poisson2Sparse {size}² {n} steps",
             p2s_of(dev, n)(yp.to(dev), draws=[d.numpy() for d in draws]),
             p2s_of(cpu, n)(yp, draws=[d.numpy() for d in draws]), GEN_FIT_RTOL)
        p2s = p2s_of(dev, 200)
        t0 = time.perf_counter()
        xq = p2s(yp.to(dev), generator=gen(SEED + 229))
        sync(dev)
        s = time.perf_counter() - t0
        print(f"Poisson2Sparse() {size}² gain {PSF_NOISE_GAIN}: 200 steps {s:.3f} s, PSNR "
              f"{psnr(xq.cpu(), xp):.4f} dB, noisy {psnr(yp, xp):.4f} dB ({card})", flush=True)
        check(bool(torch.isfinite(xq).all()), "Poisson2Sparse: non-finite output")
        out["ms"]["Poisson2Sparse 200 steps"] = s * 1e3

        def deal_of(device):
            return DEAL(generator=cg(SEED + 230), device=device)

        deal = deal_of(dev)
        xs_ = torch.from_numpy(discs(rng, 1, size))[None]
        ys_ = xs_ + 0.1 * torch.randn(xs_.shape, generator=g)
        xm, ym = xs_[..., :small, :small], ys_[..., :small, :small]
        mask_s = (torch.rand((1, small, small), generator=g) > 0.5).float()
        inp_s = {d: Inpainting((1, small, small), mask=mask_s, device=d) for d in (dev, cpu)}
        # the CPU would take minutes for the size² denoise: the card alone there
        for lbl, call, on_cpu in (
                (f"DEAL denoise {size}²", lambda m, d: m(ys_.to(d), 0.1), size == small),
                (f"DEAL denoise {small}²", lambda m, d: m(ym.to(d), 0.1), True),
                (f"DEAL inpainting {small}²", lambda m, d: m((xm * mask_s).to(d), inp_s[d]),
                 True)):
            reset_loops()
            sync(dev)
            t0 = time.perf_counter()
            got = call(deal, dev)
            sync(dev)
            s = time.perf_counter() - t0
            print(f"{lbl}: {s:.3f} s, loops {loop_count('loops')}, iterations "
                  f"{loop_stats.iterations}, bodies {loop_count('bodies')}, host reads "
                  f"{loop_count('host_reads')} ({card})", flush=True)
            check(bool(torch.isfinite(got).all()), f"{lbl}: non-finite output")
            out["ms"][lbl] = s * 1e3
            if on_cpu:
                twin(lbl, got, call(deal_of(cpu), cpu), GEN_FIT_RTOL)

        xb3 = xs_ + 0.1 * torch.randn(xs_.shape, generator=g)
        bm = BM3D()
        sync(dev)
        t0 = time.perf_counter()
        b_dev = bm(xb3.to(dev), 0.1)
        sync(dev)
        s = time.perf_counter() - t0
        b_cpu = bm(xb3, 0.1)
        p_dev, p_cpu = psnr(b_dev.cpu(), xs_), psnr(b_cpu, xs_)
        print(f"BM3D 1x1x{size}² sigma 0.1: PSNR {p_dev:.4f} dB on the card, {p_cpu:.4f} dB on "
              f"the CPU (noisy {psnr(xb3, xs_):.4f}); {s:.3f} s the first call ({card})",
              flush=True)
        check(abs(p_dev - p_cpu) <= BM3D_PSNR_DB, "BM3D: the card's PSNR is off the CPU's")
        timed(f"BM3D 1x1x{size}²", lambda: bm(xb3.to(dev), 0.1), reps=2)

        Bd = batches[-1]
        for lbl, make, shape in (
                ("ESRGANDiscriminator", lambda d: ESRGANDiscriminator(generator=cg(SEED + 231),
                                                                      device=d), (Bd, 3, 128, 128)),
                ("DCGANDiscriminator", lambda d: DCGANDiscriminator(generator=cg(SEED + 232),
                                                                    device=d), (Bd, 3, 64, 64))):
            xi = torch.rand(shape, generator=g) * 2 - 1
            md = make(dev)
            with torch.no_grad():
                twin(f"{lbl} {tuple(shape)}", md(xi.to(dev)), make(cpu)(xi), GEN_FWD_RTOL)
                timed(f"{lbl} {tuple(shape)}", lambda: md(xi.to(dev)))

        def noisy_discs():
            d = discs(rng, 1, size)
            return np.clip(d + NIQE_NOISE * rng.standard_normal(d.shape), 0, 1).astype(np.float32)

        phantoms = [noisy_discs() for _ in range(NIQE_PHANTOMS)]
        xn = torch.from_numpy(np.stack([noisy_discs() for _ in range(4)]))
        scores = {}
        for d in (dev, cpu):
            nq = NIQE(patch_size=niqe_patch)
            t0 = time.perf_counter()
            nq.create_weights([torch.from_numpy(p).to(d) for p in phantoms],
                              sharpness_threshold=NIQE_SHARPNESS)
            s = time.perf_counter() - t0
            scores[d.type] = nq(xn.to(d))
            if d == dev:
                print(f"NIQE create_weights on {NIQE_PHANTOMS} phantoms {size}²: {s:.3f} s; "
                      f"scores {scores[d.type].tolist()} ({card})", flush=True)
                timed(f"NIQE 4x1x{size}²", lambda: nq(xn.to(dev)))
        twin("NIQE", scores[dev.type], scores["cpu"], NIQE_CPU_RTOL)

        print(f"phase 19.4: {time.perf_counter() - t_phase:.3f} s into the phase", flush=True)
        # 19.5 upstream-named checkpoints: VGG16, the kernel network, DEAL
        img = torch.rand((1, 3, size, size), generator=g).to(dev)
        vgg = VGG16Features(generator=g)
        bits_round_trip("VGG16Features", vgg, vgg16_names,
                        lambda p: VGG16Features(pretrained=p),
                        lambda m: torch.cat([f.flatten() for f in m(img)]), tmp)
        bits_round_trip("KernelIdentificationNetwork", kin, kernel_network_names,
                        lambda p: KernelIdentificationNetwork(pretrained=p),
                        lambda m: m(y)["multipliers"], tmp)
        bits_round_trip("DEAL", deal, deal_names,
                        lambda p: port_deal(DEAL(), torch.load(p, weights_only=True)),
                        lambda m: m(ym.to(dev), 0.1), tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    n_other = sum(kernel_launches(op) for op in others)
    print(f"phase 19: K1-K4 and K7 launches {n_other}", flush=True)
    check(n_other == 0, "phase 19: a K1-K4 or K7 kernel was launched")
    out["s"] = time.perf_counter() - t_phase
    print(f"phase 19: {out['s']:.3f} s ({card})", flush=True)
    return out


def ssl_grads(trainer, x, y, phys, chains) -> tuple:
    """The loss and the parameter gradients (one flat f32 vector a tensor, 0
    where no gradient reaches) of the trainer's loss on a fixed batch, its
    losses drawing from the generators of the first step's path, in
    ``chains``: the same draws in either train-step configuration."""
    import torch

    model = trainer.model
    model.zero_grad(set_to_none=True)
    with chains:
        loss = trainer._differentiable_loss(x, y, phys, (0, 0, 0))[0]
        loss.backward()
    gs = [(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float().clone()
          for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), gs


def ssl_step(trainer, x, y, phys):
    """One train step of ``trainer`` on a fixed batch, in its configuration."""
    def run():
        trainer.optimizer.zero_grad(set_to_none=True)
        with trainer._chains():
            trainer._differentiable_loss(x, y, phys, (0, 0, 0))[0].backward()
        trainer.optimizer.step()
    return run


def selfsup_phase(dev, card: str, size: int = 256, batches=TRAIN_BATCHES,
                  steps: int = SSL_TRAIN_STEPS, depth: int = 20, nf: int = 64,
                  mri_size: int = WSPLIT_SIZE, frames: int = A2A_FRAMES,
                  avg_n: int = WSPLIT_AVERAGE) -> dict:
    """Phase 20: self-supervised training of the DnCNN chain through the
    ``Trainer``'s entry points with the default device, every case from the
    same seeded full-width ``DnCNN(1, 1, depth)`` (phase 9's; ``DnCNN(2, 2)``
    on MRI) in bf16, at each of ``batches`` in both train-step
    configurations: ``SplittingLoss(split_ratio=SSL_SPLIT,
    eval_n_samples=SSL_EVAL_SAMPLES)`` on ``size``² inpainting (mask
    SSL_MASK, examples/demo_splitting_loss.py) over ``ArtifactRemoval``;
    ``R2RLoss`` and ``Neighbor2Neighbor`` on ``size``² Gaussian denoising
    (sigma SSL_SIGMA); ``SurePGLoss(second_derivative=True)`` on
    Poisson-Gaussian denoising; ``MCLoss`` + ``EILoss(Rotate(multiples=1))``
    and ``MCLoss`` + ``MOEILoss(PanTiltRotate)`` on inpainting
    (examples/demo_ei_projective.py); ``EquivariantSplittingLoss`` over an
    ``EquivariantReconstructor`` (examples/demo_equivariant_splitting.py);
    ``Artifact2ArtifactLoss`` on ``DynamicMRI`` (``frames`` frames of
    ``size``², examples/demo_artifact2artifact.py) over a time-agnostic
    ``DnCNN(2, 2)``, at 1 and TRAIN_BATCHES[-1] / ``frames`` clips; one
    ``WeightedSplittingLoss`` step on ``mri_size``² single-coil MRI, its
    k-space weight from ``avg_n`` draws of each generator. Each case: the
    first step's loss within TRAIN_LOSS_RTOL and gradients within GRAD_RTOL
    of the same step under ``fused_chains_disabled()`` (the cuDNN layers),
    the same draws in both; ``steps`` steps of each configuration, their
    losses within TRAIN_LOSS_RTOL of each other (SURE-PG, SSL_FD_CASES: its
    finite differences make the gradient the two paths' bf16 rounding noise,
    so its first step's loss alone is held, and the gradient, the later
    losses and the gaps to the same step in f32 are printed); with
    ``fused_chains=True``
    K6, the stash backward (L + 2 a backward) and K5 launched the times the
    path makes a step (``SSL_LAUNCHES``), with ``False`` none. Evaluation by
    ``Trainer.test`` (K5 under ``no_grad``): SSL_EVAL_SAMPLES launches a
    batch for the splitting and R2R models, one for Neighbor2Neighbor's. The
    bf16 finite-difference divergences of SURE-PG against f32 ones of the
    same weights (printed), the any-angle rotation's and PanTiltRotate's
    warps timed alone, and a checkpoint saved and restored on the card
    (``ckpt_backend="orbax"``, ``torch.save``): the same bits, and a resumed
    epoch equal to an uninterrupted one (deterministic cuDNN). No K1-K4 or K7
    launch. Timed (``rate:`` lines, with the card): steps/s of both
    configurations in turns and the idle share of a ``True`` step, and the
    phase's seconds. On the CPU, at small sizes, it rehearses the checks (the
    launch counts on the card only) and skips the times."""
    import os
    import shutil
    import tempfile

    import torch

    import deepinv_tpu_torch.models.dncnn as dncnn_mod
    from deepinv_tpu_torch.datasets import ArrayDataset, DataLoader
    from deepinv_tpu_torch.loss import (PSNR, Artifact2ArtifactLoss, EILoss,
                                        EquivariantSplittingLoss, MCLoss, MOEILoss,
                                        Neighbor2Neighbor, R2RLoss, SplittingLoss, SurePGLoss,
                                        WeightedSplittingLoss)
    from deepinv_tpu_torch.models import (ArtifactRemoval, DnCNN, EquivariantReconstructor,
                                          TimeAgnosticNet, autocast)
    from deepinv_tpu_torch.ops.kernels.conv_chain import (conv_chain_stash,
                                                          fused_chains_disabled, stash_backward)
    from deepinv_tpu_torch.ops.kernels.resblock_chain import resblock_chain
    from deepinv_tpu_torch.ops.kernels.tv import chambolle_prox
    from deepinv_tpu_torch.ops.kernels.up_resblock_chain import up_resblock_chain
    from deepinv_tpu_torch.ops.kernels.up_sandwich import up_sandwich
    from deepinv_tpu_torch.physics import (MRI, Denoising, DynamicMRI, GaussianNoise,
                                           Inpainting, PoissonGaussianNoise)
    from deepinv_tpu_torch.physics.generator import (BernoulliSplittingMaskGenerator,
                                                     GaussianMaskGenerator, RandomMaskGenerator)
    from deepinv_tpu_torch.training import Trainer
    from deepinv_tpu_torch.transform import PanTiltRotate, Rotate

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    g = torch.Generator().manual_seed(SEED + 230)
    L = depth - 2
    others = (resblock_chain, up_resblock_chain, up_sandwich, chambolle_prox)
    for op in others:
        reset_kernel_launches(op)
    out = {"launches": {"K5": {}, "K6": {}, "stash_backward": {}}, "rates": {}, "ms": {}}
    tmp = tempfile.mkdtemp()

    def counts():
        return (kernel_launches(conv_chain_stash), kernel_launches(dncnn_mod.conv_chain),
                kernel_launches(stash_backward))

    def zero_counts():
        reset_kernel_launches(conv_chain_stash, stash_backward, dncnn_mod.conv_chain)

    net1 = DnCNN(1, 1, depth=depth, nf=nf, generator=g)
    net2 = DnCNN(2, 2, depth=depth, nf=nf, generator=g)
    # each case: (net, wrap the bf16 net into the model, physics, losses, data
    # shape of a sample, batches, steps, K5 launches a test batch or None)
    inp_split = Inpainting((1, size, size), mask=SSL_MASK, noise_model=GaussianNoise(0.02),
                           generator=g)
    inp_ei = Inpainting((1, size, size), mask=0.5, noise_model=GaussianNoise(0.02), generator=g)
    inp_ei2 = Inpainting((1, size, size), mask=0.5, noise_model=GaussianNoise(0.02), generator=g)
    inp_es = Inpainting((1, size, size), mask=0.6, noise_model=GaussianNoise(0.02), generator=g)
    den = Denoising(GaussianNoise(SSL_SIGMA))
    den_pg = Denoising(PoissonGaussianNoise(gain=PG_GAIN, sigma=PG_SIGMA))
    kt = RandomMaskGenerator((frames, size, size), acceleration=2).step(1, generator=gen_on(
        dev, SEED + 231))["mask"][0]
    dyn = DynamicMRI(mask=kt.expand((2,) + tuple(kt.shape[-3:])), img_size=(frames, size, size),
                     noise_model=GaussianNoise(0.01))
    acc = GaussianMaskGenerator((mri_size, mri_size), acceleration=4)
    mri = MRI(mask=acc.step(1, generator=gen_on(dev, SEED + 232))["mask"][0],
              img_size=(mri_size, mri_size), noise_model=GaussianNoise(0.01))
    artifact = ArtifactRemoval
    clips = max(batches[-1] // frames, 1)
    cases = {
        "splitting": (net1, artifact, inp_split, lambda: [SplittingLoss(
            split_ratio=SSL_SPLIT, eval_n_samples=SSL_EVAL_SAMPLES)], (1, size, size), batches,
            steps, SSL_EVAL_SAMPLES),
        "R2R": (net1, artifact, den, lambda: [R2RLoss()], (1, size, size), batches, steps,
                SSL_EVAL_SAMPLES),
        "Neighbor2Neighbor": (net1, artifact, den, lambda: [Neighbor2Neighbor()],
                              (1, size, size), batches, steps, 1),
        "SURE-PG": (net1, artifact, den_pg, lambda: [SurePGLoss(
            PG_SIGMA, PG_GAIN, second_derivative=True)], (1, size, size), batches, steps, None),
        "EI Rotate": (net1, artifact, inp_ei, lambda: [MCLoss(), EILoss(Rotate(multiples=1.0))],
                      (1, size, size), batches, steps, None),
        "MOEI PanTiltRotate": (net1, artifact, inp_ei, lambda: [MCLoss(), MOEILoss(
            PanTiltRotate(theta_max=3.0, theta_z_max=10.0), physics_list=[inp_ei, inp_ei2])],
            (1, size, size), batches, steps, None),
        "equivariant splitting": (
            net1, lambda n: EquivariantReconstructor(ArtifactRemoval(n),
                                                     transform=Rotate(multiples=90.0)),
            inp_es, lambda: [EquivariantSplittingLoss(transform=Rotate(multiples=90.0),
                                                      split_ratio=SSL_SPLIT)],
            (1, size, size), batches, steps, None),
        "Artifact2Artifact": (net2, lambda n: ArtifactRemoval(TimeAgnosticNet(n)), dyn,
                              lambda: [Artifact2ArtifactLoss((2, frames, size, size),
                                                             split_size=2, device=dev)],
                              (2, frames, size, size), (1, clips), steps, None),
    }
    try:
        for name, (net, wrap, physics, losses, shape, bs, n_steps, per_eval) in cases.items():
            for B in bs:
                label = f"{name} B={B}"
                xs = torch.rand((B * n_steps,) + shape, generator=g).to(dev)
                ssl_case(label, net, wrap, physics, losses, xs, B, n_steps, SSL_LAUNCHES[name],
                         L, dev, card, size, out, counts, zero_counts, per_eval, tmp)
            print(f"phase 20 {name}: {time.perf_counter() - t_phase:.3f} s into the phase",
                  flush=True)

        # one WeightedSplittingLoss step on single-coil MRI (its weight from
        # avg_n draws of the acceleration and the splitting generators)
        split_gen = BernoulliSplittingMaskGenerator((2, mri_size, mri_size), split_ratio=0.6)
        t0 = time.perf_counter()
        w_loss = WeightedSplittingLoss(split_gen, physics_generator=None)
        w_loss.weight = WeightedSplittingLoss.compute_weight(
            split_gen, acc, n=avg_n, generator=gen_on(dev, SEED + 233))
        sync(dev)
        print(f"WeightedSplittingLoss: k-space weight of {avg_n} draws each, "
              f"{time.perf_counter() - t0:.3f} s, range [{float(w_loss.weight.min()):.4f}, "
              f"{float(w_loss.weight.max()):.4f}]", flush=True)
        check(bool(torch.isfinite(w_loss.weight).all()), "WeightedSplittingLoss: weight")
        xs = torch.rand((1, 2, mri_size, mri_size), generator=g).to(dev)
        ssl_case("WeightedSplitting B=1", net2, ArtifactRemoval, mri, lambda: [w_loss], xs, 1, 1,
                 SSL_LAUNCHES["WeightedSplitting"], L, dev, card, mri_size, out, counts,
                 zero_counts, None, tmp)

        # the bf16 finite-difference divergences of SURE-PG against f32
        x = torch.rand((batches[-1], 1, size, size), generator=g).to(dev)
        y = den_pg(x, generator=gen_on(dev, SEED + 234))
        gd = gen_on(dev, SEED + 235)
        b1 = (torch.rand(y.shape, generator=gd, device=dev) < 0.5).to(y.dtype) * 2 - 1
        p = 0.7236
        b2 = torch.where(torch.rand(y.shape, generator=gd, device=dev) < p,
                         -math.sqrt((1 - p) / p), math.sqrt(p / (1 - p))).to(y.dtype)
        loss = SurePGLoss(PG_SIGMA, PG_GAIN, second_derivative=True)
        s2, tau1, tau2 = loss.sigma2, loss.tau1, loss.tau2
        divs = {}
        for prec, m in (("bf16", ArtifactRemoval(autocast(copy.deepcopy(net1)))),
                        ("f32", ArtifactRemoval(copy.deepcopy(net1)))):
            with torch.no_grad():
                f0 = m(y, den_pg)
                d1 = (2.0 / tau1) * ((PG_GAIN * y + s2) * b1 * (m(y + tau1 * b1, den_pg) - f0)
                                     ).float().mean()
                d2 = (2 * s2 * PG_GAIN / tau2 ** 2) * (b2 * (
                    m(y + tau2 * b2, den_pg) + m(y - tau2 * b2, den_pg) - 2 * f0)).float().mean()
            divs[prec] = (float(d1), float(d2))
        gap = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(divs["bf16"], divs["f32"])]
        print(f"SURE-PG B={batches[-1]} {size}²: finite-difference divergences (first order, "
              f"tau1 {tau1}; second order, tau2 {tau2}) bf16 {divs['bf16']}, f32 {divs['f32']}; "
              f"relative gap {gap} ({card})", flush=True)
        out["sure_pg_divergence"] = {"bf16": divs["bf16"], "f32": divs["f32"], "gap": gap}

        # the warps alone: the any-angle rotation and PanTiltRotate at B=16
        if cuda:
            xw = torch.rand((batches[-1], 1, size, size), generator=g).to(dev)
            for wname, tr in (("Rotate(multiples=1)", Rotate(multiples=1.0)),
                              ("PanTiltRotate", PanTiltRotate(theta_max=3.0, theta_z_max=10.0))):
                prm = tr.get_params(xw, gen_on(dev, SEED + 236))
                ms = cuda_ms(lambda: tr.transform(xw, **prm), 10, warmup=2)
                out["ms"][f"warp {wname}"] = ms
                print(f"time warp {wname} B={batches[-1]} {size}²: {ms:.4f} ms a call "
                      f"(CUDA events; {card})", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    n_other = sum(kernel_launches(op) for op in others)
    print(f"phase 20: K1-K4 and K7 launches {n_other}", flush=True)
    check(n_other == 0, "phase 20: a K1-K4 or K7 kernel was launched")
    out["s"] = time.perf_counter() - t_phase
    print(f"phase 20: {out['s']:.3f} s ({card})", flush=True)
    return out


def gen_on(dev, seed: int):
    """A generator on ``dev`` seeded ``seed``."""
    import torch

    return torch.Generator(device=dev).manual_seed(seed)


def ssl_case(label, net, wrap, physics, losses, xs, B, steps, want, L, dev, card, size, out,
             counts, zero_counts, per_eval, tmp):
    """One phase-20 training case in both train-step configurations: a
    ``Trainer`` of ``wrap(autocast(copy of net))`` with Adam(SSL_LR), online
    measurements of ``xs`` in batches of ``B``, one epoch of ``steps``
    steps. ``want`` is (K6, K5, stash backwards) a step with
    ``fused_chains=True``; the stash backward launches L + 2 a backward. On
    the splitting case at the largest batch, also the checkpoint round trip
    and the resumed epoch."""
    import os

    import torch

    from deepinv_tpu_torch.datasets import ArrayDataset, DataLoader
    from deepinv_tpu_torch.loss import PSNR
    from deepinv_tpu_torch.models import autocast
    from deepinv_tpu_torch.ops.kernels.conv_chain import fused_chains_disabled
    from deepinv_tpu_torch.training import Trainer

    cuda = dev.type == "cuda"

    def make(fused):
        model = wrap(autocast(copy.deepcopy(net)))
        return Trainer(model, physics, optimizer=torch.optim.Adam(model.parameters(), lr=SSL_LR),
                       train_dataloader=DataLoader(ArrayDataset(xs), batch_size=B),
                       losses=losses(), metrics=[PSNR()], epochs=1, online_measurements=True,
                       verbose=False, fused_chains=fused, seed=SEED)

    trainers = {f: make(f) for f in (True, False)}
    x0, y0, p0 = first_batch(trainers[True])
    la, ga = ssl_grads(trainers[True], x0, y0, p0, contextlib.nullcontext())
    lb, gb = ssl_grads(trainers[False], x0, y0, p0, fused_chains_disabled())
    e_l = abs(la - lb) / max(abs(lb), 1e-30)
    e_g, e_g2 = rel_max(torch.cat(ga), torch.cat(gb)), rel_l2(torch.cat(ga), torch.cat(gb))
    print(f"{label}: first step, kernels vs layers: loss {la} vs {lb} (relative {e_l}, bound "
          f"{TRAIN_LOSS_RTOL}), gradient relative max {e_g} (L2 {e_g2}, bound {GRAD_RTOL})",
          flush=True)
    first = {"loss": e_l, "grad_rel_max": e_g, "grad_rel_l2": e_g2}
    if label.split(" B=")[0] in SSL_FD_CASES:
        # a finite difference of bf16 outputs divides their rounding by tau
        # (SURE-PG: 1 / tau1 = 1e3, 1 / tau2² = 1e4): its gradient is the two
        # paths' rounding noise and its divergence far from f32's, printed
        # and not held (ROADMAP queue 3); the loss is held to the layers',
        # and the same step runs in f32 (the layers), finite
        t32 = Trainer(wrap(copy.deepcopy(net)), physics, losses=losses(), epochs=1,
                      optimizer=None, online_measurements=True, verbose=False, seed=SEED)
        l32, g32 = ssl_grads(t32, x0, y0, p0, fused_chains_disabled())
        e_32 = abs(la - l32) / max(abs(l32), 1e-30)
        e_g32 = rel_l2(torch.cat(ga), torch.cat(g32))
        print(f"{label}: the same step in f32: loss {l32}, the kernels' (bf16) loss relative to "
              f"it {e_32}, gradient relative L2 {e_g32}; neither gap is held", flush=True)
        check(e_l <= TRAIN_LOSS_RTOL and math.isfinite(l32) and bool(torch.isfinite(
            torch.cat(g32)).all()), f"{label}: first step's loss disagrees")
        first.update(loss_f32=e_32, grad_f32_rel_l2=e_g32)
    else:
        check(e_l <= TRAIN_LOSS_RTOL and e_g <= GRAD_RTOL, f"{label}: first step disagrees")
    out.setdefault("first_step", {})[label] = first
    secs, losses_of = {}, {}
    for f, t in trainers.items():
        zero_counts()
        secs[f] = [train_epoch(t, 0, dev)]
        n6, n5, nb = counts()
        losses_of[f] = t.logs_total_loss_train.vals
        print(f"{label} fused_chains={f}: {steps} steps, K6 {n6}, K5 {n5}, stash backward {nb}; "
              f"losses {losses_of[f]}", flush=True)
        check(len(losses_of[f]) == steps and all(math.isfinite(v) for v in losses_of[f]),
              f"{label} fused_chains={f}: non-finite loss")
        expect = (want[0] * steps, want[1] * steps, want[2] * (L + 2) * steps) if f else (0, 0, 0)
        if cuda:
            check((n6, n5, nb) == expect, f"{label} fused_chains={f}: launches K6 {n6}, K5 {n5}, "
                  f"stash backward {nb} (expected {expect})")
        else:  # the plain chain's calls, stashing or not
            check(n5 == (want[0] + want[1]) * steps * f, f"{label}: plain chain calls {n5}")
        if f:
            out["launches"]["K6"][label] = n6
            out["launches"]["K5"][label] = n5
            out["launches"]["stash_backward"][label] = nb
    e_steps = loss_error(losses_of[True], losses_of[False])
    fd = label.split(" B=")[0] in SSL_FD_CASES
    held = "not held: the steps follow its gradient" if fd else f"bound {TRAIN_LOSS_RTOL}"
    print(f"{label}: losses, kernels vs layers, relative max over the steps {e_steps} ({held})",
          flush=True)
    check(e_steps <= TRAIN_LOSS_RTOL or fd, f"{label}: the steps' losses disagree")
    if per_eval is not None:
        t = trainers[True]
        xe = xs[:B]
        zero_counts()
        scores = t.test(DataLoader(ArrayDataset(xe), batch_size=B))
        n5 = counts()[1]
        print(f"{label} eval: {scores}; K5 {n5}", flush=True)
        check(all(math.isfinite(v) for v in scores.values()), f"{label} eval: non-finite")
        check(n5 == per_eval, f"{label} eval: K5 {n5} (expected {per_eval})")
        out["launches"]["K5"][f"{label} eval"] = n5
    if cuda:
        for f in (False, True, True, False):
            secs[f].append(train_epoch(trainers[f], len(secs[f]), dev))
        prof = device_profile(f"{label} step fused_chains=True",
                              ssl_step(trainers[True], x0, y0, p0), 2, top=8)
        idle = None if prof is None else 1 - prof[4] / prof[0]
        rates = {f: steps * (len(v) - 1) / sum(v[1:]) for f, v in secs.items()}
        print(f"rate: {label} {size}² {rates[True]:.3f} steps/s fused_chains=True, "
              f"{rates[False]:.3f} steps/s False; idle share (True) {idle} ({card})", flush=True)
        out["rates"][label] = {"steps_per_s": rates, "idle_share": idle}
    if label.startswith("splitting") and B == TRAIN_BATCHES[-1] or (not cuda and label ==
                                                                     "splitting B=1"):
        ssl_checkpoint(label, trainers[True], make, dev, tmp, out)


def ssl_checkpoint(label, t, make, dev, tmp, out):
    """The trainer's state saved by the checkpointer (``ckpt_backend=
    "orbax"``, ``torch.save``) and restored into a fresh trainer: the same
    bits of every weight and optimizer tensor; then the next epoch of both,
    with deterministic cuDNN, gives the same weights."""
    import os

    import torch

    epoch = t.epochs_run
    t.ckpt_backend, t._orbax = "orbax", None
    path = os.path.join(tmp, label.replace(" ", "_"), "ckp.pkl")
    t.save_model(path, epoch=epoch - 1)
    t._orbax.wait()
    r = make(True)
    r.ckpt_backend = "orbax"
    r.load_model(path)
    same = all(torch.equal(a, b) for a, b in zip(t.model.state_dict().values(),
                                                 r.model.state_dict().values()))
    so, ro = t.optimizer.state_dict()["state"], r.optimizer.state_dict()["state"]
    same_opt = all(torch.equal(so[k][n].cpu(), ro[k][n].cpu()) for k in so for n in so[k]
                   if isinstance(so[k][n], torch.Tensor))
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        train_epoch(t, epoch, dev)
        train_epoch(r, epoch, dev)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    errs = [rel_max(a, b) for a, b in zip(r.model.state_dict().values(),
                                          t.model.state_dict().values())]
    print(f"{label}: checkpoint at epoch {epoch - 1} restored: weights the same bits {same}, "
          f"optimizer state {same_opt}, start epoch {r.epoch_start}; the next epoch resumed vs "
          f"uninterrupted: weights relative max {max(errs)}, losses {r.logs_total_loss_train.vals}"
          f" vs {t.logs_total_loss_train.vals}", flush=True)
    check(same and same_opt and r.epoch_start == epoch, f"{label}: the checkpoint did not round "
          "trip")
    check(max(errs) == 0.0, f"{label}: the resumed epoch differs from the uninterrupted one")
    out["checkpoint"] = {"same_bits": same, "resumed_rel_max": max(errs)}


class _Cycle:
    """``reads`` items of ``dataset``, item ``i`` reading ``dataset[i % len]``
    (a :class:`RandomPatchSampler` draws a fresh patch at every read)."""

    def __init__(self, dataset, reads: int):
        self.dataset, self.reads = dataset, reads

    def __len__(self):
        return self.reads

    def __getitem__(self, i):
        return self.dataset[i % len(self.dataset)]


def percentile(vals, q: float) -> float:
    """The ``q`` quantile of ``vals`` (linear between order statistics)."""
    import numpy as np

    return float(np.percentile(np.asarray(vals, np.float64), q * 100))


def serving_phase(dev, card: str, size: int = 256, nc=(64, 128, 256, 512), nb: int = R_MAIN,
                  depth: int = 20, requests: int = SERVE_REQUESTS, threads=SERVE_THREADS,
                  batch: int = TRAIN_BATCHES[-1], patch: int = DATA_PATCH,
                  volume: int = DATA_VOLUME, steps: int = DATA_STEPS) -> dict:
    """Phase 21: the inference server, the parallel layer and the data
    pipeline, through their entry points with the default device.

    (a) ``InferenceServer`` on loopback, in this process, with a bearer key,
    hosts phase 4's PnP-HQS deblurring of 1x3x``size``² under ``"BlurFFT"``
    (bf16 DRUNet ``nc``/``nb``, ``fused="down"``, MAX_ITER iterations) and
    phase 5's PnP-PGD on 1x2x``size``² MRI under ``"MRI"`` (the bf16 DnCNN of
    ``depth``, its residual layer scaled by DNCNN_RESIDUAL_SCALE). The port's
    ``Client`` posts ``requests`` requests of each, each with its own ``y``,
    from each of ``threads`` client threads: every ``x_hat`` within
    SERVE_RTOL of the same recon called in-process on its ``y`` (the gap
    printed; 0 expected), K1 and
    K5 MAX_ITER launches a request, no K6 launch (grad mode is off in the
    handler threads); a bad key gets 401, an unregistered physics 500 with
    its message. Timed: requests/s, p50 and p99 latency and the recon's own
    CUDA-event time.

    (b) ``DistributedProcessing`` of the HQS DRUNet on 1x3x``size``², overlap
    8, over ``DistributedContext(("sp",), devices=[dev] * 2)``: K1 once a
    band, within DENOISER_RTOL of the same tiling on K1's plain version, its
    gap to the whole-image call printed. ``distribute`` of SERVE_MRI_OPS
    single-coil MRI operators (phase 5's mask law, one seed each) over
    ``[dev] * 2`` inside PnP-PGD with phase 5's DnCNN (stepsize 1 /
    SERVE_MRI_OPS, the summed operator's norm): within RECON_RTOL of the
    ``StackedLinearPhysics`` recon, K5 MAX_ITER launches a recon.
    ``PipelineParallel`` over ``[dev] * 4``: 4 stages of PIPE_ITERS unrolled
    PnP-PGD iterations on MRI with that DnCNN, 4 microbatches of 2: within
    RECON_RTOL of the stages run in sequence, K5 once a stage's iteration and
    microbatch.

    (c) 8 ``.npy`` volumes of ``volume``² random discs in a temporary
    directory; ``RandomPatchSampler`` (``patch``²) and the port's
    ``DataLoader`` feed ``batch`` patches a step to phase 9's Trainer (the
    bf16 DnCNN(1, 1), ``fused_chains=True``) for ``steps`` steps: K6 once and
    the stash backward L + 2 times a step. Timed: steps/s and the idle share
    beside the same Trainer on in-memory batches. The Trainer's
    ``data_parallel`` over ``[dev] * 2`` takes ``steps`` SGD steps on the
    in-memory batches: the weights' update within DENOISER_RTOL of one
    device's, K6 once and the stash backward L + 2 times a chunk. HDF5 and
    ``ImageFolder`` are not driven here: the card's host has no h5py, and
    no libpng for the native decoder (``libpng16.so.16``), so the CPU tests
    (tests/test_torch_data_pipeline.py) hold them.

    On the CPU, at small sizes, it rehearses the checks (K6 and the stash
    backward counted on the card only) and skips the times."""
    import os
    import shutil
    import tempfile
    import urllib.error
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    import deepinv_tpu_torch.models.dncnn as dncnn_mod
    import deepinv_tpu_torch.models.drunet as drunet_mod
    from deepinv_tpu_torch.datasets import ArrayDataset, DataLoader, RandomPatchSampler
    from deepinv_tpu_torch.models import ArtifactRemoval, Client, DnCNN, DRUNet, autocast
    from deepinv_tpu_torch.ops import gaussian_blur
    from deepinv_tpu_torch.ops.kernels.conv_chain import conv_chain_stash, stash_backward
    from deepinv_tpu_torch.ops.kernels.resblock_chain import resblock_chain_plain
    from deepinv_tpu_torch.optim import L2, PnP, optim_builder
    from deepinv_tpu_torch.parallel import (DistributedContext, DistributedProcessing,
                                            PipelineParallel, distribute)
    from deepinv_tpu_torch.physics import MRI, BlurFFT, Denoising, GaussianNoise, stack
    from deepinv_tpu_torch.serve import InferenceServer
    from deepinv_tpu_torch.training import Trainer

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    g = torch.Generator().manual_seed(SEED + 240)
    out = {"launches": {"K1": {}, "K5": {}, "K6": {}, "stash_backward": {}}, "rates": {}}

    def zero():
        reset_kernel_launches(drunet_mod.resblock_chain, dncnn_mod.conv_chain)
        reset_kernel_launches(conv_chain_stash, stash_backward)

    def counts():
        return {"K1": kernel_launches(drunet_mod.resblock_chain),
                "K5": kernel_launches(dncnn_mod.conv_chain),
                "K6": kernel_launches(conv_chain_stash),
                "stash_backward": kernel_launches(stash_backward)}

    # (a) the two served problems, built as phases 4 and 5 build them
    blur = BlurFFT((3, size, size), filter=gaussian_blur(sigma=1.5),
                   noise_model=GaussianNoise(0.01))
    x_hqs = torch.rand((1, 3, size, size), generator=g).to(dev)
    y_hqs = blur(x_hqs, generator=gen_on(dev, SEED + 241))
    drunet = autocast(DRUNet(nc=nc, nb=nb, generator=g))
    hqs = optim_builder("HQS", data_fidelity=L2(), prior=PnP(drunet),
                        params_algo={"stepsize": 2.0, "g_param": 0.02}, max_iter=MAX_ITER)
    mask = (np.random.default_rng(0).random((size, size)) < 0.3).astype(np.float32)
    mri = MRI(mask=mask, img_size=(size, size))
    net = DnCNN(2, 2, depth=depth, nf=64, generator=g)
    with torch.no_grad():
        net.out_conv.weight.mul_(DNCNN_RESIDUAL_SCALE)
    dncnn = autocast(net)
    pgd = optim_builder("PGD", data_fidelity=L2(), prior=PnP(dncnn), params_algo=PGD_PARAMS,
                        max_iter=MAX_ITER)
    x_mri = torch.randn((1, 2, size, size), generator=g).to(dev)
    y_mri = mri.A(x_mri)
    served = {"BlurFFT": (hqs, blur, y_hqs, "K1"), "MRI": (pgd, mri, y_mri, "K5")}
    # each request its own measurement, each held to its own in-process recon
    ys = {"BlurFFT": [blur(torch.rand((1, 3, size, size), generator=g).to(dev),
                           generator=gen_on(dev, SEED + 300 + k)) for k in range(requests)],
          "MRI": [mri.A(torch.randn((1, 2, size, size), generator=g).to(dev))
                  for _ in range(requests)]}
    direct = {}
    for name, (m, p, _, _) in served.items():
        with torch.no_grad():
            direct[name] = [m(y, p) for y in ys[name]]
        sync(dev)
    server = InferenceServer(api_key=SERVE_KEY)
    for name, (m, p, _, _) in served.items():
        server.register(name, m, p)
    with server.running() as url:
        client = Client(url, api_key=SERVE_KEY, timeout=600)

        def post(name, k):
            p = served[name][1]
            t0 = time.perf_counter()
            x_hat = client(ys[name][k], p)
            return name, (time.perf_counter() - t0) * 1e3, rel_l2(x_hat.to(dev), direct[name][k])

        for name in served:   # one request each first: the first calls' set-up
            post(name, 0)
        for n_threads in threads:
            zero()
            t0 = time.perf_counter()
            with ThreadPoolExecutor(n_threads) as pool:
                futs = [pool.submit(post, name, k) for k in range(requests) for name in served]
                results = [f.result(timeout=600) for f in futs]
            wall = time.perf_counter() - t0
            got = counts()
            for name, (_, _, _, k) in served.items():
                out["launches"][k][f"serving {name} threads={n_threads}"] = got[k]
            print(f"serving {n_threads} client thread(s), {requests} requests a model: "
                  f"launches {got}", flush=True)
            check(got["K1"] == got["K5"] == requests * MAX_ITER,
                  f"serving threads={n_threads}: K1 {got['K1']} and K5 {got['K5']} launches, not "
                  f"{MAX_ITER} a request")
            check(not cuda or got["K6"] == got["stash_backward"] == 0,
                  f"serving threads={n_threads}: a training kernel launched ({got}): grad mode "
                  "is on in the handler threads")
            for name in served:
                gaps = [gap for n, _, gap in results if n == name]
                lat = [ms for n, ms, _ in results if n == name]
                print(f"serving {name} threads={n_threads}: relative L2 gap of each request's "
                      f"x_hat to the in-process recon of its own y max {max(gaps)} (bound "
                      f"{SERVE_RTOL}); latency p50 {percentile(lat, 0.5):.3f} ms, p99 "
                      f"{percentile(lat, 0.99):.3f} ms", flush=True)
                check(max(gaps) <= SERVE_RTOL, f"serving {name}: x_hat differs from the "
                      "in-process recon of its y")
                if cuda:
                    out["rates"][f"serving {name} threads={n_threads}"] = {
                        "p50_ms": percentile(lat, 0.5), "p99_ms": percentile(lat, 0.99)}
            if cuda:
                rps = len(results) / wall
                out["rates"][f"serving threads={n_threads}"] = {"requests_per_s": rps}
                print(f"rate: serving {n_threads} client thread(s) {size}² {rps:.3f} requests/s "
                      f"(both models; {card})", flush=True)
        for key, physics_name, want in (("wrong", "MRI", 401), (SERVE_KEY, "Nope", 500)):
            body = {"y": Client.serialize(y_mri), "physics": physics_name, "kwargs": {}}
            req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                         headers={"Authorization": f"Bearer {key}"})
            try:
                urllib.request.urlopen(req, timeout=60)
                code, msg = 200, {}
            except urllib.error.HTTPError as e:
                code, msg = e.code, json.loads(e.read())
            print(f"serving: key {key!r}, physics {physics_name!r}: HTTP {code} {msg}", flush=True)
            check(code == want, f"serving: expected HTTP {want}, got {code}")
            check(want != 500 or "no model registered" in msg.get("error", ""),
                  f"serving: the 500 lacks its message: {msg}")
    if cuda:
        for name, (m, p, y, _) in served.items():
            with torch.no_grad():
                ms = cuda_ms(lambda: m(y, p), 5, warmup=1)
            out["rates"][f"serving {name} recon"] = {"cuda_ms": ms}
            print(f"time serving {name}: the recon alone {ms:.3f} ms (CUDA events; {card})",
                  flush=True)

    # (b) the parallel layer on one card, the mesh repeating it
    def plain_k1():
        return swapped(drunet_mod, "resblock_chain",
                       lambda h, w1s, w2s, packed=None: resblock_chain_plain(h, w1s, w2s))

    tiled = DistributedProcessing(drunet, DistributedContext(("sp",), devices=[dev] * 2),
                                  overlap=8)
    zero()
    with torch.no_grad():
        t_k = tiled(x_hqs, 0.02)
        sync(dev)
        n_k1 = kernel_launches(drunet_mod.resblock_chain)
        with plain_k1():
            t_p = tiled(x_hqs, 0.02)
        whole = drunet(x_hqs, 0.02)
    out["launches"]["K1"]["tiled DRUNet"] = n_k1
    err, gap = rel_max(t_k, t_p), rel_l2(t_k, whole)
    print(f"parallel: DRUNet in 2 bands (overlap 8): K1 launches {n_k1}; vs the same tiling on "
          f"K1's plain version: relative max error {err} (bound {DENOISER_RTOL}); vs the "
          f"whole-image call: relative L2 {gap}", flush=True)
    check(n_k1 == 2, f"parallel: expected one K1 launch a band, got {n_k1}")
    check(err <= DENOISER_RTOL, "parallel: tiled DRUNet disagrees with its plain version")

    ops = [MRI(mask=(np.random.default_rng(s).random((size, size)) < 0.3).astype(np.float32),
               img_size=(size, size)) for s in range(SERVE_MRI_OPS)]
    op_ctx = DistributedContext(("op",), devices=[dev] * 2)
    dphys, serial = distribute(ops, op_ctx), stack(*ops)
    params = {"stepsize": 1.0 / SERVE_MRI_OPS, "g_param": PGD_PARAMS["g_param"]}

    def pgd_with(fid):
        return optim_builder("PGD", data_fidelity=fid, prior=PnP(dncnn), params_algo=params,
                             max_iter=MAX_ITER)

    zero()
    with torch.no_grad():
        r_d = pgd_with(distribute(L2(), op_ctx))(dphys.A(x_mri), dphys)
        sync(dev)
        n_k5 = kernel_launches(dncnn_mod.conv_chain)
        r_s = pgd_with(L2())(serial.A(x_mri), serial)
    out["launches"]["K5"]["distributed MRI PGD"] = n_k5
    err = rel_l2(r_d, r_s)
    print(f"parallel: PnP-PGD over {SERVE_MRI_OPS} distributed MRI operators: K5 launches {n_k5}; "
          f"vs the StackedLinearPhysics recon relative L2 {err} (bound {RECON_RTOL})", flush=True)
    check(n_k5 == MAX_ITER, f"parallel: expected {MAX_ITER} K5 launches a recon, got {n_k5}")
    check(err <= RECON_RTOL, "parallel: the distributed recon disagrees with the stacked one")

    def stage(step, carry):
        x, y = carry
        for _ in range(PIPE_ITERS):
            x = dncnn(x - step[0] * mri.A_adjoint(mri.A(x) - y), PGD_PARAMS["g_param"])
        return (x, y)

    S, M = 4, 4
    steps_pp = torch.full((S, 1), PGD_PARAMS["stepsize"], device=dev)
    xb = torch.randn((M * 2, 2, size, size), generator=g).to(dev)
    yb = mri.A(xb)
    pp = PipelineParallel(steps_pp, stage, DistributedContext(("pp",), devices=[dev] * S),
                          n_microbatches=M)
    zero()
    with torch.no_grad():
        got = pp((mri.A_adjoint(yb), yb))[0]
        sync(dev)
        n_pp = kernel_launches(dncnn_mod.conv_chain)
        seq = []
        for m in range(M):
            c = (mri.A_adjoint(yb[2 * m:2 * m + 2]), yb[2 * m:2 * m + 2])
            for s in range(S):
                c = stage(steps_pp[s], c)
            seq.append(c[0])
        seq = torch.cat(seq)
    out["launches"]["K5"]["pipeline"] = n_pp
    err = rel_l2(got, seq)
    print(f"parallel: pipeline of {S} stages x {PIPE_ITERS} PnP-PGD iterations, {M} microbatches "
          f"of 2: K5 launches {n_pp}; vs the stages in sequence relative L2 {err} (bound "
          f"{RECON_RTOL})", flush=True)
    check(n_pp == S * PIPE_ITERS * M, f"parallel: expected {S * PIPE_ITERS * M} K5 launches, "
          f"got {n_pp}")
    check(err <= RECON_RTOL, "parallel: the pipeline disagrees with the stages in sequence")

    # (c) patches read from .npy volumes into phase 9's Trainer
    tmp = tempfile.mkdtemp()
    try:
        rng = np.random.default_rng(SEED + 242)
        for i in range(8):
            np.save(os.path.join(tmp, f"vol{i}.npy"), discs(rng, 1, volume)[0])
        sampler = RandomPatchSampler(x_dir=tmp, patch_size=patch, seed=SEED)
        train_net = DnCNN(1, 1, depth=depth, nf=64,
                          generator=torch.Generator().manual_seed(SEED + 12))
        physics = Denoising(GaussianNoise(0.1))

        def trainer_on(loader):
            model = ArtifactRemoval(autocast(copy.deepcopy(train_net)))
            return Trainer(model, physics, optimizer=torch.optim.Adam(model.parameters(), lr=1e-4),
                           train_dataloader=loader, epochs=1, online_measurements=True,
                           verbose=False, fused_chains=True, seed=SEED)

        fed = trainer_on(DataLoader(_Cycle(sampler, batch * steps), batch_size=batch))
        xs = np.stack([sampler[i % 8] for i in range(batch * steps)])
        mem = trainer_on(DataLoader(ArrayDataset(xs), batch_size=batch))
        zero()
        train_epoch(fed, 0, dev)
        got = counts()
        L = depth - 2
        out["launches"]["K6"]["data-fed train"] = got["K6"]
        out["launches"]["stash_backward"]["data-fed train"] = got["stash_backward"]
        losses = fed.logs_total_loss_train.vals
        print(f"data: {steps} steps at B={batch} of {patch}² patches from {volume}² .npy volumes: "
              f"launches {got}; losses {losses}", flush=True)
        check(len(losses) == steps and all(math.isfinite(v) for v in losses),
              "data: non-finite or missing loss")
        check(not cuda or (got["K6"], got["stash_backward"], got["K5"]) == (
            steps, steps * (L + 2), 0), f"data: launches {got}, expected K6 {steps}, stash "
            f"backward {steps * (L + 2)}, K5 0")

        # the Trainer's data_parallel over [card] * 2 against one device, by
        # SGD so that an update is linear in its gradient
        def sgd_trainer(**kw):
            model = ArtifactRemoval(autocast(copy.deepcopy(train_net)))
            return Trainer(model, physics, optimizer=torch.optim.SGD(model.parameters(), lr=1e-3),
                           train_dataloader=DataLoader(ArrayDataset(xs), batch_size=batch),
                           epochs=1, online_measurements=True, verbose=False, fused_chains=True,
                           seed=SEED, **kw)

        def vec(params):
            return torch.cat([q.detach().reshape(-1) for q in params])

        w0 = vec(train_net.parameters())
        single = sgd_trainer()
        split = sgd_trainer(data_parallel=DistributedContext(("dp",), devices=[dev] * 2))
        train_epoch(single, 0, dev)
        zero()
        train_epoch(split, 0, dev)
        got = counts()
        out["launches"]["K6"]["data_parallel train"] = got["K6"]
        out["launches"]["stash_backward"]["data_parallel train"] = got["stash_backward"]
        err = rel_l2(vec(split.model.parameters()) - w0, vec(single.model.parameters()) - w0)
        lerr = max(abs(a - b) / abs(b) for a, b in zip(split.logs_total_loss_train.vals,
                                                       single.logs_total_loss_train.vals))
        print(f"data_parallel: {steps} SGD steps at B={batch} split over [card] * 2: launches "
              f"{got}; the weights' update relative L2 {err} from one device's (bound "
              f"{DENOISER_RTOL}), losses relative {lerr} (bound {DENOISER_RTOL})", flush=True)
        check(len(split.logs_total_loss_train.vals) == steps and err <= DENOISER_RTOL
              and lerr <= DENOISER_RTOL, "data_parallel: the split step differs from one device's")
        check(not cuda or (got["K6"], got["stash_backward"]) == (2 * steps, 2 * steps * (L + 2)),
              f"data_parallel: launches {got}, expected K6 {2 * steps} (one a chunk), stash "
              f"backward {2 * steps * (L + 2)}")
        if cuda:
            times, epoch = {"loader": [], "memory": []}, {"loader": 1, "memory": 1}
            runs = {"loader": fed, "memory": mem}
            train_epoch(mem, 0, dev)
            for k in ("loader", "memory", "memory", "loader"):
                times[k].append(train_epoch(runs[k], epoch[k], dev))
                epoch[k] += 1
            for k, t in runs.items():
                def run(t=t, k=k):
                    train_epoch(t, epoch[k], dev)
                    epoch[k] += 1
                prof = device_profile(f"data-fed train {k} B={batch} epoch", run, 2, top=6)
                idle = None if prof is None else 1 - prof[4] / prof[0]
                rate = steps * len(times[k]) / sum(times[k])
                out["rates"][f"train {k} B={batch}"] = {"steps_per_s": rate, "idle_share": idle}
                print(f"rate: train from {'RandomPatchSampler' if k == 'loader' else 'memory'} "
                      f"{patch}² B={batch} {rate:.3f} steps/s fused_chains=True, epochs "
                      f"{times[k]} s; idle share {idle} ({card})", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t_phase
    out["seconds"] = secs
    print(f"serving phase: {secs:.1f} s ({card})", flush=True)
    return out


def write_dicom(path: str, raw, slope: float = 1.0, intercept: float = 0.0) -> None:
    """An explicit-VR little-endian DICOM part-10 file of a signed int16 slice
    ``raw`` with its rescale tags (the writer of tests/test_io_battery.py)."""
    import os
    import struct

    def elem(group, el, vr, value):
        head = struct.pack("<HH", group, el) + vr
        if vr in (b"OB", b"OW"):
            return head + b"\x00\x00" + struct.pack("<I", len(value)) + value
        return head + struct.pack("<H", len(value)) + value

    def ds_value(x):
        v = f"{x:g}".encode()
        return v + b" " if len(v) % 2 else v

    rows, cols = raw.shape
    body = (elem(0x0028, 0x0010, b"US", struct.pack("<H", rows))
            + elem(0x0028, 0x0011, b"US", struct.pack("<H", cols))
            + elem(0x0028, 0x0100, b"US", struct.pack("<H", 16))
            + elem(0x0028, 0x0103, b"US", struct.pack("<H", 1))
            + elem(0x0028, 0x1052, b"DS", ds_value(intercept))
            + elem(0x0028, 0x1053, b"DS", ds_value(slope))
            + elem(0x7FE0, 0x0010, b"OW", raw.astype("<i2").tobytes()))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + body)


def ct_phantom_hu(rng, n: int):
    """An ``n``² thorax-like CT slice in Hounsfield units, int16: air, a body
    of soft tissue, two lungs, a spine and a few random nodules, with noise."""
    import numpy as np

    yy, xx = np.mgrid[-1:1:n * 1j, -1:1:n * 1j]
    hu = np.full((n, n), -1000.0)
    body = (xx / 0.85) ** 2 + (yy / 0.7) ** 2 < 1
    hu[body] = 40.0
    for sx in (-0.4, 0.4):
        hu[((xx - sx) / 0.28) ** 2 + ((yy + 0.05) / 0.45) ** 2 < 1] = -850.0
    hu[(xx / 0.08) ** 2 + ((yy - 0.5) / 0.08) ** 2 < 1] = 700.0
    for _ in range(int(rng.integers(3, 7))):
        cx, cy = rng.uniform(-0.6, 0.6, 2)
        r = rng.uniform(0.02, 0.08)
        hu[((xx - cx) ** 2 + (yy - cy) ** 2 < r * r) & body] = rng.uniform(-100.0, 200.0)
    hu += rng.normal(0.0, 10.0, (n, n))
    return np.clip(np.round(hu), -1024, 3071).astype(np.int16)


def datasets_phase(dev, card: str, model, physics, subjects: int = LIDC_SUBJECTS,
                   slices: int = LIDC_SLICES, side: int = LIDC_SIDE, batch: int = HQS_BATCH,
                   reps: int = LIDC_REPS) -> dict:
    """Phase 22: LIDC-IDRI slices through the port's dataset and DataLoader
    into phase 5's CT PnP-PGD (``model`` on ``physics``: the bf16 DnCNN(1, 1)
    of depth 20 over K5, MAX_ITER iterations).

    A temporary directory gets LIDC-IDRI's layout: ``metadata.csv`` (``Subject
    ID``, ``Modality``, ``File Location``, with a non-CT row) over
    ``subjects`` CT subjects of ``slices`` DICOM slices each, ``side``² int16
    with RescaleSlope 1 and RescaleIntercept -1024, of a seeded phantom in HU
    (:func:`ct_phantom_hu`), written by this script's own DICOM writer.
    ``LidcIdriSliceDataset(hounsfield_units=True)`` reads them; its transform
    maps LIDC_WINDOW to [0, 1] and average-pools 2x2 to ``side // 2``²; the
    port's ``DataLoader`` makes batches of ``batch``. Held: each item (without
    the transform) equals ``utils.load_dicom(path, apply_rescale=True)`` and
    the phantom; each fed batch and its recon equal, bit for bit, the same
    batch built in memory from the phantoms and its recon (with PyTorch's
    deterministic algorithms on: the CT adjoint's ``index_add_`` otherwise
    sums in a varying order, and the default mode's gap is held to
    RECON_RTOL); K5 MAX_ITER launches a recon (counted from 0 around each fed
    recon); finite recons of
    the batch's shape; ``utils.get_device()`` is the card; ``utils.randn_like``
    of a card tensor is on the card and the same for one seed. Timed: fed
    recons/s (the loader's read, the copy to the card, ``A`` and the recon)
    and the host's read ms a batch, beside the in-memory recons/s (``A`` and
    the recon), in turns. Returns the launches and rates.

    On the CPU, at small sizes, it rehearses the checks (K5 counted on the
    card only) and skips the times."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    import deepinv_tpu_torch.models.dncnn as dncnn_mod
    from deepinv_tpu_torch import utils
    from deepinv_tpu_torch.datasets import DataLoader, LidcIdriSliceDataset

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    out = {"launches": {}, "rates": {}}
    lo, hi = LIDC_WINDOW
    half = side // 2

    def window_pool(hu):
        """HU to [0, 1] over the window, 2x2 average pool, a channel axis."""
        v = np.clip((hu - lo) / (hi - lo), 0.0, 1.0).astype(np.float32)
        return v.reshape(half, 2, half, 2).mean(axis=(1, 3), dtype=np.float32)[None]

    tmp = tempfile.mkdtemp()
    try:
        rng = np.random.default_rng(SEED + 2200)
        phantoms, rows = [], []
        # listed out of order: the dataset sorts by subject
        for s_i in reversed(range(subjects)):
            subject = f"LIDC-IDRI-{s_i + 1:04d}"
            scan = os.path.join("LIDC-IDRI", subject, "01-01-2000-CT", "1.000000-scan")
            hus = [ct_phantom_hu(rng, side) for _ in range(slices)]
            for k, hu in enumerate(hus):
                write_dicom(os.path.join(tmp, scan, f"1-{k + 1:03d}.dcm"),
                            (hu.astype(np.int32) + 1024).astype(np.int16), 1.0, -1024.0)
            phantoms.append((subject, hus))
            rows.append(f"{subject},CT,.\\{scan.replace(os.sep, chr(92))}")
        rows.append("LIDC-IDRI-0099,DX,.\\nowhere")
        with open(os.path.join(tmp, "metadata.csv"), "w") as f:
            f.write("Subject ID,Modality,File Location\n" + "\n".join(rows) + "\n")
        hus = [hu for _, h in sorted(phantoms) for hu in h]  # the dataset's order

        raw = LidcIdriSliceDataset(tmp, hounsfield_units=True)
        check(len(raw) == subjects * slices, f"LIDC: {len(raw)} slices, expected "
              f"{subjects * slices}")
        for i in range(len(raw)):
            fname, folder, _ = raw.sample_identifiers[i]
            item = raw[i]
            check(item.dtype == np.float32 and np.array_equal(
                item, utils.load_dicom(os.path.join(folder, fname), apply_rescale=True))
                  and np.array_equal(item, hus[i].astype(np.float32)),
                  f"LIDC: slice {i} differs from load_dicom of its file or from its phantom")
        ds = LidcIdriSliceDataset(tmp, transform=window_pool, hounsfield_units=True)
        loader = DataLoader(ds, batch_size=batch)
        mem = [torch.from_numpy(np.stack([window_pool(h.astype(np.float32))
                                          for h in hus[o:o + batch]])).to(dev)
               for o in range(0, len(hus) - batch + 1, batch)]
        check(len(loader) == len(mem) > 0, "LIDC: the loader's batch count")

        def recon(x):
            with torch.no_grad():
                return model(physics.A(x), physics)

        # the slice CT's adjoint spreads with index_add_, whose atomic adds on
        # the card sum in an order that varies from run to run: the recons are
        # held bit for bit with PyTorch's deterministic algorithms on (its
        # index_add_ then accumulates in a fixed order), and in the default
        # mode within RECON_RTOL
        launches, gaps = [], []
        was_det = torch.are_deterministic_algorithms_enabled()
        for b_i, xb in enumerate(loader):
            x = torch.as_tensor(xb).to(dev)
            check(torch.equal(x, mem[b_i]), f"LIDC: fed batch {b_i} differs from the batch "
                  "built in memory")
            torch.use_deterministic_algorithms(True)
            try:
                reset_kernel_launches(dncnn_mod.conv_chain)
                r = recon(x)
                sync(dev)
                launches.append(kernel_launches(dncnn_mod.conv_chain))
                r_mem = recon(mem[b_i])
            finally:
                torch.use_deterministic_algorithms(was_det)
            check(tuple(r.shape) == (batch, 1, half, half) and bool(torch.isfinite(r).all()),
                  f"LIDC: recon of batch {b_i} not finite or of shape {tuple(r.shape)}")
            check(torch.equal(r, r_mem), f"LIDC: the fed recon of batch {b_i} differs from the "
                  f"in-memory one by {float((r - r_mem).abs().max())}")
            gaps.append(rel_l2(recon(x), recon(mem[b_i])))
        out["launches"]["LIDC-fed CT PGD"] = launches
        print(f"LIDC: {len(ds)} slices of {side}² int16 from {subjects} subjects, read as HU, "
              f"windowed {LIDC_WINDOW} and pooled to {half}²; {len(launches)} fed recons at "
              f"B={batch}, each bit-identical to the in-memory recon (deterministic "
              f"algorithms); default mode: relative L2 gaps {gaps} (bound {RECON_RTOL}); K5 "
              f"launches a recon {launches}", flush=True)
        check(max(gaps) <= RECON_RTOL, f"LIDC: fed and in-memory recons {gaps} apart")
        check(not cuda or launches == [MAX_ITER] * len(launches),
              f"LIDC: K5 launches {launches}, expected {MAX_ITER} a recon")

        # the functional helpers on the card
        if cuda:
            check(utils.get_device() == torch.device("cuda"), "utils.get_device() is not the card")
            v = torch.zeros((batch, 1, half, half), device=dev)
            a, b, c = (utils.randn_like(v, seed=k) for k in (7, 7, 8))
            check(a.device == v.device and torch.equal(a, b) and not torch.equal(a, c)
                  and abs(float(a.std()) - 1) < 0.01, "utils.randn_like on the card")
            print(f"utils: get_device() {utils.get_device()}; randn_like on {a.device}, the same "
                  f"draw for one seed, std {float(a.std())}", flush=True)

            times = {"fed": [], "memory": []}
            reads = []
            for k in ("fed", "memory", "memory", "fed") * reps:
                sync(dev)
                t0 = time.perf_counter()
                if k == "fed":
                    it = iter(loader)
                    for _ in range(len(loader)):
                        t1 = time.perf_counter()
                        xb = next(it)
                        reads.append(time.perf_counter() - t1)
                        recon(torch.as_tensor(xb).to(dev))
                else:
                    for x in mem:
                        recon(x)
                sync(dev)
                times[k].append(time.perf_counter() - t0)
            n_img = len(mem) * batch
            for k, ts in times.items():
                rate = n_img * len(ts) / sum(ts)
                out["rates"][f"LIDC CT PGD {k} B={batch}"] = {"recons_per_s": rate}
                src = "fed by LidcIdriSliceDataset" if k == "fed" else "from memory"
                print(f"rate: CT PnP-PGD {half}² B={batch} {src} {rate:.3f} recons/s, passes "
                      f"{ts} s ({card})", flush=True)
            read_ms = 1e3 * sum(reads) / len(reads)
            out["rates"][f"LIDC read B={batch}"] = {"host_read_ms": read_ms}
            print(f"rate: LIDC host read {read_ms:.3f} ms a batch of {batch} {side}² slices "
                  f"(warm page cache) ({card})", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t_phase
    out["seconds"] = secs
    print(f"datasets phase: {secs:.1f} s ({card})", flush=True)
    return out


def gallery_on_cpu(names, fast_names, threads: int) -> dict:
    """``main(device="cpu")`` of each demo of ``names`` (at its fast size
    where ``fast_names`` names it), in a worker process of ``threads``
    threads beside the card's runs: the references of a gallery phase's K7
    check."""
    import importlib

    import torch

    torch.set_num_threads(threads)
    out = {}
    for name in names:
        mod = importlib.import_module(f"deepinv_tpu_torch.examples.demo_{name}")
        with contextlib.redirect_stdout(sys.stderr):
            out[name] = mod.main(device="cpu", fast=name in fast_names)
    return out


def kernel_ops() -> dict:
    """The port's kernel wrappers by name, each counting its launches."""
    from deepinv_tpu_torch.ops.kernels.conv_chain import (conv_chain, conv_chain_stash,
                                                          stash_backward)
    from deepinv_tpu_torch.ops.kernels.resblock_chain import resblock_chain
    from deepinv_tpu_torch.ops.kernels.tv import chambolle_prox
    from deepinv_tpu_torch.ops.kernels.up_resblock_chain import up_resblock_chain
    from deepinv_tpu_torch.ops.kernels.up_sandwich import up_sandwich

    return {"resblock_chain": resblock_chain, "up_resblock_chain": up_resblock_chain,
            "up_sandwich": up_sandwich, "conv_chain": conv_chain,
            "conv_chain_stash": conv_chain_stash, "stash_backward": stash_backward,
            "chambolle_prox": chambolle_prox}


def kernels_counted(run):
    """``run()`` with every kernel's launch count set to 0 just before it:
    its result, the counts just after, and K7's by variant."""
    ops = kernel_ops()
    for op in ops.values():
        reset_kernel_launches(op)
    res = run()
    return (res, {k: kernel_launches(op) for k, op in ops.items()},
            kernel_launches_by_variant(ops["chambolle_prox"]))


def gallery_names(phase: int) -> tuple:
    """The demos of gallery phase ``phase``: those of its categories
    (GALLERY_PHASES), in ``CATEGORIES``' order."""
    from deepinv_tpu_torch.examples import CATEGORIES

    return tuple(n for c in GALLERY_PHASES[phase][0] for n in CATEGORIES[c])


def gallery_missing(name: str) -> list:
    """What demo ``name`` needs and the host lacks: the packages of
    GALLERY_PACKAGES that ``importlib.util.find_spec`` does not find, and the
    native image decoder for the demos of GALLERY_NATIVE where it did not
    build."""
    import importlib.util

    missing = [p for p in GALLERY_PACKAGES.get(name, ()) if importlib.util.find_spec(p) is None]
    if name in GALLERY_NATIVE and not missing:
        from deepinv_tpu_torch.native import _state, native_available

        if not native_available():
            why = (str(_state["error"]).strip().splitlines() or [""])[0][:120]
            missing.append(f"native image decoder ({why})")
    return missing


def gallery_cpu_runs(phase: int):
    """Start the CPU runs of gallery phase ``phase``'s K7 demos
    (GALLERY_CPU_GROUPS, at the fast size where the phase's fast tuple names
    a demo), one spawned worker process a group: the pool and the futures,
    whose results :func:`gallery_phase` reads and whose pool it shuts
    down. A phase without K7 demos starts no pool: ``(None, [])``."""
    import concurrent.futures
    import multiprocessing

    fast_names = GALLERY_PHASES[phase][1]
    groups = GALLERY_CPU_GROUPS.get(phase, ())
    if not groups:
        return None, []
    pool = concurrent.futures.ProcessPoolExecutor(
        len(groups), mp_context=multiprocessing.get_context("spawn"))
    return pool, [pool.submit(gallery_on_cpu, g, fast_names, threads) for g, threads in groups]


def gallery_phase(dev, card: str, phase: int = 23, cpu_runs=None) -> dict:
    """Phase 23, 24 or 25: the gallery's demos, each ``main(device=...)`` of
    ``deepinv_tpu_torch/examples/demo_<name>.py`` at its full size (at its
    fast size where the phase's fast tuple names it) on the card, each held to
    its JAX demo's claim. Phase 23 runs the 30 demos of the basics,
    plug-and-play, optimization, unfolded and sampling categories
    (GALLERY_23; GALLERY_FAST, GALLERY_K7, GALLERY_CLAIMS), phase 24 the 32 of
    the physics, blind, transforms, metrics, models, remote-sensing and
    performance ones (GALLERY_24; GALLERY24_FAST, GALLERY24_K7,
    GALLERY24_CLAIMS), phase 25 the 21 of the self-supervised, adversarial,
    distributed and datasets ones (GALLERY_25; GALLERY25_FAST,
    GALLERY25_CLAIMS), none of which reaches K7. Every
    kernel's launch count is set to 0 just before each demo and read just
    after (:func:`kernels_counted`), printed on the demo's line and summed
    on the phase's; the K7 demos must launch K7. Those demos also run on the CPU (the plain prox)
    at the same size, from the same CPU draws, in worker processes while the
    card's demos run (``cpu_runs``, from :func:`gallery_cpu_runs`, started
    here where None): each reconstruction of the card's run lies within
    TV_RTOL (relative L2) of the CPU's, and each PSNR within GALLERY_CPU_DB
    (GALLERY24_CPU_DB_SKIP names the PSNRs that the CPU's need not match). A
    demo that needs a package (GALLERY_PACKAGES) or the native decoder
    (GALLERY_NATIVE) runs where the host has it, and is named as not run,
    with what the host lacks, where it has not (:func:`gallery_missing`)."""
    import importlib.util

    _, fast_names, k7, claims, label, db_skip = GALLERY_PHASES[phase]
    names = gallery_names(phase)
    check(set(claims) == set(names) and set(k7) <= set(names)
          and sorted(n for g, _ in GALLERY_CPU_GROUPS.get(phase, ()) for n in g) == sorted(k7),
          f"{label}: the claims, K7 demos and CPU groups do not cover the phase's demos")
    pool, futures = gallery_cpu_runs(phase) if cpu_runs is None else cpu_runs
    t_phase = time.perf_counter()
    out = {"seconds_by_demo": {}, "launches": {}, "by_variant": {}, "kernels": {},
           "fast": list(fast_names), "not_run": [], "cpu_gap_db": {}, "cpu_rel": {}}
    card_runs = {}

    def on_card(mod, name):
        return mod.main(device=dev, fast=name in fast_names)

    try:
        for name in names:
            missing = gallery_missing(name)
            if missing:
                out["not_run"].append(name)
                print(f"{label}: demo_{name} not run: the host has no {', '.join(missing)} "
                      f"({card})", flush=True)
                continue
            mod = importlib.import_module(f"deepinv_tpu_torch.examples.demo_{name}")
            fast = name in fast_names
            sync(dev)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                res, counts, by7 = kernels_counted(lambda: on_card(mod, name))
            sync(dev)
            secs = time.perf_counter() - t0
            n7 = counts["chambolle_prox"]
            out["seconds_by_demo"][name] = secs
            out["launches"][name], out["by_variant"][name] = n7, by7
            out["kernels"][name] = {k: v for k, v in counts.items() if v}
            what, claim = claims[name]
            nums = {k: v for k, v in res.items() if isinstance(v, float) or (
                isinstance(v, dict) and v and all(isinstance(u, float) for u in v.values()))}
            # a history (a loss an epoch or a step) by its first and last entries
            nums.update({f"{k}[0, -1]": [v[0], v[-1]] for k, v in res.items()
                         if isinstance(v, list) and v and all(isinstance(u, float) for u in v)})
            print(f"{label}: demo_{name}{' (fast size)' if fast else ''} {secs:.2f} s, K7 {n7} "
                  f"{by7}, kernels launched {out['kernels'][name] or 'none'}, {nums} ({card})",
                  flush=True)
            check(claim(res), f"demo_{name}: its claim fails ({what}): {res}")
            if name in k7:
                check(n7 > 0, f"demo_{name} launched K7 no time")
                card_runs[name] = res
        t_wait = time.perf_counter()
        cpu_runs = {k: v for f in futures for k, v in f.result().items()}
        out["cpu_wait_s"] = time.perf_counter() - t_wait
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)

    def gaps_to_cpu(name, on_card_run, on_cpu):
        gaps = {k: abs(on_card_run[k] - on_cpu[k]) for k in on_cpu
                if k.startswith("psnr") and isinstance(on_cpu[k], float)}
        gaps.update({f"{k}[{d}]": abs(on_card_run[k][d] - v[d]) for k, v in on_cpu.items()
                     if k.startswith("psnr") and isinstance(v, dict) for d in v})
        gaps = {k: v for k, v in gaps.items() if k not in db_skip.get(name, ())}
        rel = {k: rel_l2(v.detach().cpu().double(), on_cpu["x_hat"][k].double())
               for k, v in on_card_run["x_hat"].items()}
        return gaps, rel

    for name in k7:
        gaps, rel = gaps_to_cpu(name, card_runs[name], cpu_runs[name])
        out["cpu_gap_db"][name], out["cpu_rel"][name] = max(gaps.values()), max(rel.values())
        print(f"{label}: demo_{name}, card against CPU: x_hat relative L2 {rel}, PSNR gaps "
              f"{gaps} dB ({card})", flush=True)
        check(out["cpu_rel"][name] <= TV_RTOL,
              f"demo_{name}: the card's reconstructions lie {rel} (relative L2) from the CPU's")
        check(out["cpu_gap_db"][name] <= GALLERY_CPU_DB,
              f"demo_{name}: the card's PSNRs lie {gaps} dB from the CPU's")
    secs = time.perf_counter() - t_phase
    out["seconds"] = secs
    ran = sum(out["seconds_by_demo"].values())
    out["kernels_total"] = {k: sum(c.get(k, 0) for c in out["kernels"].values())
                            for k in kernel_ops()}
    launched = {k: v for k, v in out["kernels_total"].items() if v}
    print(f"{label} phase: {secs:.1f} s, the demos {ran:.1f} s of it, the wait for the CPU "
          f"runs {out['cpu_wait_s']:.1f} s (budget {GALLERY_BUDGET_S:.0f} s); "
          f"{len(out['seconds_by_demo'])} demos run; kernels launched {launched or 'none'}; "
          f"at the fast size: {list(fast_names) or 'none'}; "
          f"not run: {out['not_run'] or 'none'} ({card})", flush=True)
    return out


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
    if sys.argv[1:] == ["--gallery"]:
        runs24 = gallery_cpu_runs(24)  # beside both phases' card demos
        for phase in (23, 24, 25):
            try:
                gal = gallery_phase(dev, card, phase, runs24 if phase == 24 else None)
            except BaseException:
                runs24[0].shutdown(wait=False, cancel_futures=True)
                raise
            print(json.dumps({k: gal[k] for k in ("seconds", "seconds_by_demo", "launches",
                                                  "kernels", "kernels_total", "not_run",
                                                  "cpu_rel", "cpu_gap_db")}),
                  flush=True)
        return 0

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
    def k5_vs_plain(shape, L, gen, form):
        """K5 at ``shape`` (weights and input from ``gen``) against its plain
        version, its L tile launches all of plan form ``form``."""
        h = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
        ws = (torch.randn((L, 64, 64, 3, 3), generator=gen) * he_std).to(dev)
        bs = (torch.randn((L, 64), generator=gen) * 0.02).to(dev)
        check(tile_form(shape) == form, f"conv_chain {shape}: the tile takes the "
              f"{tile_form(shape)} plan, not the {form} one")
        tiles = tile_launches_by_form()
        err = kernel_vs_plain(f"conv_chain vs plain {shape} L={L}, {form} plan",
                              lambda v: conv_chain(v, ws, bs),
                              lambda v: conv_chain_plain(v, ws, bs), h, KERNEL_RTOL)
        check_tile_launches(f"conv_chain {shape} L={L}", tiles, form, L)
        return err, h, ws, bs

    for shape, L in CHAIN_SHAPES:
        err, h, ws, bs = k5_vs_plain(shape, L, g, "banded")
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
    # K5 on the balanced schedule, on its own generator (the later phases
    # draw from g what they drew before)
    g_bal = torch.Generator().manual_seed(SEED + 21)
    for shape, L in BALANCED_SHAPES:
        k5_vs_plain(shape, L, g_bal, "balanced")
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
            before = kernel_launches_by_variant(chambolle_prox)
            err = kernel_vs_plain(
                f"tv_prox vs plain {shape} gamma={gammas} n_iter={n}, {lay.variant} variant"
                + (f", cluster {lay.cluster}" if lay.variant == "resident" else ""),
                (lambda t: chambolle_prox(t, gam, n)) if var is None and cl is None else
                (lambda t: tv_launch(t, gam, n, var, cl)),
                lambda t: chambolle_prox_plain(t, gam, n),
                xt, TV_RTOL, by_range=True)
            ran = {k: kernel_launches_by_variant(chambolle_prox)[k] - before[k] for k in before}
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
    for shape, L in CHAIN_SHAPES + [(TRAIN_B16_SHAPE, L_MAIN), (TAP_SHAPE, 3)] + BALANCED_SHAPES:
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

    # 11. diffusion and Langevin sampling with a full-width bf16 DRUNet (K1)
    smp = sampling_phase(dev, card)

    # 12. the Krylov data step: ADMM, DRS, CP and g-first PGD on CT over K5,
    # and the loop options on K7
    kry = krylov_phase(dev, card, pgd_ct={1: pgd["CT"], HQS_BATCH: pgd8["CT"]})

    # 13. the ops layer's CT projectors and blurs: PnP-PGD on fan-beam CT over
    # K5, TV-PGD on the interp and fourier projectors and a space-varying blur
    # over K7, cone-beam CT
    ctb = ct_breadth_phase(dev, card)

    # 14. multi-coil MRI: PnP-PGD on 15-coil 320² over K5 (birdcage and ESPIRiT
    # maps), generator-driven training over K6, every noise model and generator
    mc = mri_multicoil_phase(dev, card)

    # 15. the rest of physics/: PnP-HQS on the single-pixel camera and PnP-PGD
    # on fast compressed sensing over K5, PnP-FISTA on radio interferometry and
    # PnP-PGD on pansharpening over K7 at 512², every other new operator once
    ops15 = operators_phase(dev, card)

    # 16. the rest of optim/ and unfolded/: DPIR over K1, PnP mirror descent
    # over K5 and MLEM, an unfolded PGD trained over K6 and its stash backward,
    # a DEQ (forward over K5, backward over K6 and the stash backward)
    opt16 = optim_breadth_phase(dev, card)

    # 17. the models of the unrolled, PnP and 3D demos: MoDL's recon over K5
    # and its training over K6 and the stash backward, the 3D DnCNN and DRUNet
    # on their layers, pretrained= checkpoints over K5 and K1, VarNet and PDNet
    m17 = models_phase(dev, card)

    # 18. the diffusion backbones (ADMUNet under DDRM, DiffPIR and DPS; NCSN++
    # under PosteriorDiffusion) and the attention models (EDMPrecond(DiffUNet),
    # Restormer, SwinIR, SCUNet, PromptIR, RAM) at their published widths: no
    # K1-K8 launch, bf16 against f32, pretrained= round trips
    backbones_phase(dev, card)

    # 19. adversarial training of the DnCNN chain (K6, the stash backward, K5),
    # the blind deblurring demo's kernel network and PnP-PGD over K5, the rest
    # of models/ against the CPU, the metrics, pretrained= round trips
    gen19 = generative_phase(dev, card)

    # 20. self-supervised training of the DnCNN chain (K6, the stash backward,
    # K5): splitting, R2R, Neighbor2Neighbor, SURE-PG, EI and MOEI with
    # any-angle and projective warps, equivariant splitting, Artifact2Artifact
    # on dynamic MRI, weighted splitting on 320² MRI, evaluation on K5 and a
    # checkpoint round trip
    ssl20 = selfsup_phase(dev, card)

    # 21. the inference server (PnP-HQS over K1, PnP-PGD over K5), the
    # parallel layer (a tiled DRUNet, distributed MRI operators, a pipeline)
    # and RandomPatchSampler patches into the Trainer (K6, the stash backward)
    srv21 = serving_phase(dev, card)

    # 22. LIDC-IDRI slices read by the port's dataset and DataLoader into phase
    # 5's CT PnP-PGD (K5), against the same batches built in memory
    ct_model, _, ct_physics = pgd_models["CT"]
    ds22 = datasets_phase(dev, card, ct_model, ct_physics)

    # 23. the gallery's basics, plug-and-play, optimization, unfolded and
    # sampling demos on the card, each held to its claim; the TV demos over K7,
    # against their CPU runs
    # (phase 24's CPU runs start here, beside both phases' card demos)
    runs24 = gallery_cpu_runs(24)
    try:
        gal23 = gallery_phase(dev, card, 23)
    except BaseException:
        runs24[0].shutdown(wait=False, cancel_futures=True)
        raise

    # 24. the gallery's physics, blind, transforms, metrics, models,
    # remote-sensing and performance demos on the card, each held to its
    # claim; the TV demos over K7, against their CPU runs
    gal24 = gallery_phase(dev, card, 24, runs24)

    # 25. the gallery's self-supervised, adversarial, distributed and datasets
    # demos on the card, each held to its claim, every kernel counted around
    # each (none expected); those whose package the host lacks named
    gal25 = gallery_phase(dev, card, 25)

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
    # K1's backward at the DPS step's shape: the recompute and dX (4R convs)
    # at the TF32 peak it runs at; h and the bf16 cotangent in, dh out, the
    # bf16 weights in
    k1_bwd_bound = bound_ms(smp["k1_bwd"]["flop"], PEAK_TF32, 3 * act_bytes // 2
                            + 2 * R_MAIN * w_bytes)

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
        # phase 11: K1's launches in each sampler run (one a denoiser call),
        # its backward at the DPS step's shape (dh only: cuDNN convs in TF32,
        # the op's, and with TF32 off, in turns; cuDNN f32 layers under
        # autograd), the DPS guidance gradient's error against the plain
        # path, and the sampling rates
        "launches_sampling": smp["launches"],
        # phase 16: K1's launches in each DPIR recon (one a denoiser call, 8 a
        # recon at B=1 and B=8) and DPIR's rates and idle shares
        "launches_optim_breadth": opt16["launches"]["K1"],
        "optim_breadth_rates": {k: v for k, v in opt16["rates"].items() if "DPIR" in k},
        # phase 17: K1's launch in the DRUNet rebuilt from an upstream-named
        # checkpoint (pretrained=), one a call
        "launches_models": m17["launches"]["K1"],
        "backward_ms": smp["k1_bwd"]["ms"]["TF32 (the op)"],
        "backward_ms_tf32_off": smp["k1_bwd"]["ms"]["TF32 off"],
        "backward_library_ms": smp["k1_bwd"]["ms"]["cuDNN f32 layers under autograd"],
        "backward_device_ms": smp["k1_bwd"]["device_ms"]["TF32 (the op)"],
        "backward_bound_ms": k1_bwd_bound[0],
        "backward_bound_by": k1_bwd_bound[1],
        "dps_grad_rel_l2": smp["grad_err"],
        "dps_grad_rel_l2_tf32_off": smp["grad_err_tf32_off"],
        "sampling_rates": smp["rates"],
        # phase 21: K1's launches in the served HQS requests (MAX_ITER a
        # request, 1 and 4 client threads) and in the DRUNet tiled in two
        # bands (one a band); requests/s, latencies and the recons' times
        "launches_serving": srv21["launches"]["K1"],
        "serving_rates": srv21["rates"],
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
        # phase 12: K5's launches in each recon over the CT Krylov prox (one
        # an iteration), ADMM's rates beside PGD's, its CG iterations and
        # host reads a prox, and where an ADMM recon's device time goes
        "launches_krylov": kry["launches"]["K5"],
        "admm_ct_rates": kry["rates"],
        "admm_ct_krylov": kry["recon"],
        "admm_ct_profile": kry["profile"],
        # phase 13: K5's launches in PnP-PGD on fan-beam CT (one an
        # iteration), its rates beside PGD on the slice CT, and where a recon's
        # device time goes (the projector's share)
        "launches_ct_breadth": ctb["launches"]["K5"],
        "fan_pgd_rates": ctb["rates"],
        "fan_pgd_profile": ctb["profile"],
        # phase 14: K5's launches in PnP-PGD on 15-coil 320² MRI (one an
        # iteration; birdcage maps at B=1 and B=8, ESPIRiT maps at B=1), its
        # rates and where a recon's device time goes (FFTs against K5)
        "launches_mri_multicoil": mc["launches"]["K5"],
        "mri_multicoil_rates": mc["rates"],
        # phase 15: K5's launches in PnP-HQS on the 256² single-pixel camera and
        # PnP-PGD on 256² fast compressed sensing (one an iteration, B=1 and
        # B=8), their rates and device-time shares (K5, the Hadamard products,
        # the DST-I's FFTs)
        "launches_operators": ops15["launches"]["K5"],
        "operators_rates": {k: v for k, v in ops15["rates"].items() if "radio" not in k
                            and "pansharpening" not in k},
        # phase 16: K5's launches in PnP mirror descent (one an iteration, B=1
        # and B=8) and in a DEQ train step's forward (one a map), their rates
        "launches_optim_breadth": opt16["launches"]["K5"],
        "optim_breadth_rates": {k: v for k, v in opt16["rates"].items() if "MD" in k},
        # phase 17: K5's launches in MoDL's recon on 320² MRI (one a denoiser
        # call, 3 a recon, B=1 and B=8) and in the DnCNN rebuilt from a
        # checkpoint, MoDL's rates and its tile launches in a recon's profile
        "launches_models": m17["launches"]["K5"],
        "models_rates": {k: v for k, v in m17["rates"].items() if k.startswith("MoDL B")},
        "models_tile": m17.get("tile"),
        # phase 19: K5's launches in the adversarial steps (one a discriminator
        # step), the eval of the trained generator (one a batch) and PnP-PGD on
        # the kernel network's SpaceVaryingBlur (one an iteration), its rates
        "launches_generative": gen19["launches"]["K5"],
        "generative_rates": {k: v for k, v in gen19["rates"].items() if "blind" in k},
        # phase 20: K5's launches in the self-supervised train steps (one a
        # Neighbor2Neighbor step, its full image without a gradient) and in
        # their evaluation (SSL_EVAL_SAMPLES a splitting or R2R batch, one a
        # Neighbor2Neighbor batch)
        "launches_selfsup": ssl20["launches"]["K5"],
        # phase 21: K5's launches in the served MRI PGD requests (MAX_ITER a
        # request), PnP-PGD over distributed MRI operators (MAX_ITER a recon)
        # and the pipeline (one a stage's iteration and microbatch)
        "launches_serving": srv21["launches"]["K5"],
        # phase 22: K5's launches in each CT PnP-PGD recon fed LIDC-IDRI slices by
        # the DataLoader (MAX_ITER a recon at B=8), the fed and in-memory rates
        "launches_datasets": ds22["launches"]["LIDC-fed CT PGD"],
        "datasets_rates": ds22["rates"],
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
        # phase 12: K7's launches under Anderson acceleration, early stop and
        # backtracking (one a loop body, one a retry)
        "launches_loop_options": kry["launches"]["K7"],
        # phase 13: one resident launch an iteration of TV-PGD on the interp
        # and fourier CT projectors and on SpaceVaryingBlur
        "launches_ct_breadth": ctb["launches"]["K7"],
        # phase 15: one resident launch an iteration at 512² (a cluster of 16
        # a plane) of PnP-FISTA on radio interferometry and PnP-PGD on
        # pansharpening, their rates and K7's and the FFTs' device-time shares
        "launches_operators": ops15["launches"]["K7"],
        "operators_rates": {k: v for k, v in ops15["rates"].items() if "radio" in k
                            or "pansharpening" in k},
        "layout_ms_512": ops15["k7_512_ms"],
        # phase 23: K7's launches in each gallery demo (resident and global),
        # and the K7 demos' PSNR gaps to their CPU runs (dB)
        "launches_gallery": gal23["launches"],
        "gallery_by_variant": {k: v for k, v in gal23["by_variant"].items() if any(v.values())},
        "gallery_cpu_gap_db": gal23["cpu_gap_db"],
        # phase 24: the same for the physics, models and other demos, with the
        # K7 demos' reconstructions' gaps to their CPU runs (relative L2)
        "launches_gallery_24": gal24["launches"],
        "gallery_24_by_variant": {k: v for k, v in gal24["by_variant"].items()
                                  if any(v.values())},
        "gallery_24_cpu_gap_db": gal24["cpu_gap_db"],
        "gallery_24_cpu_rel": gal24["cpu_rel"],
        # phase 25: the same for the self-supervised, adversarial, distributed
        # and datasets demos (none expected), and those not run for a package
        "launches_gallery_25": gal25["launches"],
        "gallery_25_not_run": gal25["not_run"],
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
        # phase 14: K6's launches in the generator-driven train steps on
        # 15-coil MRI (one a step with fused_chains=True), steps/s and idle shares
        "launches_generator_train": mc["k6_launches"],
        "generator_train": mc["train"],
        # phase 16: K6's launches in the unfolded PGD's train steps (UNFOLD_ITERS
        # a step) and a DEQ train step (one, the graph step at the equilibrium),
        # with their steps/s and idle shares
        "launches_optim_breadth": opt16["launches"]["K6"],
        "optim_breadth_rates": {k: v for k, v in opt16["rates"].items() if "train" in k},
        # phase 17: K6's launches in MoDL's train steps (MODL_ITERS a step),
        # with their steps/s and idle shares
        "launches_models": m17["launches"]["K6"],
        "models_rates": {k: v for k, v in m17["rates"].items() if "train" in k},
        # phase 19: K6's launches in the adversarial generator steps (one a
        # step, two under UAIR), their steps/s and idle shares
        "launches_generative": gen19["launches"]["K6"],
        "generative_rates": {k: v for k, v in gen19["rates"].items() if "blind" not in k},
        # phase 20: K6's launches in the self-supervised train steps (SSL_LAUNCHES
        # a step), their steps/s and idle shares, the warps' times
        "launches_selfsup": ssl20["launches"]["K6"],
        "selfsup_rates": ssl20["rates"],
        "selfsup_warp_ms": ssl20["ms"],
        # phase 21: K6's launches in the Trainer fed by RandomPatchSampler
        # (one a step)
        "launches_data": srv21["launches"]["K6"],
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
        # phase 16: the launches in the unfolded PGD's train steps (L + 2 a
        # backward, UNFOLD_ITERS backwards a step) and a DEQ train step (L + 2 a
        # vector-Jacobian product of the adjoint and the parameters' cotangents)
        "launches_optim_breadth": opt16["launches"]["stash_backward"],
        # phase 17: the launches in MoDL's train steps (L + 2 a backward,
        # MODL_ITERS backwards a step)
        "launches_models": m17["launches"]["stash_backward"],
        # phase 19: the launches in the adversarial generator steps (L + 2 a
        # backward; two backwards a step under UAIR)
        "launches_generative": gen19["launches"]["stash_backward"],
        # phase 20: the launches in the self-supervised train steps (L + 2 a
        # backward; four backwards a SURE-PG step, two an EI or MOEI step)
        "launches_selfsup": ssl20["launches"]["stash_backward"],
        # phase 21: the launches in the Trainer fed by RandomPatchSampler
        # (L + 2 a step)
        "launches_data": srv21["launches"]["stash_backward"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
