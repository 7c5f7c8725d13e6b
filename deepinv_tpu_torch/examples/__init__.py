"""The demo gallery on the port: every demo of ``examples/`` (the basics,
physics, plug-and-play, optimization, unfolded, sampling, self-supervised,
adversarial, blind, transforms, metrics, models, remote-sensing,
performance, distributed and datasets demos), each a module with
``main(device=None, fast=False, ...)`` that returns its headline numbers.

Run one as ``python -m deepinv_tpu_torch.examples.demo_quickstart`` (the
CUDA device) or with ``--device cpu --fast`` on a machine without one.
"""

# the demos by category, in the order of examples/README.md's table
CATEGORIES = {
    "basics": ("quickstart", "basics", "custom_physics", "custom_optim", "custom_dataset"),
    "physics": ("mri_tour", "ct_projectors", "conebeam_fdk", "radio_interferometry",
                "physics_tour", "phase_retrieval", "ptychography", "scattering", "blur_tour",
                "lidar", "spatial_unwrapping", "anscombe", "pet", "single_pixel",
                "liu_jia_padding", "microscopy_3d"),
    "plug-and-play": ("pnp_dpir_deblur", "vanilla_pnp", "pnp_mirror_descent", "red_sr",
                      "pnp_multiscale", "wavelet_prior"),
    "optimization": ("tv_minimisation", "custom_prior", "patch_priors", "poisson_mlem", "dip",
                     "3d_denoising"),
    "unfolded": ("ct_fbp_unfolded", "unfolded_mri", "deq", "lista", "unfolded_constant_memory",
                 "learned_primal_dual", "vanilla_unfolded", "custom_prior_unfolded",
                 "unfolded_constrained_lista"),
    "sampling": ("diffusion_sampling", "sde_sampling", "mcmc_sampling", "custom_mcmc_kernel"),
    "self-supervised-learning": ("selfsup_ei", "splitting_loss", "sure_denoising",
                                 "r2r_denoising", "n2n_denoising", "multioperator_imaging",
                                 "artifact2artifact", "unsure", "equivariant_splitting",
                                 "poisson2sparse", "scan_specific", "microscopy_denoising",
                                 "lowfieldmri"),
    "adversarial-learning": ("adversarial_training", "csgm"),
    "blind-inverse-problems": ("blind_deblur", "blind_denoising", "optimize_physics_parameter"),
    "transforms-equivariance": ("transforms", "ei_projective"),
    "metrics": ("metrics", "custom_niqe"),
    # the table's models, then the volumetric CNNs, which it does not list
    "models": ("classic_denoisers", "denoiser_tour", "deal_reconstruction", "training",
               "foundation_model", "super_resolution", "3d_cnn_denoisers"),
    "remote sensing": ("pansharpening",),
    "performance": ("batched_throughput",),
    "distributed": ("distributed_pnp", "physics_distributed", "denoiser_distributed"),
    "datasets": ("native_dataloader", "io", "hdf5_convention"),
}

GALLERY = tuple(name for names in CATEGORIES.values() for name in names)
