"""The demo gallery on the port: the basics, plug-and-play, optimization,
unfolded and sampling demos of ``examples/``, each a module with
``main(device=None, fast=False, ...)`` that returns its headline numbers.

Run one as ``python -m deepinv_tpu_torch.examples.demo_quickstart`` (the
CUDA device) or with ``--device cpu --fast`` on a machine without one.
"""

# the demos, in the order of examples/README.md's table
GALLERY = ("quickstart", "basics", "custom_physics", "custom_optim", "custom_dataset",
           "pnp_dpir_deblur", "vanilla_pnp", "pnp_mirror_descent", "red_sr", "pnp_multiscale",
           "wavelet_prior", "tv_minimisation", "custom_prior", "patch_priors", "poisson_mlem",
           "dip", "3d_denoising", "ct_fbp_unfolded", "unfolded_mri", "deq", "lista",
           "unfolded_constant_memory", "learned_primal_dual", "vanilla_unfolded",
           "custom_prior_unfolded", "unfolded_constrained_lista", "diffusion_sampling",
           "sde_sampling", "mcmc_sampling", "custom_mcmc_kernel")
