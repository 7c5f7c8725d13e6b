"""Sampling of the port (deepinv_tpu/sampling/): the diffusion posterior
samplers DDRM, DiffPIR and DPS, the Langevin samplers ULA and SK-ROCK on a
score prior, and the SDE samplers (VE, VP, EDM, Song, flow matching) with
posterior guidance. Randomness is a ``torch.Generator`` (``generator=``)."""

from .base import ULA, BaseSampling, DiffusionSampler, SKRock, sampling_builder
from .diffusion import DDRM, DPS, DiffPIR
from .iterators import DiffusionIterator, SamplingIterator, SKRockIterator, ULAIterator
from .sde import (BaseSDE, BaseSDESolver, DiffusionSDE, DPSDataFidelity, EDMDiffusionSDE,
                  EulerSolver, FlowMatching, HeunSolver, NoisyDataFidelity, PosteriorDiffusion,
                  SongDiffusionSDE, VarianceExplodingDiffusion, VariancePreservingDiffusion)
from .utils import SDEOutput, Welford, projbox

SKROCKIterator = SKRockIterator  # the reference's spelling

__all__ = ["SamplingIterator", "ULAIterator", "SKRockIterator", "SKROCKIterator",
           "DiffusionIterator", "BaseSampling", "sampling_builder", "ULA", "SKRock",
           "DiffusionSampler", "DDRM", "DiffPIR", "DPS", "BaseSDE", "BaseSDESolver",
           "EDMDiffusionSDE", "SongDiffusionSDE", "NoisyDataFidelity", "DiffusionSDE",
           "VarianceExplodingDiffusion", "VariancePreservingDiffusion", "FlowMatching",
           "EulerSolver", "HeunSolver", "PosteriorDiffusion", "DPSDataFidelity", "Welford",
           "SDEOutput", "projbox"]
