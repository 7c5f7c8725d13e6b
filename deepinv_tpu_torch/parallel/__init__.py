"""The parallel layer of the port (deepinv_tpu/parallel/): a
single-controller device mesh (:class:`DistributedContext`), operator
stacks over it, spatial tiling of denoisers, ``distribute()`` and a GPipe
pipeline. One process drives every device of the mesh; see
:mod:`~deepinv_tpu_torch.parallel.context` for why.

Two arguments are taken for the JAX package's API and select nothing, as
there: ``gather_strategy`` (every gather gives the same measurements; a value
outside ``naive``/``concatenated``/``broadcast`` raises) and ``patch_size``
(a band's size is set by the mesh)."""

from .context import DistributedContext, Placement
from .distribute import DistributedDataFidelity, distribute
from .physics import DistributedStackedLinearPhysics, DistributedStackedPhysics, stack_homogeneous
from .pipeline import PipelineParallel, pipeline
from .processing import DistributedProcessing

__all__ = ["DistributedContext", "Placement", "DistributedStackedPhysics",
           "DistributedStackedLinearPhysics", "stack_homogeneous", "DistributedProcessing",
           "distribute", "DistributedDataFidelity", "pipeline", "PipelineParallel"]
