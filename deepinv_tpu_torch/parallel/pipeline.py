"""Pipeline parallelism over a ``pp`` mesh axis, GPipe microbatching (port of
deepinv_tpu/parallel/pipeline.py).

Stage ``s`` keeps its parameters on mesh device ``s``; microbatch carries go
from stage to stage with ``.to()``. The schedule is GPipe's fill-drain:
``M + S - 1`` ticks for ``M`` microbatches over ``S`` stages; at tick ``t``
stage ``s`` runs microbatch ``t - s``. The JAX package runs every stage at
every tick, the idle ones on a clipped microbatch whose result it drops
(pipeline.py:81-90); here a stage runs only the microbatches it has. The
stages of a tick are issued from the last to the first, each on its own
device, so stages on different cards overlap. Every step is a torch op
(indexing, ``.to()``, the stage), so autograd differentiates through the
pipeline, as ``jax.grad`` does through the JAX package's ``fori_loop``.
"""

from __future__ import annotations

import torch
from torch import nn

from .context import DistributedContext

__all__ = ["pipeline", "PipelineParallel"]


def _tmap(fn, tree):
    """``fn`` over the tensors of a tuple, list or dict tree."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tmap(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tmap(fn, v) for k, v in tree.items()}
    return fn(tree)


def _first(tree) -> torch.Tensor:
    while isinstance(tree, (tuple, list, dict)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


def _stack(trees: list):
    """A list of trees of one structure as one tree of stacked tensors."""
    first = trees[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([t[k] for t in trees]) for k in range(len(first)))
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def pipeline(stage_params, stage_apply, carries, ctx: DistributedContext, pp_axis: str = "pp"):
    """Run microbatch carries through a pipeline of stages (pipeline.py:39).

    :param stage_params: a tensor or a tree of tensors stacked on a leading
        stage axis of size S, the size of ``pp_axis``; entry ``s`` is stage
        ``s``'s, moved to mesh device ``s``.
    :param stage_apply: ``(params_s, carry) -> carry``, one stage; every
        stage takes and returns carries of one structure.
    :param carries: a tensor or tree stacked on a leading microbatch axis M.
    :param ctx: the mesh.
    :return: the output carries stacked on the microbatch axis, on the
        device of the input carries.
    """
    devs = ctx.axis_devices(pp_axis)
    S, n_stages = len(devs), _first(stage_params).shape[0]
    M, home = _first(carries).shape[0], _first(carries).device
    if S == 1:
        params = [_tmap(lambda p: p[i], stage_params) for i in range(n_stages)]
        outs = []
        for m in range(M):
            c = _tmap(lambda t: t[m], carries)
            for p in params:
                c = stage_apply(p, c)
            outs.append(c)
        return _stack(outs)
    if n_stages != S:
        raise ValueError(f"{n_stages} stages on a {pp_axis!r} axis of {S} devices")
    params = [_tmap(lambda p: p[s].to(devs[s], non_blocking=True), stage_params)
              for s in range(S)]
    held = [None] * S       # the carry each stage last produced
    outs = [None] * M
    for t in range(M + S - 1):
        for s in reversed(range(S)):
            m = t - s
            if not 0 <= m < M:
                continue
            c = _tmap(lambda v: v[m], carries) if s == 0 else held[s - 1]
            c = stage_apply(params[s], _tmap(lambda v: v.to(devs[s], non_blocking=True), c))
            if s == S - 1:
                outs[m] = _tmap(lambda v: v.to(home, non_blocking=True), c)
            else:
                held[s] = c
    return _stack(outs)


class PipelineParallel(nn.Module):
    """A homogeneous stage stack pipelined over ``pp`` (pipeline.py:122).

    :param stage_params: tensor or tree stacked on a leading stage axis S.
    :param stage_apply: ``(params_s, carry) -> carry``.
    :param ctx: :class:`DistributedContext` with a ``pp_axis`` axis.
    :param n_microbatches: microbatches the batch splits into (it must
        divide the batch); default the axis' size.
    """

    def __init__(self, stage_params, stage_apply, ctx: DistributedContext,
                 n_microbatches: int = None, pp_axis: str = "pp"):
        super().__init__()
        self.stage_params = stage_params
        self.stage_apply = stage_apply
        self.ctx = ctx
        self.pp_axis = pp_axis
        self.n_microbatches = n_microbatches

    def forward(self, carry):
        """``carry``: a tensor or tree with a leading batch axis B; returns
        the same structure."""
        B = _first(carry).shape[0]
        M = self.n_microbatches or self.ctx.axis_size(self.pp_axis)
        if B % M:
            raise ValueError(f"batch {B} not divisible by {M} microbatches")
        mb = _tmap(lambda c: c.reshape((M, B // M) + tuple(c.shape[1:])), carry)
        out = pipeline(self.stage_params, self.stage_apply, mb, self.ctx, pp_axis=self.pp_axis)
        return _tmap(lambda c: c.reshape((B,) + tuple(c.shape[2:])), out)
