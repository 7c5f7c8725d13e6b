"""Random physics-parameter generators (port of
deepinv_tpu/physics/generator/base.py).

``gen.step(batch_size, generator=...)`` returns a dict of parameters that
``physics.update(**params)`` (or ``physics(x, **params)``) consumes.
Generators combine: ``g1 + g2`` merges their dicts and
:class:`GeneratorMixture` draws one member per sample or per step. Each
generator takes its draws from a :class:`~deepinv_tpu_torch.core.rng.Draws`
in a fixed order (that of the JAX generator's key splits), from the caller's
``torch.Generator`` or one seeded from the generator's seed; the keyword
``draws=`` hands in the draws themselves (the parity tests). The parameters
are made on ``device``, the CUDA device by default.
"""

from __future__ import annotations

import warnings
from hashlib import sha256

import numpy as np
import torch

from ...core.rng import Draws
from ...device import resolve_device

__all__ = ["PhysicsGenerator", "GeneratorMixture", "seed_from_string"]


def seed_from_string(seed: str) -> int:
    """A 64-bit seed hashed from a string, e.g. a file's path (base.py:20)."""
    return int(sha256(seed.encode("utf-8")).hexdigest(), 16) % 0xFFFF_FFFF_FFFF_FFFF


def _as_seed(seed) -> int:
    """An int seed; a string is hashed and reduced to 63 bits as the JAX
    package reduces it for ``jax.random.key`` (base.py:66, :88)."""
    return seed_from_string(seed) % (1 << 63) if isinstance(seed, str) else int(seed)


class PhysicsGenerator:
    """Random physics-parameter sampler (deepinv_tpu/physics/generator/
    base.py:29): subclasses define ``sample(batch_size, draws, **kwargs)``.

    :param seed: the seed of the generator a step without one draws from.
    :param device: where the parameters are made; the CUDA device by default.
    """

    def __init__(self, seed: int = 0, device=None):
        self.seed = seed
        self.initial_seed = seed
        self.device = resolve_device(device)

    def sample(self, batch_size: int, draws: Draws, **kwargs) -> dict:
        raise NotImplementedError

    def _draws(self, generator, seed, draws) -> Draws:
        return Draws(generator, _as_seed(self.seed if seed is None else seed), self.device,
                     draws)

    def step(self, batch_size: int = 1, generator=None, seed=None, *, draws=None,
             **kwargs) -> dict:
        """A dict of ``batch_size`` parameter draws (base.py:80), from
        ``generator`` or a generator seeded from ``seed`` (an int or a
        string; the generator's own seed if None)."""
        return self.sample(batch_size, self._draws(generator, seed, draws), **kwargs)

    def rng_manual_seed(self, seed=None):
        """Set the seed of later steps without a generator (base.py:57); a
        string is hashed as in :meth:`step`."""
        if seed is not None:
            self.seed = _as_seed(seed)
        return self

    def reset_rng(self):
        """Restore the construction seed (base.py:73), so that steps without
        a generator repeat the first epoch's draws."""
        self.seed = self.initial_seed
        return self

    def average(self, n: int = 2000, batch_size: int = 1, generator=None, *, draws=None,
                **kwargs) -> dict:
        """Monte-Carlo mean of the parameters over ``n`` draws, in batches
        of ``batch_size`` (base.py:88), e.g. a mask generator's expected
        mask."""
        if n <= 0:
            raise ValueError("n must be positive")
        src = self._draws(generator, None, draws)
        total, done = None, 0
        while done < n:
            nb = min(n - done, max(batch_size, 1))
            params = self.sample(nb, src, **kwargs)
            done += nb
            part = {k: v.sum(0, keepdim=True) if isinstance(v, torch.Tensor) and v.dim()
                    else v * nb for k, v in params.items()}
            if total is not None and set(part) != set(total):
                raise ValueError("PhysicsGenerator.step returned inconsistent keys across calls")
            total = part if total is None else {k: total[k] + part[k] for k in total}
        return {k: v / n for k, v in total.items()}

    def __add__(self, other: "PhysicsGenerator") -> "PhysicsGenerator":
        """``g1 + g2``: the union of their parameter dicts (base.py:117)."""
        return _JointGenerator(self, other)


class _JointGenerator(PhysicsGenerator):
    """``g1 + g2`` (base.py:121): ``g1`` draws first, then ``g2``."""

    def __init__(self, g1, g2):
        super().__init__(device=g1.device)
        self.g1 = g1
        self.g2 = g2

    def sample(self, batch_size, draws, **kwargs):
        out = dict(self.g1.sample(batch_size, draws, **kwargs))
        out.update(self.g2.sample(batch_size, draws, **kwargs))
        return out


class GeneratorMixture(PhysicsGenerator):
    """A mixture of generators (base.py:136).

    With ``use_batch_sampling`` (the default) each sample of a batch draws
    its member from ``probs``; this needs members whose parameters have the
    same keys and per-sample shapes, which one probe draw each checks at
    construction. Otherwise one member is drawn a step for the whole batch.
    The member indices come from a ``numpy.random.RandomState`` seeded by
    one integer draw, as in the JAX package (base.py:195-212).
    """

    def __init__(self, generators, probs=None, use_batch_sampling: bool = True,
                 verbose: bool = False):
        super().__init__(device=generators[0].device)
        self.generators = list(generators)
        p = np.asarray(probs if probs is not None else [1 / len(generators)] * len(generators))
        self.probs = p / p.sum()
        self.use_batch_sampling = bool(use_batch_sampling) and self._compatible(
            self.generators, verbose)

    @staticmethod
    def _compatible(generators, verbose=False) -> bool:
        """Whether every member's probe draw has the same keys and the same
        non-scalar shapes (base.py:159)."""
        dicts = [g.step(1, generator=torch.Generator(device=g.device).manual_seed(0))
                 for g in generators]
        reason = None
        keys0 = set(dicts[0])
        if any(set(d) != keys0 for d in dicts[1:]):
            reason = "the generators' parameters have different keys"
        for k in sorted(keys0) if reason is None else ():
            shapes = {tuple(np.shape(d[k])) for d in dicts}
            if () in shapes or len(shapes) > 1:
                reason = f"parameter {k!r} is scalar or differs in shape between generators"
                break
        if reason is not None and verbose:
            warnings.warn(f"{reason}: a single generator will be sampled per batch.")
        return reason is None

    def sample(self, batch_size, draws, **kwargs):
        rng = np.random.RandomState(int(draws.randint(0, 2 ** 31 - 1)))
        if self.use_batch_sampling and batch_size > 1:
            idx = rng.choice(len(self.generators), size=batch_size, p=self.probs)
            outs = [self.generators[int(i)].sample(1, draws, **kwargs) for i in idx]
            return {k: torch.cat([torch.as_tensor(o[k]) for o in outs], 0) for k in outs[0]}
        idx = int(rng.choice(len(self.generators), p=self.probs))
        return self.generators[idx].sample(batch_size, draws, **kwargs)
