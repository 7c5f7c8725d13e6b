"""The source of random draws of the noise models and physics generators
(port of deepinv_tpu/core/rng.py).

The JAX package threads keys: ``ensure_key(key, seed)`` (rng.py:32) takes the
caller's key or derives one from the object's seed, and each model splits it
into one key a draw. The port draws from one ``torch.Generator`` in a fixed
order instead: the caller's, or one seeded from the object's seed on the
draws' device. Keys and generators cannot give the same numbers, so a
:class:`Draws` may also be handed the draws themselves, one array a draw in
the order the model takes them: the parity tests pass the JAX model's draws
through it, and nothing else uses it. For the Poisson and gamma laws the
given draw is the variate itself. The samplers take their normal draws from
one too (:meth:`Draws.of`, :meth:`Draws.like`).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Draws"]


class Draws:
    """Random draws in a fixed order, from ``generator`` (seeded from
    ``seed`` where it is None) or from the given ``draws``.

    :param generator: a ``torch.Generator`` on the draws' device, or None.
    :param seed: the seed of the generator made when ``generator`` is None.
    :param device: where the draws are made and returned; where it is None,
        the generator's device, else the device of the first draw asked for
        with one (:meth:`normal`), else the CPU.
    :param draws: an iterable of arrays, one a draw, in the order taken.
    """

    def __init__(self, generator=None, seed: int = 0, device=None, draws=None):
        if device is None and generator is not None:
            device = generator.device
        self.device = None if device is None else torch.device(device)
        self.generator = generator
        self.seed = seed
        self._given = None if draws is None else iter(draws)

    @classmethod
    def of(cls, generator=None, seed: int = 0, draws=None, device=None) -> "Draws":
        """The draws of one run: ``draws`` itself where it is a
        :class:`Draws` already (a sampler that runs another passes its own
        on), else a new one."""
        if isinstance(draws, Draws):
            return draws
        return cls(generator, seed, device, draws)

    @property
    def given(self) -> bool:
        """Whether the draws are handed in (not drawn)."""
        return self._given is not None

    def _dev(self, device=None) -> torch.device:
        if device is not None:
            device = torch.device(device)
            if self.device is None:
                self.device = device
            return device
        if self.device is None:
            self.device = torch.device("cpu")
        return self.device

    def _gen(self, device) -> torch.Generator:
        if self.generator is None:
            self.generator = torch.Generator(device=device).manual_seed(int(self.seed))
        return self.generator

    def _next(self, shape, dtype, device=None) -> torch.Tensor:
        try:
            d = next(self._given)
        except StopIteration:
            raise ValueError("the model takes more draws than it was given") from None
        t = torch.as_tensor(np.array(d)).to(device=self._dev(device), dtype=dtype)
        return t.reshape(shape) if shape is not None else t

    def uniform(self, shape, dtype=torch.float32) -> torch.Tensor:
        """Uniform on [0, 1)."""
        if self.given:
            return self._next(shape, dtype)
        dev = self._dev()
        return torch.rand(shape, generator=self._gen(dev), dtype=dtype, device=dev)

    def normal(self, shape, dtype=torch.float32, device=None) -> torch.Tensor:
        """Standard normal; for a complex ``dtype`` a variance of 1/2 in the
        real and in the imaginary part, as ``jax.random.normal`` draws.
        ``device`` overrides the draws' device for this draw."""
        if self.given:
            return self._next(shape, dtype, device)
        dev = self._dev(device)
        return torch.randn(shape, generator=self._gen(dev), dtype=dtype, device=dev)

    def like(self, x: torch.Tensor) -> torch.Tensor:
        """A standard normal draw of ``x``'s shape, dtype and device."""
        return self.normal(x.shape, x.dtype, x.device)

    def gumbel(self, shape, dtype=torch.float32) -> torch.Tensor:
        """Standard Gumbel: ``-log(E)``, E ~ Exp(1)."""
        if self.given:
            return self._next(shape, dtype)
        dev = self._dev()
        e = torch.empty(shape, dtype=dtype, device=dev).exponential_(generator=self._gen(dev))
        return -torch.log(e)

    def laplace(self, shape, dtype=torch.float32) -> torch.Tensor:
        """Standard Laplace: the difference of two Exp(1) draws."""
        if self.given:
            return self._next(shape, dtype)
        dev = self._dev()
        e = torch.empty((2,) + tuple(shape), dtype=dtype, device=dev).exponential_(
            generator=self._gen(dev))
        return e[0] - e[1]

    def poisson(self, rate: torch.Tensor) -> torch.Tensor:
        """Poisson variates of ``rate`` (its shape and dtype)."""
        if self.given:
            return self._next(rate.shape, rate.dtype)
        return torch.poisson(rate, generator=self._gen(self._dev(rate.device)))

    def gamma(self, concentration: torch.Tensor) -> torch.Tensor:
        """Gamma(concentration, 1) variates (``concentration``'s shape and
        dtype), by ATen's sampler, the one entry point that takes a
        generator."""
        if self.given:
            return self._next(concentration.shape, concentration.dtype)
        return torch._standard_gamma(concentration,
                                      generator=self._gen(self._dev(concentration.device)))

    def randint(self, low: int, high: int, shape=()) -> torch.Tensor:
        """Integers uniform on ``[low, high)``."""
        if self.given:
            return self._next(shape, torch.long)
        dev = self._dev()
        return torch.randint(low, high, tuple(shape), generator=self._gen(dev), device=dev)

    def permutation(self, n: int) -> torch.Tensor:
        """A random permutation of ``range(n)``."""
        if self.given:
            return self._next((n,), torch.long)
        dev = self._dev()
        return torch.randperm(n, generator=self._gen(dev), device=dev)
