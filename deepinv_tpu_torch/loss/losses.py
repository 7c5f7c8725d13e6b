"""Supervised and self-supervised losses (port of deepinv_tpu/loss/losses.py).

Stochastic losses draw from an explicit ``torch.Generator`` (the JAX package's
``key``); each also takes its draws or parameters by keyword, so that a test
can hand it the JAX package's.

Two kinds of divergence live here. SURE-Gaussian's and the Jacobian norms'
differentiate the model: SURE's is a forward-mode JVP
(``torch.autograd.forward_ad``, ``jax.jvp`` there), the Jacobian norms' a
power iteration of JVPs and VJPs that a training penalty differentiates
again. The kernel ops have neither a forward-mode rule nor a second
derivative (``first_order_only``), so those losses run the model with the
kernel gates closed (``fused_chains_disabled()``), as ``GSPnP`` does.
SURE-Poisson's and SURE-PG's divergences are finite differences of two to
four forwards, and keep the kernels (K6 and its stash backward in a train
step with ``fused_chains=True``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.autograd.forward_ad as fwAD
from torch import nn

from ..ops.kernels.conv_chain import fused_chains_disabled
from .base import Loss
from .metric import MSE

__all__ = ["SupLoss", "MCLoss", "EILoss", "MOILoss", "MOEILoss", "SureGaussianLoss",
           "SurePoissonLoss", "SurePGLoss", "R2RLoss", "R2RModel", "ScoreLoss", "ScoreModel",
           "TVLoss", "JacobianSpectralNorm", "FNEJacobianSpectralNorm"]


def _bmean(v):
    return v.reshape(v.shape[0], -1).mean(1)


def _given(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _rademacher(y, generator):
    return (torch.rand(y.shape, generator=generator, device=y.device) < 0.5).to(y.dtype) * 2 - 1


class SupLoss(Loss):
    """Supervised loss ``metric(x_net, x)`` (losses.py:46)."""

    def __init__(self, metric=None):
        self.metric = metric if metric is not None else MSE()

    def __call__(self, x_net=None, x=None, **kwargs):
        return self.metric(x_net, x)


class MCLoss(Loss):
    """Measurement consistency ``metric(A(x_net), y)`` (losses.py:71)."""

    def __init__(self, metric=None):
        self.metric = metric if metric is not None else MSE()

    def __call__(self, x_net=None, y=None, physics=None, **kwargs):
        return self.metric(physics.A(x_net), y)


class EILoss(Loss):
    """Equivariant imaging loss ``metric(model(A(T x_net)), T x_net)``
    (losses.py:81).

    :param transform: a :class:`~deepinv_tpu_torch.transform.Transform`.
    :param apply_noise: measure ``T x_net`` with the physics' noise.
    :param no_grad: stop the gradient through ``T x_net``.
    """

    def __init__(self, transform, metric=None, apply_noise: bool = True, weight: float = 1.0,
                 no_grad: bool = False):
        self.T = transform
        self.metric = metric if metric is not None else MSE()
        self.apply_noise = apply_noise
        self.weight = weight
        self.no_grad = no_grad

    def __call__(self, x_net=None, physics=None, model=None, generator=None, params=None,
                 **kwargs):
        """``params``: the transform's parameters, drawn from ``generator``
        if None; the measurement noise is drawn from ``generator`` after them."""
        if params is None:
            params = self.T.get_params(x_net, generator)
        x2 = self.T.transform(x_net, **params)
        if self.no_grad:
            x2 = x2.detach()
        y2 = physics(x2, generator=generator) if self.apply_noise else physics.A(x2)
        return self.weight * self.metric(model(y2, physics), x2)


def _pick(n: int, generator, device) -> int:
    dev = generator.device if generator is not None else device
    return int(torch.randint(0, n, (), generator=generator, device=dev))


class MOILoss(Loss):
    """Multi-operator imaging (losses.py:105): re-measure ``x_net`` through
    another operator of ``physics_list`` (or the physics updated with a
    ``physics_generator``'s parameters), reconstruct, compare with
    ``x_net``.

    :param physics_list: the operators, one drawn a call.
    :param physics_generator: draws the operator's parameters a call.
    """

    def __init__(self, physics_list=None, physics_generator=None, metric=None,
                 apply_noise: bool = True, weight: float = 1.0):
        self.physics_list = physics_list
        self.physics_generator = physics_generator
        self.metric = metric if metric is not None else MSE()
        self.apply_noise = apply_noise
        self.weight = weight

    def next_physics(self, physics=None, generator=None, batch_size: int = 1):
        """A random operator of the list, or the base physics updated with a
        generator step (losses.py:119)."""
        if self.physics_generator is not None:
            base = self.physics_list[0] if self.physics_list else physics
            return base.update(**self.physics_generator.step(batch_size, generator=generator))
        plist = self.physics_list if self.physics_list is not None else [physics]
        return plist[_pick(len(plist), generator, "cpu")]

    def __call__(self, x_net=None, physics=None, model=None, generator=None, index=None,
                 params=None, **kwargs):
        """``index``: the list's operator (drawn from ``generator`` if None);
        ``params``: the generator's parameters (drawn if None). The noise is
        drawn from ``generator`` after them."""
        if self.physics_generator is not None:
            base = self.physics_list[0] if self.physics_list else physics
            if params is None:
                params = self.physics_generator.step(x_net.shape[0], generator=generator)
            p2 = base.update(**params)
        else:
            plist = self.physics_list if self.physics_list is not None else [physics]
            if index is None:
                index = _pick(len(plist), generator, x_net.device)
            p2 = plist[int(index)]
        y2 = p2(x_net, generator=generator) if self.apply_noise else p2.A(x_net)
        return self.weight * self.metric(model(y2, p2), x_net)


class MOEILoss(EILoss):
    """Multi-operator EI (losses.py:164): :class:`EILoss` through an
    operator drawn from ``physics_list``."""

    def __init__(self, transform, physics_list=None, **kwargs):
        super().__init__(transform, **kwargs)
        self.physics_list = physics_list

    next_physics = MOILoss.next_physics
    physics_generator = None

    def __call__(self, x_net=None, physics=None, model=None, generator=None, index=None,
                 params=None, **kwargs):
        """``index``: the operator (drawn from ``generator`` first if None);
        ``params``: the transform's parameters."""
        if self.physics_list is not None:
            if index is None:
                index = _pick(len(self.physics_list), generator, x_net.device)
            physics = self.physics_list[int(index)]
        return super().__call__(x_net=x_net, physics=physics, model=model, generator=generator,
                                params=params)


class SureGaussianLoss(Loss):
    r"""SURE for Gaussian noise (losses.py:187):
    ``1/m ||y - A xhat||^2 - sigma^2 + 2 sigma^2 / m div``, with the
    Hutchinson divergence ``b . J b`` of ``y -> A(model(y))`` by a
    forward-mode JVP, the model run with the kernel gates closed (module
    docstring). ``x_net`` is not used: the JVP's primal is the
    reconstruction.

    :param tau: kept for the reference's signature; the JVP needs no step.
    :param unsure: learn ``sigma^2`` by gradient ascent on the divergence
        (UNSURE), one step a call, with ``step_size`` and ``momentum``.
    """

    def __init__(self, sigma: float, tau: float = 1e-2, unsure: bool = False,
                 step_size: float = 1e-4, momentum: float = 0.9):
        self.sigma2 = sigma ** 2
        self.tau = tau
        self.unsure = unsure
        self.step_size = step_size
        self.momentum = momentum
        self.grad_sigma = 0.0
        self.init_flag = True

    def _unsure_step(self, attr, grad_attr, flag_attr, grad, step, momentum):
        """UNSURE's gradient ascent on a noise-level estimate (losses.py:223):
        the first gradient starts the momentum, later ones blend into it,
        and the estimate moves by ``step * g``."""
        g = float(grad)
        if getattr(self, flag_attr):
            setattr(self, flag_attr, False)
            setattr(self, grad_attr, g)
        else:
            setattr(self, grad_attr, momentum * getattr(self, grad_attr) + (1 - momentum) * g)
        setattr(self, attr, float(getattr(self, attr) + step * g))

    def __call__(self, y=None, physics=None, model=None, x_net=None, generator=None,
                 probe=None, **kwargs):
        """``probe``: the Hutchinson probe ``b``, drawn N(0, I) from
        ``generator`` if None."""
        b = _given(probe, y) if probe is not None else torch.randn(
            y.shape, generator=generator, device=y.device, dtype=y.dtype)
        with fused_chains_disabled(), fwAD.dual_level():
            out = physics.A(model(fwAD.make_dual(y, b), physics))
            y1, jvp_b = fwAD.unpack_dual(out)
        div = 2 * self.sigma2 * _bmean(b * jvp_b)
        loss = _bmean((y1 - y) ** 2) + div - self.sigma2
        if self.unsure:
            self._unsure_step("sigma2", "grad_sigma", "init_flag",
                              div.detach().mean() / self.sigma2, self.step_size, self.momentum)
        return loss


class SurePoissonLoss(Loss):
    r"""SURE for Poisson noise (losses.py:257), its divergence a finite
    difference along a Rademacher probe:
    ``||y1 - y||^2 - gain mean(y) + 2 gain / tau mean(b y (y2 - y1))``."""

    def __init__(self, gain: float, tau: float = 1e-3):
        self.gain = gain
        self.tau = tau

    def __call__(self, y=None, physics=None, model=None, x_net=None, generator=None,
                 probe=None, **kwargs):
        """``probe``: the ±1 probe, drawn from ``generator`` if None."""
        b = _given(probe, y) if probe is not None else _rademacher(y, generator)
        y1 = physics.A(model(y, physics))
        y2 = physics.A(model(y + self.tau * b, physics))
        return (_bmean((y1 - y) ** 2) - self.gain * _bmean(y)
                + (2 * self.gain / self.tau) * _bmean(b * y * (y2 - y1)))


class SurePGLoss(SureGaussianLoss):
    r"""SURE for Poisson-Gaussian noise (losses.py:281): a first-order
    finite-difference divergence along a Rademacher probe (step ``tau1``)
    and, with ``second_derivative``, a second-order correction along a
    ``sqrt(5)``-weighted probe (step ``tau2``, two more forwards);
    ``unsure`` learns ``sigma^2`` and ``gain`` by gradient ascent. Through a
    bf16 network the differences take its rounding, which ``tau`` divides:
    train it in f32 where the gradient matters (ROADMAP queue 3)."""

    def __init__(self, sigma: float, gain: float, tau1: float = 1e-3, tau2: float = 1e-2,
                 second_derivative: bool = False, unsure: bool = False,
                 step_size=(1e-4, 1e-4), momentum=(0.9, 0.9), tau: Optional[float] = None):
        self.sigma2 = sigma ** 2
        self.gain = gain
        self.tau1 = tau1 if tau is None else tau
        self.tau2 = tau2
        self.second_derivative = second_derivative
        self.unsure = unsure
        self.step_size = step_size
        self.momentum = momentum
        self.grad_sigma = 0.0
        self.grad_gain = 0.0
        self.init_flag = True
        self.init_flag_gain = True

    def __call__(self, y=None, physics=None, model=None, x_net=None, generator=None,
                 probe=None, probe2=None, **kwargs):
        """``probe``: the ±1 probe; ``probe2``: the second-order probe
        (values ``-sqrt((1-p)/p)`` and ``sqrt(p/(1-p))``, p = 0.7236); each
        drawn from ``generator`` if None, in that order."""
        b1 = _given(probe, y) if probe is not None else _rademacher(y, generator)

        def f(u):
            return physics.A(model(u, physics))

        y1 = f(y)
        y2 = f(y + self.tau1 * b1)
        div1 = (2.0 / self.tau1) * _bmean((self.gain * y + self.sigma2) * b1 * (y2 - y1))
        loss = _bmean((y1 - y) ** 2) - self.gain * _bmean(y) - self.sigma2 + div1
        if self.second_derivative:
            if probe2 is not None:
                b2 = _given(probe2, y)
            else:
                p = 0.7236
                u = torch.rand(y.shape, generator=generator, device=y.device)
                b2 = torch.where(u < p, -math.sqrt((1 - p) / p),
                                 math.sqrt(p / (1 - p))).to(y.dtype)
            y2p = f(y + self.tau2 * b2)
            y2n = f(y - self.tau2 * b2)
            loss = loss - (2 * self.sigma2 * self.gain / self.tau2 ** 2) * _bmean(
                b2 * (y2p + y2n - 2 * y1))
        if self.unsure:
            d = (b1 * (y2 - y1)).detach()
            self._unsure_step("sigma2", "grad_sigma", "init_flag",
                              (2.0 / self.tau1) * d.mean(), self.step_size[0], self.momentum[0])
            self._unsure_step("gain", "grad_gain", "init_flag_gain",
                              (2.0 / self.tau1) * (y.detach() * d).mean(), self.step_size[1],
                              self.momentum[1])
        return loss


def _resolve_noise_model(own, physics):
    nm = own if own is not None else getattr(physics, "noise_model", None)
    if nm is None:
        raise ValueError("Noise model not found in the constructor or physics module.")
    return nm


class R2RModel(nn.Module):
    """GR2R re-corruption wrapper (losses.py:349): the model takes ``y_1 ~
    p(y_1 | y, alpha)`` (Gaussian re-noising, Poisson binomial thinning or
    Gamma beta thinning), one sample in training, ``eval_n_samples``
    averaged in evaluation. ``train`` is a forward keyword, as in the JAX
    package (``train_aware``), not ``nn.Module``'s mode."""

    train_aware = True

    def __init__(self, model, noise_model=None, alpha: float = 0.15, eval_n_samples: int = 5):
        super().__init__()
        self.model = model
        self.noise_model = noise_model
        self.alpha = alpha
        self.eval_n_samples = eval_n_samples

    def corrupt(self, y, noise_model, generator=None):
        """A draw of ``y_1`` (losses.py:364)."""
        a = self.alpha
        name = type(noise_model).__name__
        if name in ("GaussianNoise", "UniformGaussianNoise"):
            w = torch.randn(y.shape, generator=generator, device=y.device,
                            dtype=y.dtype) * noise_model.sigma
            return y + w * math.sqrt(a / (1 - a))
        if name == "PoissonNoise":
            gain = noise_model.gain
            z = y / gain
            w = torch.binomial(torch.round(z), torch.full_like(z, a), generator=generator)
            return gain * (z - w) / (1 - a)
        if name == "GammaNoise":
            l = noise_model.l
            ga = torch._standard_gamma((l * a).expand(y.shape).contiguous(), generator=generator)
            gb = torch._standard_gamma((l * (1 - a)).expand(y.shape).contiguous(),
                                       generator=generator)
            return y * (1 - ga / (ga + gb)) / (1 - a)
        raise NotImplementedError(f"R2R corruption for {name} not implemented")

    def forward(self, y, physics=None, generator=None, train=False, return_corruption=False,
                corrupted=None):
        """``corrupted``: the ``y_1`` draws themselves, one a sample (one in
        training); drawn from ``generator`` if None."""
        nm = _resolve_noise_model(self.noise_model, physics)
        n = 1 if train else max(self.eval_n_samples, 1)
        out, y1 = 0.0, None
        for i in range(n):
            y1 = (_given(corrupted[i], y) if corrupted is not None
                  else self.corrupt(y, nm, generator))
            out = out + self.model(y1, physics) / n
        return (out, y1) if return_corruption else out


class R2RLoss(Loss):
    r"""Generalised Recorrupted-to-Recorrupted (losses.py:395): ``y_1``
    feeds the adapted model and the loss is ``metric(A R(y_1), y_2)``,
    ``y_2 = (y - (1 - alpha) y_1) / alpha``; the model's corruption is the
    loss's (one draw, shared by returning it)."""

    def __init__(self, metric=None, noise_model=None, alpha: float = 0.15,
                 eval_n_samples: int = 5, sigma: Optional[float] = None):
        self.metric = metric if metric is not None else MSE()
        if noise_model is None and sigma is not None:
            from ..physics.noise import GaussianNoise

            noise_model = GaussianNoise(sigma, device="cpu")
        self.noise_model = noise_model
        self.alpha = alpha
        self.eval_n_samples = eval_n_samples

    def adapt_model(self, model):
        """Wrap the model to re-corrupt its input (losses.py:416)."""
        if isinstance(model, R2RModel):
            return model
        return R2RModel(model, self.noise_model, self.alpha, self.eval_n_samples)

    def __call__(self, y=None, physics=None, model=None, x_net=None, generator=None,
                 corrupted=None, **kwargs):
        m = model if isinstance(model, R2RModel) else self.adapt_model(model)
        x1, y1 = m(y, physics, generator=generator, train=True, return_corruption=True,
                   corrupted=None if corrupted is None else [corrupted])
        y2 = (y - y1 * (1 - self.alpha)) / self.alpha
        return self.metric(physics.A(x1), y2)


class ScoreModel(nn.Module):
    """Noise2Score wrapper (losses.py:431): the backbone estimates the score
    ``S(y)``; training perturbs the input with annealed noise, evaluation
    reconstructs by Tweedie's formula (Gaussian, Poisson, Gamma)."""

    train_aware = True

    def __init__(self, model, noise_model=None, delta=(0.001, 0.1), total_batches: int = 1000):
        super().__init__()
        self.model = model
        self.noise_model = noise_model
        self.delta = delta
        self.total_batches = total_batches
        self.counter = 0

    def forward(self, y, physics=None, generator=None, train=False, step=None,
                return_error=False, sigma_draw=None, eps=None):
        """``sigma_draw``: the standard normal of the training noise level
        (``(B, 1, ...)``); ``eps``: the perturbation; each drawn from
        ``generator`` if None, in that order. Without ``step`` in training a
        host counter anneals, bumped by the forward and read by the loss
        (losses.py:453-459)."""
        nm = _resolve_noise_model(self.noise_model, physics)
        dmin, dmax = self.delta
        if train:
            if step is None:
                if not return_error:
                    self.counter += 1
                step = max(self.counter, 1)
            w = min(max(step / self.total_batches, 0.0), 1.0)
            delta = dmax * (1 - w) + dmin * w
            shape = (y.shape[0],) + (1,) * (y.dim() - 1)
            z = (_given(sigma_draw, y).reshape(shape) if sigma_draw is not None else
                 torch.randn(shape, generator=generator, device=y.device, dtype=y.dtype))
            sigma = z * delta
        else:
            sigma = dmin
        e = _given(eps, y) if eps is not None else torch.randn(
            y.shape, generator=generator, device=y.device, dtype=y.dtype)
        grad = self.model(y + e * sigma, physics)
        error = _bmean((e + grad * sigma) ** 2)
        name = type(nm).__name__
        if name in ("GaussianNoise", "UniformGaussianNoise"):
            out = y + nm.sigma ** 2 * grad
        elif name == "PoissonNoise":
            yy = y if getattr(nm, "normalize", True) else y * nm.gain
            out = yy + nm.gain * yy * grad
        elif name == "GammaNoise":
            out = nm.l * y / ((nm.l - 1.0) - y * grad)
        else:
            raise NotImplementedError(f"Tweedie formula for {name} not implemented")
        return (out, error) if return_error else out


class ScoreLoss(Loss):
    r"""Noise2Score (losses.py:487): the backbone learns the score by
    ``||eps + sigma S(y + sigma eps)||^2`` at an annealed sigma; evaluation
    reconstructs by Tweedie's formula (:meth:`adapt_model`)."""

    def __init__(self, noise_model=None, total_batches: int = 1000, delta=(0.001, 0.1)):
        self.noise_model = noise_model
        self.total_batches = total_batches
        self.delta = delta

    def adapt_model(self, model):
        """Wrap the backbone into the Tweedie reconstructor (losses.py:503)."""
        if isinstance(model, ScoreModel):
            return model
        return ScoreModel(model, self.noise_model, self.delta, self.total_batches)

    def __call__(self, y=None, physics=None, model=None, x_net=None, generator=None,
                 step=None, sigma_draw=None, eps=None, **kwargs):
        m = model if isinstance(model, ScoreModel) else self.adapt_model(model)
        _, error = m(y, physics, generator=generator, train=True, step=step,
                     return_error=True, sigma_draw=sigma_draw, eps=eps)
        return error


class TVLoss(Loss):
    r"""Total variation ``2 weight (sum dh^2 / |dh| + sum dw^2 / |dw|)`` per
    sample, ``|d|`` the element count of a sample's differences
    (losses.py:520)."""

    def __init__(self, weight: float = 1.0):
        self.weight = weight

    @staticmethod
    def tensor_size(t):
        """``C * H * W`` of a ``(B, C, H, W)`` tensor (losses.py:530)."""
        return t.shape[1] * t.shape[2] * t.shape[3]

    def __call__(self, x_net=None, **kwargs):
        dh = torch.diff(x_net, dim=-2)
        dw = torch.diff(x_net, dim=-1)
        h_tv = (dh.reshape(dh.shape[0], -1) ** 2).sum(1)
        w_tv = (dw.reshape(dw.shape[0], -1) ** 2).sum(1)
        return self.weight * 2 * (h_tv / dh[0].numel() + w_tv / dw[0].numel())


class JacobianSpectralNorm(Loss):
    r"""Spectral norm of the Jacobian of ``f`` at ``x`` by ``max_iter``
    power iterations on ``J^T J`` (losses.py:544), each a forward-mode JVP
    and a VJP, with the last Rayleigh quotient. In grad mode the iterations
    keep their graph, so the norm trains as a penalty; the model runs with
    the kernel gates closed (module docstring).

    :param reduction: ``max``, ``mean``, ``sum`` or ``none`` over the batch.
    :param reduced_batchsize: use the first samples only.
    """

    def __init__(self, max_iter: int = 10, tol: float = 1e-3, eval_mode: bool = False,
                 verbose: bool = False, reduction: Optional[str] = "max",
                 reduced_batchsize: Optional[int] = None):
        self.max_iter = max_iter
        self.tol = tol
        self.eval_mode = eval_mode
        self.verbose = verbose
        if reduction is None or (isinstance(reduction, str) and reduction.lower() == "none"):
            self.reduction = lambda v: v
        elif reduction.lower() == "mean":
            self.reduction = torch.mean
        elif reduction.lower() == "sum":
            self.reduction = torch.sum
        elif reduction.lower() == "max":
            self.reduction = torch.max
        else:
            raise ValueError('Reduction should be "mean", "sum", "max", "none" or None.')
        self.reduced_batchsize = reduced_batchsize

    def compute_norm(self, f, x, generator=None, u0=None):
        """Per-sample power iteration (losses.py:572).

        :param u0: the N(0, I) start, drawn from ``generator`` if None."""
        if self.reduced_batchsize is not None:
            x = x[: self.reduced_batchsize]
        u = _given(u0, x) if u0 is not None else torch.randn(
            x.shape, generator=generator, device=x.device, dtype=x.dtype)
        bshape = (x.shape[0],) + (1,) * (x.dim() - 1)

        def bnorm(v):
            return v.reshape(v.shape[0], -1).norm(dim=1)

        u = u / bnorm(u).reshape(bshape)
        create = torch.is_grad_enabled()
        z = None
        with fused_chains_disabled(), torch.enable_grad():
            xg = x if x.requires_grad else x.detach().requires_grad_()
            out = f(xg)
            with fwAD.dual_level():
                for _ in range(self.max_iter):
                    _, jvp_u = fwAD.unpack_dual(f(fwAD.make_dual(xg, u)))
                    v = torch.autograd.grad(out, xg, jvp_u, retain_graph=True,
                                            create_graph=create)[0]
                    z = (u * v).reshape(u.shape[0], -1).sum(1) / bnorm(u).square().clamp_min(1e-12)
                    u = v / bnorm(v).clamp_min(1e-12).reshape(bshape)
        return self.reduction(torch.sqrt(z.clamp_min(0.0)))

    def __call__(self, y=None, x_net=None, model=None, physics=None, generator=None, u0=None,
                 **kwargs):
        def f(u):
            return model(u, physics) if physics is not None else model(u)

        return self.compute_norm(f, y, generator=generator, u0=u0)


class FNEJacobianSpectralNorm(JacobianSpectralNorm):
    r"""Firm non-expansiveness penalty: the spectral norm of ``2J - I``
    (losses.py:605), at ``y`` or, with ``interpolation``, at ``eta y + (1 -
    eta) x_net``, ``eta ~ U[0, 1)`` a sample (drawn before the start)."""

    def __call__(self, y=None, x_net=None, model=None, physics=None, generator=None,
                 interpolation: bool = False, eta=None, u0=None, **kwargs):
        if interpolation:
            shape = (y.shape[0],) + (1,) * (y.dim() - 1)
            e = (_given(eta, y).reshape(shape) if eta is not None else
                 torch.rand(shape, generator=generator, device=y.device, dtype=y.dtype))
            point = e * y + (1 - e) * x_net
        else:
            point = y

        def g(u):
            out = model(u, physics) if physics is not None else model(u)
            return 2 * out - u

        return self.compute_norm(g, point, generator=generator, u0=u0)


ScoreLoss.ScoreModel = ScoreModel
