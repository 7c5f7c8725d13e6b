"""Adversarial losses (port of deepinv_tpu/loss/adversarial.py).

A least-squares (LSGAN) metric against real and fake labels; the generator
and discriminator losses take the discriminator ``D`` as an argument, as the
JAX losses do. They return a scalar. A generator loss's ``backward()`` also
reaches ``D``'s parameters: the trainer clears them before the
discriminator's own backward (``training/adversarial.py``).
"""

from __future__ import annotations

from .base import Loss

__all__ = ["DiscriminatorMetric", "GeneratorLoss", "DiscriminatorLoss",
           "SupAdversarialGeneratorLoss", "SupAdversarialDiscriminatorLoss",
           "UnsupAdversarialGeneratorLoss", "UnsupAdversarialDiscriminatorLoss",
           "UAIRGeneratorLoss"]


class DiscriminatorMetric:
    """``mean((pred - label)^2)`` against the real or the fake label
    (adversarial.py:29); ``no_grad`` stops the gradient at ``pred``."""

    def __init__(self, real_label: float = 1.0, fake_label: float = 0.0, no_grad: bool = False):
        self.real_label = real_label
        self.fake_label = fake_label
        self.no_grad = no_grad

    def __call__(self, pred, real: bool):
        target = self.real_label if real else self.fake_label
        if self.no_grad:
            pred = pred.detach()
        return ((pred - target) ** 2).mean()


class GeneratorLoss(Loss):
    """Base generator loss (adversarial.py:44): the generator wants ``D`` to
    call its output real."""

    def __init__(self, weight_adv: float = 1.0):
        self.weight_adv = weight_adv
        self.metric_gan = DiscriminatorMetric()

    def adversarial_loss(self, real, fake, D):
        return self.weight_adv * self.metric_gan(D(fake), real=True)


class DiscriminatorLoss(Loss):
    """Base discriminator loss (adversarial.py:57): real as real, the fake
    (its gradient stopped) as fake."""

    def __init__(self, weight_adv: float = 1.0):
        self.weight_adv = weight_adv
        self.metric_gan = DiscriminatorMetric()

    def adversarial_loss(self, real, fake, D):
        return self.weight_adv * (self.metric_gan(D(real), real=True)
                                  + self.metric_gan(D(fake.detach()), real=False))


class SupAdversarialGeneratorLoss(GeneratorLoss):
    """Supervised: fool ``D`` on ``x_net`` against ``x`` (adversarial.py:72);
    ``weight_adv`` 0.01 as in the original paper."""

    def __init__(self, weight_adv: float = 0.01):
        super().__init__(weight_adv=weight_adv)

    def __call__(self, x=None, x_net=None, D=None, **kwargs):
        return self.adversarial_loss(x, x_net, D)


class SupAdversarialDiscriminatorLoss(DiscriminatorLoss):
    """Supervised discriminator loss, halved as the reference halves it
    (adversarial.py:83)."""

    def __call__(self, x=None, x_net=None, D=None, **kwargs):
        return self.adversarial_loss(x, x_net, D) * 0.5


class UnsupAdversarialGeneratorLoss(GeneratorLoss):
    """Unsupervised: ``D`` tells the measurements ``y`` from the re-measured
    ``A(x_net)`` (adversarial.py:91)."""

    def __call__(self, y=None, x_net=None, physics=None, D=None, y_hat=None, **kwargs):
        if y_hat is None:
            y_hat = physics.A(x_net)
        return self.adversarial_loss(y, y_hat, D)


class UnsupAdversarialDiscriminatorLoss(DiscriminatorLoss):
    """Unsupervised discriminator loss (adversarial.py:101)."""

    def __call__(self, y=None, x_net=None, physics=None, D=None, y_hat=None, **kwargs):
        if y_hat is None:
            y_hat = physics.A(x_net)
        return self.adversarial_loss(y, y_hat, D)


class UAIRGeneratorLoss(GeneratorLoss):
    """UAIR (Pajot et al.; adversarial.py:110): the unsupervised adversarial
    term on ``y_hat = A(x_net)`` plus ``weight_mc`` times the mean squared
    gap between ``y_hat`` and ``A(model(y_hat))``. The second model call is a
    second pass through the network (a second K6 launch in a fused train
    step)."""

    def __init__(self, weight_adv: float = 0.5, weight_mc: float = 1.0):
        super().__init__(weight_adv=weight_adv)
        self.weight_mc = weight_mc

    def __call__(self, y=None, x_net=None, physics=None, model=None, D=None, **kwargs):
        y_hat = physics.A(x_net)
        adv = self.adversarial_loss(y, y_hat, D)
        y_tilde = physics.A(model(y_hat, physics))
        return adv + self.weight_mc * ((y_tilde - y_hat) ** 2).mean()
