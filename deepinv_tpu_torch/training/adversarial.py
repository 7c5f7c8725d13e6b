"""Adversarial training (port of deepinv_tpu/training/adversarial.py).

Alternating generator and discriminator updates over the port's
:class:`~deepinv_tpu_torch.training.Trainer` loop (epochs, eval, checkpoints,
early stop); only the train batch's :meth:`AdversarialTrainer.step` differs.
The JAX step (adversarial.py:110-126) is one jitted function; here it is two
PyTorch steps, and three things that ``jax.value_and_grad`` gives for free
are kept by hand:

- the generator's loss differentiates the model alone (adversarial.py:113).
  Its ``backward()`` here also fills ``D``'s ``.grad`` through the
  adversarial term, so ``D``'s gradients are cleared before the
  discriminator's backward and never reach its step;
- the discriminator's loss is taken on the *updated* generator: ``x_net`` is
  recomputed by a ``torch.no_grad()`` forward (a K5 launch on a bf16 DnCNN
  with the gates open), not reused from the generator step
  (adversarial.py:100, 120). The generator step's ``x_net`` is the one logged
  and scored;
- generator loss ``i`` draws from ``fold_in(key, i)`` and discriminator loss
  ``i`` from ``fold_in(key, 100 + i)`` (adversarial.py:94, 105). In the port's
  scheme (``Trainer._differentiable_loss``) the batch's measurement draws
  from the generator of ``path + (0,)`` and generator loss ``i`` from
  ``path + (1 + i,)``, so discriminator loss ``i`` draws from
  ``path + (101 + i,)``: distinct unless there are more than 100 generator
  losses, where the JAX keys collide too.

``fused_chains`` governs both steps: with ``False`` each runs inside
``fused_chains_disabled()``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..loss.adversarial import SupAdversarialDiscriminatorLoss
from ..utils.logger import AverageMeter
from .trainer import Trainer, _to_list

__all__ = ["AdversarialTrainer", "AdversarialOptimizer"]

# the offset of the discriminator losses' generators past the generator
# losses' (fold_in(key, 100 + i), adversarial.py:105)
_D_LOSS_PATH = 101


class AdversarialOptimizer:
    """The generator's and the discriminator's optimizers
    (adversarial.py:29): ``torch.optim.Adam(lr=1e-4)`` over ``model`` and
    ``D`` where not given (optax's ``adam(1e-4)`` there)."""

    def __init__(self, optimizer_g=None, optimizer_d=None, model=None, D=None):
        if optimizer_g is None:
            optimizer_g = torch.optim.Adam(model.parameters(), lr=1e-4)
        if optimizer_d is None:
            optimizer_d = torch.optim.Adam(D.parameters(), lr=1e-4)
        self.g = optimizer_g
        self.d = optimizer_d


class AdversarialTrainer(Trainer):
    """A :class:`Trainer` whose train step updates the generator (``model``,
    by ``optimizer`` on ``losses``) and then the discriminator ``D`` (by
    ``optimizer_d`` on ``losses_d``) on each loader batch
    (adversarial.py:39).

    :param D: the discriminator (default ``PatchGANDiscriminator()`` on the
        model's device).
    :param losses_d: the discriminator's losses (default
        ``SupAdversarialDiscriminatorLoss()``).
    :param optimizer_d: its optimizer (default ``Adam(D.parameters(),
        lr=1e-4)``).

    ``check_grad`` also records ``D``'s gradient norm before its update in
    ``check_grad_val_D``; ``grad_clip`` clips the generator's gradient only,
    as the JAX package's optax chain does.
    """

    def __init__(self, model, physics, D=None, losses=None, losses_d=None, optimizer=None,
                 optimizer_d=None, **kwargs):
        super().__init__(model, physics, optimizer=optimizer, losses=losses, **kwargs)
        if D is None:
            from ..models import PatchGANDiscriminator

            D = PatchGANDiscriminator(device=self.device)
        self.D = D
        self.losses_d = (_to_list(losses_d) if losses_d is not None
                         else [SupAdversarialDiscriminatorLoss()])
        self.optimizer_d = (optimizer_d if optimizer_d is not None
                            else torch.optim.Adam(D.parameters(), lr=1e-4))
        self.reset_metrics()

    def reset_metrics(self):
        super().reset_metrics()
        self.logs_total_loss_d = AverageMeter("loss_D")
        self.check_grad_val_D = AverageMeter("grad_norm_D")

    def check_clip_grad_D(self):
        """Record ``D``'s gradient norm before its update in
        ``check_grad_val_D`` when ``check_grad`` is set; nothing is clipped
        (adversarial.py:74). Returns the norm, or None."""
        if not self.check_grad:
            return None
        grads = [p.grad for p in self.D.parameters() if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        self.check_grad_val_D.update(float(norm))
        return norm

    def _adversarial_loss(self, losses, x, x_net, y, physics, path, offset):
        """The summed mean of ``losses`` with ``D``; loss ``i`` draws from
        the generator of ``path + (offset + i,)``."""
        total = 0.0
        for i, l in enumerate(losses):
            total = total + l(x_net=x_net, x=x, y=y, physics=physics, model=self.model, D=self.D,
                              generator=self.generator(*path, offset + i)).mean()
        return total

    def generator_step(self, x, y, physics, path):
        """The generator's update (adversarial.py:113-117); returns its loss
        and the ``x_net`` it saw."""
        self.optimizer.zero_grad(set_to_none=True)
        with self._chains():
            x_net = self.model_inference(y, physics, train=True)
            loss = self._adversarial_loss(self.losses, x, x_net, y, physics, path, 1)
            loss.backward()
        self.check_clip_grad()
        self.optimizer.step()
        return loss.detach(), x_net.detach()

    def discriminator_step(self, x, y, physics, path):
        """The discriminator's update on the updated generator's output
        (adversarial.py:119-123); returns its loss. ``D``'s gradients from
        the generator's backward are dropped first."""
        self.optimizer_d.zero_grad(set_to_none=True)
        with self._chains():
            with torch.no_grad():
                x_net = self.model_inference(y, physics)
            loss = self._adversarial_loss(self.losses_d, x, x_net, y, physics, path,
                                          _D_LOSS_PATH)
            loss.backward()
        self.check_clip_grad_D()
        self.optimizer_d.step()
        return loss.detach()

    def step(self, epoch, train_ite=None, train: bool = True, last_batch: bool = False):
        """One generator and one discriminator update per loader batch, the
        loaders in a random order (adversarial.py:128); eval batches take
        :meth:`Trainer.step`."""
        if not train:
            return super().step(epoch, train_ite=train_ite, train=False, last_batch=last_batch)
        iterators = self.current_train_iterators
        logs = {}
        for g in np.random.permutation(self.G):
            batch = next(iterators[g])
            physics = self.physics[g % len(self.physics)]
            path = (self._epoch_seed, self._ite_in_epoch, int(g))
            x, y, physics = self.get_samples(batch, physics, *self._sample_generators(*path, 0))
            lg, x_net = self.generator_step(x, y, physics, path)
            ld = self.discriminator_step(x, y, physics, path)
            n = x.shape[0]
            self.logs_total_loss_train.update(float(lg), n=n)
            self.logs_total_loss_d.update(float(ld), n=n)
            logs["TotalLoss"] = self.logs_total_loss_train.avg
            logs["loss_D"] = self.logs_total_loss_d.avg
            if self.compute_train_metrics:
                x_net, logs = self.compute_metrics(x, x_net, y, physics, logs, train=True,
                                                   epoch=epoch)
        self._ite_in_epoch += 1
        if last_batch and self.verbose:
            body = ", ".join(f"{k}={round(v, 5)}" for k, v in logs.items())
            print(f"Train epoch {epoch}: {body}")
        return logs
