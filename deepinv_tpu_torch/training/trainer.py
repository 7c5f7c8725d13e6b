"""Trainer (port of deepinv_tpu/training/trainer.py).

The JAX Trainer jits one ``train_step(model, opt_state, batch, key)``; here
a step is PyTorch's own: the loss is computed eagerly, ``backward()`` fills
the parameters' ``.grad`` and a ``torch.optim`` optimizer steps them. What it
keeps of the JAX Trainer:

- one loader or several, drawn in the reference's per-step permutation
  (``np.random.seed(seed + epoch)``, trainer.py:504, 637), with one optimizer
  step per loader batch or one over the summed loss
  (``optimizer_step_multi_dataset``);
- online measurements ``y = physics(x, generator)`` from a generator seeded
  per epoch and step, the counterpart of the key folding at
  trainer.py:517-519 and 622-629, including ``loop_random_online_physics``
  (the draws differ from JAX's, the semantics do not), with the operator's
  parameters drawn first by a ``physics_generator`` from a generator of its
  own path (trainer.py:458-466), and offline ``(x, y[, params])`` batches;
- the per-loss meters, train and eval metrics, ``compare_no_learning``,
  ``eval_interval``, the best model, early stopping (:meth:`stop_criterion`),
  gradient clipping with the pre-clip norm recorded by ``check_grad``,
  checkpoints (state dicts in place of numpy trees) and the overridable hooks
  (:meth:`compute_loss`, :meth:`model_inference`, ``get_samples_*``,
  :meth:`step`).

One argument has no JAX counterpart, because the JAX switch is a trace-time
global: ``fused_chains``. With ``False`` (the default, the reference's) each
step runs inside ``fused_chains_disabled()``, as the JAX Trainer traces its
step (trainer.py:405-413, 438-444): the port's kernel gates are closed and
DnCNN's hidden layers are separate convs under autograd. With ``True`` the
gates stay open, so a bf16 DnCNN's hidden chain trains on the stash kernel
(K6) and its stash backward, which is what ``jax.grad`` of a fused DnCNN
does in the JAX package.

Batches go to the model's device. Adversarial training is
``training/adversarial.py``. Waiting (ROADMAP queue 1): wandb/mlflow, the
orbax checkpoint backend, ``data_parallel`` and plotting.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import os
from typing import Optional

import numpy as np
import torch

from ..datasets.base import check_dataset
from ..device import resolve_device
from ..loss import PSNR, SupLoss
from ..ops.kernels.conv_chain import fused_chains_disabled
from ..utils.logger import AverageMeter

__all__ = ["Trainer", "test"]


def _to_list(v):
    if v is None:
        return []
    return list(v) if isinstance(v, (list, tuple)) else [v]


class Trainer:
    """Train a reconstruction model (trainer.py:55).

    :param model: reconstructor ``model(y, physics)``, an ``nn.Module``.
    :param physics: physics or list of physics (paired with the loaders).
    :param optimizer: a ``torch.optim`` optimizer over ``model.parameters()``
        (default ``Adam(lr=1e-3)``, optax's ``adam(1e-3)`` there).
    :param train_dataloader: loader or list of loaders yielding ``x``
        (online) or ``(x, y)`` / ``(x, y, params)`` (offline).
    :param losses: loss or list (default supervised).
    :param metrics: metric or list (default PSNR).
    :param online_measurements: measure ``y = physics(x)`` at each step.
    :param physics_generator: with online measurements, a
        :class:`~deepinv_tpu_torch.physics.generator.PhysicsGenerator` whose
        ``step(B)`` parameters update the physics before each measurement
        (a fresh mask, noise level, ... a sample).
    :param loop_random_online_physics: draw the same measurements every
        epoch (trainer.py:626).
    :param grad_clip: clip the gradient's global norm (``clip_grad_norm_``).
    :param early_stop: None | int (evaluations without improvement) | bool
        (``True`` means ``patience``).
    :param optimizer_step_multi_dataset: one optimizer step over the summed
        loss of all loaders (default), else one step per loader batch.
    :param check_grad: record each step's pre-clip gradient norm in
        ``check_grad_val``.
    :param save_path: checkpoint directory.
    :param fused_chains: leave the kernel gates open in the train step (see
        the module docstring); default False, the reference's configuration.

    Two-epoch supervised training of a small DnCNN on the CPU::

        import numpy as np, torch
        from deepinv_tpu_torch.training import Trainer
        from deepinv_tpu_torch.models import DnCNN, ArtifactRemoval
        from deepinv_tpu_torch.physics import Denoising, GaussianNoise
        from deepinv_tpu_torch.datasets import ArrayDataset, DataLoader
        xs = np.random.default_rng(0).random((8, 1, 16, 16)).astype("float32")
        model = ArtifactRemoval(DnCNN(1, 1, depth=2, nf=8, device="cpu"))
        trainer = Trainer(model, Denoising(GaussianNoise(0.1, device="cpu")),
                          optimizer=torch.optim.Adam(model.parameters(), lr=1e-3),
                          train_dataloader=DataLoader(ArrayDataset(xs), batch_size=4),
                          epochs=2, online_measurements=True, verbose=False)
        trainer.train()
        assert len(trainer.loss_history) == 2
    """

    def __init__(self, model, physics, optimizer=None, train_dataloader=None,
                 eval_dataloader=None, losses=None, metrics=None, epochs: int = 100,
                 online_measurements: bool = False, physics_generator=None,
                 loop_random_online_physics: bool = False, grad_clip: Optional[float] = None,
                 early_stop=False, patience: int = 5, optimizer_step_multi_dataset: bool = True,
                 compute_train_metrics: bool = True, check_grad: bool = False,
                 eval_interval: int = 1, save_path: Optional[str] = None, ckpt_interval: int = 1,
                 compare_no_learning: bool = False, no_learning_method="A_adjoint",
                 verbose: bool = True, seed: int = 0, fused_chains: bool = False):
        self.model = model
        self.physics = _to_list(physics)
        self.losses = _to_list(losses) if losses is not None else [SupLoss()]
        for l in self.losses:
            self.model = l.adapt_model(self.model)
        params = list(self.model.parameters())
        if optimizer is None and params:
            optimizer = torch.optim.Adam(params, lr=1e-3)
        self.optimizer = optimizer
        self.train_dataloader = _to_list(train_dataloader)
        self.eval_dataloader = _to_list(eval_dataloader)
        self.metrics = _to_list(metrics) if metrics is not None else [PSNR()]
        self.epochs = epochs
        self.online_measurements = online_measurements
        self.physics_generator = physics_generator
        self.loop_random_online_physics = loop_random_online_physics
        self.grad_clip = grad_clip
        if isinstance(early_stop, bool):
            self.early_stop = patience if early_stop else None
        else:
            self.early_stop = early_stop
        self.optimizer_step_multi_dataset = optimizer_step_multi_dataset
        self.compute_train_metrics = compute_train_metrics
        self.check_grad = check_grad
        self.eval_interval = eval_interval
        self.save_path = save_path
        self.ckpt_interval = ckpt_interval
        self.compare_no_learning = compare_no_learning
        self.no_learning_method = no_learning_method
        self.verbose = verbose
        self.seed = seed
        self.fused_chains = fused_chains
        self.epoch_start = 0
        self.epochs_run = 0
        self.loss_history = []
        self.eval_metrics_history = {}
        self.best_metric = None
        self.best_model = None
        self.G = len(self.train_dataloader) or 1
        self.current_train_iterators = None
        self.current_eval_iterators = None
        self._epoch_seed = None
        self._ite_in_epoch = 0
        self.reset_metrics()

    @property
    def device(self) -> torch.device:
        """The model's device, where every batch goes: that of its first
        parameter or buffer, else the default device of the entry points."""
        t = next(itertools.chain(self.model.parameters(), self.model.buffers()), None)
        return t.device if t is not None else resolve_device(None)

    def generator(self, *path) -> torch.Generator:
        """A generator on the model's device seeded from ``(seed, *path)``:
        the counterpart of ``fold_in`` of the JAX key."""
        s = int(np.random.SeedSequence([self.seed, *path]).generate_state(1)[0])
        return torch.Generator(device=self.device).manual_seed(s)

    def _chains(self):
        """The train step's kernel gates: closed unless ``fused_chains``."""
        return contextlib.nullcontext() if self.fused_chains else fused_chains_disabled()

    def _to_device(self, v):
        return torch.as_tensor(v, device=self.device)

    # -- setup (trainer.py:275) ------------------------------------------
    def setup_train(self, train: bool = True, **kwargs):
        """Normalize the loaders, check the datasets, reset the meters and
        make fresh iterators (trainer.py:275)."""
        self.train_dataloader = _to_list(self.train_dataloader)
        self.eval_dataloader = _to_list(self.eval_dataloader)
        for loader in self.train_dataloader + self.eval_dataloader:
            ds = getattr(loader, "dataset", None)
            if ds is not None:
                check_dataset(ds)
        self.G = len(self.train_dataloader) or 1
        self.reset_metrics()
        self.current_train_iterators = [iter(dl) for dl in self.train_dataloader]
        self.current_eval_iterators = [iter(dl) for dl in self.eval_dataloader]
        if self._epoch_seed is None:
            self._epoch_seed = 0

    def reset_metrics(self):
        """Reset every running meter (trainer.py:298)."""
        self.logs_total_loss_train = AverageMeter("loss")
        self.logs_losses_train = [AverageMeter(type(l).__name__) for l in self.losses]
        self.logs_metrics_train = [AverageMeter(type(m).__name__) for m in self.metrics]
        self.logs_metrics_eval = [AverageMeter(type(m).__name__) for m in self.metrics]
        self.logs_metrics_no_learning = [AverageMeter(type(m).__name__) for m in self.metrics]
        self.check_grad_val = AverageMeter("grad_norm")

    # -- overridable hooks (trainer.py:321-385) --------------------------
    def model_inference(self, y, physics, model=None, train: bool = False, generator=None):
        """Reconstruct ``x_net = model(y, physics)`` (trainer.py:321)."""
        model = self.model if model is None else model
        return model(y, physics)

    def compute_loss(self, model, x, y, physics, generator=None):
        """Total training loss and reconstruction ``(loss, x_net)``
        (trainer.py:332); stochastic losses draw from ``generator``. The
        train step calls ``backward()`` on the loss, so an override takes
        effect."""
        total, x_net, _ = self._loss_terms(model, x, y, physics, [generator] * len(self.losses))
        return total, x_net

    def _loss_terms(self, model, x, y, physics, generators):
        """``(total, x_net, {loss name: value})``, loss ``i`` drawing from
        ``generators[i]`` (trainer.py:343-360)."""
        x_net = self.model_inference(y, physics, model=model, train=True)
        total, terms = 0.0, {}
        for l, gen in zip(self.losses, generators):
            li = l(x_net=x_net, x=x, y=y, physics=physics, model=model, generator=gen).mean()
            terms[type(l).__name__] = li
            total = total + li
        return total, x_net, terms

    def _differentiable_loss(self, x, y, physics, path):
        """The step's loss; loss ``i`` draws from the generator of
        ``(*path, 1 + i)`` (``fold_in(key, i)``)."""
        if type(self).compute_loss is Trainer.compute_loss:
            gens = [self.generator(*path, 1 + i) for i in range(len(self.losses))]
            return self._loss_terms(self.model, x, y, physics, gens)
        total, x_net = self.compute_loss(self.model, x, y, physics, self.generator(*path, 1))
        return total, x_net, {"TotalLoss": total}

    def _metric_value(self, m, x_net, x) -> float:
        return float(m(x_net, x).mean())

    def compute_metrics(self, x, x_net, y, physics, logs, train: bool = True, epoch: int = None):
        """Update the metric meters over a batch and fill ``logs``
        (trainer.py:362). Returns ``(x_net, logs)``."""
        if x_net is None:
            with torch.no_grad():
                x_net = self.model_inference(y, physics)
        n = x.shape[0]
        meters = self.logs_metrics_train if train else self.logs_metrics_eval
        for i, m in enumerate(self.metrics):
            meters[i].update(self._metric_value(m, x_net, x), n=n)
            logs[type(m).__name__] = meters[i].avg
            if not train and self.compare_no_learning:
                with torch.no_grad():
                    x_nl = self.no_learning_inference(y, physics)
                self.logs_metrics_no_learning[i].update(self._metric_value(m, x_nl, x), n=n)
                logs[f"{type(m).__name__} no learning"] = self.logs_metrics_no_learning[i].avg
        return x_net, logs

    def check_clip_grad(self):
        """Clip the gradient's global norm to ``grad_clip`` and record the
        pre-clip norm in ``check_grad_val`` when ``check_grad`` is set
        (trainer.py:387). Returns the norm, or None if neither is set."""
        if self.grad_clip is None and not self.check_grad:
            return None
        max_norm = self.grad_clip if self.grad_clip is not None else float("inf")
        gnorm = torch.nn.utils.clip_grad_norm_(self.model.parameters(), max_norm)
        if self.check_grad:
            self.check_grad_val.update(float(gnorm))
        return gnorm

    def _optimizer_step(self):
        self.check_clip_grad()
        self.optimizer.step()

    # -- samples (trainer.py:458-488) ------------------------------------
    def get_samples_online(self, batch, physics, generator, param_generator=None):
        """Measure ``y = physics(x)`` with ``generator`` (trainer.py:458),
        after updating the physics with ``physics_generator.step(B)`` drawn
        from ``param_generator``."""
        x = self._to_device(batch[0] if isinstance(batch, (tuple, list)) else batch)
        if self.physics_generator is not None:
            params = self.physics_generator.step(x.shape[0], generator=param_generator)
            physics = physics.update(**params)
        with torch.no_grad():
            y = physics(x, generator=generator)
        return x, y, physics

    def get_samples_offline(self, batch, physics):
        """Stored ``(x, y[, params])`` pairs (trainer.py:469)."""
        if not isinstance(batch, (tuple, list)) or len(batch) < 2:
            raise ValueError("offline training requires (x, y) or (x, y, params) batches")
        x, y = self._to_device(batch[0]), self._to_device(batch[1])
        if len(batch) > 2 and isinstance(batch[2], dict):
            physics = physics.update(**{k: self._to_device(v) for k, v in batch[2].items()})
        return x, y, physics

    def get_samples(self, batch, physics, generator, param_generator=None):
        """A batch as ``(x, y, physics)`` (trainer.py:484)."""
        if self.online_measurements:
            return self.get_samples_online(batch, physics, generator, param_generator)
        return self.get_samples_offline(batch, physics)

    def _sample_generators(self, *path):
        """The generators of a batch's measurement and of its physics
        parameters, ``path`` and ``(*path, 1)``: the split of the JAX key
        into ``kn`` and ``kg`` (trainer.py:462)."""
        return self.generator(*path), (self.generator(*path, 1)
                                       if self.physics_generator is not None else None)

    # -- one train or eval iteration (trainer.py:491) --------------------
    def step(self, epoch, train_ite=None, train: bool = True, last_batch: bool = False):
        """One batch from each loader, in a random order (trainer.py:491).
        With ``optimizer_step_multi_dataset`` the gradients of all loaders
        add up in ``.grad`` and one optimizer step follows; otherwise each
        loader batch takes its own step."""
        iterators = self.current_train_iterators if train else self.current_eval_iterators
        G_perm = np.random.permutation(self.G if train else len(iterators))
        logs = {}
        multi = train and self.optimizer_step_multi_dataset and len(G_perm) > 1
        if multi:
            self.optimizer.zero_grad(set_to_none=True)
        names = [type(l).__name__ for l in self.losses]
        for g in G_perm:
            batch = next(iterators[g])
            physics = self.physics[g % len(self.physics)]
            path = (self._epoch_seed, self._ite_in_epoch, int(g))
            x, y, physics = self.get_samples(batch, physics, *self._sample_generators(*path, 0))
            n = x.shape[0]
            if train:
                if not multi:
                    self.optimizer.zero_grad(set_to_none=True)
                with self._chains():
                    loss, x_net, terms = self._differentiable_loss(x, y, physics, path)
                    loss.backward()
                if not multi:
                    self._optimizer_step()
                x_net = x_net.detach()
                self.logs_total_loss_train.update(float(loss.detach()), n=n)
                logs["TotalLoss"] = self.logs_total_loss_train.avg
                for i, name in enumerate(names):
                    if name in terms:
                        self.logs_losses_train[i].update(float(terms[name].detach()), n=n)
                        if len(self.losses) > 1:
                            logs[name] = self.logs_losses_train[i].avg
                if self.compute_train_metrics:
                    x_net, logs = self.compute_metrics(x, x_net, y, physics, logs, train=True,
                                                       epoch=epoch)
            else:
                with torch.no_grad():
                    x_net = self.model_inference(y, physics)
                x_net, logs = self.compute_metrics(x, x_net, y, physics, logs, train=False,
                                                   epoch=epoch)
        if multi:
            self._optimizer_step()
        self._ite_in_epoch += 1
        if last_batch and self.verbose:
            body = ", ".join(f"{k}={round(v, 5)}" for k, v in logs.items())
            print(f"{'Train' if train else 'Eval'} epoch {epoch}: {body}")
        return logs

    # -- training loop (trainer.py:620) ----------------------------------
    def train(self):
        """Run the epochs; returns the model."""
        self.setup_train(train=True)
        for epoch in range(self.epoch_start, self.epochs):
            self._epoch_seed = 0 if self.loop_random_online_physics else epoch
            self.reset_metrics()
            self._ite_in_epoch = 0
            self.current_train_iterators = [iter(dl) for dl in self.train_dataloader]
            batches = min(len(dl) for dl in self.train_dataloader)
            np.random.seed(self.seed + epoch)
            for i in range(batches):
                self.step(epoch, train_ite=epoch * batches + i, train=True,
                          last_batch=(i == batches - 1))
            self.loss_history.append(self.logs_total_loss_train.avg)
            self.epochs_run = epoch + 1

            if self.eval_dataloader and (epoch + 1) % self.eval_interval == 0:
                eval_metrics = self.test(self.eval_dataloader)
                first = list(eval_metrics.values())[0]
                for k, v in eval_metrics.items():
                    self.eval_metrics_history.setdefault(k, []).append(v)
                higher = not getattr(self.metrics[0], "lower_better", True)
                if self.best_metric is None or (
                        first > self.best_metric if higher else first < self.best_metric):
                    self.best_metric = first
                    self.best_model = copy.deepcopy(self.model)
                    if self.save_path:
                        self.save_model(os.path.join(self.save_path, "ckp_best.pkl"), epoch)
                if self.stop_criterion(epoch, epoch * batches + batches - 1):
                    break
            if self.save_path and (epoch + 1) % self.ckpt_interval == 0:
                self.save_model(os.path.join(self.save_path, f"ckp_{epoch}.pkl"), epoch)
        return self.model

    def stop_criterion(self, epoch, train_ite=None, **kwargs):
        """Early stop when the first eval metric has not improved over the
        last ``early_stop`` evaluations (trainer.py:674)."""
        if not self.early_stop or not self.eval_metrics_history:
            return False
        history = self.eval_metrics_history.get(type(self.metrics[0]).__name__)
        if not history:
            history = next(iter(self.eval_metrics_history.values()))
        lower_better = getattr(self.metrics[0], "lower_better", True)
        best = min(history) if lower_better else max(history)
        best_epoch = history.index(best) * self.eval_interval
        stop = epoch > self.early_stop * self.eval_interval + best_epoch
        if stop and self.verbose:
            print(f"Early stopping at epoch {epoch}: first eval metric has not improved in "
                  f"the last {self.early_stop} evaluations.")
        return stop

    # -- evaluation (trainer.py:696) -------------------------------------
    def test(self, dataloaders=None, train: bool = False):
        """Average each metric over the loaders (trainer.py:696); returns
        ``{name: mean, name_std: deviation}`` (and the no-learning baseline's
        means with ``compare_no_learning``). Online measurements draw from
        the generator of ``(10000, step)`` (``fold_in`` of the key of
        ``seed + 10000``, trainer.py:702, 718)."""
        loaders = _to_list(dataloaders) if dataloaders is not None else self.eval_dataloader
        meters = {type(m).__name__: AverageMeter() for m in self.metrics}
        nl_meters = {type(m).__name__: AverageMeter() for m in self.metrics}
        with torch.no_grad():
            for g, dl in enumerate(loaders):
                physics = self.physics[g % len(self.physics)]
                for step, batch in enumerate(dl):
                    x, y, cur = self.get_samples(batch, physics,
                                                 *self._sample_generators(10_000, step))
                    x_net = self.model_inference(y, cur)
                    for m in self.metrics:
                        meters[type(m).__name__].update(self._metric_value(m, x_net, x),
                                                        n=x.shape[0])
                    if self.compare_no_learning:
                        x_nl = self.no_learning_inference(y, cur)
                        for m in self.metrics:
                            nl_meters[type(m).__name__].update(self._metric_value(m, x_nl, x),
                                                               n=x.shape[0])
        out = {}
        for name, meter in meters.items():
            out[name] = meter.avg
            out[name + "_std"] = meter.std
        if self.compare_no_learning:
            for name, meter in nl_meters.items():
                out[name + " no learning"] = meter.avg
                out[name + "_no_learning"] = meter.avg
        return out

    def no_learning_inference(self, y, physics):
        """Baseline reconstruction (trainer.py:747)."""
        m = self.no_learning_method
        if not isinstance(m, str) and callable(m):
            return m(y, physics)
        if m == "A_adjoint":
            return physics.A_adjoint(y)
        if m == "A_dagger":
            return physics.A_dagger(y)
        if m == "prox_l2":
            return physics.prox_l2(physics.A_adjoint(y), y, 1.0)
        if m == "y":
            return y
        raise ValueError(f"no-learning method {m!r} not recognized")

    # -- checkpoints (trainer.py:781-850) --------------------------------
    def save_model(self, path: str, epoch: int = 0):
        """Save the epoch, the model's and the optimizer's state dicts and
        the histories (``torch.save``, a pickle; trainer.py:781)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.save({"epoch": epoch, "model": self.model.state_dict(),
                    "optimizer": self.optimizer.state_dict(),
                    "loss_history": list(self.loss_history),
                    "eval_metrics_history": self.eval_metrics_history}, path)

    def load_model(self, path: str):
        """Restore a checkpoint in place (trainer.py:804); training resumes
        at the next epoch."""
        payload = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(payload["model"])
        self.optimizer.load_state_dict(payload["optimizer"])
        self.epoch_start = payload["epoch"] + 1
        self.loss_history = list(payload["loss_history"])
        self.eval_metrics_history = payload.get("eval_metrics_history", {})
        return self

    def save_best_model(self, epoch=None, train_ite=None, **kwargs):
        """Write the best model so far to ``save_path/ckp_best.pkl``
        (trainer.py:827)."""
        if not self.save_path:
            raise ValueError("save_best_model requires save_path")
        if self.best_model is not None:
            model, self.model = self.model, self.best_model
            try:
                self.save_model(os.path.join(self.save_path, "ckp_best.pkl"))
            finally:
                self.model = model

    def load_best_model(self):
        """The best model tracked during training, in memory or from
        ``save_path/ckp_best.pkl`` (trainer.py:839)."""
        if self.best_model is not None:
            self.model = self.best_model
            return self
        if self.save_path:
            path = os.path.join(self.save_path, "ckp_best.pkl")
            if os.path.exists(path):
                return self.load_model(path)
        raise ValueError("no best model tracked (train with eval_dataloader)")


def test(model, test_dataloader, physics, metrics=None, online_measurements=False,
         physics_generator=None, **kwargs):
    """Standalone evaluation (trainer.py:853)."""
    trainer = Trainer(model, physics, train_dataloader=None, metrics=metrics,
                      online_measurements=online_measurements,
                      physics_generator=physics_generator,
                      verbose=kwargs.pop("verbose", False), **kwargs)
    return trainer.test(_to_list(test_dataloader))
