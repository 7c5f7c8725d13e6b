"""Measurement-splitting losses (port of deepinv_tpu/loss/measplit.py):
:class:`SplittingLoss` with its :class:`SplittingModel`, and
:class:`Neighbor2Neighbor`.

A split draws a mask, feeds ``M y`` through ``M A`` to the model and scores
the reconstruction on the complement. The JAX wrapper shares its mask with
the loss through the key; here the loss hands the model its generator and
takes the mask back (``return_mask=True``), so the two agree. Every draw can
be handed in instead (``masks=``, ``mask=``, ``choice=``).
"""

from __future__ import annotations

import torch
from torch import nn

from .base import Loss
from .metric import MSE

__all__ = ["SplittingLoss", "SplittingModel", "Neighbor2Neighbor"]


def _base_mask(physics):
    """The physics' own mask, or None (measplit.py:30)."""
    m = getattr(physics, "mask", None)
    if m is None or isinstance(m, (int, float)):
        return None
    return m


def sample_split_mask(y, physics, generator, split_ratio, pixelwise, mask_generator):
    """One splitting mask, a subset of the physics' mask where it has one
    (measplit.py:38): from ``mask_generator`` if given, else Bernoulli
    (``split_ratio``) per pixel, shared by the channels if ``pixelwise``."""
    input_mask = _base_mask(physics)
    if mask_generator is not None:
        m = mask_generator.step(y.shape[0], generator=generator, input_mask=input_mask)["mask"]
        m = m.to(device=y.device, dtype=y.dtype).broadcast_to(y.shape)
        return m * input_mask if input_mask is not None else m
    shape = list(y.shape)
    if pixelwise:
        shape[1] = 1
    dev = generator.device if generator is not None else y.device
    m = (torch.rand(shape, generator=generator, device=dev) < split_ratio).to(y.device, y.dtype)
    m = m.broadcast_to(y.shape)
    return m * input_mask if input_mask is not None else m


def split(mask, y, physics=None):
    """``y1 = M y`` and ``A1 = M A`` with the physics' noise model
    (measplit.py:60): a physics with a mask takes ``mask * its mask``, any
    other becomes ``compose(physics, Inpainting(mask))`` with the whole
    batched mask."""
    y1 = mask * y
    if physics is None:
        return y1
    base = _base_mask(physics)
    if base is not None:
        return y1, physics.update(mask=mask * base)
    from ..physics.base import compose, replace
    from ..physics.inpainting import Inpainting

    inp = Inpainting(img_size=tuple(y.shape[1:]), mask=mask, device=y.device)
    return y1, replace(compose(physics, inp), noise_model=getattr(physics, "noise_model", None))


class SplittingModel(nn.Module):
    """Input-splitting wrapper (measplit.py:83): one random split feeds the
    model in training; in evaluation the output is averaged over
    ``eval_n_samples`` splits (``eval_split_input``), optionally over the
    output complements (``eval_split_output``), or the whole measurement is
    used. ``train`` is a forward keyword as in the JAX package
    (``train_aware``, which the Trainer reads), not ``nn.Module``'s mode.

    :param noise_model: further noise on the split input in training
        (Robust-SSDU).
    """

    train_aware = True

    def __init__(self, model, split_ratio=0.9, mask_generator=None, eval_n_samples=5,
                 eval_split_input=True, eval_split_output=False, pixelwise=True,
                 noise_model=None):
        super().__init__()
        self.model = model
        self.split_ratio = split_ratio
        self.mask_generator = mask_generator
        self.eval_n_samples = eval_n_samples
        self.eval_split_input = eval_split_input
        self.eval_split_output = eval_split_output
        self.pixelwise = pixelwise
        self.noise_model = noise_model

    def forward(self, y, physics, generator=None, train=False, return_mask=False, masks=None,
                noise_draws=None):
        """``masks``: the masks of the splits, one a sample; ``noise_draws``:
        the Robust-SSDU noise's draws, one a sample; each drawn from
        ``generator`` if None (mask, then noise, split by split)."""
        if not train and not self.eval_split_input:
            out = self.model(y, physics)
            return (out, None) if return_mask else out
        n = 1 if train else max(self.eval_n_samples, 1)
        split_output = (not train) and self.eval_split_output
        out, m2_sum, mask0 = 0.0, 0.0, None
        for i in range(n):
            if masks is not None:
                mask = torch.as_tensor(masks[i], dtype=y.dtype, device=y.device)
            else:
                mask = sample_split_mask(y, physics, generator, self.split_ratio,
                                         self.pixelwise, self.mask_generator)
            if mask0 is None:
                mask0 = mask
            y1, p1 = split(mask, y, physics)
            if self.noise_model is not None and train:
                draws = None if noise_draws is None else [noise_draws[i]]
                y1 = mask * self.noise_model(y1, generator=generator, draws=draws)
            o = self.model(y1, p1)
            if split_output:
                base = _base_mask(physics)
                m2 = (base if base is not None else 1.0) - mask
                out = out + m2 * o
                m2_sum = m2_sum + m2
            else:
                out = out + o / n
        if split_output:
            out = out / torch.clamp(m2_sum, min=1e-6)
        return (out, mask0) if return_mask else out


class SplittingLoss(Loss):
    r"""Measurement splitting (measplit.py:149): ``y1 = M y`` feeds the
    adapted model; the loss is ``metric(M_2 A(xhat), M_2 y) / mean(M_2)``
    on the complement ``M_2 = M_A - M``.

    :param split_ratio: the share of measurements kept as input.
    :param mask_generator: a PhysicsGenerator of splitting masks (default
        Bernoulli per pixel).
    :param eval_n_samples: splits averaged in evaluation.
    :param eval_split_input: split the input in evaluation.
    :param eval_split_output: average only the output complements.
    :param pixelwise: one mask for all channels.
    :param normalize_loss: divide by the complement's density.
    """

    def __init__(self, metric=None, split_ratio: float = 0.9, mask_generator=None,
                 eval_n_samples: int = 5, eval_split_input: bool = True,
                 eval_split_output: bool = False, pixelwise: bool = True,
                 normalize_loss: bool = True):
        self.metric = metric if metric is not None else MSE()
        self.split_ratio = split_ratio
        self.mask_generator = mask_generator
        self.eval_n_samples = eval_n_samples
        self.eval_split_input = eval_split_input
        self.eval_split_output = eval_split_output
        self.pixelwise = pixelwise
        self.normalize_loss = normalize_loss

    split = staticmethod(split)

    def sample_mask(self, y, generator=None, physics=None):
        return sample_split_mask(y, physics, generator, self.split_ratio, self.pixelwise,
                                 self.mask_generator)

    def __call__(self, x_net=None, y=None, physics=None, model=None, generator=None, mask=None,
                 **kwargs):
        """``mask``: the split's mask, drawn from ``generator`` if None."""
        masks = None if mask is None else [mask]
        if isinstance(model, SplittingModel):
            x1, mask = model(y, physics, generator=generator, train=True, return_mask=True,
                             masks=masks)
        else:
            if mask is None:
                mask = self.sample_mask(y, generator, physics)
            y1, p1 = split(mask, y, physics)
            x1 = model(y1, p1)
        base = _base_mask(physics)
        mask2 = (base if base is not None else 1.0) - mask
        loss = self.metric(mask2 * physics.A(x1), mask2 * y)
        if self.normalize_loss:
            loss = loss / torch.clamp(torch.as_tensor(mask2).mean(), min=1e-6)
        return loss

    def adapt_model(self, model):
        """Wrap the model in a :class:`SplittingModel` (measplit.py:229)."""
        if isinstance(model, SplittingModel):
            return model
        return SplittingModel(model, split_ratio=self.split_ratio,
                              mask_generator=self.mask_generator,
                              eval_n_samples=self.eval_n_samples,
                              eval_split_input=self.eval_split_input,
                              eval_split_output=self.eval_split_output,
                              pixelwise=self.pixelwise)


SplittingLoss.SplittingModel = SplittingModel

_IDX_PAIR = [[0, 1], [0, 2], [1, 3], [2, 3], [1, 0], [2, 0], [3, 1], [3, 2]]


class Neighbor2Neighbor(Loss):
    r"""Neighbor2Neighbor (measplit.py:249, Huang et al. 2021): two
    neighbouring pixels of each 2x2 cell make a pair of sub-images; the loss
    is the reconstruction of one from the other plus ``gamma`` times a
    consistency with the full image's reconstruction, which runs without a
    gradient."""

    def __init__(self, metric=None, gamma: float = 2.0):
        self.metric = metric if metric is not None else MSE()
        self.gamma = gamma

    @staticmethod
    def space_to_depth(x, block_size: int):
        """``(B, C, H, W) -> (B, C b^2, H/b, W/b)`` in torch's ``unfold``
        order (measplit.py:258)."""
        B, C, H, W = x.shape
        b = block_size
        v = x.reshape(B, C, H // b, b, W // b, b).permute(0, 1, 3, 5, 2, 4)
        return v.reshape(B, C * b * b, H // b, W // b)

    @staticmethod
    def generate_mask_pair(img, generator=None, choice=None):
        """Two flat boolean masks of length ``B H/2 W/2 4``, each picking one
        pixel of every cell, the pair drawn from the adjacent-pair table
        (measplit.py:269); ``choice`` the table rows, drawn if None."""
        B, C, H, W = img.shape
        ncell = B * (H // 2) * (W // 2)
        dev = img.device
        table = torch.tensor(_IDX_PAIR, device=dev)
        if choice is None:
            gdev = generator.device if generator is not None else dev
            choice = torch.randint(0, 8, (ncell,), generator=generator, device=gdev)
        rd = torch.as_tensor(choice, device=dev).long().reshape(-1)
        pair = table[rd] + (torch.arange(ncell, device=dev) * 4)[:, None]
        mask1 = torch.zeros(ncell * 4, dtype=torch.bool, device=dev)
        mask2 = torch.zeros(ncell * 4, dtype=torch.bool, device=dev)
        mask1[pair[:, 0]] = True
        mask2[pair[:, 1]] = True
        return mask1, mask2

    @classmethod
    def generate_subimages(cls, img, mask):
        """The masked pixel of each cell, ``(B, C, H/2, W/2)``
        (measplit.py:286)."""
        B, C, H, W = img.shape
        outs = []
        for i in range(C):
            per = cls.space_to_depth(img[:, i:i + 1], 2).permute(0, 2, 3, 1).reshape(-1, 4)
            sel = per[mask.reshape(-1, 4)]
            outs.append(sel.reshape(B, H // 2, W // 2, 1).permute(0, 3, 1, 2))
        return torch.cat(outs, 1)

    @staticmethod
    def _subsample(y, choice, offset):
        """One pixel of each cell, ``choice`` in 0..3 a cell
        (measplit.py:300)."""
        B, C, H, W = y.shape
        H2, W2 = H // 2, W // 2
        cells = y[:, :, :H2 * 2, :W2 * 2].reshape(B, C, H2, 2, W2, 2)
        cells = cells.movedim(3, -2).reshape(B, C, H2, W2, 4)
        idx = ((choice + offset) % 4).expand(B, C, H2, W2)[..., None]
        return torch.gather(cells, -1, idx)[..., 0]

    def __call__(self, y=None, physics=None, model=None, x_net=None, generator=None,
                 choice=None, **kwargs):
        """``choice``: the pair table's rows, ``(B, 1, H/2, W/2)`` in 0..7,
        drawn from ``generator`` if None."""
        B, C, H, W = y.shape
        H2, W2 = H // 2, W // 2
        table = torch.tensor(_IDX_PAIR, device=y.device)
        if choice is None:
            gdev = generator.device if generator is not None else y.device
            choice = torch.randint(0, 8, (B, 1, H2, W2), generator=generator, device=gdev)
        pair = table[torch.as_tensor(choice, device=y.device).long()]
        c1, c2 = pair[..., 0], pair[..., 1]
        g1 = self._subsample(y, c1, 0)
        g2 = self._subsample(y, c2, 0)
        f_g1 = model(g1, physics)
        with torch.no_grad():
            f_y = model(y, physics)
        f_y1 = self._subsample(f_y, c1, 0)
        f_y2 = self._subsample(f_y, c2, 0)
        return self.metric(f_g1, g2) + self.gamma * self.metric(f_g1 - f_y1, g2 - f_y2)
