"""Weights from elsewhere: from the JAX package (:func:`load_jax_params`, new
in the port) and from upstream torch checkpoints (port of
deepinv_tpu/models/convert.py).

The port's modules use the JAX modules' attribute names, so a JAX leaf at
tree path ``m_down1.layers.0.conv1.weight`` is the port's state-dict entry of
the same name. A module whose names differ (``ADMUNet``'s flat dict ``p``,
``NCSNpp``'s ``enc`` / ``dec`` dictionaries) maps them by a ``jax_names()``
method. Flattening a JAX module into that ``{path: numpy array}``
dictionary needs JAX and is left to the caller.

Upstream checkpoints name the same tensors otherwise (DRUNet's
``m_down1.0.res.0.weight``, SRResNet's ``blocks.0.layers.0.weight``): each
``*_names`` function maps the port's names of a model to upstream's, and
:func:`port_weights` copies a checkpoint through such a map. Conv weights
are OIHW on both sides and transposed-conv weights IOHW, so porting is a
renaming.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

__all__ = ["load_jax_params", "load_torch_checkpoint", "port_weights", "upstream_state_dict",
           "dncnn_names", "drunet_names", "srresnet_names", "dsccp_names", "adm_names",
           "ncsnpp_names", "restormer_names", "swinir_names", "scunet_names", "ram_names",
           "vgg16_names", "kernel_network_names", "deal_names", "port_dncnn", "port_drunet",
           "port_srresnet", "port_dsccp", "port_ncsnpp", "port_restormer", "port_swinir",
           "port_scunet", "port_ram", "port_vgg16", "port_kernel_network", "port_deal"]


def load_jax_params(module: nn.Module, arrays: dict) -> nn.Module:
    """Copy ``arrays`` (``{dotted path: np.ndarray}``) into ``module``'s
    parameters and buffers, in place, keeping each tensor's dtype and device.
    Where ``module`` has ``jax_names()`` (``{state-dict name: JAX tree
    path}``), each tensor is read from its path; leaves the JAX module derives
    from its configuration (``ADMUNet``'s alpha tables) are then not read.

    :raises KeyError: if a key of the module is missing from ``arrays`` or
        ``arrays`` has a key the module does not.
    :raises ValueError: if a shape differs.
    :return: ``module``.
    """
    state = module.state_dict(keep_vars=True)
    if hasattr(module, "jax_names"):
        names = module.jax_names()
        missing = sorted(k for k, path in names.items() if path not in arrays)
        if missing:
            raise KeyError(f"load_jax_params: missing {missing[:8]} ({len(missing)} missing)")
        arrays = {k: arrays[path] for k, path in names.items()}
    missing = sorted(set(state) - set(arrays))
    extra = sorted(set(arrays) - set(state))
    if missing or extra:
        raise KeyError(f"load_jax_params: missing {missing[:8]}, unexpected {extra[:8]} "
                       f"({len(missing)} missing, {len(extra)} unexpected)")
    for k, t in state.items():
        a = np.asarray(arrays[k])
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"load_jax_params: {k} has shape {tuple(a.shape)}, "
                             f"the module expects {tuple(t.shape)}")
    with torch.no_grad():
        for k, t in state.items():
            t.copy_(torch.from_numpy(np.array(arrays[k], dtype=np.float32)))
    return module


def load_torch_checkpoint(path) -> dict:
    """A state dict as ``{name: np.ndarray}`` from a ``.pth`` (read by
    ``torch.load(weights_only=True)`` on the CPU), an ``.npz`` or a dict,
    unwrapped from ``params_ema``, ``params`` or ``state_dict``
    (convert.py:20)."""
    if isinstance(path, dict):
        sd = path
    elif str(path).endswith(".npz"):
        with np.load(path) as f:
            sd = dict(f)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    for wrap in ("params_ema", "params", "state_dict"):
        if wrap in sd and isinstance(sd[wrap], dict):
            sd = sd[wrap]
            break
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in sd.items()}


def _conv(names: dict, ours: str, theirs: str, bias: bool = True):
    names[f"{ours}.weight"] = f"{theirs}.weight"
    if bias:
        names[f"{ours}.bias"] = f"{theirs}.bias"


def dncnn_names(model) -> dict:
    """DnCNN: upstream's names are the port's (convert.py:48)."""
    return {k: k for k in model.state_dict()}


def drunet_names(model) -> dict:
    """DRUNet (convert.py:347): a ResBlock's convs are upstream's ``res.0``
    and ``res.2``, and the stages are indexed without ``layers``."""
    names = {}
    for k in ("m_head", "m_tail"):
        _conv(names, k, k, bias=False)
    nb = model.nb
    for stage in ("m_down1", "m_down2", "m_down3", "m_body", "m_up3", "m_up2", "m_up1"):
        first = 1 if stage.startswith("m_up") else 0
        for i in range(first, first + nb):
            _conv(names, f"{stage}.layers.{i}.conv1", f"{stage}.{i}.res.0", bias=False)
            _conv(names, f"{stage}.layers.{i}.conv2", f"{stage}.{i}.res.2", bias=False)
        if stage.startswith("m_down"):
            _conv(names, f"{stage}.layers.{nb}", f"{stage}.{nb}", bias=False)
        elif stage != "m_body":
            _conv(names, f"{stage}.layers.0", f"{stage}.0", bias=False)
    return names


def _norm(names: dict, ours: str, theirs: str):
    for attr in ("weight", "bias", "running_mean", "running_var"):
        names[f"{ours}.{attr}"] = f"{theirs}.{attr}"


def srresnet_names(model) -> dict:
    """SRResNet (convert.py:233): ``fe.0``/``fe.1``, each block's
    ``layers.0``-``layers.4``, ``block.0``/``block.1``, ``upsampling.s.0`` and
    ``.2``, ``final_conv.0``."""
    names = {}
    _conv(names, "fe_conv", "fe.0")
    names["fe_act.weight"] = "fe.1.weight"
    for i in range(len(model.blocks)):
        p = f"blocks.{i}.layers"
        _conv(names, f"blocks.{i}.conv1", f"{p}.0")
        _norm(names, f"blocks.{i}.n1", f"{p}.1")
        names[f"blocks.{i}.act.weight"] = f"{p}.2.weight"
        _conv(names, f"blocks.{i}.conv2", f"{p}.3")
        _norm(names, f"blocks.{i}.n2", f"{p}.4")
    _conv(names, "block_conv", "block.0")
    _norm(names, "block_norm", "block.1")
    for s in range(len(model.up_convs)):
        _conv(names, f"up_convs.{s}", f"upsampling.{s}.0")
        names[f"up_acts.{s}.weight"] = f"upsampling.{s}.2.weight"
    _conv(names, "final_conv", "final_conv.0")
    state = model.state_dict()
    return {k: v for k, v in names.items() if k in state}


def dsccp_names(model) -> dict:
    """DScCP (convert.py:266): the tied kernels are upstream's even convs
    ``conv.{2k}``, and ``mu``."""
    names = {f"weights.{k}": f"conv.{2 * k}.weight" for k in range(model.depth)}
    names["mu"] = "mu"
    return names


def _optional(model, name: str) -> bool:
    """Whether a checkpoint may lack ``name``: a bias, a norm's tensors, a
    PReLU slope (convert.py:41-45, 236-247), NCSN++'s Fourier frequencies and
    augmentation weights (:182-204) or a RAM head's zero skip (:331)."""
    owner, _, leaf = name.rpartition(".")
    if leaf in ("bias", "running_mean", "running_var", "freqs", "map_augment_w"):
        return True
    if owner.endswith("zero_conv_skip"):
        return True
    return type(model.get_submodule(owner)).__name__ in ("BatchNorm2d", "_LayerNorm2d", "PReLU")


def port_weights(model: nn.Module, sd: dict, names: dict) -> nn.Module:
    """Copy the upstream state dict ``sd`` into ``model`` through ``names``
    (``{port name: upstream name}``), in place, each tensor keeping its
    dtype, device and memory format. Weights must be there; biases, norm
    statistics and PReLU slopes that ``sd`` lacks keep their values, as in
    the JAX ``port_*`` functions.

    :raises KeyError: if a weight of ``names`` is missing from ``sd``.
    :raises ValueError: if a shape differs.
    """
    state = model.state_dict(keep_vars=True)
    with torch.no_grad():
        for ours, theirs in names.items():
            if theirs not in sd:
                if _optional(model, ours):
                    continue
                raise KeyError(f"port_weights: the checkpoint has no {theirs!r} (for {ours!r})")
            t, a = state[ours], np.asarray(sd[theirs])
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"port_weights: {theirs} has shape {tuple(a.shape)}, "
                                 f"{ours} expects {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(a, dtype=np.float32)))
    return model


def _renamed(model, rules, skip=()) -> dict:
    """``{port name: upstream name}`` of every state-dict entry of ``model``
    but those ending in one of ``skip``, each renamed by the ``(pattern,
    replacement)`` regular expressions ``rules`` in turn."""
    names = {}
    for k in model.state_dict():
        if k.endswith(tuple(skip)):
            continue
        v = k
        for pat, rep in rules:
            v = re.sub(pat, rep, v)
        names[k] = v
    return names


def adm_names(model) -> dict:
    """ADMUNet: its names are guided-diffusion's (adm.py:1-17)."""
    return {k: k for k in model.state_dict()}


def ncsnpp_names(model) -> dict:
    """NCSN++ (convert.py:180): the mapping and affine layers are upstream's
    ``map_layer0.weight``, ``enc.{name}.affine.bias``; the FIR filters are
    constants and left out."""
    return _renamed(model, [(r"(map_\w+)_w$", r"\1.weight"), (r"(map_\w+)_b$", r"\1.bias"),
                            (r"affine_w$", "affine.weight"), (r"affine_b$", "affine.bias")],
                    skip=("resample_filter",))


def restormer_names(model) -> dict:
    """Restormer (convert.py:141): upstream's level, layer and conv names."""
    levels = {"enc": ("encoder_level1", "encoder_level2", "encoder_level3", "latent"),
              "dec": ("decoder_level3", "decoder_level2", "decoder_level1")}
    rules = [(rf"^{top}\.{i}\.", f"{name}.") for top, names in levels.items()
             for i, name in enumerate(names)]
    rules += [(rf"^downs\.{i}\.conv\.", f"{n}.body.0.")
              for i, n in enumerate(("down1_2", "down2_3", "down3_4"))]
    rules += [(rf"^ups\.{i}\.conv\.", f"{n}.body.0.")
              for i, n in enumerate(("up4_3", "up3_2", "up2_1"))]
    rules += [(r"^reduce\.0\.", "reduce_chan_level3."), (r"^reduce\.1\.", "reduce_chan_level2."),
              (r"^refine\.", "refinement."), (r"^patch_embed\.", "patch_embed.proj."),
              (r"^out_conv\.", "output."), (r"\.(norm[12])\.", r".\1.body."),
              (r"\.attn\.qkv_dw\.", ".attn.qkv_dwconv."), (r"\.attn\.proj\.", ".attn.project_out."),
              (r"\.ffn\.inp\.", ".ffn.project_in."), (r"\.ffn\.dw\.", ".ffn.dwconv."),
              (r"\.ffn\.out\.", ".ffn.project_out.")]
    return _renamed(model, rules)


def swinir_names(model) -> dict:
    """SwinIR (convert.py:64): ``patch_embed.norm``, each block under
    ``residual_group`` with ``mlp.fc1``/``mlp.fc2``, the pixel-shuffle
    convs at even indices; the image mean is a constant and left out."""
    rules = [(r"^patch_norm\.", "patch_embed.norm."),
             (r"^layers\.(\d+)\.blocks\.", r"layers.\1.residual_group.blocks."),
             (r"\.(fc[12])\.", r".mlp.\1."),
             (r"^conv_before_upsample\.", "conv_before_upsample.0.")]
    if model.upsampler == "pixelshuffle":
        rules.append((r"^upsample\.(\d+)\.", lambda m: f"upsample.{2 * int(m.group(1))}."))
    return _renamed(model, rules, skip=("mean",))


def scunet_names(model) -> dict:
    """SCUNet (convert.py:103): the head and tail under ``.0``, a block's
    ``conv_block.0``/``.2`` and ``mlp.0``/``.2``."""
    return _renamed(model, [(r"^m_(head|tail)\.", r"m_\1.0."), (r"\.conv_a\.", ".conv_block.0."),
                            (r"\.conv_b\.", ".conv_block.2."), (r"\.mlp_fc1\.", ".mlp.0."),
                            (r"\.mlp_fc2\.", ".mlp.2.")])


def ram_names(model) -> dict:
    """RAM (convert.py:306): ``m_head.conv{i}``, ``tail{i}``/``head{i}``,
    a head block's ``conv1{k}``/``conv2{k}``/``skipconv{k}``."""
    return _renamed(model, [(r"\.convs\.(\d+)\.", r".conv\1."), (r"\.tails\.(\d+)\.", r".tail\1."),
                            (r"\.heads\.(\d+)\.", r".head\1."), (r"\.convs([12])\.(\d+)\.", r".conv\1\2."),
                            (r"\.skipconvs\.(\d+)\.", r".skipconv\1.")])


def vgg16_names(model) -> dict:
    """VGG16Features (vgg.py:80): torchvision's ``features.<idx>`` of each
    conv; the ImageNet mean and deviation are constants and left out."""
    from .vgg import _TORCH_IDX

    names = {}
    for i, idx in enumerate(_TORCH_IDX):
        _conv(names, f"convs.{i}", f"features.{idx}")
    return names


def kernel_network_names(model) -> dict:
    """KernelIdentificationNetwork (convert.py:276): ``inc_*.0``, ``feat.0``, a
    block's ``double_conv.0``/``.2`` and ``feat.0``, the heads' convs at even
    indices."""
    return _renamed(model, [(r"^(inc_rgb|inc_gray|feat)\.", r"\1.0."),
                            (r"\.conv1\.", ".double_conv.0."), (r"\.conv2\.", ".double_conv.2."),
                            (r"^((?:kernel_)?up\d)\.feat\.", r"\1.feat.0."),
                            (r"^(masks|kernels)_end\.(\d)\.",
                             lambda m: f"{m.group(1)}_end.{2 * int(m.group(2))}.")])


def deal_names(model) -> dict:
    """DEAL (convert.py:372): ``W1``/``M1`` ``conv_layers.{j}``, the first
    under its zero-mean parametrization (the original coefficients, as the
    port applies the zero mean at the call), ``M2.weight``, ``M3.weight`` and
    each spline's ``coefficients``."""
    names = {}
    for mc in ("W1", "M1"):
        for j in range(len(getattr(model, mc).weights)):
            leaf = "parametrizations.weight.original" if j == 0 else "weight"
            names[f"{mc}.weights.{j}"] = f"{mc}.conv_layers.{j}.{leaf}"
    names["M2"], names["M3"] = "M2.weight", "M3.weight"
    for spline in ("spline1", "spline2", "spline3", "spline_lambda", "spline_scaling"):
        names[f"{spline}.coefficients"] = f"{spline}.coefficients"
    return names


def port_dncnn(model, sd):
    """Upstream DnCNN weights into ``model`` (convert.py:48)."""
    return port_weights(model, sd, dncnn_names(model))


def port_drunet(model, sd):
    """Upstream DRUNet weights into ``model`` (convert.py:347)."""
    return port_weights(model, sd, drunet_names(model))


def port_srresnet(model, sd):
    """Upstream SRResNet weights into ``model`` (convert.py:233)."""
    return port_weights(model, sd, srresnet_names(model))


def port_dsccp(model, sd):
    """Upstream DScCP weights into ``model`` (convert.py:266)."""
    return port_weights(model, sd, dsccp_names(model))


def port_ncsnpp(model, sd):
    """Upstream NCSN++ / DDPM++ (EDM) weights into ``model`` (convert.py:180)."""
    return port_weights(model, sd, ncsnpp_names(model))


def port_restormer(model, sd):
    """Upstream Restormer weights into ``model`` (convert.py:141)."""
    return port_weights(model, sd, restormer_names(model))


def port_swinir(model, sd):
    """Upstream SwinIR weights into ``model`` (convert.py:64)."""
    return port_weights(model, sd, swinir_names(model))


def port_scunet(model, sd):
    """Upstream SCUNet weights into ``model`` (convert.py:103)."""
    return port_weights(model, sd, scunet_names(model))


def port_ram(model, sd):
    """Upstream RAM weights into ``model`` (convert.py:306)."""
    return port_weights(model, sd, ram_names(model))


def port_vgg16(model, sd):
    """A torchvision ``vgg16`` state dict into ``model`` (vgg.py:80)."""
    return port_weights(model, sd, vgg16_names(model))


def port_kernel_network(model, sd):
    """The published KernelIdentificationNetwork weights into ``model``
    (convert.py:276)."""
    return port_weights(model, sd, kernel_network_names(model))


def port_deal(model, sd):
    """A DEAL state dict into ``model`` (convert.py:372): keys with or
    without the ``model.`` prefix, each W1/M1 kernel under its zero-mean
    parametrization's ``original`` or as a plain ``weight``."""
    sd = {k.removeprefix("model."): v for k, v in sd.items()}
    names = {}
    for ours, theirs in deal_names(model).items():
        if theirs not in sd and ".conv_layers." in theirs:
            prefix = theirs.removesuffix(".parametrizations.weight.original").removesuffix(
                ".weight")
            theirs = next((k for k in (f"{prefix}.parametrizations.weight.original",
                                       f"{prefix}.weight") if k in sd), theirs)
        names[ours] = theirs
    return port_weights(model, sd, names)


def upstream_state_dict(model, names: dict) -> dict:
    """``model``'s tensors under upstream's names (the inverse of
    :func:`port_weights`), on the CPU: what an upstream checkpoint of it
    holds."""
    state = model.state_dict()
    return {theirs: state[ours].detach().float().cpu().contiguous()
            for ours, theirs in names.items()}
