"""The port's ADMUNet against the JAX package's, on the CPU, at full width
(the FFHQ checkpoint's architecture, 93.6 M parameters): the width is fixed
by the class. The JAX module is built once for the file (its construction
and first forward take tens of seconds), its every parameter redrawn at
random, and carried into the port by ``load_jax_params`` (its flat dict
``p``) and by ``load_torch_state_dict`` from the same arrays.

Bound: 1e-4 relative max error in f32; the ``pretrained=`` round trip from a
guided-diffusion-named ``.pt`` file gives its source's output bits.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepinv_tpu.models as JM
import deepinv_tpu_torch.models as TM
from deepinv_tpu.models.convert import load_torch_checkpoint as jax_load_checkpoint
from deepinv_tpu_torch.models.convert import adm_names, upstream_state_dict
from test_torch_attention_models import BOUND, crossed, image, rel, run
from test_torch_drunet import DEV, jax_params

# sigmas off the midpoints between entries of the timestep table
SIGMAS = np.array([0.0731], np.float32)


@pytest.fixture(scope="module")
def adms():
    return crossed(JM.ADMUNet(key=jax.random.key(0)), TM.ADMUNet(device=DEV), 1)


def test_adm_names_are_guided_diffusions(adms):
    """The state dict is the JAX flat dict, name for name and shape for shape
    (``input_blocks.{i}.{j}.in_layers.0.weight``, ``middle_block.1.qkv.weight``,
    ``out.2.bias``), and ``load_torch_state_dict`` from it gives the same
    tensors as ``load_jax_params``."""
    ref, port = adms
    state = port.state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in ref.p.items()}
    assert {"input_blocks.1.0.in_layers.0.weight", "middle_block.1.qkv.weight", "out.2.bias",
            "input_blocks.3.0.in_layers.2.weight", "output_blocks.1.1.out_layers.3.weight"} \
        <= set(state)
    assert sum(v.numel() for v in state.values()) > 93_000_000
    other = TM.ADMUNet(device=DEV).load_torch_state_dict(
        {k: np.asarray(v) for k, v in ref.p.items()})
    assert all(torch.equal(other.state_dict()[k], v) for k, v in state.items())
    for a, b in zip(jax_params(ref)["sqrt_1m_alphas_cumprod"], port.sqrt_1m_alphas_cumprod):
        assert a == float(b)


@pytest.mark.parametrize("mode", ["timestep", "noise_level"])
def test_adm_matches_jax(adms, mode):
    """Both forward modes at 1x3x32²: the noise and variance channels at a
    raw timestep, and the denoiser through the timestep table's ``argmin``."""
    ref, port = adms
    x = image((1, 3, 32, 32), 2)
    s = np.array([123.0], np.float32) if mode == "timestep" else SIGMAS
    got = run(port, x if mode == "noise_level" else 2 * x - 1, torch.from_numpy(s), type_t=mode)
    want = ref(jnp.asarray(x if mode == "noise_level" else 2 * x - 1), jnp.asarray(s),
               type_t=mode)
    assert got.shape == ((1, 6, 32, 32) if mode == "timestep" else x.shape)
    assert rel(got, want) <= BOUND


def test_adm_circular_pad_matches_jax(adms):
    """A 40x48 input, wrap-padded at the top and left to 64² and cropped back."""
    ref, port = adms
    x = image((1, 3, 40, 48), 3)
    got = run(port, x, torch.from_numpy(SIGMAS))
    assert got.shape == x.shape
    assert rel(got, ref(jnp.asarray(x), jnp.asarray(SIGMAS))) <= BOUND


def test_adm_pretrained_matches_jax(adms, tmp_path):
    """A checkpoint written under guided-diffusion's names and read by the
    port's ``pretrained=`` and the JAX loader (``load_torch_checkpoint`` and
    ``load_torch_state_dict``, what its ``pretrained=`` runs): the port gives
    its source's output bits, JAX its output within the bound; a missing or
    misshapen tensor raises as in JAX."""
    ref, src = adms
    sd = upstream_state_dict(src, adm_names(src))
    path = str(tmp_path / "diffusion_ffhq_10m.pt")
    torch.save(sd, path)
    port = TM.ADMUNet(pretrained=path, device=DEV)
    jref = copy.copy(ref)
    jref.p = dict(ref.p)
    jref.load_torch_state_dict(jax_load_checkpoint(path))
    x = image((1, 3, 32, 32), 4)
    want = run(src, x, torch.from_numpy(SIGMAS))
    assert np.array_equal(run(port, x, torch.from_numpy(SIGMAS)), want)
    assert rel(jref(jnp.asarray(x), jnp.asarray(SIGMAS)), want) <= BOUND
    del sd["out.2.bias"]
    with pytest.raises(KeyError, match="out.2.bias"):
        port.load_torch_state_dict(sd)
    with pytest.raises(KeyError, match="out.2.bias"):
        jref.load_torch_state_dict(sd)
    sd["out.2.bias"] = torch.zeros(7)
    with pytest.raises(ValueError, match="out.2.bias"):
        port.load_torch_state_dict(sd)
