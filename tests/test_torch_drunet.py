"""The port's DRUNet against the JAX package's on the CPU, same weights.

The JAX weights cross by tree path (``load_jax_params``). Scale 0 is kept at
64 channels so the port's kernel-op dispatch is exercised: bf16 activations
take ``resblock_chain`` (its plain version on the CPU), f32 ones the blocks.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepinv_tpu_torch.models.drunet as drunet_mod
from deepinv_tpu.models import DRUNet as JaxDRUNet
from deepinv_tpu.models import autocast as jax_autocast
from deepinv_tpu_torch.models import DRUNet, autocast, load_jax_params

# the port runs on the CUDA device by default; these tests run on the CPU
DEV = "cpu"
NC = (64, 32, 32, 32)

# Each pytest-xdist worker collects (imports) every test file, this one
# included, and is a process of its own on the shared cores, where
# PyTorch's intra-op pool takes every core: six workers on 8 cores
# oversubscribed the host and ran a 3 s TV-PGD test in 95 s. A worker takes
# its share of the cores.
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


@contextlib.contextmanager
def numpy_draws(seed: int = 0):
    """Inside the block ``jax.random.normal`` and ``uniform`` and the JAX
    layers' He init draw by numpy: eager ``jax.random`` compiles a draw for
    every new shape, most of a full-width JAX model's build on the CPU (58 s
    of RAM's, 170 s of ADMUNet's). For modules whose weights the test redraws
    or carries to the port as they are: the values differ from JAX's own
    draws, their laws do not."""
    import deepinv_tpu.models.layers as jlayers

    rng = np.random.default_rng(seed)

    def normal(key, shape=(), dtype=jnp.float32):
        return jnp.asarray(rng.standard_normal(shape), dtype)

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(rng.uniform(np.asarray(minval), np.asarray(maxval), shape), dtype)

    def he_init(key, shape, fan_in, dtype=jnp.float32):
        return jnp.asarray(rng.standard_normal(shape) * np.sqrt(2.0 / fan_in), dtype)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", normal)
        mp.setattr(jax.random, "uniform", uniform)
        mp.setattr(jlayers, "he_init", he_init)
        yield


def jax_built(cls, *args, **kwargs):
    """``cls(*args, **kwargs)``, a JAX module, built by numpy's draws
    (``numpy_draws``)."""
    with numpy_draws():
        return cls(*args, **kwargs)


def jax_params(module) -> dict:
    """A JAX module's array leaves as ``{dotted tree path: np.ndarray}``."""
    def name(k):
        for attr in ("name", "idx", "key"):
            if hasattr(k, attr):
                return str(getattr(k, attr))
        raise TypeError(k)

    leaves = jax.tree_util.tree_flatten_with_path(module)[0]
    return {".".join(name(k) for k in path): np.array(v) for path, v in leaves}


def _pair(nc=NC, nb=1, seed=0, act_mode="R"):
    ref = JaxDRUNet(nc=nc, nb=nb, act_mode=act_mode, key=jax.random.key(seed))
    port = load_jax_params(DRUNet(nc=nc, nb=nb, act_mode=act_mode, device=DEV), jax_params(ref))
    return ref, port


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def test_load_jax_params_carries_every_weight():
    ref, port = _pair()
    arrays = jax_params(ref)
    state = port.state_dict()
    assert set(state) == set(arrays) and len(state) == 22
    for k, v in arrays.items():
        assert torch.equal(state[k], torch.from_numpy(v))


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_load_jax_params_refuses_mismatch(fault):
    ref, port = _pair()
    arrays = jax_params(ref)
    if fault == "missing":
        arrays.pop("m_tail.weight")
    elif fault == "extra":
        arrays["m_tail.bias"] = np.zeros(3, np.float32)
    else:
        arrays["m_tail.weight"] = arrays["m_tail.weight"][:, :-1]
    with pytest.raises(ValueError if fault == "shape" else KeyError):
        load_jax_params(port, arrays)


@pytest.mark.parametrize("size,act_mode", [((32, 32), "R"), ((37, 31), "R"), ((32, 32), "E")])
def test_f32_forward_matches_jax(size, act_mode):
    """f32 forward, relative error <= 1e-4 (f32 convs summed in another
    order); 37 x 31 goes through test_pad's modulo-16 edge padding; ELU
    blocks take the per-block path at every scale."""
    ref, port = _pair(act_mode=act_mode)
    x = np.random.default_rng(1).random((2, 3) + size).astype(np.float32)
    want = ref(jnp.asarray(x), 0.05)
    with torch.no_grad():
        got = port(torch.from_numpy(x), 0.05)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-4


def test_bf16_autocast_forward_matches_jax(monkeypatch):
    """bf16 autocast forward vs the JAX package's. The JAX CPU path rounds
    conv2 before the residual add, the port's scale-0 chain (like the kernel)
    after it, so the outputs differ by bf16 roundings that pass through the
    net: relative error <= 5e-2 (bf16 has 2^-8 relative precision)."""
    calls = []
    chain = drunet_mod.resblock_chain
    monkeypatch.setattr(drunet_mod, "resblock_chain",
                        lambda *a, **k: calls.append(a[0].dtype) or chain(*a, **k))
    ref, port = _pair(seed=3)
    x = np.random.default_rng(2).random((1, 3, 32, 32)).astype(np.float32)
    want = jax_autocast(ref)(jnp.asarray(x), 0.05)
    den = autocast(port)
    with torch.no_grad():
        got = den(torch.from_numpy(x), 0.05)
        assert calls == [torch.bfloat16]          # scale 0 went through the op
        port(torch.from_numpy(x), 0.05)
        assert calls == [torch.bfloat16]          # f32 takes the blocks
    assert got.dtype == torch.float32
    # the wrapper keeps the module, whose f32 parameters it exposes; the
    # bf16 casts live only inside its calls
    assert den.denoiser is port and port.m_head.weight.dtype == torch.float32
    assert {id(p) for p in den.parameters()} == {id(p) for p in port.parameters()}
    assert _rel(got.numpy(), np.asarray(want, np.float32)) <= 5e-2


def test_chain_weights_are_packed_once_per_weight_version():
    """Inference reuses the stacked chain weights until a weight changes;
    under autograd the stacks are rebuilt so gradients reach each block."""
    port = DRUNet(nc=NC, nb=2, generator=torch.Generator().manual_seed(0), device=DEV)
    blocks = list(port.m_down1[:-1])
    with torch.no_grad():
        first = port._chain_weights(blocks)
        assert port._chain_weights(blocks) is first
        blocks[1].conv2.weight.mul_(2.0)
        second = port._chain_weights(blocks)
    assert second is not first and torch.equal(second[1][1], blocks[1].conv2.weight)

    den = autocast(port)
    x = torch.rand((1, 3, 32, 32), generator=torch.Generator().manual_seed(1))
    den(x, 0.05).sum().backward()
    g = den.denoiser.m_down1[0].conv1.weight.grad
    assert g is not None and bool(torch.isfinite(g.float()).all()) and float(g.abs().max()) > 0


def test_random_init_follows_the_jax_scheme():
    """He-normal init, with the reference's 0.2 gain on ResBlock convs."""
    port = DRUNet(generator=torch.Generator().manual_seed(0), device=DEV)
    w = port.m_down1[0].conv1.weight
    assert abs(float(w.detach().std()) / (0.2 * (2 / (64 * 9)) ** 0.5) - 1) < 0.02
    w = port.m_down2[-1].weight
    assert abs(float(w.detach().std()) / (2 / (128 * 4)) ** 0.5 - 1) < 0.02
    w = port.m_up1[0].weight  # transposed conv, fan-in = in_channels * k * k
    assert abs(float(w.detach().std()) / (2 / (128 * 4)) ** 0.5 - 1) < 0.02
