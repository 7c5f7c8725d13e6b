"""The port's TensorList, composed and stacked physics and
``StackedPhysicsDataFidelity`` against the JAX package's, on the CPU.

A stacked physics measures ``[A_1 x, ..., A_k x]`` as a TensorList of
members of any shape; its ``prox_l2`` and ``A_dagger`` run the Krylov solver
on TensorLists (and the implicit backward through them). Same inputs from a
numpy seed on both sides; f32 within 1e-4 relative max error of JAX (1e-3 for
gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinv_tpu.core import TensorList as JaxTensorList
from deepinv_tpu.ops import gaussian_blur as jax_gaussian_blur
from deepinv_tpu.optim import L2 as JaxL2
from deepinv_tpu.optim.data_fidelity import StackedPhysicsDataFidelity as JaxStackedFidelity
from deepinv_tpu.physics import Blur as JaxBlur
from deepinv_tpu.physics import Denoising as JaxDenoising
from deepinv_tpu.physics import Downsampling as JaxDownsampling
from deepinv_tpu.physics import Physics as JaxPhysics
from deepinv_tpu.physics import compose as jax_compose
from deepinv_tpu.physics import stack as jax_stack
from deepinv_tpu_torch.core import TensorList
from deepinv_tpu_torch.optim import L2, StackedPhysicsDataFidelity
from deepinv_tpu_torch.physics import (Blur, ComposedLinearPhysics, ComposedPhysics, Denoising,
                                       Downsampling, GaussianNoise, Physics, StackedLinearPhysics,
                                       compose, stack)
from test_torch_drunet import DEV

SIZE = 16


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _rel_list(a, b):
    return max(_rel(u, v) for u, v in zip(a, b))


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair():
    """A reflect-padded Gaussian blur and a 2x bicubic downsampling, in both
    packages."""
    f = np.array(jax_gaussian_blur(sigma=1.0))
    jb = JaxBlur(filter=jnp.asarray(f), padding="reflect")
    jd = JaxDownsampling(img_size=(1, SIZE, SIZE), filter="bicubic", factor=2)
    tb = Blur(_t(f), padding="reflect", device=DEV)
    td = Downsampling((1, SIZE, SIZE), filter="bicubic", factor=2, device=DEV)
    return (jb, jd), (tb, td)


def _x(seed=0, batch=2):
    return np.random.default_rng(seed).random((batch, 1, SIZE, SIZE)).astype(np.float32)


def test_tensorlist_arithmetic_matches_jax():
    rng = np.random.default_rng(1)
    a = [rng.standard_normal((2, 3)).astype(np.float32), rng.standard_normal(4).astype(np.float32)]
    b = [rng.standard_normal((2, 3)).astype(np.float32) + 2, rng.random(4).astype(np.float32) + 1]
    ja, jb = JaxTensorList([jnp.asarray(v) for v in a]), JaxTensorList([jnp.asarray(v) for v in b])
    ta, tb = TensorList([_t(v) for v in a]), TensorList([_t(v) for v in b])
    for got, want in ((ta + tb, ja + jb), (ta - tb, ja - jb), (ta * tb, ja * jb),
                      (ta / tb, ja / jb), (2.0 * ta + 1.0, 2.0 * ja + 1.0), (1.0 - ta, 1.0 - ja),
                      (-ta, -ja), (ta.conj(), ja.conj()), (ta.clone(), ja.clone()),
                      (ta.detach(), ja.detach())):
        assert isinstance(got, TensorList) and _rel_list(got, want) == 0
    assert _rel(ta.flatten().numpy(), ja.flatten()) == 0
    assert abs(float(ta.sum()) - float(ja.sum())) <= 1e-5
    assert ta.to(torch.float64)[0].dtype == torch.float64 and len(ta) == 2
    with pytest.raises(ValueError):
        ta + TensorList([ta[0]])


def test_compose_matches_jax():
    """``compose(blur, down)`` and ``down * blur``: A, the adjoint (reversed),
    the Krylov pseudo-inverse and prox of the composition, and a nonlinear
    composition's A."""
    (jb, jd), (tb, td) = _pair()
    jc, tc = jax_compose(jb, jd), compose(tb, td)
    assert isinstance(tc, ComposedLinearPhysics) and isinstance(td * tb, ComposedLinearPhysics)
    x = _x()
    y = np.array(jc.A(jnp.asarray(x)))
    assert _rel(tc.A(_t(x)).numpy(), y) <= 1e-5
    assert _rel((td * tb).A(_t(x)).numpy(), y) <= 1e-5
    assert _rel(tc.A_adjoint(_t(y)).numpy(), jc.A_adjoint(jnp.asarray(y))) <= 1e-5
    # the JAX Krylov solves through jax.jit: eager JAX compiles every op
    assert _rel(tc.A_dagger(_t(y)).numpy(), jax.jit(jc.A_dagger)(jnp.asarray(y))) <= 1e-4
    z = _x(2)
    assert _rel(tc.prox_l2(_t(z), _t(y), 0.8).numpy(), jax.jit(
        lambda a, b: jc.prox_l2(a, b, 0.8))(jnp.asarray(z), jnp.asarray(y))) <= 1e-4
    sq = Physics(A=lambda v: v ** 2)
    tn = compose(tb, sq)
    assert isinstance(tn, ComposedPhysics) and not isinstance(tn, ComposedLinearPhysics)
    assert _rel(tn.A(_t(x)).numpy(),
                jax_compose(jb, JaxPhysics(A=lambda v: v ** 2)).A(jnp.asarray(x))) <= 1e-5


def test_stack_matches_jax():
    """``stack(blur, down)``: TensorList measurements, the summed adjoint and
    ``prox_l2`` by CG over TensorLists (scalar and per-sample gamma); the
    stack of a stack flattened; ``A_dagger`` of ``stack(identity, down)``
    (the blur's stack is too ill-conditioned for 50 CG iterations to settle:
    both packages drift apart there as they drift from x)."""
    (jb, jd), (tb, td) = _pair()
    js, ts = jax_stack(jb, jd), stack(tb, td)
    assert isinstance(ts, StackedLinearPhysics) and len(ts) == 2 and ts[1] is td
    assert len(stack(ts, Denoising())) == 3 and len(tb.stack(td)) == 2
    x = _x()
    y = ts.A(_t(x))
    jy = js.A(jnp.asarray(x))
    assert isinstance(y, TensorList) and [tuple(v.shape) for v in y] == [
        (2, 1, SIZE, SIZE), (2, 1, SIZE // 2, SIZE // 2)]
    assert _rel_list(y, jy) <= 1e-5
    assert _rel(ts.A_adjoint(y).numpy(), js.A_adjoint(jy)) <= 1e-5
    jdag, tdag = jax_stack(JaxDenoising(), jd), stack(Denoising(), td)
    assert _rel(tdag.A_dagger(tdag.A(_t(x))).numpy(),
                jdag.A_dagger(jdag.A(jnp.asarray(x)))) <= 1e-4
    z = _x(3)
    for g in (0.8, np.array([0.5, 2.0], np.float32)):
        tg = g if isinstance(g, float) else _t(g)
        assert _rel(ts.prox_l2(_t(z), y, tg).numpy(),
                    js.prox_l2(jnp.asarray(z), jy, jnp.asarray(g))) <= 1e-4


def test_stacked_prox_implicit_gradient_matches_jax():
    """Gradients of ``sum(w * prox_l2(z, y, gamma))`` with respect to each
    member of the TensorList ``y``, and ``z``, through the implicit
    backward, against ``jax.grad``."""
    (jb, jd), (tb, td) = _pair()
    js, ts = jax_stack(jb, jd), stack(tb, td)
    x, z, w = _x(4), _x(5), _x(6)
    jy = js.A(jnp.asarray(x))

    def loss(yv, zv):
        return jnp.sum(js.prox_l2(zv, yv, 1.5, tol=1e-7, max_iter=100) * jnp.asarray(w))

    gy, gz = jax.jit(jax.grad(loss, argnums=(0, 1)))(jy, jnp.asarray(z))
    ty = TensorList([_t(v).requires_grad_(True) for v in jy])
    tz = _t(z).requires_grad_(True)
    (ts.prox_l2(tz, ty, 1.5, tol=1e-7, max_iter=100) * _t(w)).sum().backward()
    assert _rel_list([v.grad for v in ty], gy) <= 1e-3 and _rel(tz.grad.numpy(), gz) <= 1e-3


def test_stacked_fidelity_matches_jax():
    """``StackedPhysicsDataFidelity`` (one L2 per member, the second with
    sigma 0.5) and a plain L2 through the stack: values and gradients."""
    (jb, jd), (tb, td) = _pair()
    js, ts = jax_stack(jb, jd), stack(tb, td)
    x, x2 = _x(7), _x(8)
    jy = js.A(jnp.asarray(x))
    ty = TensorList([_t(v) for v in jy])
    jf = JaxStackedFidelity([JaxL2(), JaxL2(sigma=0.5)])
    tf = StackedPhysicsDataFidelity([L2(), L2(sigma=0.5)])
    for t_fid, j_fid in ((tf, jf), (L2(), JaxL2())):
        assert _rel(t_fid.fn(_t(x2), ty, ts).numpy(), j_fid.fn(jnp.asarray(x2), jy, js)) <= 1e-5
        assert _rel(t_fid.grad(_t(x2), ty, ts).numpy(),
                    j_fid.grad(jnp.asarray(x2), jy, js)) <= 1e-5


def test_stacked_noise_and_forward():
    """Each member applies its own noise model; ``physics(x)`` is a TensorList."""
    (_, _), (tb, td) = _pair()
    noisy = stack(Denoising(noise_model=GaussianNoise(0.1, device=DEV)), td)
    x = _t(_x(9))
    y = noisy(x, generator=torch.Generator().manual_seed(0))
    assert isinstance(y, TensorList)
    assert float((y[0] - x).std()) > 0.05 and torch.equal(y[1], td.A(x))
