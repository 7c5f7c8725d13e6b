"""The port's inference server against the JAX package's, on the CPU.

Both servers run on loopback in the test's process and host the same two
reconstructors: ``ArtifactRemoval(MedianFilter(3))`` under ``"Denoising"``
and a small f32 PnP-HQS with DRUNet (weights crossed by ``load_jax_params``)
under ``"BlurFFT"``. Each framework's ``Client`` posts to each server; every
``x_hat`` is held within 1e-5 (relative max error) of JAX's direct call.
"""

import json
import sys
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinv_tpu.models import ArtifactRemoval as JArtifactRemoval
from deepinv_tpu.models import Client as JClient
from deepinv_tpu.models import MedianFilter as JMedian
from deepinv_tpu.ops import gaussian_blur as jgauss
from deepinv_tpu.optim import L2 as JL2
from deepinv_tpu.optim import PnP as JPnP
from deepinv_tpu.optim import optim_builder as jbuilder
from deepinv_tpu.physics import BlurFFT as JBlurFFT
from deepinv_tpu.physics import Denoising as JDenoising
from deepinv_tpu.serve import InferenceServer as JServer
from deepinv_tpu_torch.models import ArtifactRemoval, Client, MedianFilter
from deepinv_tpu_torch.optim import L2, PnP, optim_builder
from deepinv_tpu_torch.physics import BlurFFT, Denoising, GaussianNoise
from deepinv_tpu_torch.serve import InferenceServer

from test_torch_drunet import _pair

KEY = "s3cret"
RTOL = 1e-5
HQS = {"stepsize": 2.0, "g_param": 0.05}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def hosted():
    """The two problems in both frameworks, the JAX direct calls, and both
    servers running with the bearer key."""
    rng = np.random.default_rng(0)
    f = np.asarray(jgauss(sigma=1.0))
    ys = {"Denoising": rng.random((1, 1, 24, 24)).astype(np.float32),
          "BlurFFT": rng.random((1, 3, 32, 32)).astype(np.float32)}
    ref, port = _pair(seed=3)
    jmodels = {"Denoising": (JArtifactRemoval(JMedian(3)), JDenoising()),
               "BlurFFT": (jbuilder("HQS", JL2(), JPnP(ref), HQS, max_iter=2),
                           JBlurFFT(img_size=(3, 32, 32), filter=jnp.asarray(f)))}
    tmodels = {"Denoising": (ArtifactRemoval(MedianFilter(3)),
                             Denoising(GaussianNoise(0.05, device="cpu"))),
               "BlurFFT": (optim_builder("HQS", L2(), PnP(port), HQS, max_iter=2, device="cpu"),
                           BlurFFT((3, 32, 32), filter=torch.from_numpy(f.copy()),
                                   device="cpu"))}
    want = {k: np.asarray(m(jnp.asarray(ys[k]), p)) for k, (m, p) in jmodels.items()}
    servers = {"jax": JServer(api_key=KEY), "port": InferenceServer(api_key=KEY)}
    for k in ys:
        servers["jax"].register(k, *jmodels[k])
        servers["port"].register(k, *tmodels[k])
    urls = {name: s.start() for name, s in servers.items()}
    yield ys, want, jmodels, tmodels, servers, urls
    for s in servers.values():
        s.stop()


@pytest.mark.parametrize("client", ["port", "jax"])
@pytest.mark.parametrize("server", ["port", "jax"])
def test_either_client_either_server(hosted, client, server):
    """Each Client against each server, both problems: x_hat within 1e-5 of
    JAX's direct call, float32, of the measurement's shape."""
    ys, want, jmodels, tmodels, _, urls = hosted
    for name, y in ys.items():
        if client == "port":
            got = Client(urls[server], api_key=KEY)(torch.from_numpy(y), tmodels[name][1]).numpy()
        else:
            got = np.asarray(JClient(urls[server], api_key=KEY)(jnp.asarray(y), jmodels[name][1]))
        assert got.dtype == np.float32 and got.shape == want[name].shape
        assert _rel(got, want[name]) <= RTOL, (name, _rel(got, want[name]))


def test_concurrent_requests(hosted):
    """4 client threads x 4 requests a model to the port's server, each
    request with its own measurement (seeded draws): every x_hat equals the
    port's direct call on its own measurement (the same bits) and is within
    1e-5 of JAX's (jitted) direct call on it."""
    import jax

    ys, _, jmodels, tmodels, _, urls = hosted
    rng = np.random.default_rng(1)
    requests = [(name, rng.random(y.shape).astype(np.float32)) for _ in range(4)
                for name, y in ys.items()]
    jitted = {name: jax.jit(lambda y, m=m, p=p: m(y, p)) for name, (m, p) in jmodels.items()}
    with torch.no_grad():
        direct = [tmodels[name][0](torch.from_numpy(y), tmodels[name][1]).numpy()
                  for name, y in requests]
    want = [np.asarray(jitted[name](jnp.asarray(y))) for name, y in requests]

    def post(i):
        name, y = requests[i]
        return Client(urls["port"], api_key=KEY)(torch.from_numpy(y), tmodels[name][1]).numpy()

    with ThreadPoolExecutor(4) as pool:
        results = list(pool.map(post, range(len(requests)), timeout=120))
    assert len(results) == 4 * len(ys)
    for got, d, w in zip(results, direct, want):
        assert np.array_equal(got, d)
        assert _rel(got, w) <= RTOL


def _raw(url, body: dict, key: str):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json",
                                          "Authorization": f"Bearer {key}"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_errors_as_jax(hosted):
    """A bad key gets 401 and ``{"error": "unauthorized"}``; an unregistered
    physics gets 500 with the same message from both servers."""
    ys, _, _, _, _, urls = hosted
    body = {"y": Client.serialize(ys["Denoising"]), "physics": "Nope", "kwargs": {}}
    for key, code in (("wrong", 401), (KEY, 500)):
        got = {name: _raw(url, body, key) for name, url in urls.items()}
        assert got["port"] == got["jax"] and got["port"][0] == code
    assert "no model registered for physics 'Nope'" in got["port"][1]["error"]


def test_a_large_unauthorised_request_gets_its_401(hosted):
    """A bad key on an 8 MB body still gets its 401 and message: the server
    reads the body before it replies, so closing the connection does not
    reset it under the client (a reply over unread bytes lost 19 of 20 such
    requests at 1 MB)."""
    urls = hosted[-1]
    body = {"y": Client.serialize(torch.zeros(1, 1, 1448, 1448)), "physics": "Nope",
            "kwargs": {}}
    for _ in range(5):
        assert _raw(urls["port"], body, "wrong") == (401, {"error": "unauthorized"})


class _Probe(torch.nn.Module):
    """A recon that records grad mode and how many calls overlap, with a
    read-modify-write that a second thread inside it would break."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(()))
        self.inside, self.most, self.grad_seen = 0, 0, set()

    def forward(self, y, physics):
        self.inside += 1
        n = self.inside
        self.most = max(self.most, n)
        self.grad_seen.add(torch.is_grad_enabled())
        x = (y * self.w).to(torch.bfloat16)
        for _ in range(50):
            x = x + 0
        self.inside = n - 1
        return x


def test_lock_no_grad_and_half_output():
    """16 threads, more than the cores, 4 requests each, with a short switch
    interval: one model's recons never overlap, run without grad, and a bf16
    output goes out as float32."""
    probe = _Probe()
    server = InferenceServer().register("Denoising", probe, Denoising(), device="cpu")
    y = np.random.default_rng(1).random((1, 1, 8, 8)).astype(np.float32)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with server.running() as url:
            def post(_):
                return Client(url)(torch.from_numpy(y), Denoising())

            with ThreadPoolExecutor(16) as pool:
                outs = [f.result(timeout=120) for f in [pool.submit(post, i) for i in range(64)]]
    finally:
        sys.setswitchinterval(old)
    assert not server._thread.is_alive()
    assert probe.most == 1 and probe.grad_seen == {False}
    want = torch.from_numpy(y).to(torch.bfloat16).float()
    assert all(o.dtype == torch.float32 and torch.equal(o, want) for o in outs)
