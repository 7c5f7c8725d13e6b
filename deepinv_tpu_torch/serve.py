"""Inference serving: the server side of :class:`deepinv_tpu_torch.models.Client`
(port of deepinv_tpu/serve.py).

- :class:`InferenceServer` is a threaded HTTP server hosting named
  reconstructors (serve.py:55). Each request's measurement goes to the
  registered model's device, the CUDA device by the port's policy
  (:mod:`deepinv_tpu_torch.device`), and the recon runs there.
- :func:`serve` is the blocking one-model entry point (serve.py:163).

The wire protocol is the JAX package's, so either framework's ``Client``
works against either server: a JSON body with the measurement as a base64
``.npy`` under ``"y"`` and the physics' class name under ``"physics"``, a
bearer token when the server has a key (401 and ``{"error":
"unauthorized"}`` otherwise), ``{"x_hat": <base64 .npy>}`` on success and
500 with ``{"error": <message>}`` on any failure.

Two things differ from the JAX server, because eager PyTorch modules are not
thread-safe the way a jitted call is:

- each registered model has its own lock, and its recon runs under it: a
  bf16 :class:`~deepinv_tpu_torch.models.precision.AutocastDenoiser` swaps
  its parameters for casts in place while it runs, and the kernels' launch
  counters are plain increments. Decoding, encoding and the HTTP exchange
  stay concurrent;
- grad mode is thread-local and every handler thread starts with it on, so
  the recon runs under ``torch.no_grad()`` inside the request. Under grad a
  DnCNN's chain would take the training kernel and keep every activation.

The JAX server keeps one ``jax.jit`` a shape (serve.py:93-94); here each
request runs the module eagerly.

    >>> import numpy as np, torch
    >>> from deepinv_tpu_torch.serve import InferenceServer
    >>> from deepinv_tpu_torch.models import ArtifactRemoval, Client, MedianFilter
    >>> from deepinv_tpu_torch.physics import Denoising, GaussianNoise
    >>> physics = Denoising(GaussianNoise(0.05, device="cpu"))
    >>> server = InferenceServer().register("Denoising", ArtifactRemoval(MedianFilter(3)),
    ...                                     physics)
    >>> y = torch.rand((1, 1, 16, 16))
    >>> with server.running() as url:
    ...     x_hat = Client(url)(y, physics)
    >>> x_hat.shape
    torch.Size([1, 1, 16, 16])
"""

from __future__ import annotations

import base64
import io
import json
import threading
from contextlib import contextmanager
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .device import module_device

__all__ = ["InferenceServer", "serve"]


def _encode(arr) -> str:
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr))
    return base64.b64encode(buf.getvalue()).decode()


def _decode(s: str) -> np.ndarray:
    return np.load(io.BytesIO(base64.b64decode(s)))


def _to_numpy(x) -> np.ndarray:
    """A recon as numpy; bf16 and fp16 go out as float32 (numpy has no
    bfloat16)."""
    x = x.detach()
    if x.dtype in (torch.bfloat16, torch.float16):
        x = x.float()
    return x.cpu().numpy()


class InferenceServer:
    """Threaded HTTP reconstruction server (serve.py:55).

    :param api_key: optional bearer token; requests must present it.
    :param host: bind address (default loopback).
    :param port: port; 0 picks a free one.
    """

    def __init__(self, api_key: str = "", host: str = "127.0.0.1", port: int = 0):
        self.api_key = api_key
        self.host = host
        self.port = port
        self._registry = {}
        self._httpd = None
        self._thread = None

    def register(self, physics_name: str, model, physics, device=None):
        """Host ``model(y, physics)`` for requests naming ``physics_name``
        (the Client sends ``type(physics).__name__``).

        :param device: where the measurements go; by default the device of
            the model's first parameter or buffer (else the physics'), else
            the CUDA device.
        """
        dev = torch.device(device) if device is not None else module_device(model, physics)
        self._registry[physics_name] = (model, physics, dev, threading.Lock())
        return self

    # -- request handling --------------------------------------------------
    def _infer(self, payload: dict) -> dict:
        """One request: decode ``y`` onto the model's device, run the recon
        under the model's lock and ``torch.no_grad()``, encode ``x_hat``."""
        name = payload.get("physics")
        if name not in self._registry:
            raise KeyError(f"no model registered for physics {name!r}; "
                           f"available: {sorted(self._registry)}")
        model, physics, dev, lock = self._registry[name]
        y = torch.from_numpy(_decode(payload["y"])).to(dev)
        with lock, torch.no_grad():
            x_hat = model(y, physics)
            out = _to_numpy(x_hat)
        return {"x_hat": _encode(out)}

    def _make_handler(server_self):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, code: int, out: dict):
                body = json.dumps(out).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                try:
                    # the body is read before any reply: closing a socket
                    # with request bytes unread resets the connection, and
                    # the client then loses the reply (a 401's among them)
                    body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                    if server_self.api_key:
                        auth = self.headers.get("Authorization", "")
                        if auth != f"Bearer {server_self.api_key}":
                            self._reply(401, {"error": "unauthorized"})
                            return
                    self._reply(200, server_self._infer(json.loads(body)))
                except Exception as e:  # noqa: BLE001 — reported to the client
                    self._reply(500, {"error": str(e)})

        return Handler

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> str:
        """Start serving in a background thread; returns the endpoint URL."""
        self._httpd = ThreadingHTTPServer((self.host, self.port), self._make_handler())
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self.url

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._thread.join()

    @contextmanager
    def running(self):
        url = self.start()
        try:
            yield url
        finally:
            self.stop()


def serve(model, physics, host: str = "127.0.0.1", port: int = 8000, api_key: str = "",
          device=None):
    """Blocking one-model server (serve.py:163): ``serve(model, physics)``, then
    point either framework's ``Client`` at it."""
    s = InferenceServer(api_key=api_key, host=host, port=port)
    s.register(type(physics).__name__, model, physics, device=device)
    url = s.start()
    print(f"serving {type(model).__name__} for {type(physics).__name__} at {url}")
    try:
        s._thread.join()
    except KeyboardInterrupt:
        s.stop()
