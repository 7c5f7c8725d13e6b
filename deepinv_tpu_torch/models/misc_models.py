"""Remaining model adapters: the [-1, 1] wrapper, the score-model wrapper, the
EPLL denoiser and the remote-inference client (port of
deepinv_tpu/models/misc_models.py)."""

from __future__ import annotations

import base64
import io
import json

import numpy as np
import torch

from .base import Denoiser, Reconstructor

__all__ = ["MinusOneOneDenoiserWrapper", "ScoreModelWrapper", "EPLLDenoiser", "Client"]


class MinusOneOneDenoiserWrapper(Denoiser):
    """A denoiser trained on [-1, 1] images applied to [0, 1] ones
    (misc_models.py:28)."""

    def __init__(self, denoiser):
        super().__init__()
        self.denoiser = denoiser

    def forward(self, x, sigma=0.05, **kwargs):
        return (self.denoiser(2 * x - 1, 2 * sigma, **kwargs) + 1) / 2


class ScoreModelWrapper(Denoiser):
    r"""A score / diffusion network as a noise-level-calibrated denoiser
    (misc_models.py:40).

    With :math:`x_t = s_t (x_0 + \sigma_t \varepsilon)`, the wrapped model
    predicts ``"epsilon"``, ``"sample"`` (:math:`x_0`) or the ``"v_prediction"``
    target; the wrapper maps a denoiser call's noise level to the model's time
    through the ``sigma_t`` / ``scale_t`` schedules and turns the prediction
    into a denoised estimate. A schedule is a tensor (a table of
    ``n_timesteps`` values over ``[0, T]``) or a callable of continuous time;
    a missing one is derived from the variance-preserving or -exploding
    relation.

    :param score_model: the network ``model(x, t, ...)``.
    :param prediction_type: ``"epsilon"``, ``"v_prediction"`` or ``"sample"``.
    :param clip_output: clamp the estimate to the model's range.
    :param sigma_t: the noise schedule; ``scale_t`` the scaling schedule.
    :param sigma_inverse: ``sigma_t``'s inverse, if known.
    :param T: the time horizon.
    :param takes_integer_time: the model takes integer time steps.
    :param n_timesteps: the length of a tabulated schedule.
    """

    def __init__(self, score_model=None, prediction_type: str = "epsilon",
                 clip_output: bool = True, sigma_t=None, scale_t=None, sigma_inverse=None,
                 variance_preserving: bool = False, variance_exploding: bool = False,
                 T: float = 1.0, takes_integer_time: bool = False, n_timesteps: int = 1000,
                 _was_trained_on_minus_one_one: bool = True):
        super().__init__()
        if prediction_type not in ("epsilon", "v_prediction", "sample"):
            raise ValueError(f"Unsupported prediction_type: {prediction_type}")
        if variance_preserving and variance_exploding:
            raise ValueError("variance_preserving and variance_exploding cannot both be True.")
        self.model = score_model
        self.prediction_type = prediction_type
        self.clip_output = clip_output
        self.takes_integer_time = takes_integer_time
        self.n_timesteps = n_timesteps
        self._was_trained_on_minus_one_one = _was_trained_on_minus_one_one
        self.variance_preserving = variance_preserving
        self.variance_exploding = variance_exploding
        self.T = T
        self.sigma_inverse = sigma_inverse
        if scale_t is None and sigma_t is not None:
            if variance_preserving:
                scale_t = self._map_schedule(sigma_t, lambda s: torch.sqrt(1.0 / (1.0 + s ** 2)))
            elif variance_exploding:
                scale_t = self._map_schedule(sigma_t, torch.ones_like)
        elif sigma_t is None and scale_t is not None and variance_preserving:
            sigma_t = self._map_schedule(
                scale_t, lambda s: torch.sqrt(torch.clamp(1.0 / s ** 2 - 1.0, min=0.0)))
        self.sigma_t = sigma_t
        self.scale_t = scale_t

    @property
    def score_model(self):
        """The wrapped network (``model``)."""
        return self.model

    @staticmethod
    def _map_schedule(schedule, fn):
        """``fn`` composed onto a schedule, a tensor or a callable
        (misc_models.py:117)."""
        if callable(schedule):
            return lambda t: fn(torch.as_tensor(schedule(torch.as_tensor(t))))
        return fn(torch.as_tensor(schedule, dtype=torch.float32))

    def get_schedule_value(self, schedule, t, target_size=None):
        """A schedule at times ``t`` (misc_models.py:124): the callable's value,
        or the table's entry ``floor(t (n_timesteps - 1) / T)``; reshaped to
        ``(-1, 1, ...)`` against ``target_size``."""
        t = torch.as_tensor(t)
        if callable(schedule):
            val = torch.as_tensor(schedule(t))
        else:
            idx = (t * (self.n_timesteps - 1) / self.T).long()
            val = torch.as_tensor(schedule, device=t.device)[idx]
        if target_size is not None:
            val = val.reshape((-1,) + (1,) * (len(target_size) - 1))
        return val

    def time_from_sigma(self, sigma):
        """``t`` with ``sigma_t(t) = sigma`` (misc_models.py:137): the given
        inverse, the nearest table entry, or 32 bisection steps."""
        sigma = torch.as_tensor(sigma)
        if self.sigma_inverse is not None:
            return torch.as_tensor(self.sigma_inverse(sigma))
        if not callable(self.sigma_t):
            sigmas = torch.as_tensor(self.sigma_t, device=sigma.device)
            idx = (sigmas[None, :] - sigma.reshape(-1)[:, None]).abs().argmin(1)
            t = idx.float() * self.T / (self.n_timesteps - 1)
            return t.reshape(sigma.shape) if sigma.dim() else t[0]
        lo = torch.zeros(sigma.shape, dtype=torch.float32, device=sigma.device)
        hi = torch.full_like(lo, self.T)
        for _ in range(32):
            mid = (lo + hi) / 2
            right = torch.as_tensor(self.sigma_t(mid)) < sigma
            lo, hi = torch.where(right, mid, lo), torch.where(right, hi, mid)
        return (lo + hi) / 2

    @staticmethod
    def stable_division(a, b, epsilon: float = 1e-7):
        """``a / b`` with ``|b|`` kept at least ``epsilon`` (misc_models.py:160)."""
        if isinstance(b, (int, float)):
            return a / (max(epsilon, abs(b)) * (1.0 if b >= 0 else -1.0))
        b = torch.as_tensor(b)
        sign = torch.where(b >= 0, 1.0, -1.0).to(b.dtype)
        return a / torch.where(b.abs() > epsilon, b, sign * epsilon)

    def _pred_to_score(self, pred, x, sigma, scale):
        if self.prediction_type == "epsilon":
            return -self.stable_division(pred, sigma)
        if self.prediction_type == "v_prediction":
            return -self.stable_division(pred / scale + sigma * x, sigma)
        return self.stable_division(x + (scale * sigma) ** 2 * pred, scale)

    def _pred_to_x0(self, pred, x, sigma, scale):
        if self.prediction_type == "epsilon":
            return x / scale - sigma * pred
        if self.prediction_type == "v_prediction":
            return scale * (x - sigma * pred)
        return pred

    def _model_time(self, t):
        return (t * (self.n_timesteps - 1)).to(torch.int32) if self.takes_integer_time else t

    @staticmethod
    def _first(pred):
        return pred[0] if isinstance(pred, (list, tuple)) else pred

    def score(self, x, t=None, *args, **kwargs):
        r"""The score :math:`\nabla_x \log p_t(x)` at time ``t``
        (misc_models.py:191)."""
        if t is None:
            raise ValueError("A time step t must be provided.")
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device).reshape(-1)
        t = t.broadcast_to((x.shape[0],))
        pred = self._first(self.model(x, self._model_time(t), *args, **kwargs))
        sigma = self.get_schedule_value(self.sigma_t, t, x.shape)
        scale = self.get_schedule_value(self.scale_t, t, x.shape)
        return self._pred_to_score(torch.as_tensor(pred).to(x.dtype), x, sigma, scale)

    def forward(self, x, sigma=0.05, input_in_minus_one_one: bool = False, *args, **kwargs):
        if self.sigma_t is None:
            s = torch.as_tensor(sigma)
            return x + s ** 2 * self.model(x, s, *args, **kwargs)
        s = torch.as_tensor(sigma, dtype=x.dtype, device=x.device).reshape(-1)
        s = s.broadcast_to((x.shape[0],))
        rescale = self._was_trained_on_minus_one_one and not input_in_minus_one_one
        if rescale:
            s = s * 2
        t = self.time_from_sigma(s)
        scale = self.get_schedule_value(self.scale_t, t, x.shape)
        x_in = ((x * 2 - 1) if rescale else x) * scale
        pred = self._first(self.model(x_in, self._model_time(t), *args, **kwargs))
        sig = s.reshape((-1,) + (1,) * (x.dim() - 1))
        x0 = self._pred_to_x0(torch.as_tensor(pred).to(x.dtype), x_in, sig, scale)
        if self.clip_output:
            x0 = x0.clamp(-1.0, 1.0)
        return (x0 + 1) / 2 if rescale else x0


class EPLLDenoiser(Denoiser):
    """The EPLL patch denoiser as a denoiser (misc_models.py:228), over
    :class:`~deepinv_tpu_torch.optim.EPLL`.

    :param generator: CPU ``torch.Generator`` of the default mixture.
    :param device: the CUDA device by default.
    """

    def __init__(self, gmm=None, patch_size: int = 6, channels: int = 1, generator=None,
                 device=None):
        from ..optim.epll import EPLL

        super().__init__()
        self.epll = EPLL(gmm=gmm, patch_size=patch_size, channels=channels,
                         generator=generator, device=device)

    def forward(self, x, sigma=0.05, **kwargs):
        return self.epll(x, sigma)


class Client(Reconstructor):
    """Remote-inference REST client (misc_models.py:240): posts the
    measurement, base64 ``.npy`` inside a JSON payload, to ``endpoint`` and
    reads the reconstruction ``x_hat`` back in the same encoding.
    """

    def __init__(self, endpoint: str, api_key: str = "", timeout: float = 60.0):
        super().__init__()
        self.endpoint = endpoint
        self.api_key = api_key
        self.timeout = timeout

    @staticmethod
    def serialize(tensor) -> str:
        """A tensor or array as a base64 ``.npy`` string (misc_models.py:254)."""
        if isinstance(tensor, torch.Tensor):
            tensor = tensor.detach().cpu().numpy()
        buf = io.BytesIO()
        np.save(buf, np.asarray(tensor))
        return base64.b64encode(buf.getvalue()).decode()

    @staticmethod
    def deserialize(data: str) -> np.ndarray:
        """A base64 ``.npy`` string as an array (misc_models.py:259)."""
        return np.load(io.BytesIO(base64.b64decode(data)))

    def payload(self, y, physics, **kwargs) -> dict:
        """The request's JSON body (misc_models.py:273): the measurement, the
        physics' class name and the keyword arguments that are numbers or
        strings."""
        return {"y": self.serialize(y), "physics": type(physics).__name__,
                "kwargs": {k: v for k, v in kwargs.items() if isinstance(v, (int, float, str))}}

    def forward(self, y, physics, **kwargs):
        import urllib.request

        req = urllib.request.Request(
            self.endpoint, data=json.dumps(self.payload(y, physics, **kwargs)).encode(),
            headers={"Content-Type": "application/json",
                     "Authorization": f"Bearer {self.api_key}"})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            out = json.loads(resp.read())
        return torch.from_numpy(self.deserialize(out["x_hat"])).to(y.device)
