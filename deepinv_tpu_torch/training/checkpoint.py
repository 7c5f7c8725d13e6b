"""Train-state checkpoints on ``torch.save`` (port of the interface of
deepinv_tpu/training/checkpoint.py).

The JAX package stores its pytrees with orbax; this is not orbax. It keeps
``OrbaxCheckpointer``'s name and interface (checkpoint.py:23-91): one
numbered directory a step under ``directory``, the newest ``max_to_keep``
kept, ``save``, ``restore``, ``latest_step``, ``wait`` and ``close``. A
step's state (the model's and the optimizer's state dicts and the extras)
is copied to the host when :meth:`save` is called, so the next step may
change the parameters at once; with ``async_save`` a thread then writes the
copy (to a temporary file, renamed when whole) while training goes on, and
:meth:`wait` joins it. :meth:`restore` reads with
``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import os
import shutil
import threading

import numpy as np
import torch

__all__ = ["OrbaxCheckpointer"]

_FILE = "state.pt"


def _host(v):
    """A host copy of a state's tensors (and numpy arrays, as tensors)."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", copy=True)
    if isinstance(v, np.ndarray):
        return torch.from_numpy(np.array(v))
    if isinstance(v, dict):
        return {k: _host(u) for k, u in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_host(u) for u in v)
    return v


def _state(obj):
    return obj.state_dict() if hasattr(obj, "state_dict") else obj


class OrbaxCheckpointer:
    """Train-state checkpoints under ``directory`` (checkpoint.py:23), by
    ``torch.save``: the JAX package's name and interface, not orbax.

    :param directory: the root, one numbered subdirectory a step.
    :param max_to_keep: how many of the newest steps are kept.
    :param async_save: write in a background thread (the host copy is made
        before :meth:`save` returns).
    """

    def __init__(self, directory: str, max_to_keep: int = 3, async_save: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._thread = None
        self._error = None

    def _steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.exists(os.path.join(self.directory, name, _FILE)):
                out.append(int(name))
        return sorted(out)

    def _write(self, step, state):
        try:
            d = os.path.join(self.directory, str(step))
            os.makedirs(d, exist_ok=True)
            tmp = os.path.join(d, _FILE + ".tmp")
            torch.save(state, tmp)
            os.replace(tmp, os.path.join(d, _FILE))
            for old in self._steps()[:-self.max_to_keep] if self.max_to_keep else []:
                shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
        except BaseException as e:  # raised again by wait()
            self._error = e

    def save(self, step: int, model, opt_state=None, extra: dict | None = None):
        """Keep the state at ``step`` (checkpoint.py:50): ``model`` an
        ``nn.Module`` or a state dict, ``opt_state`` an optimizer or its state
        dict, ``extra`` a dict of tensors, arrays and numbers."""
        self.wait()
        state = {"model": _host(_state(model))}
        if opt_state is not None:
            state["opt_state"] = _host(_state(opt_state))
        if extra:
            state["extra"] = _host(dict(extra))
        if self.async_save:
            self._thread = threading.Thread(target=self._write, args=(int(step), state))
            self._thread.start()
        else:
            self._write(int(step), state)
            self.wait()

    def restore(self, model, opt_state=None, step: int | None = None):
        """Load ``step`` (the newest if None) into ``model`` and
        ``opt_state`` (checkpoint.py:73); returns ``(model, opt_state,
        extra, step)``. An ``nn.Module`` or an optimizer is loaded in place
        (each tensor goes to its parameter's device, an optimizer's step
        count stays on the host); a state dict is returned as read, on the
        host."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        state = torch.load(os.path.join(self.directory, str(step), _FILE), map_location="cpu",
                           weights_only=True)
        if hasattr(model, "load_state_dict"):
            model.load_state_dict(state["model"])
        else:
            model = state["model"]
        if "opt_state" in state:
            if hasattr(opt_state, "load_state_dict"):
                opt_state.load_state_dict(state["opt_state"])
            else:
                opt_state = state["opt_state"]
        return model, opt_state, state.get("extra", {}), step

    def latest_step(self):
        """The newest step written whole, or None."""
        self.wait()
        steps = self._steps()
        return steps[-1] if steps else None

    def wait(self):
        """Block until the pending write is on disk (checkpoint.py:85); a
        write that failed raises here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def close(self):
        self.wait()
