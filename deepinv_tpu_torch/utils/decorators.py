"""Deprecation helpers (port of deepinv_tpu/utils/decorators.py).

Renamed or dropped keyword arguments, superseded functions and classes, and
attributes kept behind a warning. Each helper emits a ``DeprecationWarning``
pointing at the caller (``stacklevel=2``) with the JAX package's message, and
otherwise keeps the behaviour. Pure Python: nothing here touches a tensor.
"""

from __future__ import annotations

import functools
import warnings
from typing import Any

__all__ = [
    "deprecated_alias",
    "deprecated_argument",
    "deprecated_func",
    "deprecated_class",
    "deprecated_func_replaced_by",
    "deprecate_attribute",
]


def _warn(message: str) -> None:
    warnings.warn(message, DeprecationWarning, stacklevel=3)


def deprecated_alias(**aliases: str):
    """Accept old keyword names, forwarding them to their new names
    (decorators.py:29).

    ``@deprecated_alias(num_angles="angles")`` lets ``f(num_angles=3)`` keep
    working (with a warning) as ``f(angles=3)``. Passing both the old and the
    new name is an error.
    """

    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            for old, new in aliases.items():
                if old in kwargs:
                    if new in kwargs:
                        raise TypeError(f"Cannot specify both {old!r} and {new!r}")
                    _warn(
                        f"Argument {old!r} is deprecated and will be removed "
                        f"in a future version. Use {new!r} instead."
                    )
                    kwargs[new] = kwargs.pop(old)
            return fn(*args, **kwargs)

        return wrapper

    return decorator


def deprecated_argument(*names: str):
    """Drop the listed keyword arguments after warning (decorators.py:56):
    arguments that no longer have any effect and no replacement."""

    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            for name in names:
                if name in kwargs:
                    _warn(
                        f"Argument {name!r} is deprecated and will be removed "
                        "in a future version."
                    )
                    kwargs.pop(name)
            return fn(*args, **kwargs)

        return wrapper

    return decorator


def deprecated_func(fn):
    """Mark a function or method as deprecated, with no replacement
    (decorators.py:77)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        _warn(
            f"Function {fn.__name__!r} is deprecated and will be removed in "
            "a future version."
        )
        return fn(*args, **kwargs)

    return wrapper


def deprecated_class(cls):
    """Mark a class as deprecated: instantiation warns, then proceeds
    (decorators.py:91)."""
    inner_init = cls.__init__

    @functools.wraps(inner_init)
    def init(self, *args, **kwargs):
        _warn(
            f"Class {cls.__name__!r} is deprecated and will be removed in a "
            "future version."
        )
        inner_init(self, *args, **kwargs)

    cls.__init__ = init
    return cls


def deprecated_func_replaced_by(
    replacement,
    *,
    redirect: bool = False,
    since: str | None = None,
    remove_in: str | None = None,
    extra: str | None = None,
):
    """Deprecate a function in favour of ``replacement`` (decorators.py:107).

    :param replacement: the new callable, or its dotted path as a string.
    :param redirect: forward the call to ``replacement`` after warning
        (requires a callable).
    :param since: version the deprecation started in (message only).
    :param remove_in: version the function disappears in (message only).
    :param extra: extra text appended to the warning.
    """
    if redirect and not callable(replacement):
        raise TypeError("redirect=True requires a callable 'replacement'.")
    name = (
        replacement
        if isinstance(replacement, str)
        else f"{replacement.__module__}.{replacement.__qualname__}"
    )

    def decorator(fn):
        when = " ".join(
            s
            for s in (
                f"since {since}" if since else "",
                f"and will be removed in {remove_in}" if remove_in else "",
            )
            if s
        )
        msg = (
            f"Function {fn.__name__!r} is deprecated "
            + (when + "." if when else "and will be removed in a future version.")
            + f" Use {name!r} instead."
            + (f" {extra}" if extra else "")
        )

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            _warn(msg)
            if redirect:
                return replacement(*args, **kwargs)
            return fn(*args, **kwargs)

        return wrapper

    return decorator


def deprecate_attribute(
    obj: Any,
    *,
    attr_name: str,
    attr_underscore_name: str,
    attr_initial_value: Any,
    deprecation_message: str,
    doc: str | None = None,
) -> None:
    """Keep an attribute readable, writable and deletable behind a warning
    (decorators.py:160).

    Installs a property named ``attr_name`` on ``type(obj)`` — a
    deliberate **class-level** side effect shared by all instances; the
    property is installed once, but the deprecation message and initial
    value are kept per-instance, so later calls for the same attribute on
    other instances (possibly with different messages) behave as expected.
    """
    setattr(obj, attr_underscore_name, attr_initial_value)
    # per-instance message: the shared property looks it up on self
    setattr(obj, f"_{attr_name}__deprecation_message", deprecation_message)
    cls = type(obj)
    if isinstance(getattr(cls, attr_name, None), property):
        return

    def _msg(self):
        return getattr(
            self, f"_{attr_name}__deprecation_message", deprecation_message
        )

    def fget(self):
        value = getattr(self, attr_underscore_name)
        _warn(_msg(self))
        return value

    def fset(self, value):
        setattr(self, attr_underscore_name, value)
        _warn(_msg(self))

    def fdel(self):
        delattr(self, attr_underscore_name)
        _warn(_msg(self))

    setattr(cls, attr_name, property(fget, fset, fdel, doc))
