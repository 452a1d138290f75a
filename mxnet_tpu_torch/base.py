"""Foundational helpers: the framework error, the typed env-var
accessor, the data directory and the name registry.

The port's own copy of ``MXNetError``, ``set_error_hook``, ``get_env``,
``data_dir`` and ``Registry`` (the JAX package's ``base.py``); the port
imports nothing from that package.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Generic, Iterator, Optional, TypeVar

__all__ = ["MXNetError", "DeferredInitializationError", "set_error_hook",
           "get_env", "data_dir", "Registry"]

# Observer called with every constructed MXNetError (the trace flight
# recorder arms this to dump its span rings at the failure point, even
# when the error is later caught).  It must never raise into the
# constructor: whatever it raises is swallowed.
_ERROR_HOOK: Optional[Callable[[BaseException], None]] = None


def set_error_hook(hook: Optional[Callable[[BaseException], None]]):
    """Install (or clear, with None) the MXNetError construction
    observer; returns the previous hook."""
    global _ERROR_HOOK
    prev = _ERROR_HOOK
    _ERROR_HOOK = hook
    return prev


class MXNetError(RuntimeError):
    """Top-level framework error (ref: include/mxnet/base.h dmlc::Error)."""

    def __init__(self, *args):
        super().__init__(*args)
        hook = _ERROR_HOOK
        if hook is not None:
            try:
                hook(self)
            except Exception:
                pass


class DeferredInitializationError(MXNetError):
    """A tensor whose shape waits for the first forward was used before
    it (``mxnet_tpu/base.py:56``); ``Block.__call__`` catches it, infers
    the layer's widths from the input and runs the forward again.  The
    error hook is not called: the first forward of every deferred layer
    raises one, and that is no failure."""

    def __init__(self, *args):
        RuntimeError.__init__(self, *args)


_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off", ""}


def get_env(name: str, default: Any = None, typ: Optional[type] = None) -> Any:
    """Typed env-var accessor, the analogue of ``dmlc::GetEnv``."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    t = typ if typ is not None else (type(default) if default is not None else str)
    if t is bool:
        low = raw.strip().lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
        raise MXNetError(f"env var {name}={raw!r} is not a boolean")
    try:
        return t(raw)
    except ValueError as e:
        raise MXNetError(f"env var {name}={raw!r} is not a valid {t.__name__}") from e


def data_dir() -> str:
    """Data cache directory, $MXNET_HOME or ~/.mxnet
    (ref python/mxnet/base.py data_dir)."""
    return os.path.expanduser(get_env("MXNET_HOME", os.path.join("~", ".mxnet")))


T = TypeVar("T")


class Registry(Generic[T]):
    """Generic name -> object registry (the JAX package's ``Registry``):
    ``register`` works as a bare decorator, a decorator with a name, or
    a call with the object; names are case-insensitive by default."""

    def __init__(self, kind: str, ignore_case: bool = True):
        self.kind = kind
        self._ignore_case = ignore_case
        self._map: Dict[str, T] = {}

    def _key(self, name: str) -> str:
        return name.lower() if self._ignore_case else name

    def register(self, name: Optional[str] = None, obj: Optional[T] = None, *,
                 allow_override: bool = False):
        """Register ``obj`` under ``name``; usable as decorator."""

        def do(o: T, nm: Optional[str]) -> T:
            n = self._key(nm if nm is not None else getattr(o, "__name__"))
            if n in self._map and not allow_override and self._map[n] is not o:
                raise MXNetError(f"{self.kind} '{n}' is already registered")
            self._map[n] = o
            return o

        if obj is not None:
            return do(obj, name)
        if callable(name) and not isinstance(name, str):
            return do(name, None)  # bare @registry.register
        return lambda o: do(o, name)

    def get(self, name: str) -> T:
        key = self._key(name)
        if key not in self._map:
            raise MXNetError(
                f"unknown {self.kind} '{name}'; known: {sorted(self._map)}")
        return self._map[key]

    def find(self, name: str) -> Optional[T]:
        return self._map.get(self._key(name))

    def __contains__(self, name: str) -> bool:
        return self._key(name) in self._map

    def __iter__(self) -> Iterator[str]:
        return iter(self._map)

    def items(self):
        return self._map.items()
