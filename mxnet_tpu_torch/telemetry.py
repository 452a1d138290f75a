"""Process-global runtime metrics: counters, gauges and timers.

The port's own copy of the JAX package's ``telemetry.py`` core
(``inc`` / ``set_gauge`` / ``observe`` / ``snapshot``), keeping its
metric names — the decode tier ticks ``serve.tokens``,
``serve.decode_step_seconds``, ``serve.prefill_seconds``,
``serve.ttft_seconds``, ``serve.decode_slots_active`` and friends; the
batch tier ``serve.batches``, ``serve.rows``, ``serve.padded_rows``,
``serve.batch_occupancy``, ``serve.dispatch_seconds``,
``serve.sync_seconds`` and ``serve.e2e_seconds``; a hybridized block
``hybridize.cache_hits``, ``hybridize.cache_misses``,
``hybridize.compile_seconds`` (here the seconds of a warm run and a
CUDA-graph capture), ``hybridize.warmup_compiles``,
``hybridize.retrace_warnings``, ``hybridize.shape_churn_warnings``
and ``jit.warmup_seconds``.
Every call site guards on the module flag ``_ENABLED``
(``MXNET_TELEMETRY=0`` disables).  Timer percentiles come from a
bounded reservoir of the most recent samples.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Union

from .base import get_env

__all__ = ["set_enabled", "inc", "set_gauge", "gauge", "observe",
           "snapshot", "reset", "Counter", "Gauge", "Timer"]

_ENABLED: bool = bool(get_env("MXNET_TELEMETRY", 1, int))

_REGISTRY: "Dict[str, Union[Counter, Gauge, Timer]]" = {}
_REG_LOCK = threading.Lock()


def set_enabled(flag: bool) -> bool:
    """Flip recording at runtime; returns the previous state."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(flag)
    return prev


class Counter:
    """Monotonic accumulator."""

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, delta: Union[int, float] = 1):
        with self._lock:
            self.value += delta

    def summary(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-written value, high-water mark and the time of the last set."""

    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self.max = 0
        self.ts = 0.0
        self._lock = threading.Lock()

    def set(self, value: Union[int, float]):
        with self._lock:
            self.value = value
            self.ts = time.time()
            self.max = max(self.max, value)

    def reset_max(self):
        """Start a new high-water window at the current value."""
        with self._lock:
            self.max = self.value

    def summary(self) -> dict:
        return {"type": "gauge", "value": self.value, "max": self.max,
                "last_update_ts": round(self.ts, 3)}


class Timer:
    """Duration summary: exact count/total/min/max, p50/p99 over the most
    recent ``RESERVOIR`` samples."""

    RESERVOIR = 1024
    kind = "timer"

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0
        self._samples: deque = deque(maxlen=self.RESERVOIR)
        self._lock = threading.Lock()

    def observe(self, seconds: float):
        with self._lock:
            self.count += 1
            self.total += seconds
            self.min = min(self.min, seconds)
            self.max = max(self.max, seconds)
            self._samples.append(seconds)

    def summary(self) -> dict:
        with self._lock:
            samples = sorted(self._samples)
            count, total, mn, mx = self.count, self.total, self.min, self.max

        def pct(q):
            if not samples:
                return 0.0
            return samples[min(len(samples) - 1,
                               int(round(q * (len(samples) - 1))))]

        return {"type": "timer", "count": count, "value": total,
                "total": total, "min": mn if count else 0.0, "max": mx,
                "p50": pct(0.50), "p99": pct(0.99)}


def _get(name: str, cls):
    m = _REGISTRY.get(name)
    if m is None:
        with _REG_LOCK:
            m = _REGISTRY.setdefault(name, cls(name))
    if not isinstance(m, cls):
        raise TypeError(f"metric {name!r} already registered as {m.kind}")
    return m


def inc(name: str, delta: Union[int, float] = 1):
    if _ENABLED:
        _get(name, Counter).inc(delta)


def set_gauge(name: str, value: Union[int, float]):
    if _ENABLED:
        _get(name, Gauge).set(value)


def gauge(name: str) -> Gauge:
    """The gauge ``name``, registered on first use."""
    return _get(name, Gauge)


def observe(name: str, seconds: float):
    if _ENABLED:
        _get(name, Timer).observe(seconds)


def snapshot() -> Dict[str, dict]:
    """``{name: summary}`` of every metric; each summary has ``type`` and
    a uniform ``value`` (counter value / gauge value / timer total)."""
    with _REG_LOCK:
        items = sorted(_REGISTRY.items())
    return {name: m.summary() for name, m in items}


def reset():
    """Drop every metric."""
    with _REG_LOCK:
        _REGISTRY.clear()
