"""Deterministic fault injection (``MXNET_FAULT_INJECT``): the port's
copy of ``mxnet_tpu/resilience/chaos.py``, standard library only.

A production run dies in ways a green test suite never exercises: a
transfer between threads fails, a write is cut in half, a rank drops
mid barrier.  The recovery paths for those events are exactly the code
that never runs in CI, unless the failures are injectable.  This module
makes them injectable on one host, from a single env var,
deterministically.

Spec grammar (comma-separated clauses)::

    MXNET_FAULT_INJECT="site:kind:prob[:after][,site:kind:prob[:after]]"

  * ``site``  — a named seam (see below); free-form, unknown sites are
    simply never drawn.
  * ``kind``  — ``error`` (raise :class:`ChaosError` at the seam),
    ``torn`` (checkpoint writes: commit a truncated payload — the
    kill-mid-write torn-file case; other sites treat it as ``error``),
    ``delay`` (sleep ``MXNET_FAULT_DELAY`` seconds, default 0.05 — a
    slow disk / slow rank, for deadline tests).
  * ``prob``  — per-call fire probability in [0, 1].
  * ``after`` — optional integer N: the first N calls at the site never
    fire (lets a run make progress before the chaos starts).

Sites.  The port instruments one seam so far,
``serve.prefill_transfer``; the others are the JAX package's seams,
named here so that a spec written for it parses the same, and are never
drawn until the port grows them:

  ============================  =============================================
  ``serve.prefill_transfer``    the prefill->decode cache shipment
                                (serve/decode.py ``_admit_ready``) —
                                fires BEFORE the batch cache is touched,
                                so ``error`` fails only that request's
                                future (slot stays free, the decode loop
                                keeps serving); ``delay`` stalls the
                                admit by ``MXNET_FAULT_DELAY``
  ``engine.push``               not yet instrumented in the port
  ``dataloader.getitem``        not yet instrumented in the port
  ``dist.init``                 not yet instrumented in the port
  ``dist.allgather``            not yet instrumented in the port
  ``dist.barrier``              not yet instrumented in the port
  ``ckpt.write``                not yet instrumented in the port
  ``ckpt.read``                 not yet instrumented in the port
  ``dist.heartbeat``            not yet instrumented in the port
  ``obs.scrape``                not yet instrumented in the port
  ``edge.request``              not yet instrumented in the port
  ``fleet.dispatch``            not yet instrumented in the port
  ``fleet.spawn``               not yet instrumented in the port
  ============================  =============================================

Determinism: every site draws from its own ``random.Random`` seeded by
``MXNET_FAULT_SEED`` (default 0) xor a site-name hash, and fires as a
function of nothing but (seed, site, call index) — the same spec replays
the same failures, which is what makes chaos runs debuggable.
``prob=1.0`` needs no RNG at all.

Telemetry: every fired fault ticks ``chaos.injected`` plus the per-site
``chaos.injected.<site>`` counter.  Overhead when no
spec is configured: one module-global boolean read per seam.
"""
from __future__ import annotations

import os
import threading
import time as _time
import zlib
from random import Random
from typing import Callable, Dict, List, Optional

from .. import telemetry as _tel
from ..base import MXNetError, get_env

__all__ = ["ChaosError", "FaultSpec", "parse", "configure", "reset",
           "active", "maybe_fail", "draw", "wrap"]

_KINDS = ("error", "torn", "delay")


class ChaosError(MXNetError):
    """An injected fault (never raised by real failures — catchable by
    chaos harnesses without masking genuine errors)."""


class FaultSpec:
    """One parsed ``site:kind:prob[:after]`` clause."""

    __slots__ = ("site", "kind", "prob", "after")

    def __init__(self, site: str, kind: str, prob: float, after: int = 0):
        if kind not in _KINDS:
            raise MXNetError(
                f"fault kind {kind!r} unknown (expected one of {_KINDS})")
        if not 0.0 <= prob <= 1.0:
            raise MXNetError(f"fault prob {prob!r} outside [0, 1]")
        if after < 0:
            raise MXNetError(f"fault after {after!r} must be >= 0")
        self.site = site
        self.kind = kind
        self.prob = float(prob)
        self.after = int(after)

    def __repr__(self):
        return (f"FaultSpec({self.site}:{self.kind}:{self.prob}"
                f":{self.after})")


def parse(spec: str) -> List[FaultSpec]:
    """Parse a ``MXNET_FAULT_INJECT`` string into :class:`FaultSpec` s."""
    out: List[FaultSpec] = []
    for clause in spec.split(","):
        clause = clause.strip()
        if not clause:
            continue
        parts = clause.split(":")
        if len(parts) not in (3, 4):
            raise MXNetError(
                f"bad fault clause {clause!r}: expected "
                "site:kind:prob[:after]")
        site, kind, prob = parts[0], parts[1], parts[2]
        try:
            p = float(prob)
            after = int(parts[3]) if len(parts) == 4 else 0
        except ValueError as e:
            raise MXNetError(f"bad fault clause {clause!r}: {e}") from e
        out.append(FaultSpec(site, kind, p, after))
    return out


# -- module state -------------------------------------------------------------
# _ACTIVE is the one flag every seam reads (same contract as
# telemetry._ENABLED): no spec configured -> one global boolean per event.
_ACTIVE: bool = False
_SPECS: Dict[str, FaultSpec] = {}
_COUNTS: Dict[str, int] = {}
_RNGS: Dict[str, Random] = {}
_SEED: int = 0
_LOCK = threading.Lock()


def configure(spec: Optional[str] = None, seed: Optional[int] = None):
    """(Re)install fault specs and reset call counters.

    ``spec=None`` reads ``MXNET_FAULT_INJECT`` (empty/unset clears);
    ``seed=None`` reads ``MXNET_FAULT_SEED`` (default 0).  Returns the
    installed spec list."""
    global _ACTIVE, _SEED
    if spec is None:
        spec = os.environ.get("MXNET_FAULT_INJECT", "")
    if seed is None:
        seed = get_env("MXNET_FAULT_SEED", 0, int)
    specs = parse(spec) if spec else []
    # validate BEFORE mutating: a raising configure() must not leave a
    # half-installed spec set (or a stale _ACTIVE) behind
    sites = [s.site for s in specs]
    if len(sites) != len(set(sites)):
        dup = next(s for s in sites if sites.count(s) > 1)
        raise MXNetError(f"duplicate fault site {dup!r}")
    with _LOCK:
        _SPECS.clear()
        _COUNTS.clear()
        _RNGS.clear()
        _SEED = int(seed)
        for s in specs:
            _SPECS[s.site] = s
        _ACTIVE = bool(_SPECS)
    return specs


def reset():
    """Clear every installed spec (tests)."""
    configure("")


def active() -> bool:
    """True when any fault spec is installed (seams gate on this)."""
    return _ACTIVE


def draw(site: str) -> Optional[str]:
    """Count one call at ``site``; return the fault kind if a fault
    fires, else None.  Use :func:`maybe_fail` unless the seam needs
    custom handling (checkpoint torn-write cooperation)."""
    if not _ACTIVE:
        return None
    with _LOCK:
        spec = _SPECS.get(site)
        if spec is None:
            return None
        n = _COUNTS.get(site, 0) + 1
        _COUNTS[site] = n
        if n <= spec.after:
            return None
        if spec.prob < 1.0:
            rng = _RNGS.get(site)
            if rng is None:
                rng = _RNGS[site] = Random(
                    _SEED ^ zlib.crc32(site.encode()))
            if rng.random() >= spec.prob:
                return None
        kind = spec.kind
    _tel.inc("chaos.injected")
    _tel.inc(f"chaos.injected.{site}")
    return kind


def maybe_fail(site: str):
    """The standard seam hook: draw, and act on the fired kind —
    ``error``/``torn`` raise :class:`ChaosError`, ``delay`` sleeps
    ``MXNET_FAULT_DELAY`` seconds."""
    kind = draw(site)
    if kind is None:
        return
    if kind == "delay":
        _time.sleep(get_env("MXNET_FAULT_DELAY", 0.05, float))
        return
    raise ChaosError(
        f"injected fault at {site!r} (MXNET_FAULT_INJECT, "
        f"call #{_COUNTS.get(site, 0)})")


def wrap(site: str, fn: Callable) -> Callable:
    """Wrap a callable so the fault fires *inside* it — the engine uses
    this so an injected push failure flows through the normal poison →
    rethrow-at-wait error contract instead of failing the submit call."""

    def chaotic():
        maybe_fail(site)
        return fn()

    return chaotic


# Read the env once at import: forked dataloader workers inherit the
# parsed spec, and a run launched with MXNET_FAULT_INJECT set needs no
# code changes to come under chaos.
if os.environ.get("MXNET_FAULT_INJECT"):
    configure()
