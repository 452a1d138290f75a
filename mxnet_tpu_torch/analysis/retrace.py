"""Retrace guard: flag unbounded signature growth per HybridBlock.

The port of ``mxnet_tpu/analysis/retrace.py``, with its thresholds and
their variables.  The telemetry *counts* captures
(``hybridize.cache_misses`` / ``compile_seconds``); this guard turns the
count into an actionable diagnostic.  ``_CachedOp`` reports every newly
captured signature here; when one block crosses
``MXNET_RETRACE_WARN_LIMIT`` distinct signatures (default 8) the guard
diffs the accumulated signatures, points at the input slot that varies
— distinguishing parameter/state slots from the caller's argument
leaves — and emits a **J001** diagnostic plus a
``hybridize.retrace_warnings`` telemetry tick, once per block type.

**J002 (shape-churn storm)** fires earlier and on a rate, not a count:
a block that keeps capturing a NEW signature at least every
``MXNET_SHAPE_CHURN_EVERY`` calls (default 4) once it has accumulated
``MXNET_SHAPE_CHURN_MIN`` signatures (default 4), with **no
ShapeBucketer attached**.  A bucketed block never fires either rule:
its signature set is bounded by construction (at most
``len(buckets)``), so the guard stays silent for warmup sweeps over
large bucket grids.

A signature is ``(cache_key, ((shape, dtype), ...))`` where
``cache_key[2]`` is ``n_state``: the leading ``n_state`` input slots are
the block's parameters and buffers (see ``gluon/block.py``).  Varying
*argument* slots mean the caller feeds unbucketed shapes (pad or bucket
them); varying *state* slots mean parameters changed shape or dtype
between calls.

Stdlib-only at import; telemetry/logging engage lazily.
"""
from __future__ import annotations

import logging
import os
import threading
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .diagnostics import Diagnostic

__all__ = ["on_trace", "report", "reset", "set_limit", "get_limit",
           "set_churn_params"]

_LOG = logging.getLogger(__name__)

_LOCK = threading.Lock()
_LIMIT = int(os.environ.get("MXNET_RETRACE_WARN_LIMIT", "8"))
_CHURN_MIN = int(os.environ.get("MXNET_SHAPE_CHURN_MIN", "4"))
_CHURN_EVERY = int(os.environ.get("MXNET_SHAPE_CHURN_EVERY", "4"))
_warned: Set[str] = set()
_churn_warned: Set[str] = set()
_DIAGS: List[Diagnostic] = []


def set_limit(n: int) -> int:
    """Set the distinct-signature threshold; returns the previous one."""
    global _LIMIT
    prev, _LIMIT = _LIMIT, int(n)
    return prev


def get_limit() -> int:
    return _LIMIT


def set_churn_params(min_sigs: Optional[int] = None,
                     every: Optional[int] = None) -> Tuple[int, int]:
    """Set the J002 thresholds (min distinct signatures, max calls per
    new signature); returns the previous ``(min, every)`` pair."""
    global _CHURN_MIN, _CHURN_EVERY
    prev = (_CHURN_MIN, _CHURN_EVERY)
    if min_sigs is not None:
        _CHURN_MIN = int(min_sigs)
    if every is not None:
        _CHURN_EVERY = int(every)
    return prev


def _varying_slots(sigs: List[tuple]) -> List[Tuple[int, Set[tuple]]]:
    """Input slots whose (shape, dtype) differs across signatures."""
    seen: Dict[int, Set[tuple]] = {}
    for _, leaves in sigs:
        for i, spec in enumerate(leaves):
            seen.setdefault(i, set()).add(tuple(spec))
    return [(i, specs) for i, specs in sorted(seen.items())
            if len(specs) > 1]


def _state_count(sig: tuple) -> int:
    key = sig[0]
    if isinstance(key, tuple) and len(key) >= 3 and isinstance(key[2], int):
        return key[2]
    return 0


def _emit_churn(block_label: str, sigs: List[tuple], n_calls: int):
    """J002: new signatures keep arriving every few calls and no
    bucketer is attached — name the churning slot and the fix."""
    n_state = _state_count(sigs[-1])
    varying = _varying_slots(sigs)
    if varying:
        i, specs = varying[0]
        what = (f"state/param slot #{i}" if i < n_state
                else f"argument leaf #{i - n_state}")
        shapes = sorted(str(s[0]) for s in specs)
        shown = ", ".join(shapes[:5])
        if len(shapes) > 5:
            shown += f", … ({len(shapes)} shapes)"
        culprit = f"{what} churns: {shown}"
    else:
        culprit = "the cache key itself churns (argument structure flips)"
    msg = (f"{block_label} shape-churn storm: {len(sigs)} distinct "
           f"captured signatures in {n_calls} calls (a new CUDA graph "
           f"capture every "
           f"~{max(1, n_calls // len(sigs))} calls) and no ShapeBucketer "
           f"attached — {culprit}; attach hybridize(bucketer=...) or "
           f"DataLoader(bucket_spec=...) to bound the signature set")
    d = Diagnostic(path="<retrace>", line=0, code="J002", message=msg,
                   symbol=block_label, source="retrace")
    with _LOCK:
        _DIAGS.append(d)
    try:
        from .. import telemetry as _tel

        _tel.inc("hybridize.shape_churn_warnings")
    except Exception:
        pass
    _LOG.warning("retrace-guard J002: %s", msg)


def on_trace(block_label: str, sig: tuple, traced: Iterable[tuple],
             n_calls: Optional[int] = None, bucketed: bool = False):
    """Called by _CachedOp after adding a newly traced signature.

    ``n_calls`` is the block's total forward-call count (``None`` for
    deliberate traces — warmup sweeps — which are exempt from the churn
    rate); ``bucketed`` suppresses both rules: a bucketed block's
    signature set is bounded by construction."""
    sigs = list(traced)
    if bucketed:
        return
    # J002: rate-based, fires before J001's absolute limit.  The
    # n_calls floor makes the churn SUSTAINED: a bounded shape set that
    # is merely discovered early (e.g. a DataLoader(bucket_spec=...)
    # pipeline hitting each of its buckets in the first epoch) stops
    # producing traces before the floor and never fires — genuine churn
    # keeps tracing and crosses it.
    if n_calls is not None and len(sigs) >= _CHURN_MIN \
            and n_calls >= _CHURN_MIN * _CHURN_EVERY \
            and n_calls <= len(sigs) * _CHURN_EVERY:
        with _LOCK:
            fresh = block_label not in _churn_warned
            if fresh:
                _churn_warned.add(block_label)
        if fresh:
            _emit_churn(block_label, sigs, n_calls)
    if len(sigs) < _LIMIT:
        return
    with _LOCK:
        if block_label in _warned:
            return
        _warned.add(block_label)
    n_state = _state_count(sig)
    varying = _varying_slots(sigs)
    if varying:
        parts = []
        for i, specs in varying[:4]:
            what = (f"state/param slot #{i}" if i < n_state
                    else f"argument leaf #{i - n_state}")
            shapes = sorted(str(s[0]) for s in specs)
            shown = ", ".join(shapes[:5])
            if len(shapes) > 5:
                shown += f", … ({len(shapes)} shapes)"
            parts.append(f"{what} varies: {shown}")
        culprit = "; ".join(parts)
    else:
        keys = {s[0] for s in sigs}
        culprit = (f"{len(keys)} distinct cache keys (argument structure "
                   "or train/eval mode flips per call)")
    msg = (f"{block_label} accumulated {len(sigs)} distinct captured "
           f"signatures (limit {_LIMIT}) — every new one pays a warm run "
           f"and a CUDA graph capture; {culprit}")
    d = Diagnostic(path="<retrace>", line=0, code="J001", message=msg,
                   symbol=block_label, source="retrace")
    with _LOCK:
        _DIAGS.append(d)
    try:
        from .. import telemetry as _tel

        _tel.inc("hybridize.retrace_warnings")
    except Exception:
        pass
    _LOG.warning("retrace-guard J001: %s", msg)


def report() -> List[Diagnostic]:
    with _LOCK:
        return list(_DIAGS)


def reset():
    with _LOCK:
        _warned.clear()
        _churn_warned.clear()
        _DIAGS.clear()
