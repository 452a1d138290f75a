"""Token-level continuous batching for autoregressive decode.

The port of ``mxnet_tpu/serve/decode.py``.  Scheduling is at TOKEN
granularity over a fixed set of cache *slots*:

  * the batch cache is one tuple of ``(S, ...)`` tensors (``S`` slots);
    a request claims a free slot at any step boundary — its prompt runs
    as a one-row prefill, the row cache is copied into the slot, and the
    request rides the next decode step with everyone already in flight;
  * a request leaves on EOS, max-tokens, cancel or deadline, and its
    slot frees at once;
  * the shared capacity axis ``C`` is bucketed (``capacity_buckets``):
    when a row would outgrow ``C`` the whole batch zero-extends to the
    next bucket; at the last bucket the full rows finish truncated.  A
    cache whose shape does not depend on the capacity (the LSTM
    carrier's recurrent state, :attr:`DecodeEntry.capacity_static`)
    never grows and never truncates a row.

Prefill and every decode step run the model's attention through the
hand-written decode kernel on the card (``ops.attention``).  The entry
hybridizes the LM's forward twice: as the decode step with its cache
donated, and as the prefill with its cache NOT donated; and a
:class:`_CacheMover` and a :class:`_CacheGrower`.  Its warmup captures
the JAX package's grid (``DecodeEntry.warmup``): on the card each step,
prefill, move and growth is then one CUDA-graph replay.  The lengths stay
on the card, and the step graph reads and writes the entry's batch cache
in place, so a step neither reads back nor copies the cache.  A prefill
graph copies the row cache it is given into its own input and returns a
copy of its output, as a JAX executable returns a fresh buffer: every
prefill owns the row cache it returns, so a finished prefill can wait in
a queue while another prefill of the same bucket runs.

Sampling runs on the host between steps: greedy (``temperature=0``) or
temperature/top-k with one ``torch.Generator`` per request, deterministic
under a fixed ``seed``.

**Disaggregated prefill** (``prefill_workers > 0`` or
``MXNET_PREFILL_WORKERS``): prompt forwards move off the decode loop
onto a pool of ``mx-prefill-<model>-<i>`` threads.  A worker runs the
prompt bucket at its own capacity bucket, samples the first token, and
ships a :class:`_Ready` (the finished row cache and its length) back to
the loop, which claims a slot and moves the cache across with
:class:`_CacheMover`: the worker's capacity bucket and the batch's may
differ, so only the intersecting page window is copied
(``parallel.layout.intersect_box``, ``ops.attention.cache_page_copy``).
The shipment crosses the ``serve.prefill_transfer`` fault seam
(``resilience.chaos``) BEFORE touching the batch cache: an injected
fault fails only that request's future and the loop keeps serving.  The
workers keep the default stream, so the order in which the host submits
a prefill, its copy into the trie and its move is the order on the card.

**Prefix cache** (:class:`~mxnet_tpu_torch.serve.prefix.PrefixCache`,
on by default with the pool for page-layout models): workers look shared
prompt prefixes up in a block-aligned trie, materialize the retained
pages into a row cache, and forward only the remainder, from
``cache_len`` = the matched length; a hit adds no
``serve.prefill_seconds`` observation, its remainder runs under
``serve.prefix_fill_seconds``.

Telemetry (the JAX package's names): ``serve.tokens``,
``serve.decode_step_seconds``, ``serve.prefill_seconds``,
``serve.prefix_fill_seconds``, ``serve.ttft_seconds``,
``serve.cache_move_seconds``, ``serve.decode_slots_active``,
``serve.decode_requests``, ``serve.decode_submitted``,
``serve.cache_grows``, ``serve.rejected``, ``serve.deadline_exceeded``,
``serve.cancelled``, ``serve.cache_quant_bytes_saved``, and the trie's
``serve.cache_*`` set.  The JAX package's trace spans and TTFT objective
are not ported (no ``trace`` or ``obs`` package in the port yet).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import telemetry as _tel
from ..base import MXNetError, get_env
from ..gluon.block import HybridBlock, _clone_tree
from ..jit.bucketing import _Policy
from ..ops import attention as _att
from ..parallel import layout as _layout
from ..resilience import chaos as _chaos
from .coalescer import ClosedError, DeadlineError, RejectedError
from .prefix import PrefixCache

__all__ = ["DecodeEntry", "DecodeServer", "DecodeFuture", "TokenRangeError",
           "register_decode", "decode_server", "decode_submit", "generate",
           "shutdown_decode"]

class TokenRangeError(MXNetError):
    """A prompt token id outside ``[0, vocab_size)``, refused at submit
    (HTTP 400 at an edge) instead of reaching the embedding gather."""

    status = 400


def _quant_bytes_saved(cache) -> int:
    """Device memory an int8 KV cache saves against the same geometry in
    f32: 3 bytes per int8 element, minus the f32 scale pages."""
    leaves = [leaf for layer in cache for leaf in layer]
    if not any(leaf.dtype == torch.int8 for leaf in leaves):
        return 0
    return sum(3 * leaf.numel() if leaf.dtype == torch.int8
               else -leaf.numel() * leaf.element_size() for leaf in leaves)


class _DecodeStep(HybridBlock):
    """The LM's forward as a block of the entry's own: its graphs belong
    to this entry, so a second entry over the same LM (a re-registration
    while the old server drains) captures its own and leaves these
    alone.  The entry hybridizes one for the decode step, with the cache
    donated (position 1; its graphs are keyed on the entry's batch
    buffers), and one for the prefill, with nothing donated (its graphs
    are keyed on shapes alone, and each call returns a cache of its
    own)."""

    def __init__(self, lm):
        super().__init__()
        self.lm = lm

    def forward(self, tokens, cache, cache_len, n_tokens):
        return self.lm(tokens, cache, cache_len, n_tokens)


class _CacheMover(HybridBlock):
    """Copy a one-row cache into the batch cache at a slot given as a
    tensor on the card (the JAX ``_CacheMover``'s traced slot), so one
    captured graph serves every slot.  A (B, H, C, dh) page leaf moves
    the page window both capacities hold
    (``parallel.layout.intersect_box`` on axis 2, through
    ``ops.attention.cache_page_copy``); any other leaf (the LSTM's (B, U)
    state) is spliced as a whole row.  Hybridized with the batch cache
    donated (position 0): it is updated in place and returned."""

    def forward(self, batch_cache, row_cache, slot):
        for b_layer, r_layer in zip(batch_cache, row_cache):
            for b, r in zip(b_layer, r_layer):
                if r.ndim == 4:
                    win = _layout.intersect_box(((0, r.shape[2]),),
                                                ((0, b.shape[2]),))
                    _att.cache_page_copy(b, r, win[0][1] - win[0][0],
                                         dst_row=slot)
                else:
                    row = slot.reshape(-1)[:1].long().clamp(
                        0, b.shape[0] - r.shape[0])
                    rows = row + torch.arange(r.shape[0], device=b.device)
                    b.index_copy_(0, rows, r.to(b.dtype))
        return batch_cache


class _CacheGrower(HybridBlock):
    """Zero-extend every cache leaf's capacity axis (axis 2): the cache
    is copied into ``target``, a cache of the next capacity bucket, and
    the rest of ``target`` is zeroed.  The JAX ``_CacheGrower`` returns a
    new cache of the target's shape; here the target is the entry's
    buffer of that capacity (donated, position 1), which the next decode
    step's graph reads in place, so growth is the one copy of the batch
    cache."""

    def forward(self, cache, target):
        for layer, t_layer in zip(cache, target):
            for leaf, t in zip(layer, t_layer):
                c = leaf.shape[2]
                t[:, :, :c] = leaf
                t[:, :, c:] = 0
        return target


class _DecodeRequest:
    __slots__ = ("id", "model", "prompt", "max_new_tokens", "temperature",
                 "top_k", "gen", "tokens", "truncated", "t0", "on_token",
                 "deadline", "cancelled", "finish_reason", "_event", "_error")

    def __init__(self, rid, model, prompt, max_new_tokens, temperature,
                 top_k, seed, on_token=None, deadline=None):
        self.id = rid
        self.model = model
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.gen = torch.Generator().manual_seed(
            int(seed if seed is not None else rid))
        self.tokens: List[int] = []
        self.truncated = False
        self.t0 = time.perf_counter()       # submit time; TTFT anchor
        # streaming sink: each token id, then None at resolution
        self.on_token = on_token
        self.deadline = deadline            # absolute time.monotonic()
        self.cancelled = False
        # "stop" | "length" | "deadline" | "cancelled" | "error"
        self.finish_reason: Optional[str] = None
        self._event = threading.Event()
        self._error: Optional[BaseException] = None

    def expired(self, now: Optional[float] = None) -> bool:
        return self.deadline is not None and \
            (now if now is not None else time.monotonic()) >= self.deadline


def _emit(req: _DecodeRequest, tok: Optional[int]):
    """Feed one token (or the ``None`` terminal) to the streaming sink; a
    broken sink is dropped so the loop keeps serving the other slots."""
    cb = req.on_token
    if cb is None:
        return
    try:
        cb(tok)
    except Exception:  # noqa: BLE001 — a sink bug, not a serving bug
        req.on_token = None


def _fail(req: _DecodeRequest, err: BaseException):
    """Resolve a request with an error (non-MXNetErrors wrapped)."""
    req._error = err if isinstance(err, MXNetError) \
        else MXNetError(f"{type(err).__name__}: {err}")
    req._error.__cause__ = err
    req.finish_reason = "error"
    req._event.set()
    _emit(req, None)


class _Ready:
    """A pool-prefilled request in flight from prefill to decode: the
    finished one-row cache, which it owns until the loop's move, plus the
    geometry the decode loop needs to redistribute it into a slot
    (``src_cap`` = the worker's capacity bucket, ``min_capacity`` = the
    prompt bucket the batch must reach before the valid pages fit)."""

    __slots__ = ("req", "row_cache", "cache_len", "src_cap", "min_capacity")

    def __init__(self, req, row_cache, cache_len, src_cap, min_capacity):
        self.req = req
        self.row_cache = row_cache
        self.cache_len = cache_len
        self.src_cap = src_cap
        self.min_capacity = min_capacity


class DecodeFuture:
    """Handle returned by ``submit()``; ``result()`` blocks for the
    generated token ids."""

    __slots__ = ("_req",)

    def __init__(self, req: _DecodeRequest):
        self._req = req

    @property
    def id(self) -> int:
        return self._req.id

    @property
    def truncated(self) -> bool:
        """True when generation stopped because the cache ran out of
        capacity buckets."""
        return self._req.truncated

    @property
    def finish_reason(self) -> Optional[str]:
        return self._req.finish_reason

    def tokens_so_far(self) -> List[int]:
        return list(self._req.tokens)

    def cancel(self):
        """Release the slot at the next step boundary; the future resolves
        with the partial tokens (``finish_reason == "cancelled"``)."""
        self._req.cancelled = True

    def done(self) -> bool:
        return self._req._event.is_set()

    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self._req._event.wait(timeout):
            raise MXNetError(
                f"decode request {self._req.id} ({self._req.model}) still "
                f"pending after {timeout}s")
        if self._req._error is not None:
            raise self._req._error
        return self._req.tokens


class DecodeEntry:
    """One registered decode model: the LM, its bucket grids, the cache
    buffers and the captured grid.

    ``block`` follows the decode contract of
    ``gluon/model_zoo/decoder.py``: ``begin_cache(batch, capacity)`` and
    ``block(tokens, cache, cache_len, n_tokens) -> (logits, cache)``.
    ``precision="int8"`` switches its KV cache to int8 pages with
    per-position scales.  :attr:`capacity_static` says whether the
    cache's shape ignores the capacity (found by probing
    ``begin_cache(1, 1)`` against ``begin_cache(1, 2)``, as the JAX
    entry does).

    The entry hybridizes the LM's forward twice (:attr:`lm_step` with
    its cache donated, :attr:`prefill_step` with nothing donated; each a
    :class:`_DecodeStep` of its own), and a :class:`_CacheMover` and a
    :class:`_CacheGrower` beside them, as the JAX entry hybridizes the
    LM and those two (``hybridize(False)`` on :attr:`blocks` runs them
    eagerly, with ``warmup()`` after it).  It keeps one batch cache for
    each capacity bucket, the donated buffer of its step graph, so a
    decode loop that rebinds to what a step returns passes the graph the
    same buffer and copies no cache; growth copies it once, into the
    next capacity's buffer.  A prefill starts from a new zeroed row
    cache (or a prefix hit's) and returns a row cache of its own: on the
    card the graph copies it in and out, two row-cache copies a prefill,
    so a row cache is never shared between two prefills in flight."""

    def __init__(self, name: str, block, *, slots: int = 4,
                 prompt_buckets: Sequence[int] = (8, 16, 32),
                 capacity_buckets: Sequence[int] = (32, 64),
                 eos_id: Optional[int] = None, max_new_tokens: int = 32,
                 warmup: bool = True, precision: Optional[str] = None):
        if not hasattr(block, "begin_cache"):
            raise MXNetError(
                f"decode model {name!r} has no begin_cache(batch, capacity) "
                "— see gluon/model_zoo/decoder.py for the contract")
        if slots < 1:
            raise MXNetError(f"slots must be >= 1, got {slots}")
        if precision not in (None, "int8"):
            raise MXNetError(
                f"decode model {name!r}: precision={precision!r} "
                "unsupported; None or 'int8'")
        if precision == "int8" and \
                getattr(block, "_cache_dtype", False) is False:
            raise MXNetError(
                f"decode model {name!r} has no quantizable KV cache "
                "(no cache_dtype contract — the LSTM carrier's recurrent "
                "state has no per-position pages to quantize); "
                "precision='int8' needs the transformer family")
        if precision == "int8":
            block._cache_dtype = "int8"
        self.precision = precision
        self.name = name
        self.block = block
        self.slots = int(slots)
        self.eos_id = eos_id
        self.max_new_tokens = int(max_new_tokens)
        self.prompt_policy = _Policy(list(prompt_buckets))
        self.capacity_policy = _Policy(list(capacity_buckets))
        self.prompt_buckets = tuple(self.prompt_policy.enumerate())
        self.capacity_buckets = tuple(self.capacity_policy.enumerate())
        if self.prompt_buckets[-1] > self.capacity_buckets[-1]:
            raise MXNetError(
                f"largest prompt bucket {self.prompt_buckets[-1]} exceeds "
                f"largest capacity bucket {self.capacity_buckets[-1]} — the "
                "prompt's KV rows must fit the cache")
        # probe two DISTINCT capacities (the bucket list may hold only one)
        shapes = [[tuple(leaf.shape) for layer in block.begin_cache(1, c)
                   for leaf in layer] for c in (1, 2)]
        self.capacity_static = shapes[0] == shapes[1]
        self.device = getattr(block, "device", None) or \
            next(block.parameters()).device
        # the buffers are made at first use, by the warmup or by the
        # server's worker, which may run beside a later warmup() call
        self._batch: Dict[int, tuple] = {}
        self._buf_lock = threading.Lock()
        self._ones = torch.ones(self.slots, dtype=torch.int64,
                                device=self.device)
        self._slot_ids = torch.arange(self.slots, dtype=torch.int64,
                                      device=self.device)
        self.lm_step = _DecodeStep(block)
        self.prefill_step = _DecodeStep(block)
        self.mover = _CacheMover()
        self.grower = _CacheGrower()
        self.lm_step.hybridize(donate_args=(1,))
        self.prefill_step.hybridize()
        self.mover.hybridize(donate_args=(0,))
        self.grower.hybridize(donate_args=(1,))
        if warmup:
            self.warmup()

    @property
    def blocks(self) -> tuple:
        """The entry's four hybridized blocks: the LM's step, its
        prefill, the mover and the grower."""
        return (self.lm_step, self.prefill_step, self.mover, self.grower)

    # ---------------------------------------------------------- buffers
    def batch_cache(self, capacity: int):
        """The entry's batch cache of ``capacity`` (made at first use)."""
        with self._buf_lock:
            cache = self._batch.get(capacity)
            if cache is None:
                cache = self._batch[capacity] = \
                    self.block.begin_cache(self.slots, capacity)
        return cache

    @staticmethod
    def zero_cache(cache):
        with torch.no_grad():
            torch._foreach_zero_([leaf for layer in cache for leaf in layer])
        return cache

    # ---------------------------------------------------------- warmup
    def warmup(self) -> int:
        """Capture the JAX entry's grid (``mxnet_tpu/serve/decode.py:
        414-446``): a prefill for each (prompt bucket <= capacity) pair
        and a step for each capacity (the first only, for a
        capacity-static cache); a move for each (destination, source)
        capacity pair; a growth for each consecutive pair.  Without
        hybridization it runs each once eagerly (kernel builds, the
        allocator).  It writes to none of the entry's buffers, so it may
        run beside the entry's server.  Returns the number of new
        captures (or forwards)."""
        s = self.slots
        caps = self.capacity_buckets[:1] if self.capacity_static \
            else self.capacity_buckets
        steps = [(np.zeros((s, 1), np.int64), self.batch_cache(c),
                  np.zeros(s, np.int64), self._ones) for c in caps]
        prefills = [(np.zeros((1, tp), np.int64), self.block.begin_cache(1, c),
                     np.zeros(1, np.int64), np.ones(1, np.int64))
                    for c in caps for tp in self.prompt_buckets if tp <= c]
        slot = self._slot_ids[:1]
        movers = [(self.batch_cache(cd), self.block.begin_cache(1, cs), slot)
                  for cd in caps for cs in caps]
        growers = [(self.batch_cache(lo), self.batch_cache(hi))
                   for lo, hi in zip(caps, caps[1:])]
        n = 0
        for blk, samples in zip(self.blocks,
                                (steps, prefills, movers, growers)):
            if not samples:
                continue
            if blk._active:
                n += blk.warmup(samples)
                continue
            with torch.no_grad():
                for sample in samples:
                    # on copies: the buffers may be a running server's
                    blk(*_clone_tree(sample))
                    n += 1
        return n

    # ------------------------------------------------------- execution
    def prefill(self, tokens: np.ndarray, true_len: int, capacity: int):
        """One-row prompt forward from an empty cache: ``(last_logits (V,)
        numpy, row_cache)``; ``tokens`` is already padded to a bucket,
        the row cache is the caller's own."""
        return self.prefill_window(tokens, self.block.begin_cache(1, capacity),
                                   0, true_len)

    def prefill_window(self, tokens: np.ndarray, cache, cache_len: int,
                       n_new: int):
        """Forward ``n_new`` real tokens (padded window ``tokens`` (1, Tp))
        against a row cache whose first ``cache_len`` positions are
        already valid — the prefix-hit remainder path: ``(last_logits
        (V,) numpy, row_cache)``.  It replays the prefill's graphs
        (``cache_len`` and ``n_tokens`` are inputs, not part of the
        signature), so a hit needs no warmup of its own."""
        with torch.no_grad():           # serving keeps no autograd graph
            logits, cache = self.prefill_step(
                tokens, cache, np.full(1, cache_len, np.int64),
                np.full(1, n_new, np.int64))
        return logits[0, n_new - 1].float().cpu().numpy(), cache

    def step(self, pending: np.ndarray, cache, lens: np.ndarray):
        """One decode step for the whole slot batch: ``(logits (S, V)
        numpy, cache)``."""
        with torch.no_grad():
            logits, cache = self.lm_step(
                pending.reshape(self.slots, 1).astype(np.int64), cache,
                lens.astype(np.int64), self._ones)
        return logits[:, 0, :].float().cpu().numpy(), cache

    def move(self, cache, row_cache, slot: int):
        """Copy ``row_cache`` into batch ``slot``; returns the batch
        cache."""
        with torch.no_grad():
            return self.mover(cache, row_cache,
                              self._slot_ids[slot:slot + 1])

    def grow(self, cache, capacity: int):
        """The batch cache zero-extended into the entry's buffer of
        ``capacity``."""
        with torch.no_grad():
            return self.grower(cache, self.batch_cache(capacity))


class DecodeServer:
    """The token-level scheduler: one worker thread
    (``mx-decode-worker-<name>``) owns the slot batch and the batch
    cache; ``submit`` only enqueues under the condition variable.

    With ``prefill_workers > 0`` (default ``MXNET_PREFILL_WORKERS``, 0 =
    unified) the server is disaggregated: submits land on the prefill
    queue, ``mx-prefill-<model>-<i>`` threads run prompt forwards to
    completion (consulting ``prefix_cache`` — a :class:`PrefixCache`;
    ``None`` creates one for page-layout models when there is a pool,
    ``True`` always, ``False`` never), and finished shipments re-enter
    the decode queue as :class:`_Ready` items.  One condition variable
    guards both queues and the in-flight prefill count, so ``close()``
    drains exactly: the loop exits only when closed, both queues are
    empty, no prefill is in flight and every slot has resolved."""

    def __init__(self, entry: DecodeEntry, queue_max: Optional[int] = None,
                 prefill_workers: Optional[int] = None, prefix_cache=None):
        self.entry = entry
        self._queue_max = queue_max if queue_max is not None \
            else get_env("MXNET_SERVE_QUEUE_MAX", 1024, int)
        self._prefill_workers = int(
            prefill_workers if prefill_workers is not None
            else get_env("MXNET_PREFILL_WORKERS", 0, int))
        if self._prefill_workers < 0:
            raise MXNetError(
                f"prefill_workers must be >= 0, got {self._prefill_workers}")
        if prefix_cache is None:
            self.prefix = PrefixCache(name=entry.name) \
                if self._prefill_workers > 0 and not entry.capacity_static \
                else None
        elif prefix_cache is True:
            self.prefix = PrefixCache(name=entry.name)
        elif prefix_cache is False:
            self.prefix = None
        else:
            self.prefix = prefix_cache
        if self.prefix is not None and entry.capacity_static:
            raise MXNetError(
                f"decode model {entry.name!r} has a capacity-independent "
                "cache (no per-position pages) — the prefix cache cannot "
                "slice it; pass prefix_cache=False")
        self._q: deque = deque()
        self._pq: deque = deque()
        self._prefill_busy = 0
        self._cv = threading.Condition()
        self._closed = False
        self._seq = 0
        # worker-owned state
        self._cap_i = 0
        self._cache = None
        self._active: List[Optional[_DecodeRequest]] = [None] * entry.slots
        self._pending = np.zeros(entry.slots, np.int64)
        self._lens = np.zeros(entry.slots, np.int64)
        self._steps = 0
        self._thread = threading.Thread(
            target=self._loop, name=f"mx-decode-worker-{entry.name}",
            daemon=True)
        self._thread.start()
        self._prefill_threads = [
            threading.Thread(target=self._prefill_loop,
                             name=f"mx-prefill-{entry.name}-{i}", daemon=True)
            for i in range(self._prefill_workers)]
        for t in self._prefill_threads:
            t.start()

    # ------------------------------------------------------------- API
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               temperature: float = 0.0, top_k: int = 0,
               seed: Optional[int] = None, on_token=None,
               deadline: Optional[float] = None) -> DecodeFuture:
        """Enqueue one generation request.  ``on_token`` is called with
        every sampled token id, then once with ``None``; ``deadline``
        (seconds from now) bounds the request end to end — an expired
        request releases its slot at the next step boundary and its
        future raises :class:`DeadlineError`."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise MXNetError("decode prompt must be non-empty")
        vocab = getattr(self.entry.block, "_vocab_size", None)
        if vocab is not None:
            bad = [t for t in prompt if t < 0 or t >= vocab]
            if bad:
                raise TokenRangeError(
                    f"decode prompt for {self.entry.name!r} has token ids "
                    f"outside [0, {vocab}): {bad[:8]}")
        if deadline is not None and deadline <= 0:
            _tel.inc("serve.rejected")
            raise RejectedError(
                f"decode request deadline {deadline!r}s already expired "
                "at submit; shed")
        with self._cv:
            if self._closed:
                raise ClosedError(
                    f"decode server {self.entry.name!r} is closed")
            if len(self._q) + len(self._pq) >= self._queue_max:
                _tel.inc("serve.rejected")
                raise RejectedError(
                    f"decode queue full ({self._queue_max}); shed load "
                    "upstream or raise MXNET_SERVE_QUEUE_MAX")
            self._seq += 1
            req = _DecodeRequest(
                self._seq, self.entry.name, prompt,
                max_new_tokens if max_new_tokens is not None
                else self.entry.max_new_tokens,
                temperature, top_k, seed, on_token=on_token,
                deadline=None if deadline is None
                else time.monotonic() + deadline)
            (self._pq if self._prefill_workers else self._q).append(req)
            self._cv.notify_all()
        _tel.inc("serve.decode_submitted")
        return DecodeFuture(req)

    def generate(self, prompt, timeout: Optional[float] = None,
                 **kw) -> List[int]:
        """Blocking convenience: submit + result."""
        return self.submit(prompt, **kw).result(timeout)

    def close(self, timeout: float = 60.0):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        deadline = time.monotonic() + timeout
        for t in self._prefill_threads:
            t.join(max(0.0, deadline - time.monotonic()))
        self._thread.join(max(0.0, deadline - time.monotonic()))
        if self._thread.is_alive() \
                or any(t.is_alive() for t in self._prefill_threads):
            raise MXNetError(
                f"decode server {self.entry.name!r} failed to drain within "
                f"{timeout}s")

    @property
    def alive(self) -> bool:
        """The worker runs, or the server was closed cleanly."""
        return self._thread.is_alive() or self._closed

    # ---------------------------------------------------------- worker
    def _occupancy(self) -> int:
        return sum(1 for r in self._active if r is not None)

    def _loop(self):
        e = self.entry
        self._cache = e.zero_cache(e.batch_cache(e.capacity_buckets[0]))
        _tel.set_gauge("serve.cache_quant_bytes_saved",
                       _quant_bytes_saved(self._cache))
        while True:
            with self._cv:
                while not self._q and self._occupancy() == 0 \
                        and not (self._closed and not self._pq
                                 and self._prefill_busy == 0):
                    self._cv.wait(0.1)
                if self._closed and not self._q and not self._pq \
                        and self._prefill_busy == 0 \
                        and self._occupancy() == 0:
                    return
                free = self._active.count(None)
                admitted = [self._q.popleft()
                            for _ in range(min(free, len(self._q)))]
            for item in admitted:
                ready = isinstance(item, _Ready)
                try:
                    if ready:
                        self._admit_ready(item)
                    else:
                        self._admit(item)
                except Exception as err:  # noqa: BLE001 — to its future
                    _fail(item.req if ready else item, err)
            self._reap()
            if self._occupancy() == 0:
                continue
            self._ensure_capacity()
            if self._occupancy() == 0:
                continue
            try:
                self._step()
            except Exception as err:  # noqa: BLE001 — keep serving
                self._fail_batch(err)
            self._reap()

    def _dead_on_arrival(self, req: _DecodeRequest) -> bool:
        """Cancelled or expired before claiming a slot."""
        if req.cancelled:
            req.finish_reason = "cancelled"
        elif req.expired():
            req.finish_reason = "deadline"
            req._error = DeadlineError(
                f"decode request {req.id} ({req.model}) deadline expired "
                "before admission")
            _tel.inc("serve.deadline_exceeded")
        else:
            return False
        self._resolve(req)
        return True

    def _admit(self, req: _DecodeRequest):
        """Slot claim -> prefill -> copy into the running batch."""
        if self._dead_on_arrival(req):
            return
        e = self.entry
        caps = e.capacity_buckets
        slot = self._active.index(None)
        t = len(req.prompt)
        tp = e.prompt_policy.bucket(t)      # raises on over-long prompts
        while not e.capacity_static and caps[self._cap_i] < tp:
            self._grow()
        toks = np.zeros((1, tp), np.int64)
        toks[0, :t] = req.prompt
        t0 = time.perf_counter()
        last_logits, row_cache = e.prefill(toks, t, caps[self._cap_i])
        _tel.observe("serve.prefill_seconds", time.perf_counter() - t0)
        first = self._sample(req, last_logits)
        req.tokens.append(first)
        _emit(req, first)
        _tel.inc("serve.tokens")
        _tel.observe("serve.ttft_seconds", time.perf_counter() - req.t0)
        if (e.eos_id is not None and first == e.eos_id) \
                or req.max_new_tokens <= 1:
            self._resolve(req)
            return
        self._cache = e.move(self._cache, row_cache, slot)
        self._lens[slot] = t
        self._pending[slot] = first
        self._active[slot] = req
        _tel.set_gauge("serve.decode_slots_active", self._occupancy())

    def _admit_ready(self, ready: _Ready):
        """Claim a slot for a pool-prefilled request and redistribute its
        row cache into the batch.  The ``serve.prefill_transfer`` fault
        seam fires BEFORE the move, so an injected transfer fault leaves
        the batch cache untouched: only this request's future fails, the
        slot stays free, and the loop keeps serving."""
        e = self.entry
        req = ready.req
        if self._dead_on_arrival(req):
            return
        caps = e.capacity_buckets
        slot = self._active.index(None)
        while not e.capacity_static and caps[self._cap_i] < ready.min_capacity:
            self._grow()
        if _chaos.active():
            kind = _chaos.draw("serve.prefill_transfer")
            if kind == "delay":
                time.sleep(get_env("MXNET_FAULT_DELAY", 0.05, float))
            elif kind is not None:
                raise _chaos.ChaosError(
                    "injected fault at 'serve.prefill_transfer' "
                    f"(request {req.id})")
        t0 = time.perf_counter()
        self._cache = e.move(self._cache, ready.row_cache, slot)
        _tel.observe("serve.cache_move_seconds", time.perf_counter() - t0)
        ready.row_cache = None
        self._lens[slot] = ready.cache_len
        self._pending[slot] = req.tokens[-1]
        self._active[slot] = req
        _tel.set_gauge("serve.decode_slots_active", self._occupancy())

    # ---------------------------------------------------- prefill pool
    def _prefill_loop(self):
        while True:
            with self._cv:
                while not self._closed and not self._pq:
                    self._cv.wait(0.1)
                if not self._pq:            # closed and drained
                    return
                req = self._pq.popleft()
                self._prefill_busy += 1
            ready = None
            try:
                ready = self._run_prefill(req)
            except Exception as err:  # noqa: BLE001 — to its future
                _fail(req, err)
            with self._cv:
                self._prefill_busy -= 1
                if ready is not None:
                    self._q.append(ready)
                self._cv.notify_all()

    def _run_prefill(self, req: _DecodeRequest) -> Optional[_Ready]:
        """One request's prompt forward on the pool: prefix-trie lookup,
        cold prefill or prefix-remainder forward, trie retention, first
        token.  Returns the shipment for the decode loop, or None when
        generation already finished (EOS / one-token budget)."""
        if self._dead_on_arrival(req):
            return None
        e = self.entry
        caps = e.capacity_buckets
        t = len(req.prompt)
        tp = e.prompt_policy.bucket(t)      # raises on over-long prompts
        matched, chain = 0, []
        if self.prefix is not None:
            matched, chain = self.prefix.lookup(req.prompt)
        if e.capacity_static:
            src_cap = caps[0]
        elif matched:
            # the remainder window appends at `matched`, so the row needs
            # matched + bucket(remainder) pages, which can exceed the cold
            # bucket; an unfittable hit degrades to a miss
            rem_bucket = e.prompt_policy.bucket(t - matched)
            need = max(tp, matched + rem_bucket)
            src_cap = next((c for c in caps if c >= need), None)
            if src_cap is None:
                matched, chain = 0, []
        if not matched and not e.capacity_static:
            src_cap = next(c for c in caps if c >= tp)
        t0 = time.perf_counter()
        if matched:
            rem = t - matched
            toks = np.zeros((1, rem_bucket), np.int64)
            toks[0, :rem] = req.prompt[matched:]
            last_logits, row_cache = e.prefill_window(
                toks, self.prefix.materialize(chain, src_cap), matched, rem)
            _tel.observe("serve.prefix_fill_seconds",
                         time.perf_counter() - t0)
        else:
            toks = np.zeros((1, tp), np.int64)
            toks[0, :t] = req.prompt
            last_logits, row_cache = e.prefill(toks, t, src_cap)
            _tel.observe("serve.prefill_seconds", time.perf_counter() - t0)
        if self.prefix is not None:
            self.prefix.insert(req.prompt, row_cache, t)
        first = self._sample(req, last_logits)
        req.tokens.append(first)
        _emit(req, first)
        _tel.inc("serve.tokens")
        _tel.observe("serve.ttft_seconds", time.perf_counter() - req.t0)
        if (e.eos_id is not None and first == e.eos_id) \
                or req.max_new_tokens <= 1:
            self._resolve(req)
            return None
        return _Ready(req, row_cache, t, src_cap, tp)

    def _ensure_capacity(self):
        """Grow the batch before a step whose append would overflow; at
        the last bucket, finish the full rows as truncated.  A
        capacity-static cache never grows nor truncates."""
        if self.entry.capacity_static:
            return
        caps = self.entry.capacity_buckets
        need = max(int(self._lens[i]) for i, r in enumerate(self._active)
                   if r is not None)
        if need < caps[self._cap_i]:
            return
        if self._cap_i + 1 < len(caps):
            self._grow()
            return
        for i, r in enumerate(self._active):
            if r is not None and int(self._lens[i]) >= caps[self._cap_i]:
                r.truncated = True
                self._release(i)

    def _grow(self):
        e = self.entry
        self._cache = e.grow(self._cache, e.capacity_buckets[self._cap_i + 1])
        self._cap_i += 1
        _tel.inc("serve.cache_grows")
        _tel.set_gauge("serve.cache_quant_bytes_saved",
                       _quant_bytes_saved(self._cache))

    def _step(self):
        e = self.entry
        self._steps += 1
        t0 = time.perf_counter()
        logits, self._cache = e.step(self._pending, self._cache, self._lens)
        _tel.observe("serve.decode_step_seconds", time.perf_counter() - t0)
        newly = 0
        for i, req in enumerate(self._active):
            if req is None:
                continue
            self._lens[i] += 1          # this step appended pending[i]
            tok = self._sample(req, logits[i])
            req.tokens.append(tok)
            _emit(req, tok)
            newly += 1
            if (e.eos_id is not None and tok == e.eos_id) \
                    or len(req.tokens) >= req.max_new_tokens:
                self._release(i)
            else:
                self._pending[i] = tok
        _tel.inc("serve.tokens", newly)

    def _fail_batch(self, err: BaseException):
        """A step raised: fail every resident request with the error and
        start again from an empty cache, so the loop keeps serving."""
        for i, req in enumerate(self._active):
            if req is not None:
                self._active[i] = None
                _fail(req, err)
        self._lens[:] = 0
        self._pending[:] = 0
        self._cap_i = 0
        self._cache = self.entry.zero_cache(
            self.entry.batch_cache(self.entry.capacity_buckets[0]))
        _tel.set_gauge("serve.decode_slots_active", 0)

    def _reap(self):
        """Release slots whose request was cancelled or whose deadline
        passed mid-stream, at this step boundary."""
        now = time.monotonic()
        for i, req in enumerate(self._active):
            if req is None:
                continue
            if req.cancelled:
                req.finish_reason = "cancelled"
            elif req.expired(now):
                req.finish_reason = "deadline"
                req._error = DeadlineError(
                    f"decode request {req.id} ({req.model}) deadline "
                    f"expired after {len(req.tokens)} token(s); slot "
                    "released")
                _tel.inc("serve.deadline_exceeded")
            else:
                continue
            self._release(i)

    @staticmethod
    def _sample(req: _DecodeRequest, logits_row: np.ndarray) -> int:
        if req.temperature <= 0.0:
            return int(np.argmax(logits_row))
        z = torch.from_numpy(np.asarray(logits_row, np.float32)) \
            / float(req.temperature)
        if 0 < req.top_k < z.numel():
            kth = torch.topk(z, req.top_k).values[-1]
            z = z.masked_fill(z < kth, float("-inf"))
        probs = torch.softmax(z, dim=-1)
        return int(torch.multinomial(probs, 1, generator=req.gen))

    def _release(self, slot: int):
        req = self._active[slot]
        self._active[slot] = None
        self._lens[slot] = 0
        self._pending[slot] = 0
        self._resolve(req)
        _tel.set_gauge("serve.decode_slots_active", self._occupancy())

    def _resolve(self, req: _DecodeRequest):
        if req.finish_reason is None:
            req.finish_reason = "length" if req.truncated \
                or len(req.tokens) >= req.max_new_tokens else "stop"
        req._event.set()
        _emit(req, None)
        _tel.inc("serve.decode_requests")
        if req.finish_reason == "cancelled":
            _tel.inc("serve.cancelled")


# ----------------------------------------------------- module-level API
_DECODE: Dict[str, DecodeServer] = {}
_DLOCK = threading.Lock()


def register_decode(name: str, block, **cfg) -> DecodeEntry:
    """Register ``block`` for decode serving under ``name``: builds the
    :class:`DecodeEntry` (warmup included) and starts its
    :class:`DecodeServer`.  ``queue_max``, ``prefill_workers`` and
    ``prefix_cache`` go to the server, the rest to the entry.
    Re-registering a name drains and replaces the old server."""
    srv_kw = {k: cfg.pop(k)
              for k in ("prefill_workers", "prefix_cache", "queue_max")
              if k in cfg}
    entry = DecodeEntry(name, block, **cfg)
    server = DecodeServer(entry, **srv_kw)
    with _DLOCK:
        old = _DECODE.pop(name, None)
        _DECODE[name] = server
    if old is not None:
        old.close(30.0)
    return entry


def decode_server(name: str) -> DecodeServer:
    with _DLOCK:
        try:
            return _DECODE[name]
        except KeyError:
            raise MXNetError(
                f"no decode model {name!r}; registered: "
                f"{sorted(_DECODE)}") from None


def decode_submit(name: str, prompt, **kw) -> DecodeFuture:
    """Enqueue one generation request (non-blocking)."""
    return decode_server(name).submit(prompt, **kw)


def generate(name: str, prompt, timeout: Optional[float] = None,
             **kw) -> List[int]:
    """Blocking generation on the named decode server."""
    return decode_server(name).generate(prompt, timeout=timeout, **kw)


def shutdown_decode(timeout: float = 60.0):
    """Drain and stop every decode server."""
    with _DLOCK:
        servers = list(_DECODE.values())
        _DECODE.clear()
    for s in servers:
        s.close(timeout)
