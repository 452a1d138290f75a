"""Prefix-trie KV-cache reuse across decode requests: the port of
``mxnet_tpu/serve/prefix.py``.

System-prompt-heavy traffic re-prefills the same leading tokens for
every request.  Causality makes that work reusable: a transformer KV
page at position ``p`` depends only on tokens ``<= p``, so the cache
pages of a shared prompt *prefix* are the same across requests and can
be copied instead of recomputed.  This module keeps those pages in a
trie keyed on BLOCK-ALIGNED token chunks (``block`` tokens a node):

* :meth:`PrefixCache.lookup` walks the trie over a prompt's full
  blocks and returns the longest retained prefix — capped one token
  short of the prompt, because the next-token logits still need at
  least one real forward;
* :meth:`PrefixCache.materialize` scatters the matched nodes' pages
  into a fresh row cache at the requested capacity bucket through
  :func:`mxnet_tpu_torch.parallel.layout.scatter_into`, trie nodes as
  the source layout;
* :meth:`PrefixCache.insert` retains the full blocks of a finished
  prefill, sliced off the returned row cache's page axis; existing
  nodes are skipped (the same pages, by causality).

Pages stay where the row cache is: on the card they are device copies
(``clone`` of a block's slice, never a view of a row cache that will be
reused), so neither an insert nor a hit moves pages between the host and
the card; the JAX trie keeps host copies.  A retained page counts its
bytes (``numel * element_size``) against the same budget, so the byte
counts and the eviction order are the JAX trie's.  Every leaf of a layer
is kept in its own type: ``(k, v)`` pages, or the int8 cache's ``(k_q,
k_scale, v_q, v_scale)`` with its ``(1, H, C, 1)`` scales.  A node holds
each leaf kind of all layers as one ``(layers, 1, H, block, w)`` tensor
(its own storage, freed when the node is evicted), so an insert and a
materialize issue a few operations a leaf kind, not one a leaf: the
workers that run them share the host with the decode loop.

Eviction is LRU over CHILDLESS nodes (an interior node's pages stay
reachable only through its children, so leaves go first), driven by a
byte budget: ``MXNET_PREFIX_CACHE_BYTES`` (default 64 MiB; 0 disables
retention).  Capacity-independent caches (the LSTM carrier: one
recurrent state, no per-position pages) cannot be sliced by prefix, so
the decode tier refuses the cache for those models.

Telemetry (the JAX package's names): ``serve.cache_hits`` /
``serve.cache_misses`` / ``serve.cache_evictions`` counters,
``serve.cache_hit_tokens`` (prefill tokens skipped), and the
``serve.cache_bytes`` gauge.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import telemetry as _tel
from ..base import MXNetError, get_env
from ..parallel import layout as _layout

__all__ = ["PrefixCache"]


class _Node:
    """One trie node: ``block`` tokens' worth of KV pages, one tensor a
    leaf kind (k, v; or k_q, k_scale, v_q, v_scale): ``(layers, 1, H,
    block, w)`` copies."""

    __slots__ = ("key", "parent", "children", "pages", "nbytes", "tick")

    def __init__(self, key, parent, pages, nbytes, tick):
        self.key = key
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.pages = pages
        self.nbytes = nbytes
        self.tick = tick


class PrefixCache:
    """Block-aligned prefix trie over prompt token ids (module
    docstring).  Thread-safe: N prefill workers look up and insert
    concurrently under one lock."""

    def __init__(self, block: int = 8, max_bytes: Optional[int] = None,
                 name: str = "default"):
        if block < 1:
            raise MXNetError(f"prefix block must be >= 1, got {block}")
        self.block = int(block)
        self.max_bytes = int(
            get_env("MXNET_PREFIX_CACHE_BYTES", 64 << 20, int)
            if max_bytes is None else max_bytes)
        self.name = name
        self._lock = threading.Lock()
        self._children: Dict[Tuple[int, ...], _Node] = {}  # root level
        self._nodes: List[_Node] = []
        self._bytes = 0
        self._tick = 0
        self._hits = 0
        self._misses = 0
        self._evictions = 0

    # ------------------------------------------------------------ lookup
    def lookup(self, tokens: Sequence[int]) -> Tuple[int, List[_Node]]:
        """Longest retained block-aligned prefix of ``tokens``: returns
        ``(matched_len, nodes)`` with ``matched_len`` a multiple of
        ``block`` and strictly less than ``len(tokens)`` (at least one
        token is always left to forward).  Ticks
        ``serve.cache_{hits,misses}``; touches the matched chain's LRU
        clocks."""
        toks = [int(t) for t in tokens]
        max_blocks = max(0, (len(toks) - 1)) // self.block
        chain: List[_Node] = []
        with self._lock:
            self._tick += 1
            level = self._children
            for i in range(max_blocks):
                key = tuple(toks[i * self.block:(i + 1) * self.block])
                node = level.get(key)
                if node is None:
                    break
                node.tick = self._tick
                chain.append(node)
                level = node.children
            matched = len(chain) * self.block
            if matched:
                self._hits += 1
            else:
                self._misses += 1
        if matched:
            _tel.inc("serve.cache_hits")
            _tel.inc("serve.cache_hit_tokens", matched)
        else:
            _tel.inc("serve.cache_misses")
        return matched, chain

    # ------------------------------------------------------- materialize
    def materialize(self, chain: Sequence[_Node], capacity: int):
        """Assemble the matched chain into a fresh row cache at
        ``capacity``: per layer, zeroed ``(1, H, capacity, w)`` leaves
        (on the pages' device, in their types) with each node's pages
        scattered at its block offset — node boxes are the source layout,
        the capacity bucket the target box
        (:func:`~mxnet_tpu_torch.parallel.layout.scatter_into`).  Returns
        the cache tuple the LM forward takes."""
        if not chain:
            raise MXNetError("materialize() needs a non-empty match chain")
        matched = len(chain) * self.block
        if matched > capacity:
            raise MXNetError(
                f"matched prefix ({matched} tokens) exceeds capacity "
                f"bucket {capacity}")
        kinds = []
        for j, template in enumerate(chain[0].pages):
            n_layers, _b, h, _blk, w = template.shape
            buf = torch.zeros((n_layers, 1, h, capacity, w),
                              dtype=template.dtype, device=template.device)
            tbox = ((0, n_layers), (0, 1), (0, h), (0, capacity), (0, w))
            # the chain tiles [0, matched) contiguously: one concatenated
            # source box per leaf kind, not one per node
            sbox = ((0, n_layers), (0, 1), (0, h), (0, matched), (0, w))
            _layout.scatter_into(
                buf, tbox, sbox, torch.cat([n.pages[j] for n in chain], dim=3))
            kinds.append(buf.unbind(0))
        return tuple(zip(*kinds))

    # ------------------------------------------------------------ insert
    def insert(self, tokens: Sequence[int], cache, valid_len: int) -> int:
        """Retain the full blocks of a finished prefill: ``cache`` is the
        LM's returned row cache (per layer a tuple of ``(1, H, C, w)``
        tensors, or numpy arrays), valid through ``valid_len`` positions.
        Each new node keeps copies of its block's pages; nodes already
        present are skipped.  Returns the number of NEW nodes, after
        evicting LRU childless nodes down to the byte budget."""
        if self.max_bytes <= 0:
            return 0
        toks = [int(t) for t in tokens]
        n_blocks = min(len(toks), int(valid_len)) // self.block
        if n_blocks == 0:
            return 0
        leaves = [[torch.as_tensor(leaf) for leaf in layer]
                  for layer in cache]
        if any(a.ndim != 4 for layer in leaves for a in layer):
            raise MXNetError(
                "prefix cache needs (1, H, C, dh) page-layout leaves — "
                "capacity-independent caches cannot be prefix-sliced")
        kinds = None                # each leaf kind stacked over the layers
        created = 0
        with self._lock:
            self._tick += 1
            level = self._children
            parent: Optional[_Node] = None
            for i in range(n_blocks):
                key = tuple(toks[i * self.block:(i + 1) * self.block])
                node = level.get(key)
                if node is None:
                    if kinds is None:
                        kinds = [torch.stack(kind) for kind in zip(*leaves)]
                    blk = slice(i * self.block, (i + 1) * self.block)
                    pages = tuple(k[:, :, :, blk, :].clone() for k in kinds)
                    nbytes = sum(a.numel() * a.element_size() for a in pages)
                    node = _Node(key, parent, pages, nbytes, self._tick)
                    level[key] = node
                    self._nodes.append(node)
                    self._bytes += nbytes
                    created += 1
                else:
                    node.tick = self._tick
                parent = node
                level = node.children
            evicted = self._evict_locked()
            held = self._bytes
        if evicted:
            _tel.inc("serve.cache_evictions", evicted)
        _tel.set_gauge("serve.cache_bytes", held)
        return created

    def _evict_locked(self) -> int:
        """Drop LRU childless nodes until the byte budget holds."""
        evicted = 0
        while self._bytes > self.max_bytes:
            victim = None
            for node in self._nodes:
                if node.children:
                    continue
                if victim is None or node.tick < victim.tick:
                    victim = node
            if victim is None:
                break
            siblings = (victim.parent.children if victim.parent is not None
                        else self._children)
            siblings.pop(victim.key, None)
            self._nodes.remove(victim)
            self._bytes -= victim.nbytes
            self._evictions += 1
            evicted += 1
        return evicted

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._lock:
            total = self._hits + self._misses
            return {"nodes": len(self._nodes), "bytes": self._bytes,
                    "max_bytes": self.max_bytes, "block": self.block,
                    "hits": self._hits, "misses": self._misses,
                    "evictions": self._evictions,
                    "hit_rate": (self._hits / total) if total else 0.0}

    def clear(self):
        with self._lock:
            self._children.clear()
            self._nodes.clear()
            self._bytes = 0
        _tel.set_gauge("serve.cache_bytes", 0)
