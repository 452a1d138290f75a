"""The prefix trie's page layout against the decode server's throughput,
on one CUDA card.

    python3 tools/torch_prefix_layout.py [--turns ukluk] [--requests 64]

``chip_smoke.py`` phase 56's f32 traffic (GPT-2 small, 64 requests of a
shared 192-token prefix plus 8-56 unique tokens, 48 new each, all queued
at once) served by a pool of 2 prefill workers with the prefix cache, in
turns, one process: ``k`` the trie as ``serve.prefix.PrefixCache`` keeps
it (each node one ``(layers, 1, H, block, w)`` tensor a leaf kind), ``l``
a trie that keeps one tensor a leaf and a block (the JAX trie's layout:
twelve layers of (k, v) make 24 clones a block at insert and a cat, a
zeros and a copy a leaf at materialize), ``p`` the pool without a prefix
cache, ``u`` the unified server.  Both tries compute the same pages;
they differ in the operations the workers issue, which share the host's
interpreter with the decode loop.  Each turn prints tokens/s, TTFT
p50 / p99, rows a step and the workers' host time in ``lookup``,
``materialize``, ``insert`` and ``prefill_window`` (perf_counter around
each call: a call's wait for the interpreter included), then the card as
``nvidia-smi`` names it.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo import transformer_lm  # noqa: E402
from mxnet_tpu_torch.parallel import layout  # noqa: E402
from mxnet_tpu_torch.serve import decode, prefix  # noqa: E402


class PerLeafPrefixCache(prefix.PrefixCache):
    """The same trie with one page tensor a leaf and a block."""

    def materialize(self, chain, capacity):
        matched = len(chain) * self.block
        out = []
        for li, leaves in enumerate(chain[0].pages):
            bufs = []
            for j, t in enumerate(leaves):
                _b, h, _blk, w = t.shape
                buf = torch.zeros((1, h, capacity, w), dtype=t.dtype,
                                  device=t.device)
                layout.scatter_into(
                    buf, ((0, 1), (0, h), (0, capacity), (0, w)),
                    ((0, 1), (0, h), (0, matched), (0, w)),
                    torch.cat([n.pages[li][j] for n in chain], dim=2))
                bufs.append(buf)
            out.append(tuple(bufs))
        return tuple(out)

    def insert(self, tokens, cache, valid_len):
        toks = [int(t) for t in tokens]
        n_blocks = min(len(toks), int(valid_len)) // self.block
        created = 0
        with self._lock:
            self._tick += 1
            level, parent = self._children, None
            for i in range(n_blocks):
                key = tuple(toks[i * self.block:(i + 1) * self.block])
                node = level.get(key)
                if node is None:
                    blk = slice(i * self.block, (i + 1) * self.block)
                    pages = tuple(tuple(a[:, :, blk, :].clone() for a in lyr)
                                  for lyr in cache)
                    nbytes = sum(a.numel() * a.element_size()
                                 for lyr in pages for a in lyr)
                    node = prefix._Node(key, parent, pages, nbytes,
                                        self._tick)
                    level[key] = node
                    self._nodes.append(node)
                    self._bytes += nbytes
                    created += 1
                else:
                    node.tick = self._tick
                parent, level = node, node.children
            self._evict_locked()
        return created


TIMES = {}


def timed(owner, name):
    fn = getattr(owner, name)

    def wrapper(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            TIMES.setdefault(name, []).append(time.perf_counter() - t0)

    setattr(owner, name, wrapper)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", default="ukluk")
    ap.add_argument("--requests", type=int, default=64)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_prefix_layout: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cs.phase_build()
    lm = cs.xavier_init(transformer_lm(device=dev, **cs.GPT2_SMALL), 0)
    prompts = cs.pool_traffic(args.requests)
    for name in ("lookup", "materialize", "insert"):
        timed(prefix.PrefixCache, name)
    for name in ("materialize", "insert"):        # its own; lookup inherited
        timed(PerLeafPrefixCache, name)
    timed(decode.DecodeEntry, "prefill_window")
    names = {"k": "per kind", "l": "per leaf", "p": "pool", "u": "unified"}
    for i, turn in enumerate(args.turns):
        TIMES.clear()
        kw = dict(prefill_workers=2)
        if turn == "p":
            kw["prefix_cache"] = False
        elif turn == "u":
            kw = dict(prefill_workers=0)
        elif turn == "l":
            kw["prefix_cache"] = PerLeafPrefixCache(name="per_leaf")
        r = cs.pool_serve(lm, f"layout{i}", prompts, "flash_attention_decode",
                          **kw)
        parts = ", ".join(
            f"{k} {len(v)} calls p50 {statistics.median(v) * 1e3:.3f} ms"
            for k, v in sorted(TIMES.items()))
        print(f"turn {i} {names[turn]}: {r['tokens_per_s']:.1f} tokens/s, "
              f"TTFT p50 {r['ttft_p50_ms']:.1f} ms p99 "
              f"{r['ttft_p99_ms']:.1f} ms, {r['steps']} steps "
              f"({r['rows_per_step']:.2f} rows), {r['prefix_fills']} prefix "
              f"fills; {parts}", flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
