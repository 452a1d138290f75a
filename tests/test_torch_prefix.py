"""The port's prefix cache and prefill pool against the JAX package's,
on the CPU.

* The trie units of ``tests/test_prefix.py`` run against both
  ``PrefixCache`` classes on the same tokens and caches: equal ``lookup``
  results, ``stats()``, byte counts and evictions, and ``materialize``
  bit for bit.  The port keeps every leaf in its type (int8 pages, f32
  scales, bf16 pages) where its cache is, and counts the same bytes.
* The decode server on a tiny ``TransformerLM`` with the JAX package's
  weights: unified, pool and pool + prefix-hit answers equal to the JAX
  server's; the hit's telemetry counts (no ``serve.prefill_seconds``
  observation, one ``serve.prefix_fill_seconds``); an injected
  ``serve.prefill_transfer`` fault failing only its request; the pool's
  thread names and their joining; ``register_decode`` passing the pool
  through; the capacity-static ``LSTMLM`` through a pool and its refusal
  of an explicit prefix cache.
"""
from __future__ import annotations

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import serve as jserve
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.base import MXNetError as JaxMXNetError
from mxnet_tpu.gluon.model_zoo import lstm_lm as jax_lstm_lm
from mxnet_tpu.ndarray.ndarray import NDArray
from mxnet_tpu.resilience import chaos as jchaos
from mxnet_tpu.serve.prefix import PrefixCache as JaxPrefixCache

from mxnet_tpu_torch import convert, serve
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import lstm_lm
from mxnet_tpu_torch.resilience import chaos as tchaos
from mxnet_tpu_torch.serve.prefix import PrefixCache

from torch_parity import seeded_params, twin_lms


@pytest.fixture()
def fresh_telemetry():
    prev = (jtel.set_enabled(True), ttel.set_enabled(True))
    jtel.reset()
    ttel.reset()
    yield
    jtel.reset()
    ttel.reset()
    jtel.set_enabled(prev[0])
    ttel.set_enabled(prev[1])


@pytest.fixture()
def no_chaos():
    yield
    jchaos.configure("")
    tchaos.configure("")


# ------------------------------------------------------------- trie units
def _fake_leaves(capacity, layers=2, h=2, dh=4, scale=1.0, int8=False):
    """Per layer numpy leaves with position-distinguishable values:
    ``(k, v)`` pages (1, h, C, dh), or the int8 layout's ``(k_q, k_scale,
    v_q, v_scale)`` with (1, h, C, 1) scales."""
    out = []
    for layer in range(layers):
        leaves = []
        for kv in range(2):
            a = (np.arange(capacity, dtype="float32")[None, None, :, None]
                 + layer * 1000 + kv * 100) * scale
            page = np.broadcast_to(a, (1, h, capacity, dh)).copy()
            if int8:
                leaves += [(page % 127).astype("int8"),
                           np.broadcast_to(a, (1, h, capacity, 1)).copy()
                           / 127.0]
            else:
                leaves.append(page)
        out.append(leaves)
    return out


def _caches(capacity, **kw):
    """The same fake cache as the JAX trie's input (NDArrays) and the
    port's (torch tensors)."""
    leaves = _fake_leaves(capacity, **kw)
    return (tuple(tuple(NDArray(jnp.asarray(a)) for a in layer)
                  for layer in leaves),
            tuple(tuple(torch.from_numpy(a) for a in layer)
                  for layer in leaves))


class Twin:
    """One JAX trie and one port trie driven with the same calls; every
    call's result must be equal."""

    def __init__(self, **kw):
        self.j = JaxPrefixCache(**kw)
        self.t = PrefixCache(**kw)

    def insert(self, toks, capacity, valid, **kw):
        jc, tc = _caches(capacity, **kw)
        got = (self.j.insert(toks, jc, valid), self.t.insert(toks, tc, valid))
        assert got[0] == got[1]
        self.same_stats()
        return got[1]

    def lookup(self, toks):
        (jm, jchain), (tm, tchain) = self.j.lookup(toks), self.t.lookup(toks)
        assert jm == tm and len(jchain) == len(tchain)
        assert [n.key for n in jchain] == [n.key for n in tchain]
        self.same_stats()
        return tm, (jchain, tchain)

    def same_stats(self):
        assert self.j.stats() == self.t.stats()

    def materialize(self, chains, capacity):
        jout = self.j.materialize(chains[0], capacity)
        tout = self.t.materialize(chains[1], capacity)
        for jl, tl in zip(jout, tout):
            assert len(jl) == len(tl)
            for a, b in zip(jl, tl):
                want = np.asarray(a._data)
                assert b.numpy().dtype == want.dtype
                np.testing.assert_array_equal(b.numpy(), want)
        return tout


def test_lookup_is_block_aligned_and_leaves_one_token():
    tw = Twin(block=4, max_bytes=1 << 20)
    toks = list(range(1, 10))               # 9 tokens -> 2 full blocks
    assert tw.insert(toks, 16, 9) == 2
    assert tw.lookup(toks)[0] == 8
    assert tw.lookup(toks[:8])[0] == 4       # one token always forwarded
    assert tw.lookup(toks[:4] + [99] * 5)[0] == 4
    assert tw.lookup([99] * 9)[0] == 0


def test_insert_shares_existing_nodes():
    tw = Twin(block=4, max_bytes=1 << 20)
    toks = list(range(1, 14))               # 13 tokens -> 3 full blocks
    assert tw.insert(toks, 16, 13) == 3
    assert tw.insert(toks, 16, 13) == 0
    assert tw.insert(toks[:8] + [40, 41, 42, 43, 44], 16, 13) == 1
    assert tw.t.stats()["nodes"] == 4
    assert tw.insert([7] * 12, 16, 5) == 1  # valid_len caps retention


@pytest.mark.parametrize("layout", ["f32", "int8"])
@pytest.mark.parametrize("capacity", [12, 32])
def test_materialize_bit_for_bit_and_bounds(layout, capacity):
    tw = Twin(block=4, max_bytes=1 << 20)
    toks = list(range(1, 10))
    tw.insert(toks, 16, 9, int8=layout == "int8")
    _, chains = tw.lookup(toks)
    out = tw.materialize(chains, capacity)
    assert len(out[0]) == (4 if layout == "int8" else 2)
    assert out[0][0].shape == (1, 2, capacity, 4)
    if layout == "int8":
        assert out[0][0].dtype == torch.int8
        assert out[0][1].shape == (1, 2, capacity, 1)
    with pytest.raises(MXNetError):
        tw.t.materialize(chains[1], 4)      # matched 8 > capacity 4
    with pytest.raises(JaxMXNetError):
        tw.j.materialize(chains[0], 4)
    with pytest.raises(MXNetError):
        tw.t.materialize([], 32)


def test_materialize_keeps_bf16_pages():
    pc = PrefixCache(block=4, max_bytes=1 << 20)
    rs = np.random.RandomState(0)
    src = tuple(tuple(torch.from_numpy(rs.randn(1, 2, 16, 4).astype("f4"))
                      .bfloat16() for _ in range(2)) for _ in range(2))
    pc.insert(list(range(1, 10)), src, 9)
    out = pc.materialize(pc.lookup(list(range(1, 10)))[1], 32)
    for layer, want in zip(out, src):
        for a, b in zip(layer, want):
            assert a.dtype == torch.bfloat16
            assert torch.equal(a[:, :, :8], b[:, :, :8])
            assert not a[:, :, 8:].any()
    # a retained page is a copy, never a view of the row cache
    src[0][0].zero_()
    again = pc.materialize(pc.lookup(list(range(1, 10)))[1], 16)
    assert torch.equal(again[0][0], out[0][0][:, :, :16])


@pytest.mark.parametrize("layout", ["f32", "int8"])
def test_eviction_is_lru_childless_as_jax(fresh_telemetry, layout):
    int8 = layout == "int8"
    node = 2 * (2 * 2 * 4 * 4 * 4) if not int8 else \
        2 * 2 * (2 * 4 * 4 + 2 * 4 * 4)
    tw = Twin(block=4, max_bytes=2 * node)
    a = list(range(1, 10))
    b = [20 + i for i in range(9)]
    tw.insert(a, 16, 9, int8=int8)
    assert tw.t.stats()["bytes"] == 2 * node
    tw.insert(b, 16, 9, int8=int8)          # 4 nodes -> evict down to 2
    st = tw.t.stats()
    assert st["nodes"] == 2 and st["bytes"] == 2 * node
    assert st["evictions"] == 2
    assert tw.lookup(a)[0] == 0
    assert tw.lookup(b)[0] == 8
    for tel in (jtel, ttel):
        snap = tel.snapshot()
        assert snap["serve.cache_evictions"]["value"] == 2
        assert snap["serve.cache_bytes"]["value"] == 2 * node
        assert snap["serve.cache_hits"]["value"] == 1
        assert snap["serve.cache_misses"]["value"] == 1
        assert snap["serve.cache_hit_tokens"]["value"] == 8


def test_zero_budget_disables_retention():
    tw = Twin(block=4, max_bytes=0)
    assert tw.insert(list(range(9)), 16, 9) == 0
    assert tw.lookup(list(range(9)))[0] == 0
    assert tw.t.stats()["nodes"] == 0


def test_budget_from_the_environment(monkeypatch):
    monkeypatch.setenv("MXNET_PREFIX_CACHE_BYTES", "1234")
    assert PrefixCache().max_bytes == JaxPrefixCache().max_bytes == 1234
    monkeypatch.delenv("MXNET_PREFIX_CACHE_BYTES")
    assert PrefixCache().max_bytes == JaxPrefixCache().max_bytes == 64 << 20
    with pytest.raises(MXNetError):
        PrefixCache(block=0)


def test_non_page_layout_cache_rejected():
    pc = PrefixCache(block=4, max_bytes=1 << 20)
    with pytest.raises(MXNetError):
        pc.insert(list(range(9)), ((torch.zeros(2, 8),),), 9)


def test_clear_resets_bytes(fresh_telemetry):
    tw = Twin(block=4, max_bytes=1 << 20)
    tw.insert(list(range(9)), 16, 9)
    tw.j.clear()
    tw.t.clear()
    tw.same_stats()
    assert tw.t.stats()["bytes"] == 0
    assert ttel.snapshot()["serve.cache_bytes"]["value"] == 0


# --------------------------------------------------- disaggregated server
CFG = dict(slots=2, prompt_buckets=(4, 16), capacity_buckets=(16, 32),
           max_new_tokens=5)
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]     # 10 tokens: 8 matched
SHORT = [7, 8, 9]                           # below the block floor


def _counts(tel):
    snap = tel.snapshot()

    def n(name, field):
        return snap.get(name, {}).get(field, 0)

    return {"prefill": n("serve.prefill_seconds", "count"),
            "prefix_fill": n("serve.prefix_fill_seconds", "count"),
            "move": n("serve.cache_move_seconds", "count"),
            "ttft": n("serve.ttft_seconds", "count"),
            "hits": n("serve.cache_hits", "value"),
            "hit_tokens": n("serve.cache_hit_tokens", "value"),
            "misses": n("serve.cache_misses", "value")}


def _hit_run(mod, tel, lm):
    """``test_prefix_hit_bit_exact_and_skips_prefill``'s calls on one
    package: answers and the counts at each point it reads them."""
    entry = mod.DecodeEntry("pfx_lm", lm, **CFG)
    uni = mod.DecodeServer(entry, prefill_workers=0)
    try:
        want = uni.generate(PROMPT, timeout=120.0)
        want_short = uni.generate(SHORT, timeout=120.0)
    finally:
        uni.close(60.0)
    dis = mod.DecodeServer(entry, prefill_workers=1)
    try:
        assert dis.prefix is not None           # made with the pool
        cold = dis.generate(PROMPT, timeout=120.0)
        after_cold = _counts(tel)
        hit = dis.generate(PROMPT, timeout=120.0)
        after_hit = _counts(tel)
        short = dis.generate(SHORT, timeout=120.0)
        stats = dis.prefix.stats()
    finally:
        dis.close(60.0)
    return dict(tokens=(want, want_short, cold, hit, short),
                counts=(after_cold, after_hit), stats=stats)


@pytest.mark.parametrize("cache_dtype", [None, "int8"], ids=["f32", "int8"])
def test_prefix_hit_equals_jax_and_skips_prefill(fresh_telemetry,
                                                 cache_dtype):
    jlm, tlm, _ = twin_lms(seed=41, cache_dtype=cache_dtype)
    jr = _hit_run(jserve, jtel, jlm)
    tr = _hit_run(serve, ttel, tlm)
    assert tr["tokens"] == jr["tokens"]
    want, want_short, cold, hit, short = tr["tokens"]
    assert want == cold == hit and short == want_short
    assert tr["counts"] == jr["counts"]
    after_cold, after_hit = tr["counts"]
    # the hit added no prefill; its remainder ran as a prefix fill
    assert after_hit["prefill"] == after_cold["prefill"] == 3
    assert after_hit["prefix_fill"] == 1
    assert after_hit["hits"] == 1 and after_hit["hit_tokens"] == 8
    assert after_hit["move"] == 2 and after_hit["ttft"] == 4
    assert tr["stats"] == jr["stats"]
    assert tr["stats"]["hits"] == 1 and tr["stats"]["misses"] == 2


def _shared_prefix_traffic(n=8, seed=5):
    rs = np.random.RandomState(seed)
    head = rs.randint(0, 32, size=8).tolist()
    return [head + rs.randint(0, 32, size=int(k)).tolist()
            for k in rs.randint(1, 7, size=n)]


def _serve_all(mod, lm, prompts, **srv):
    entry = mod.DecodeEntry("pool_lm", lm, **CFG)
    s = mod.DecodeServer(entry, **srv)
    try:
        with s._cv:                  # all queued before any is admitted
            futs = [s.submit(p) for p in prompts]
        return [f.result(120.0) for f in futs], s.prefix
    finally:
        s.close(60.0)


@pytest.mark.parametrize("mode", ["pool", "pool_prefix"])
def test_pool_answers_equal_the_jax_unified_server(fresh_telemetry, mode):
    """Eight requests sharing an 8-token prefix, all at once into two
    slots: prefills run ahead of free slots, the batch grows 16 -> 32 and
    cross-capacity moves happen; every answer equals the JAX unified
    server's."""
    jlm, tlm, _ = twin_lms(seed=42)
    prompts = _shared_prefix_traffic()
    want, _ = _serve_all(jserve, jlm, prompts, prefill_workers=0)
    got, prefix = _serve_all(serve, tlm, prompts, prefill_workers=2,
                             prefix_cache=mode == "pool_prefix")
    assert got == want
    snap = ttel.snapshot()
    assert snap["serve.cache_grows"]["value"] >= 1
    assert snap["serve.cache_move_seconds"]["count"] == len(prompts)
    if mode == "pool_prefix":
        assert prefix.stats()["hits"] >= 1
        assert snap["serve.prefix_fill_seconds"]["count"] == \
            prefix.stats()["hits"]
        assert snap["serve.prefill_seconds"]["count"] == \
            prefix.stats()["misses"]
    else:
        assert prefix is None
        assert snap["serve.prefill_seconds"]["count"] == len(prompts)


def test_prefill_transfer_fault_fails_only_that_request(
        fresh_telemetry, no_chaos):
    jlm, tlm, _ = twin_lms(seed=43)
    prompt = [11, 12, 13, 14, 15, 16, 17, 18, 19]
    want, _ = _serve_all(jserve, jlm, [prompt], prefill_workers=0)
    srv = serve.DecodeServer(serve.DecodeEntry("pfx_lm", tlm, **CFG),
                             prefill_workers=1, prefix_cache=False)
    try:
        tchaos.configure("serve.prefill_transfer:error:1.0")
        fut = srv.submit(prompt)
        with pytest.raises(MXNetError, match="prefill_transfer"):
            fut.result(60.0)
        assert fut.finish_reason == "error"
        # the fault fired BEFORE the move: the slot is free, the loop
        # alive, and the next request serves
        assert all(r is None for r in srv._active)
        tchaos.configure("")
        assert [srv.generate(prompt, timeout=60.0)] == want
        assert srv.alive
    finally:
        srv.close(60.0)
    assert ttel.snapshot()["chaos.injected.serve.prefill_transfer"][
        "value"] == 1


def test_prefill_threads_named_and_joined():
    _, tlm, _ = twin_lms(seed=44)
    srv = serve.DecodeServer(serve.DecodeEntry("pfx_lm", tlm, **CFG),
                             prefill_workers=2)
    names = {t.name for t in threading.enumerate()}
    assert {"mx-prefill-pfx_lm-0", "mx-prefill-pfx_lm-1"} <= names
    assert len(srv.generate(PROMPT, timeout=60.0)) == 5
    srv.close(60.0)
    left = [t.name for t in threading.enumerate()
            if t.name.startswith("mx-prefill-pfx_lm")
            or t.name == "mx-decode-worker-pfx_lm"]
    assert not left


def test_prefill_workers_from_the_environment(monkeypatch):
    _, tlm, _ = twin_lms(seed=45)
    monkeypatch.setenv("MXNET_PREFILL_WORKERS", "1")
    entry = serve.DecodeEntry("env_lm", tlm, warmup=False, **CFG)
    srv = serve.DecodeServer(entry)
    try:
        assert srv._prefill_workers == 1 and srv.prefix is not None
    finally:
        srv.close(60.0)
    own = PrefixCache(block=2)
    srv = serve.DecodeServer(entry, prefill_workers=0, prefix_cache=own)
    try:
        assert srv.prefix is own
    finally:
        srv.close(60.0)


def test_register_decode_passes_pool_config(fresh_telemetry):
    jlm, tlm, _ = twin_lms(seed=46)
    cfg = dict(slots=1, prompt_buckets=(4,), capacity_buckets=(16,),
               max_new_tokens=3, prefill_workers=1)
    out = []
    for mod in (jserve, serve):
        mod.register_decode("pfx_api", jlm if mod is jserve else tlm, **cfg)
        try:
            srv = mod.decode_server("pfx_api")
            assert srv._prefill_workers == 1 and srv.prefix is not None
            out.append(mod.generate("pfx_api", [1, 2, 3], timeout=60.0))
        finally:
            mod.shutdown_decode(60.0)
    assert out[0] == out[1] and len(out[1]) == 3


def _twin_lstms(seed):
    tiny = dict(vocab_size=40, units=16, num_layers=2)
    jlm = jax_lstm_lm(**tiny)
    jlm.initialize(jmx.init.Xavier())
    params = seeded_params(jlm, seed)
    for name, p in jlm.collect_params().items():
        p.set_data(params[name])
    tlm = lstm_lm(device="cpu", **tiny)
    convert.load_into(tlm, params)
    return jlm, tlm


def test_lstm_pool_equals_jax_and_refuses_a_prefix_cache(fresh_telemetry):
    jlm, tlm = _twin_lstms(47)
    prompts = [[1, 2, 3], [4, 5, 6, 7], [8], [9, 10, 11, 12, 13, 14]]
    want, _ = _serve_all(jserve, jlm, prompts, prefill_workers=0)
    got, prefix = _serve_all(serve, tlm, prompts, prefill_workers=1)
    assert got == want and prefix is None   # none made for a static cache
    entry = serve.DecodeEntry("lstm", tlm, warmup=False, **CFG)
    with pytest.raises(MXNetError, match="capacity-independent"):
        serve.DecodeServer(entry, prefill_workers=1, prefix_cache=True)
    with pytest.raises(MXNetError, match="capacity-independent"):
        serve.DecodeServer(entry, prefill_workers=0,
                           prefix_cache=PrefixCache())
