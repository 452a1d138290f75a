"""The serving tiers hybridized, against the JAX package, on the CPU.

* ``ops.attention.cache_append`` with tensor lengths (no read back to
  the host: what a captured decode step runs) against the JAX op, rows
  at different offsets, f32, bf16 and int8, a start past the capacity
  clamped as ``dynamic_update_slice`` clamps it; ``cache_page_copy`` at
  a tensor slot against the JAX op.
* A decode server on a tiny ``TransformerLM`` (f32 and int8 caches) and
  on a tiny ``LSTMLM``, hybridized, against the JAX server's tokens for
  the same greedy requests; the warmup grid's size against the JAX
  entry's, and no ``hybridize.cache_misses`` after it in either.
* The batch tier: ``serve.register`` hybridizes with the bucketer and
  captures the bucket grid (in the background too), as the JAX
  registry compiles it; the same answers and counts.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import serve as jserve
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import lstm_lm as jax_lstm_lm
from mxnet_tpu.ops import attention as jatt

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert, serve
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import lstm_lm
from mxnet_tpu_torch.ops import attention as tatt

from torch_parity import seeded_params, twin_lms


@pytest.fixture(autouse=True)
def fresh_telemetry():
    prev = (jtel.set_enabled(True), ttel.set_enabled(True))
    jtel.reset()
    ttel.reset()
    yield
    jtel.reset()
    ttel.reset()
    jtel.set_enabled(prev[0])
    ttel.set_enabled(prev[1])


def misses(tel) -> int:
    return tel.snapshot().get("hybridize.cache_misses", {}).get("value", 0)


# ------------------------------------------------- the cache primitives
_DTYPES = {"f32": (torch.float32, jnp.float32),
           "bf16": (torch.bfloat16, jnp.bfloat16),
           "int8": (torch.int8, jnp.int8)}


def _cache_case(kind, b=4, h=2, c=16, t=3, d=5, seed=0):
    rs = np.random.RandomState(seed)
    if kind == "int8":
        cache = rs.randint(-127, 128, (b, h, c, d)).astype("i1")
        new = rs.randint(-127, 128, (b, h, t, d)).astype("i1")
    else:
        cache = rs.randn(b, h, c, d).astype("f4")
        new = rs.randn(b, h, t, d).astype("f4")
    return cache, new


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_cache_append_device_lengths_match_jax(kind):
    tdt, jdt = _DTYPES[kind]
    cache, new = _cache_case(kind)
    # rows at different offsets; the last starts past C - T (clamped)
    lens = np.array([0, 5, 13, 15], "i4")
    want = np.asarray(jatt.cache_append(jnp.asarray(cache, jdt),
                                        jnp.asarray(new, jdt),
                                        jnp.asarray(lens)).astype(jnp.float32))
    tcache = torch.from_numpy(cache).to(tdt)
    out = tatt.cache_append(tcache, torch.from_numpy(new).to(tdt),
                            torch.from_numpy(lens))
    assert out is tcache                      # in place
    np.testing.assert_array_equal(out.float().numpy(), want)


def test_cache_append_host_lengths_keep_the_overflow_check():
    cache, new = _cache_case("f32")
    with pytest.raises(tmx.MXNetError, match="passes capacity"):
        tatt.cache_append(torch.from_numpy(cache), torch.from_numpy(new),
                          [0, 5, 13, 15])
    out = tatt.cache_append(torch.from_numpy(cache.copy()),
                            torch.from_numpy(new), np.array([0, 5, 13, 2]))
    want = np.asarray(jatt.cache_append(jnp.asarray(cache), jnp.asarray(new),
                                        jnp.asarray([0, 5, 13, 2])))
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("slot", [0, 2, 3])
def test_cache_page_copy_at_a_tensor_slot_matches_jax(slot):
    rs = np.random.RandomState(slot)
    dst = rs.randn(4, 2, 16, 3).astype("f4")
    src = rs.randn(1, 2, 8, 3).astype("f4")
    want = np.asarray(jatt.cache_page_copy(jnp.asarray(dst), jnp.asarray(src),
                                           8, dst_row=jnp.int32(slot)))
    out = tatt.cache_page_copy(torch.from_numpy(dst.copy()),
                               torch.from_numpy(src), 8,
                               dst_row=torch.tensor([slot]))
    np.testing.assert_array_equal(out.numpy(), want)


# ------------------------------------------------------- decode serving
CFG = dict(slots=2, prompt_buckets=(4, 8), capacity_buckets=(16, 32),
           max_new_tokens=6)
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9, 10], [11], list(range(1, 9))]


def _serve_both(jlm, tlm, **cfg):
    """Serve PROMPTS on the JAX server and the port's, each entry's grid
    warmed first; returns (tokens, grid size, misses while serving) for
    each side."""
    cfg = {**CFG, **cfg}
    out = []
    for srv_mod, tel, lm in ((jserve, jtel, jlm), (serve, ttel, tlm)):
        entry = srv_mod.DecodeEntry("lm", lm, warmup=False, **cfg)
        grid = entry.warmup()
        before = misses(tel)
        srv = srv_mod.DecodeServer(entry)
        try:
            # the last request outgrows the first capacity: one growth
            futs = [srv.submit(p, max_new_tokens=12 if len(p) == 8 else None)
                    for p in PROMPTS]
            toks = [f.result(120.0) for f in futs]
        finally:
            srv.close(60.0)
        out.append((toks, grid, misses(tel) - before,
                    tel.snapshot().get("serve.cache_grows",
                                       {}).get("value", 0), entry))
    return out


@pytest.mark.parametrize("cache_dtype", [None, "int8"], ids=["f32", "int8"])
def test_hybridized_decode_server_matches_the_jax_server(cache_dtype):
    jlm, tlm, _ = twin_lms(seed=41, cache_dtype=cache_dtype)
    (jt, jg, jm, jgrow, _), (tt, tg, tm, tgrow, te) = _serve_both(jlm, tlm)
    assert tt == jt
    assert tg == jg == 2 * 3 + 4 + 1       # LM 6, movers 4, growth 1
    assert jm == tm == 0
    assert tgrow == jgrow >= 1
    assert te.lm_step._active and te.lm_step._donate_args == (1,)
    assert te.lm_step.lm is tlm


def test_hybridized_lstm_decode_server_matches_the_jax_server():
    tiny = dict(vocab_size=40, units=16, num_layers=2)
    jlm = jax_lstm_lm(**tiny)
    jlm.initialize(jmx.init.Xavier())
    params = seeded_params(jlm, 43)
    for name, p in jlm.collect_params().items():
        p.set_data(params[name])
    tlm = lstm_lm(device="cpu", **tiny)
    convert.load_into(tlm, params)
    (jt, jg, jm, _, _), (tt, tg, tm, tgrow, _) = _serve_both(jlm, tlm)
    assert tt == jt
    assert tg == jg == 2 + 1 + 1              # capacity-static: first only
    assert jm == tm == 0 and tgrow == 0


def test_eager_decode_entry_serves_the_same_tokens():
    _, tlm, _ = twin_lms(seed=44)
    got = []
    for hyb in (True, False):
        entry = serve.DecodeEntry("lm", tlm, warmup=False, **CFG)
        if not hyb:
            for blk in entry.blocks:
                blk.hybridize(False)
        entry.warmup()
        srv = serve.DecodeServer(entry)
        try:
            got.append([srv.generate(p, timeout=120.0) for p in PROMPTS[:3]])
        finally:
            srv.close(60.0)
        tlm.hybridize(False)
    assert got[0] == got[1]


def _submit_all(srv, prompts, **kw):
    """Every prompt queued before the worker admits any."""
    with srv._cv:
        return [srv.submit(p, **kw) for p in prompts]


def test_decode_warmup_beside_its_server_writes_no_live_cache():
    """``DecodeEntry.warmup()`` while the entry's server decodes (from a
    request's token sink, on the worker, between a prefill and its move
    into the batch): the live caches are left alone, so every answer
    equals the one of a server that ran alone."""
    _, tlm, _ = twin_lms(seed=41)
    got = []
    for beside in (False, True):
        entry = serve.DecodeEntry("lm", tlm, **CFG)
        srv = serve.DecodeServer(entry)
        fired = []

        def sink(tok):
            if beside and not fired:
                fired.append(entry.warmup())

        try:
            futs = _submit_all(srv, PROMPTS, on_token=sink)
            got.append([f.result(120.0) for f in futs])
        finally:
            srv.close(60.0)
    assert fired == [0]
    assert got[0] == got[1]


def test_second_decode_entry_on_one_lm_keeps_the_first_ones_graphs():
    """Each entry hybridizes the LM's forward in a block of its own: a
    second entry over the same LM (a re-registration while the old
    server drains) leaves the first entry's signatures, so the first
    serves on with no capture, and both answer as the JAX server."""
    jlm, tlm, _ = twin_lms(seed=41)
    jt = _serve_both(jlm, tlm)[0][0]
    a = serve.DecodeEntry("a", tlm, **CFG)
    traced = set(a.lm_step._cached_op._traced)
    b = serve.DecodeEntry("b", tlm, **CFG)
    assert a.lm_step._cached_op._traced == traced
    assert b.lm_step._cached_op is not a.lm_step._cached_op
    before = misses(ttel)
    srvs = [serve.DecodeServer(e) for e in (a, b)]
    try:
        futs = []
        for s in srvs:
            with s._cv:          # as _serve_both submits them
                futs.append([s.submit(p, max_new_tokens=12 if len(p) == 8
                                      else None) for p in PROMPTS])
        toks = [[f.result(120.0) for f in fs] for fs in futs]
    finally:
        for s in srvs:
            s.close(60.0)
    assert misses(ttel) == before
    assert toks[0] == toks[1] == jt


# --------------------------------------------------------- batch serving
class _JHead(jmx.gluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.dense = jnn.Dense(4, flatten=False)

    def forward(self, x):
        return self.dense(x)


class _THead(tmx.gluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.dense = tnn.Dense(4, flatten=False, in_units=8, device="cpu")

    def forward(self, x):
        return self.dense(x)


@pytest.mark.parametrize("background", [False, True],
                         ids=["sync", "background"])
def test_registered_block_captures_the_bucket_grid_as_jax_compiles(
        background):
    jnet, tnet = _JHead(), _THead()
    jmx.random.seed(0)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.np.ones((1, 3, 8)))
    convert.load_into(tnet, {n: p.data().asnumpy()
                             for n, p in jnet.collect_params().items()})
    buckets = {0: [1, 2, 4], 1: [4, 8]}
    rs = np.random.RandomState(3)
    reqs = [rs.rand(n, 8).astype("f4") for n in (3, 5, 8, 1, 7)]
    res = []
    for srv_mod, tel, net in ((jserve, jtel, jnet), (serve, ttel, tnet)):
        entry = srv_mod.register("head", net, bucketer=buckets,
                                 sample=np.zeros((4, 8), "f4"),
                                 background=background)
        if background:
            assert entry.warmup_handle.wait(300) == 6
        assert entry.warmup_done()
        before = misses(tel)
        try:
            outs = [srv_mod.predict("head", r, timeout=60.0) for r in reqs]
        finally:
            srv_mod.shutdown()
            srv_mod.unregister("head")
        res.append((entry.compiled, outs, misses(tel) - before))
    (jc, jo, jm), (tc, to, tm) = res
    assert tc == jc == (None if background else 6)
    assert tm == jm == 0
    for r, a, b in zip(reqs, jo, to):
        assert a.shape == b.shape == (len(r), 4)
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
