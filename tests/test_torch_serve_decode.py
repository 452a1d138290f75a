"""The port's decode server on the CPU (``device="cpu"``).

Greedy tokens served by the port must equal the JAX package's eager
greedy decode of the same weights.  The comparison is exact, so the test
first asserts that every step's top-2 logit margin on the JAX side is
above ``MARGIN`` — a margin that clears the 1e-4 logit parity bar of
``test_torch_decoder.py`` many times over, so an argmax cannot flip on
summation order.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from mxnet_tpu_torch import serve
from mxnet_tpu_torch import telemetry as tel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serve import (ClosedError, DeadlineError, RejectedError,
                                   TokenRangeError)
from torch_parity import jax_greedy, twin_lms

MARGIN = 1e-2


@pytest.fixture()
def fresh_telemetry():
    prev = tel.set_enabled(True)
    tel.reset()
    yield
    tel.reset()
    tel.set_enabled(prev)


def _server(tlm, **cfg):
    cfg = {"slots": 2, "prompt_buckets": (4, 8),
           "capacity_buckets": (16, 32), "max_new_tokens": 6, **cfg}
    return serve.DecodeServer(serve.DecodeEntry("tlm", tlm, **cfg))


@pytest.mark.parametrize("cache_dtype", [None, "int8"], ids=["f32", "int8"])
def test_served_greedy_equals_jax_greedy(fresh_telemetry, cache_dtype):
    jlm, tlm, _ = twin_lms(seed=21, cache_dtype=cache_dtype)
    srv = _server(tlm)
    try:
        # more requests than slots: continuous admission, varying occupancy
        prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9, 10], [11]]
        futs = [srv.submit(p) for p in prompts]
        for p, f in zip(prompts, futs):
            want, margins = jax_greedy(jlm, p, 6)
            assert min(margins) > MARGIN, (p, margins)
            assert f.result(60.0) == want, f"prompt {p}"
            assert f.finish_reason == "length"
        # 8 prompt + 12 new tokens outgrow the first capacity bucket
        long_fut = srv.submit(list(range(1, 9)), max_new_tokens=12)
        want, margins = jax_greedy(jlm, list(range(1, 9)), 12)
        assert min(margins) > MARGIN, margins
        assert long_fut.result(60.0) == want
        assert not long_fut.truncated
        snap = tel.snapshot()
        assert snap["serve.cache_grows"]["value"] >= 1
        assert snap["serve.tokens"]["value"] == 4 * 6 + 12
        assert snap["serve.prefill_seconds"]["count"] == 5
        assert snap["serve.decode_step_seconds"]["count"] >= 1
        assert snap["serve.decode_slots_active"]["value"] == 0
    finally:
        srv.close(60.0)


def test_sampling_deterministic_under_seed(fresh_telemetry):
    _, tlm, _ = twin_lms(seed=22)
    srv = _server(tlm)
    try:
        kw = dict(timeout=60.0, temperature=0.8, top_k=5)
        a = srv.generate([2, 3, 4], seed=123, **kw)
        b = srv.generate([2, 3, 4], seed=123, **kw)
        assert a == b and len(a) == 6
        draws = {tuple(srv.generate([2, 3, 4], seed=s, **kw))
                 for s in range(6)}
        assert len(draws) > 1                 # the seed matters
        # top_k=1 at any temperature is greedy
        assert srv.generate([2, 3, 4], temperature=1.5, top_k=1, seed=5,
                            timeout=60.0) == srv.generate([2, 3, 4],
                                                          timeout=60.0)
    finally:
        srv.close(60.0)


def test_truncation_at_last_bucket(fresh_telemetry):
    _, tlm, _ = twin_lms(seed=23)
    srv = _server(tlm, slots=1, prompt_buckets=(4,), capacity_buckets=(8,),
                  max_new_tokens=32)
    try:
        fut = srv.submit([1, 2, 3, 4])
        toks = fut.result(60.0)
        # prompt fills 4 of 8; one token from prefill, one per step until
        # the append would pass the last bucket
        assert fut.truncated and fut.finish_reason == "length"
        assert len(toks) == 5
    finally:
        srv.close(60.0)


def test_eos_and_module_api(fresh_telemetry):
    jlm, tlm, _ = twin_lms(seed=24)
    first = jax_greedy(jlm, [1, 2], 1)[0][0]
    serve.register_decode("api_lm", tlm, slots=1, prompt_buckets=(4,),
                          capacity_buckets=(8,), max_new_tokens=4,
                          eos_id=first)
    try:
        assert serve.generate("api_lm", [1, 2], timeout=60.0) == [first]
        fut = serve.decode_submit("api_lm", [3], max_new_tokens=2)
        assert len(fut.result(60.0)) <= 2
        with pytest.raises(MXNetError):
            serve.decode_server("nope")
        with pytest.raises(MXNetError):
            serve.decode_submit("api_lm", [])
    finally:
        serve.shutdown_decode(60.0)
    with pytest.raises(MXNetError):
        serve.decode_server("api_lm")


def test_cancel_releases_slot_with_partial_tokens(fresh_telemetry):
    _, tlm, _ = twin_lms(seed=25)
    srv = _server(tlm, max_new_tokens=20)
    try:
        seen, holder = [], []

        def sink(tok):
            seen.append(tok)
            if len(seen) == 2:
                holder[0].cancel()

        fut = srv.submit([1, 2, 3], on_token=sink)
        holder.append(fut)
        toks = fut.result(60.0)
        assert fut.finish_reason == "cancelled"
        assert 2 <= len(toks) < 20
        assert seen[-1] is None and seen[:-1] == toks
        # the slot is free again: the server keeps serving
        assert len(srv.generate([4, 5], timeout=60.0)) == 20
        assert tel.snapshot()["serve.cancelled"]["value"] == 1
    finally:
        srv.close(60.0)


def test_deadline_expires_mid_stream(fresh_telemetry):
    _, tlm, _ = twin_lms(seed=26)
    srv = _server(tlm, max_new_tokens=30)
    try:
        fut = srv.submit([1, 2, 3], deadline=0.3,
                         on_token=lambda tok: time.sleep(0.1))
        with pytest.raises(DeadlineError):
            fut.result(60.0)
        assert fut.finish_reason == "deadline"
        assert 1 <= len(fut.tokens_so_far()) < 30
        with pytest.raises(RejectedError):
            srv.submit([1], deadline=0.0)
        assert tel.snapshot()["serve.deadline_exceeded"]["value"] == 1
    finally:
        srv.close(60.0)


def test_bad_requests_fail_alone_and_closed_server(fresh_telemetry):
    _, tlm, _ = twin_lms(seed=27)
    srv = _server(tlm)
    try:
        with pytest.raises(TokenRangeError):
            srv.submit([1, 32])
        with pytest.raises(TokenRangeError):
            srv.submit([-1])
        # an over-long prompt fails ITS future; its batch-mate is served
        bad = srv.submit(list(range(20)))
        good = srv.submit([5, 6])
        with pytest.raises(MXNetError, match="bucket"):
            bad.result(60.0)
        assert len(good.result(60.0)) == 6
    finally:
        srv.close(60.0)
    assert srv.alive
    with pytest.raises(ClosedError):
        srv.submit([1])


def test_worker_thread_named_and_joined():
    _, tlm, _ = twin_lms(seed=28)
    srv = _server(tlm)
    names = [t.name for t in threading.enumerate()]
    assert "mx-decode-worker-tlm" in names
    srv.close(60.0)
    assert not srv._thread.is_alive()


@pytest.mark.parametrize("kw", [{"prefill_workers": -1},
                                {"prefill_workers": 1, "prefix_cache": True}])
def test_later_slice_options_raise(kw):
    """The refusals of the JAX server that remain once the prefill pool
    and the prefix cache are ported: a negative pool size, and a prefix
    cache asked for on a capacity-static (LSTM) model.  Both packages
    refuse, through ``DecodeServer`` and through ``register_decode``."""
    from mxnet_tpu import serve as jserve
    from mxnet_tpu.base import MXNetError as JaxMXNetError
    from mxnet_tpu.gluon.model_zoo import lstm_lm as jax_lstm_lm
    from mxnet_tpu_torch.gluon.model_zoo import lstm_lm

    if "prefix_cache" in kw:
        jlm = jax_lstm_lm(vocab_size=32, units=8, num_layers=1)
        tlm = lstm_lm(vocab_size=32, units=8, num_layers=1, device="cpu")
        match = "capacity-independent"
    else:
        jlm, tlm, _ = twin_lms(seed=29)
        match = "prefill_workers must be >= 0"
    cfg = dict(slots=1, prompt_buckets=(4,), capacity_buckets=(8,),
               warmup=False)
    for srv_mod, lm, err in ((jserve, jlm, JaxMXNetError),
                             (serve, tlm, MXNetError)):
        entry = srv_mod.DecodeEntry("tlm", lm, **cfg)
        with pytest.raises(err, match=match):
            srv_mod.DecodeServer(entry, **kw)
    with pytest.raises(MXNetError, match=match):
        serve.register_decode("later", tlm, **cfg, **kw)
    with pytest.raises(MXNetError):
        serve.decode_server("later")


def test_entry_validation():
    _, tlm, _ = twin_lms(seed=30)
    with pytest.raises(MXNetError):
        serve.DecodeEntry("x", tlm, slots=0)
    with pytest.raises(MXNetError):
        serve.DecodeEntry("x", tlm, precision="fp8")
    with pytest.raises(MXNetError):
        serve.DecodeEntry("x", tlm, prompt_buckets=(64,),
                          capacity_buckets=(32,))
    with pytest.raises(MXNetError):
        serve.DecodeEntry("x", object())
    entry = serve.DecodeEntry("x", tlm, prompt_buckets=(4,),
                              capacity_buckets=(8, 16), precision="int8",
                              warmup=False)
    assert entry.block.begin_cache(1, 8)[0][0].dtype.is_floating_point is False
    # the JAX grid: a prefill and a step at each capacity (4), a move for
    # each (destination, source) capacity pair (4), one growth (1); a
    # second warmup captures nothing new
    assert entry.warmup() == 4 + 4 + 1
    assert entry.warmup() == 0


def test_failing_step_fails_resident_requests_and_keeps_serving(
        fresh_telemetry):
    _, tlm, _ = twin_lms(seed=31)
    srv = _server(tlm)
    real_step = srv.entry.step
    calls = []

    def flaky(*args):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected step fault")
        return real_step(*args)

    srv.entry.step = flaky
    try:
        fut = srv.submit([1, 2, 3])
        with pytest.raises(MXNetError, match="injected step fault"):
            fut.result(60.0)
        assert fut.finish_reason == "error"
        assert len(srv.generate([4, 5], timeout=60.0)) == 6
        assert srv.alive
    finally:
        srv.close(60.0)


def test_serving_keeps_no_autograd_graph_with_trainable_parameters():
    """The model's parameters are trainable (``requires_grad``); every
    forward the decode server runs must still record no graph."""
    _, tlm, _ = twin_lms(seed=5)
    assert all(p.requires_grad for p in tlm.parameters())
    seen = []
    hook = tlm.register_forward_hook(
        lambda mod, args, out: seen.append((out[0].requires_grad,
                                            out[0].grad_fn)))
    srv = _server(tlm)
    try:
        assert len(srv.submit([1, 2, 3]).result(60.0)) == 6
    finally:
        srv.close(60.0)
        hook.remove()
    assert seen and all(rg is False and fn is None for rg, fn in seen)
