"""The port's LSTM LM against the JAX package's, on the CPU: the decode
carrier ``LSTMLM`` (prefill and step logits, the capacity-static decode
tier) and BASELINE config #4's net as ``bench.py``'s ``bench_lstm_lm``
writes it, trained through ``ShardedTrainer`` at small widths.

Bars: logits and states within 1e-4 (as the transformer LM's); served
greedy answers equal to the port's eager greedy loop's, exactly (as
the JAX package's test holds its server to its eager loop); the trainer's
losses within 1e-5 relative and its weights within 1e-4 x max|w| after
3 SGD steps at lr 1.0 (the JAX trainer's arena kernel in interpret mode,
the port's plain arena update).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon import rnn as jrnn
from mxnet_tpu.gluon.model_zoo import lstm_lm as jax_lstm_lm
from mxnet_tpu.kernels import registry as jkreg
from mxnet_tpu.parallel.mesh import make_mesh
from mxnet_tpu.parallel.trainer import ShardedTrainer as JTrainer
from mxnet_tpu_torch import convert, serve
from mxnet_tpu_torch import telemetry as tel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import HybridBlock
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon import rnn as trnn
from mxnet_tpu_torch.gluon.model_zoo import (LSTMLM, TransformerLM,
                                             get_model, lstm_lm)
from mxnet_tpu_torch.parallel import ShardedTrainer
from mxnet_tpu_torch.serve.decode import _CacheMover
from torch_parity import jax_forward, seeded_params

TINY = dict(vocab_size=48, units=16, num_layers=2)


@pytest.fixture()
def fresh_telemetry():
    prev = tel.set_enabled(True)
    tel.reset()
    yield
    tel.reset()
    tel.set_enabled(prev)


def twin_lstm_lms(seed):
    jlm = jax_lstm_lm(**TINY)
    jlm.initialize(mx.init.Xavier())
    params = seeded_params(jlm, seed)
    for name, p in jlm.collect_params().items():
        p.set_data(params[name])
    tlm = lstm_lm(device="cpu", **TINY)
    convert.load_into(tlm, params)
    return jlm, tlm


def _np_cache(cache):
    return [[np.asarray(leaf.asnumpy() if hasattr(leaf, "asnumpy")
                        else leaf.detach().numpy()) for leaf in layer]
            for layer in cache]


def test_lstm_lm_prefill_and_steps_match_jax():
    jlm, tlm = twin_lstm_lms(seed=2)
    assert sorted(n for n, _ in tlm.named_parameters()) == \
        sorted(jlm.collect_params())
    rs = np.random.RandomState(3)
    toks = rs.randint(0, TINY["vocab_size"], (3, 6)).astype(np.int32)
    n_tok = np.asarray([6, 4, 2], np.int32)        # padded rows below T
    want, jcache = jax_forward(jlm, toks, jlm.begin_cache(3, 16),
                               [0, 0, 0], n_tok)
    got, tcache = tlm(toks, tlm.begin_cache(3, 16), [0, 0, 0], n_tok)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4)
    for gl, wl in zip(_np_cache(tcache), _np_cache(jcache)):
        for g, w in zip(gl, wl):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    for t in range(3):
        step = rs.randint(0, TINY["vocab_size"], (3, 1)).astype(np.int32)
        want, jcache = jax_forward(jlm, step, jcache, n_tok + t, [1, 1, 1])
        got, tcache = tlm(step, tcache, n_tok + t, [1, 1, 1])
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {t}")


def test_padded_tokens_never_reach_the_state():
    _, tlm = twin_lstm_lms(seed=4)
    toks = np.asarray([[5, 6, 7, 0, 0, 0]], np.int32)
    short, c_short = tlm(toks[:, :3], tlm.begin_cache(1), [0], [3])
    padded, c_pad = tlm(toks, tlm.begin_cache(1), [0], [3])
    assert torch.equal(padded[:, :3], short)
    for a, b in zip(c_short, c_pad):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def _eager_greedy(tlm, prompt, n_new):
    """The port's one-row greedy loop: a full re-forward per token."""
    toks, out = list(prompt), []
    for _ in range(n_new):
        logits, _ = tlm(np.asarray([toks]), tlm.begin_cache(1), [0],
                        [len(toks)])
        out.append(int(logits[0, -1].argmax()))
        toks.append(out[-1])
    return out


def test_decode_server_lstm_capacity_static(fresh_telemetry):
    """The port of ``tests/test_decode.py::
    test_decode_server_lstm_capacity_static``: more requests than slots,
    of mixed lengths, so every slot is written after admissions and
    releases."""
    _, tlm = twin_lstm_lms(seed=22)
    entry = serve.DecodeEntry("lstmlm", tlm, slots=2, prompt_buckets=(4, 8),
                              capacity_buckets=(16, 32), max_new_tokens=5)
    # recurrent state IS the history: growth must be structurally a no-op
    assert entry.capacity_static
    srv = serve.DecodeServer(entry)
    try:
        prompts = [[1, 2, 3], [4, 5, 6, 7], [8], [9, 10, 11, 12, 13, 14],
                   [15, 16]]
        futs = [srv.submit(p) for p in prompts]
        for p, f in zip(prompts, futs):
            assert f.result(60.0) == _eager_greedy(tlm, p, 5), f"prompt {p}"
        # 6 + 40 tokens pass every capacity bucket: no growth, no cut
        long_fut = srv.submit(list(range(1, 7)), max_new_tokens=40)
        assert long_fut.result(60.0) == _eager_greedy(tlm, range(1, 7), 40)
        assert not long_fut.truncated
        snap = tel.snapshot()
        assert snap.get("serve.cache_grows", {"value": 0})["value"] == 0
        assert snap["serve.tokens"]["value"] == 5 * 5 + 40
        assert snap["serve.cache_quant_bytes_saved"]["value"] == 0
    finally:
        srv.close(60.0)


def test_capacity_static_warmup_steps_the_first_bucket_only():
    _, tlm = twin_lstm_lms(seed=5)
    entry = serve.DecodeEntry("x", tlm, slots=2, prompt_buckets=(4, 8),
                              capacity_buckets=(16, 32, 64), warmup=False)
    assert entry.capacity_static
    # two prefills and one step at the first capacity, one move there
    assert entry.warmup() == 2 + 1 + 1
    tf = TransformerLM(vocab_size=16, units=8, num_heads=2, num_layers=1,
                       max_length=32, device="cpu")
    assert not serve.DecodeEntry("t", tf, prompt_buckets=(4,),
                                 capacity_buckets=(8, 16),
                                 warmup=False).capacity_static


def test_int8_precision_refuses_the_lstm_carrier():
    _, tlm = twin_lstm_lms(seed=6)
    with pytest.raises(MXNetError, match="LSTM carrier"):
        serve.DecodeEntry("x", tlm, precision="int8")


def move_rows(batch, row, slot):
    """The decode entry's move: one eager ``_CacheMover`` forward at a
    slot given as a tensor."""
    return _CacheMover().forward(batch, row, torch.tensor([slot]))


def test_move_rows_splices_state_rows_and_windows_pages():
    batch = tuple((torch.zeros(3, 4), torch.zeros(3, 4)) for _ in range(2))
    row = tuple((torch.full((1, 4), 1.0 + i), torch.full((1, 4), -1.0 - i))
                for i in range(2))
    move_rows(batch, row, 2)
    for i, (h, c) in enumerate(batch):
        assert torch.equal(h[2], row[i][0][0]) and not h[:2].any()
        assert torch.equal(c[2], row[i][1][0]) and not c[:2].any()
    pages = ((torch.zeros(2, 1, 8, 2),),)
    src = ((torch.ones(1, 1, 4, 2),),)
    move_rows(pages, src, 1)
    assert pages[0][0][1, :, :4].eq(1).all() and not pages[0][0][1, :, 4:].any()
    assert not pages[0][0][0].any()


def test_get_model_routes_the_decode_lms():
    assert isinstance(get_model("lstm_lm", device="cpu", **TINY), LSTMLM)
    assert isinstance(get_model("transformer_lm", vocab_size=16, units=8,
                                num_heads=2, num_layers=1, max_length=16,
                                device="cpu"), TransformerLM)


# ------------------------------------ BASELINE config #4 at small widths
V, E, HID, LAYERS, BATCH, SEQ = 50, 16, 16, 2, 4, 6


class JaxBenchLM(mx.gluon.HybridBlock):
    """``bench_lstm_lm``'s net (``bench.py``), widths given."""

    def __init__(self):
        super().__init__()
        self.embedding = jnn.Embedding(V, E)
        self.lstm = jrnn.LSTM(HID, num_layers=LAYERS, input_size=E)
        self.decoder = jnn.Dense(V, flatten=False, in_units=HID)

    def forward(self, x):
        e = self.embedding(x).transpose(1, 0, 2)
        return self.decoder(self.lstm(e)).transpose(1, 0, 2)


class BenchLM(HybridBlock):
    """The same net with ``import mxnet_tpu_torch as mx``."""

    def __init__(self, device=None):
        super().__init__()
        self.embedding = tnn.Embedding(V, E, device=device)
        self.lstm = trnn.LSTM(HID, num_layers=LAYERS, input_size=E,
                              device=device)
        self.decoder = tnn.Dense(V, flatten=False, in_units=HID,
                                 device=device)

    def forward(self, x):
        e = self.embedding(x).transpose(0, 1)
        return self.decoder(self.lstm(e)).transpose(0, 1)


def _jax_loss(pred, y):
    lp = jax.nn.log_softmax(pred.astype(jnp.float32), -1)
    return jnp.mean(-jnp.take_along_axis(lp, y[..., None], -1)[..., 0],
                    axis=-1)


def bench_loss(pred, y):
    lp = torch.log_softmax(pred.float(), -1)
    return (-lp.gather(-1, y.long()[..., None])[..., 0]).mean(-1)


def test_bench_lstm_lm_trains_as_jax():
    jnet = JaxBenchLM()
    jnet.initialize(mx.init.Xavier())
    params = seeded_params(jnet, seed=12)
    for name, p in jnet.collect_params().items():
        p.set_data(params[name])
    tnet = convert.load_into(BenchLM(device="cpu"), params)
    rs = np.random.RandomState(0)
    x = rs.randint(0, V, size=(BATCH, SEQ)).astype("int32")
    y = rs.randint(0, V, size=(BATCH, SEQ)).astype("int32")
    with jkreg.override("interpret"):
        jtr = JTrainer(jnet, _jax_loss,
                       mesh=make_mesh({"dp": -1}, devices=jax.devices()[:1]),
                       optimizer="sgd", learning_rate=1.0, fused_opt="arena")
        want = [float(jtr.step(x, y, block=True)) for _ in range(3)]
    tr = ShardedTrainer(tnet, bench_loss, optimizer="sgd", learning_rate=1.0)
    assert tr.uses_arena
    got = [tr.step(x, y, block=True) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert got[-1] < got[0]
    tparams = dict(tnet.named_parameters())
    assert sorted(jtr.train_names) == sorted(tparams)
    for name, w in zip(jtr.train_names, jtr.pvals):
        w = np.asarray(w)
        np.testing.assert_allclose(
            tparams[name].detach().numpy(), w, rtol=0,
            atol=1e-4 * float(np.abs(w).max()), err_msg=name)
