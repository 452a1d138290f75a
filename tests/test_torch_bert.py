"""The port's BERT encoder and pretraining heads against the JAX
package's, on the CPU.

A tiny ``get_bert`` (and ``BERTForPretrain`` over it) is built in both
packages; numpy weights drawn from a seed go into the JAX model with
``Parameter.set_data`` and into the port with ``convert.load_into`` (the
names map one to one).  Tolerance 1e-4 on ``(seq, pooled)`` and on
``(mlm_scores, nsp_scores)``: f32 through two layers, different
summation order.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.bert import BERTForPretrain as JBERTForPretrain
from mxnet_tpu.gluon.model_zoo.bert import get_bert as jax_get_bert
from mxnet_tpu_torch import autograd, convert
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert

from torch_parity import nd_i32, seeded_params

TINY = dict(num_layers=2, units=32, hidden_size=64, num_heads=4,
            vocab_size=97, max_length=32, dropout=0.0)
TOL = 1e-4


@pytest.fixture(scope="module")
def twins():
    jb = jax_get_bert(**TINY)
    jb.initialize(mx.init.Xavier())
    jb(nd_i32(np.zeros((1, 4))), nd_i32(np.zeros((1, 4))),
       nd_i32(np.full((1,), 4)))
    params = seeded_params(jb, seed=5)
    for name, p in jb.collect_params().items():
        p.set_data(params[name])
    tb = tbert.get_bert(device="cpu", **TINY)
    convert.load_into(tb, params)
    return jb, tb


def _batch(b, t, seed):
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, TINY["vocab_size"], (b, t)).astype(np.int32)
    types = (rs.rand(b, t) > 0.5).astype(np.int32)
    lens = rs.randint(1, t + 1, (b,)).astype(np.int32)
    lens[0] = t
    return tokens, types, lens


@pytest.mark.parametrize("b,t", [(1, 8), (3, 16), (2, 32)])
def test_bert_matches_jax(twins, b, t):
    jb, tb = twins
    tokens, types, lens = _batch(b, t, seed=b * t)
    jseq, jpooled = jb(nd_i32(tokens), nd_i32(types), nd_i32(lens))
    with torch.no_grad():
        tseq, tpooled = tb(tokens, types, lens)
    np.testing.assert_allclose(tseq.numpy(), jseq.asnumpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tpooled.numpy(), jpooled.asnumpy(), rtol=TOL,
                               atol=TOL)


def test_bert_without_lengths_or_types_matches_jax(twins):
    jb, tb = twins
    tokens, _, _ = _batch(2, 12, seed=1)
    jseq, jpooled = jb(nd_i32(tokens))
    with torch.no_grad():
        tseq, tpooled = tb(tokens)
    np.testing.assert_allclose(tseq.numpy(), jseq.asnumpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tpooled.numpy(), jpooled.asnumpy(), rtol=TOL,
                               atol=TOL)


def test_bert_output_invariant_to_padding(twins):
    _, tb = twins
    tokens, types, _ = _batch(1, 11, seed=2)
    with torch.no_grad():
        seq, pooled = tb(tokens, types, np.asarray([11]))
    rs = np.random.RandomState(3)
    pad_tok = np.concatenate(
        [tokens, rs.randint(0, TINY["vocab_size"], (1, 21))], 1)
    pad_typ = np.concatenate([types, np.ones((1, 21), np.int32)], 1)
    with torch.no_grad():
        pseq, ppooled = tb(pad_tok, pad_typ, np.asarray([11]))
    np.testing.assert_allclose(pseq[:, :11].numpy(), seq.numpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(ppooled.numpy(), pooled.numpy(), rtol=TOL,
                               atol=TOL)


def test_parameter_names_are_the_jax_names(twins):
    jb, tb = twins
    assert sorted(dict(tb.named_parameters())) == \
        sorted(jb.collect_params())


def test_bert_specs_and_limits():
    spec = tbert._BERT_SPECS
    assert spec["bert_12_768_12"] == dict(num_layers=12, units=768,
                                          hidden_size=3072, num_heads=12)
    assert spec["bert_24_1024_16"] == dict(num_layers=24, units=1024,
                                           hidden_size=4096, num_heads=16)
    tb = tbert.get_bert(device="cpu", **{**TINY, "max_length": 8})
    tb.initialize(seed=1)
    with pytest.raises(ValueError, match="max_length"):
        tb(np.zeros((1, 9), np.int32))
    # dtype= is the embeddings' type, every other layer f32, as in JAX
    import jax.numpy as jnp

    jb = jax_get_bert(dtype=jnp.float16, **TINY)
    jb.initialize(mx.init.Xavier())
    jb(nd_i32(np.zeros((1, 4))), nd_i32(np.zeros((1, 4))),
       nd_i32(np.full((1,), 4)))
    want = {n: str(jnp.dtype(p.data()._data.dtype))
            for n, p in jb.collect_params().items()}
    tb = tbert.get_bert(device="cpu", dtype=torch.float16, **TINY)
    got = {n: str(p.dtype).replace("torch.", "")
           for n, p in tb.named_parameters()}
    assert got == want and "float16" in got.values()
    seq, pooled = tb.initialize(seed=1)(np.zeros((1, 4), np.int32))
    assert seq.dtype == pooled.dtype == torch.float32


def test_initialize_is_seeded_and_device_independent():
    a = tbert.get_bert(device="cpu", **TINY).initialize(seed=7)
    b = tbert.get_bert(device="cpu", **TINY).initialize(seed=7)
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    assert not autograd.is_training()           # served outside training


def test_activation_and_dropout_layers():
    from mxnet_tpu.ops import nn as jnn
    from mxnet_tpu_torch.gluon.nn import Dense, Dropout
    from mxnet_tpu_torch.ops import nn as tnn

    x = np.linspace(-3, 3, 13).astype("float32")
    for act in ("tanh", "erf_gelu"):
        np.testing.assert_allclose(
            tnn.activation(torch.from_numpy(x), act).numpy(),
            np.asarray(jnn.activation(x, act)), rtol=1e-6, atol=1e-6)
    with pytest.raises(MXNetError, match="unknown activation"):
        tnn.activation(torch.from_numpy(x), "swish")
    dense = Dense(2, "tanh", flatten=False, in_units=13, device="cpu")
    torch.nn.init.ones_(dense.weight)
    torch.nn.init.zeros_(dense.bias)
    with torch.no_grad():
        y = dense(torch.from_numpy(x)[None])
    np.testing.assert_allclose(y.numpy(), np.tanh(np.full((1, 2), x.sum())),
                               rtol=1e-6)
    drop = Dropout(0.5)
    ones = torch.ones(1000)
    assert torch.equal(drop(ones), ones)        # identity outside training
    with autograd.record():
        out = drop(ones)
    assert 0 < int((out == 0).sum()) < 1000


def test_pretrain_forward_matches_jax():
    rs = np.random.RandomState(9)
    b, t, n_pred = 3, 32, 5
    tokens, types, lens = _batch(b, t, seed=9)
    pos = np.stack([rs.choice(n, n_pred, replace=False)
                    for n in lens]).astype(np.int32)
    jnet = JBERTForPretrain(jax_get_bert(**TINY))
    jnet.initialize(mx.init.Xavier())
    jnet(nd_i32(tokens), nd_i32(types), nd_i32(lens), nd_i32(pos))
    params = seeded_params(jnet, seed=8)
    for name, p in jnet.collect_params().items():
        p.set_data(params[name])
    tnet = tbert.BERTForPretrain(tbert.get_bert(device="cpu", **TINY))
    convert.load_into(tnet, params)            # names equal JAX's
    assert not autograd.is_training()           # no dropout outside record()
    for masked in (pos, None):
        extra = () if masked is None else (masked,)
        jm, jn = jnet(nd_i32(tokens), nd_i32(types), nd_i32(lens),
                      *(nd_i32(m) for m in extra))
        with torch.no_grad():
            tm, tn = tnet(tokens, types, lens, *extra)
        assert tm.shape == (b, t if masked is None else n_pred,
                            TINY["vocab_size"])
        np.testing.assert_allclose(tm.numpy(), jm.asnumpy(), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(tn.numpy(), jn.asnumpy(), rtol=TOL,
                                   atol=TOL)
