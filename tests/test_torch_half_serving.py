"""16-bit serving in the port against the JAX package, on the CPU.

The JAX package serves in 16 bits by three routes, and the port follows
each: ``Block.cast`` (every parameter and, here, every buffer: the JAX
package's running statistics are parameters), ``TransformerLM(dtype=)``
(only the embeddings and the cache 16-bit; the cells stay f32), and
``amp.convert_hybrid_block`` (weights 16-bit, gammas, betas, biases and
running statistics f32; mixed operands promote as jnp does).  Weights
are drawn with numpy from a seed and carried by ``convert.load_into``.

Bars: the decode kernel's plain version against the Pallas kernel in
interpret mode within 2^-7 (bf16) / 2^-10 (f16) x max|ref| for a 16-bit
output and 1e-5 for an f32 one (caches of one key block, so both round
P at the same running max), the lse within 1e-5; a model's 16-bit
outputs within 2^-4 x max|ref| of the JAX package's (two bf16
computations in other orders, PERF.md section 2), their dtypes exactly;
``convert_hybrid_block``'s f32 BERT within 1e-3 x max|ref|; batch norm in
inference and the bf16 weight carry bit for bit.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import amp as jamp
from mxnet_tpu.gluon.model_zoo import transformer_lm as jax_transformer_lm
from mxnet_tpu.gluon.model_zoo.bert import get_bert as jax_get_bert
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
from mxnet_tpu.kernels import registry as jkreg
from mxnet_tpu.ops import attention as jatt
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch import convert, serve
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.model_zoo import get_model
from mxnet_tpu_torch.gluon.model_zoo import transformer_lm
from mxnet_tpu_torch.gluon.parameter import grad_req, set_grad_req
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.ops import nn as tops
from mxnet_tpu_torch.test_utils import DECODE_PAIRS

from torch_parity import TINY, jax_forward, nd_i32, seeded_params

BF16 = 2.0 ** -4          # a model's bf16 outputs, two computations
_JT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.float16: jnp.float16, torch.int8: jnp.int8}
_NAME = {torch.float32: "f32", torch.bfloat16: "bf16",
         torch.float16: "f16", torch.int8: "int8"}


def _np(x):
    """f32 numpy of a JAX array / NDArray / numpy array of any float type."""
    x = x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)
    return x.astype(np.float32)


def _dtype_name(x) -> str:
    if torch.is_tensor(x):
        return str(x.dtype).replace("torch.", "")
    x = x._data if hasattr(x, "_data") else x
    return np.dtype(x.dtype).name


def _within(got, want, frac, what):
    got, want = _np(got) if not torch.is_tensor(got) else \
        got.float().numpy(), _np(want)
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert np.isfinite(got).all() and err <= frac * top, \
        f"{what}: {err:.3e} > {frac:.3g} x {top:.3e}"
    return err / top


# ----------------------------------------------------------- faults C9, C8
def test_bf16_weights_carry_bit_for_bit():
    """A bf16 JAX array reaches the port as bf16 with the same bits (it
    used to raise: torch takes no numpy array of that type)."""
    rs = np.random.RandomState(0)
    w = np.asarray(jnp.asarray(rs.randn(7, 5).astype("f4")).astype(
        jnp.bfloat16))
    h = np.asarray(jnp.asarray(rs.randn(3).astype("f4")).astype(jnp.float16))
    got = convert.params_from_jax({"w": w, "h": h})
    assert got["w"].dtype == torch.bfloat16 and got["h"].dtype == torch.float16
    assert np.array_equal(got["w"].view(torch.int16).numpy(),
                          w.view(np.int16))
    assert np.array_equal(got["h"].numpy(), h)
    dense = tnn.Dense(7, in_units=5, dtype=torch.bfloat16, device="cpu")
    convert.load_into(dense, {"weight": w, "bias": np.asarray(
        jnp.zeros(7, jnp.bfloat16))})
    assert torch.equal(dense.weight.data, got["w"])


@pytest.mark.parametrize("stats", ["f32", "16bit"])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_batch_norm_infer_16bit_matches_jitted_jax_bits(dt, stats):
    """Inference batch norm on a 16-bit x returns x's type (it returned
    f32 where the statistics are f32) and the jitted JAX op's bits, with
    f32 and with 16-bit statistics."""
    rs = np.random.RandomState(3)
    c = 131
    x = (rs.randn(16, c) * 3).astype("f4")
    vals = [(rs.rand(c) + 0.5), rs.randn(c), rs.randn(c),
            rs.rand(c) * 2 + 1e-4]
    sdt = torch.float32 if stats == "f32" else dt
    jx = jnp.asarray(x).astype(_JT[dt])
    js = [jnp.asarray(v.astype("f4")).astype(_JT[sdt]) for v in vals]
    want = jax.jit(lambda *a: jnn.batch_norm_infer(*a, eps=1e-5, axis=-1))(
        jx, *js)
    tx = torch.from_numpy(_np(jx)).to(dt)
    ts = [torch.from_numpy(_np(s)).to(sdt) for s in js]
    got = tops.batch_norm_infer(tx, *ts, eps=1e-5, axis=-1)
    assert got.dtype == dt
    assert np.array_equal(got.float().numpy(), _np(want))


# ------------------------------------------------------ the decode kernel
def _decode_inputs(q_dtype, kv_dtype, b, h, tq, c, d, seed):
    """The same inputs for both packages: numpy draws cast to each type;
    an int8 cache quantized once by the JAX package's ``quantize_kv``."""
    rs = np.random.RandomState(seed)
    q = (rs.rand(b, h, tq, d) - 0.5).astype("f4")
    k = (rs.rand(b, h, c, d) - 0.5).astype("f4")
    v = (rs.rand(b, h, c, d) - 0.5).astype("f4")
    jq = jnp.asarray(q).astype(_JT[q_dtype])
    if kv_dtype == torch.int8:
        jk, jks = jatt.quantize_kv(jnp.asarray(k))
        jv, jvs = jatt.quantize_kv(jnp.asarray(v))
        jax_kw = dict(k_scale=jks, v_scale=jvs)
        tk, tv = (torch.from_numpy(np.asarray(a)) for a in (jk, jv))
        t_kw = {n: torch.from_numpy(np.asarray(a)) for n, a in jax_kw.items()}
    else:
        jk = jnp.asarray(k).astype(_JT[kv_dtype])
        jv = jnp.asarray(v).astype(_JT[kv_dtype])
        jax_kw = {}
        tk, tv = (torch.from_numpy(_np(a)).to(kv_dtype) for a in (jk, jv))
        t_kw = {}
    tq_ = torch.from_numpy(_np(jq)).to(q_dtype)
    return (jq, jk, jv, jax_kw), (tq_, tk, tv, t_kw)


@pytest.mark.parametrize("pair", DECODE_PAIRS,
                         ids=[f"{_NAME[q]}_{_NAME[k]}" for q, k in DECODE_PAIRS])
@pytest.mark.parametrize("tq,c,d", [(1, 128, 8), (5, 64, 36), (40, 64, 8)])
def test_decode_plain_matches_the_pallas_kernel(pair, tq, c, d):
    """The port's plain version of every (query, cache) pair against
    ``_decode_forward_pallas(..., interpret=True)``: cache lengths 0
    (an inert row) and at the capacity's edge (cache_len + Tq = C) and
    between; the output in q's type, the lse f32."""
    q_dtype, kv_dtype = pair
    lens = np.asarray([0, (c - tq) // 3, c - tq], np.int32)
    (jq, jk, jv, jkw), (tq_, tk, tv, tkw) = _decode_inputs(
        q_dtype, kv_dtype, 3, 2, tq, c, d, seed=tq * 10 + d)
    want, want_lse = jatt._decode_forward_pallas(
        jq, jk, jv, jnp.asarray(lens), scale=1.0 / np.sqrt(d),
        interpret=True, return_lse=True, **jkw)
    got, got_lse = tatt.flash_attention_decode(
        tq_, tk, tv, torch.from_numpy(lens), return_lse=True, **tkw)
    assert _dtype_name(got) == _dtype_name(want) == _dtype_name(jq)
    assert got_lse.dtype == torch.float32
    frac = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
    if q_dtype in frac:
        _within(got, want, frac[q_dtype], "output")
    else:
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), _np(want_lse), rtol=1e-5,
                               atol=1e-5)


def test_cache_primitives_keep_the_jax_casts():
    """``cache_append`` and ``cache_page_copy`` cast the payload to the
    cache's type, as the JAX ones do; ``quantize_kv`` of a bf16 row and
    ``dequantize_kv(dtype=bf16)`` give the JAX package's bits."""
    rs = np.random.RandomState(1)
    new = rs.randn(2, 2, 3, 8).astype("f4")
    jc = jatt.cache_append(jnp.zeros((2, 2, 8, 8), jnp.bfloat16),
                           jnp.asarray(new), jnp.asarray([0, 4]))
    tc = tatt.cache_append(torch.zeros(2, 2, 8, 8, dtype=torch.bfloat16),
                           torch.from_numpy(new), [0, 4])
    assert tc.dtype == torch.bfloat16
    assert np.array_equal(tc.float().numpy(), _np(jc))
    dst = jatt.cache_page_copy(jnp.zeros((1, 2, 6, 8), jnp.float16),
                               jnp.asarray(new[:1]), 3, dst_start=2)
    tdst = tatt.cache_page_copy(torch.zeros(1, 2, 6, 8, dtype=torch.float16),
                                torch.from_numpy(new[:1]), 3, dst_start=2)
    assert np.array_equal(tdst.float().numpy(), _np(dst))
    xb = jnp.asarray(new).astype(jnp.bfloat16)
    jq_, js = jatt.quantize_kv(xb)
    tq_, ts = tatt.quantize_kv(torch.from_numpy(_np(xb)).bfloat16())
    assert np.array_equal(tq_.numpy(), np.asarray(jq_))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    back = jatt.dequantize_kv(jq_, js, dtype=jnp.bfloat16)
    assert np.array_equal(
        tatt.dequantize_kv(tq_, ts, dtype=torch.bfloat16).float().numpy(),
        _np(back))


# --------------------------------------------------------- TransformerLM
def _jax_lm(jlm, *args):
    """The JAX package's forward with its kernels in interpret mode, as
    it runs on its chip: its decode kernel writes q's type, where its
    reference fallback would write v's."""
    with jkreg.override("interpret"):
        return jax_forward(jlm, *args)


def _twin_lms(route):
    """The three routes of a 16-bit ``TransformerLM``: (a) ``dtype=`` only,
    (b) ``cast`` only, (c) both; the same seeded weights in both packages,
    carried before the cast."""
    jlm = jax_transformer_lm(dtype=jnp.bfloat16 if route in "ac"
                             else jnp.float32, **TINY)
    jlm.initialize(mx.init.Xavier())
    params = seeded_params(jlm, 11)
    for name, p in jlm.collect_params().items():
        p.set_data(params[name])
    tlm = transformer_lm(device="cpu", dtype=torch.bfloat16 if route in "ac"
                         else torch.float32, **TINY)
    convert.load_into(tlm, params)
    if route in "bc":
        jlm.cast("bfloat16")
        assert tlm.cast("bfloat16") is tlm
    return jlm, tlm


@pytest.mark.parametrize("route", ["a", "b", "c"],
                         ids=["dtype_only", "cast_only", "both"])
def test_transformer_lm_routes_match_jax(route):
    """A 5-token prefill then 4 decode steps: the cache's and the
    logits' dtypes equal the JAX package's exactly ((a) bf16 cache, f32
    logits; (b) f32 cache, bf16 logits; (c) both bf16) and the logits lie
    within 2^-4 x max|logit| of its."""
    jlm, tlm = _twin_lms(route)
    toks = np.random.RandomState(4).randint(0, TINY["vocab_size"], (2, 9))
    jl, jc = _jax_lm(jlm, toks[:, :5], jlm.begin_cache(2, 16), [0, 0],
                     [5, 5])
    tl, tc = tlm(toks[:, :5], tlm.begin_cache(2, 16), [0, 0], [5, 5])
    for t in range(5, 9):
        assert _dtype_name(tc[0][0]) == _dtype_name(jc[0][0])
        assert _dtype_name(tl) == np.dtype(jl.dtype).name
        _within(tl, jl, BF16, f"route {route}, logits at {t}")
        jl, jc = _jax_lm(jlm, toks[:, t:t + 1], jc, [t, t], [1, 1])
        tl, tc = tlm(toks[:, t:t + 1], tc, [t, t], [1, 1])
    want = {"a": ("bfloat16", "float32"), "b": ("float32", "bfloat16"),
            "c": ("bfloat16", "bfloat16")}[route]
    assert (_dtype_name(tc[0][0]), _dtype_name(tl)) == want


def test_transformer_lm_dtype_makes_only_the_jax_parameters_16bit():
    jlm = jax_transformer_lm(dtype=jnp.float16, **TINY)
    jlm.initialize(mx.init.Xavier())
    tlm = transformer_lm(device="cpu", dtype=torch.float16, **TINY)
    jdt = {n: np.dtype(p.dtype).name for n, p in jlm.collect_params().items()}
    tdt = {n: _dtype_name(p) for n, p in tlm.named_parameters()}
    assert tdt == jdt
    assert sorted(n for n, v in tdt.items() if v == "float16") == \
        ["position_weight", "word_embed.weight"]


def test_int8_cache_of_a_16bit_model_matches_jax():
    """``cache_dtype="int8"`` under a cast model: int8 pages, f32 scales,
    bf16 logits, as the JAX package gives them."""
    jlm = jax_transformer_lm(cache_dtype="int8", **TINY)
    jlm.initialize(mx.init.Xavier())
    params = seeded_params(jlm, 12)
    for name, p in jlm.collect_params().items():
        p.set_data(params[name])
    tlm = transformer_lm(device="cpu", cache_dtype="int8", **TINY)
    convert.load_into(tlm, params)
    jlm.cast("bfloat16")
    tlm.cast(torch.bfloat16)
    toks = np.random.RandomState(5).randint(0, TINY["vocab_size"], (1, 6))
    jl, jc = _jax_lm(jlm, toks, jlm.begin_cache(1, 16), [0], [6])
    tl, tc = tlm(toks, tlm.begin_cache(1, 16), [0], [6])
    assert [_dtype_name(x) for x in tc[0]] == \
        [_dtype_name(x) for x in jc[0]] == ["int8", "float32"] * 2
    assert _dtype_name(tl) == np.dtype(jl.dtype).name == "bfloat16"
    _within(tl, jl, BF16, "int8 cache logits")


# ------------------------------------------------------------------ BERT
BERT = dict(num_layers=2, units=32, hidden_size=64, num_heads=4,
            vocab_size=97, max_length=32, dropout=0.0)


def _twin_berts(seed=5):
    jb = jax_get_bert(**BERT)
    jb.initialize(mx.init.Xavier())
    jb(nd_i32(np.zeros((1, 4))), nd_i32(np.zeros((1, 4))),
       nd_i32(np.full((1,), 4)))
    params = seeded_params(jb, seed)
    for name, p in jb.collect_params().items():
        p.set_data(params[name])
    tb = tbert.get_bert(device="cpu", **BERT)
    convert.load_into(tb, params)
    return jb, tb


def _bert_batch():
    rs = np.random.RandomState(6)
    tokens = rs.randint(0, BERT["vocab_size"], (3, 16)).astype(np.int32)
    types = (rs.rand(3, 16) > 0.5).astype(np.int32)
    return tokens, types, np.asarray([16, 9, 1], np.int32)


def _jax_bert(jb, batch):
    with jkreg.override("interpret"):
        return jb(*(nd_i32(a) for a in batch))


def test_cast_bert_matches_jax():
    """``cast("bfloat16")`` BERT with per-row lengths: bf16 sequence and
    pooled outputs in both packages, within 2^-4 x max|ref|."""
    jb, tb = _twin_berts()
    jb.cast("bfloat16")
    tb.cast(torch.bfloat16)
    batch = _bert_batch()
    jseq, jpooled = _jax_bert(jb, batch)
    with torch.inference_mode():
        tseq, tpooled = tb(*batch)
    for got, want, what in ((tseq, jseq, "sequence"),
                            (tpooled, jpooled, "pooled")):
        assert _dtype_name(got) == _dtype_name(want) == "bfloat16"
        _within(got, want, BF16, what)


def test_convert_hybrid_block_bert_computes_in_f32_as_jax_does():
    """Route 3 on BERT: 16-bit weights meet f32 LayerNorms and biases, so
    the encoder computes in f32 by promotion; f32 outputs within 1e-3 x
    max|ref| of the JAX package's."""
    jb, tb = _twin_berts()
    jamp.convert_hybrid_block(jb, "bfloat16")
    tamp.convert_hybrid_block(tb, "bfloat16")
    assert tb.encoder.layers[0].attention.qkv.weight.dtype == torch.bfloat16
    assert tb.encoder.layers[0].attention.qkv.bias.dtype == torch.float32
    batch = _bert_batch()
    jseq, jpooled = _jax_bert(jb, batch)
    with torch.inference_mode():
        tseq, tpooled = tb(*batch)
    for got, want, what in ((tseq, jseq, "sequence"),
                            (tpooled, jpooled, "pooled")):
        assert _dtype_name(got) == _dtype_name(want) == "float32"
        _within(got, want, 1e-3, what)


# ---------------------------------------------------------------- ResNet
def _twin_resnet18(seed=3):
    kw = dict(thumbnail=True, classes=10, layout="NHWC")
    jnet = jresnet.get_resnet(1, 18, **kw)
    tnet = get_model("resnet18_v1", device="cpu", **kw)
    jnet.initialize(mx.init.Xavier())
    jnet(mx.np.zeros((1, 16, 16, 3)))
    rs = np.random.RandomState(seed)
    params = {}
    for name, p in sorted(jnet.collect_params().items()):
        shape = p.shape
        if name.endswith("running_var"):
            v = rs.uniform(0.5, 1.5, size=shape)
        elif name.endswith("gamma"):
            v = 1.0 + rs.uniform(-0.3, 0.3, size=shape)
        elif len(shape) >= 2:
            bound = np.sqrt(3.0 / np.prod(shape[1:]))
            v = rs.uniform(-bound, bound, size=shape)
        else:
            v = rs.uniform(-0.3, 0.3, size=shape)
        params[name] = v.astype("f4")
        p.set_data(params[name])
    convert.load_into(tnet, params)
    return jnet, tnet


def test_cast_resnet18_scores_as_jax_does():
    """ResNet-18 v1 NHWC cast to bf16 (its running statistics too), a
    bf16 input, inference: bf16 scores within 2^-4 x max|ref| of the JAX
    package's."""
    jnet, tnet = _twin_resnet18()
    jnet.cast("bfloat16")
    tnet.cast(torch.bfloat16)
    assert {b.dtype for b in tnet.buffers()} == {torch.bfloat16}
    x = np.random.RandomState(8).rand(2, 16, 16, 3).astype("f4")
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    want = jnet(mx.np.array(jx))
    with torch.inference_mode():
        got = tnet(torch.from_numpy(_np(jx)).bfloat16())
    assert _dtype_name(got) == _dtype_name(want) == "bfloat16"
    _within(got, want, BF16, "scores")


def test_convert_hybrid_block_resnet_raises_in_both_packages():
    """Route 3 on a ResNet leaves 16-bit convolution weights beside an f32
    input: lax.conv_general_dilated refuses the mixed pair, and so does
    the port, naming both types."""
    jnet, tnet = _twin_resnet18()
    jamp.convert_hybrid_block(jnet, "bfloat16")
    tamp.convert_hybrid_block(tnet, "bfloat16")
    x = np.random.RandomState(8).rand(2, 16, 16, 3).astype("f4")
    with pytest.raises(TypeError):
        jnet(mx.np.array(x))
    with pytest.raises(MXNetError, match="bfloat16"):
        tnet(torch.from_numpy(x))


# ----------------------------------------------------------- Block.cast
def test_block_cast_casts_buffers_and_keeps_gradients_and_grad_req():
    """Every floating parameter and buffer turns bf16; a parameter stays
    the same tensor, its gradient re-attached as zeros of the new type,
    and its ``grad_req`` keeps acting ("write" overwrites, "add" adds)."""
    net = tnn.HybridSequential().add(
        tnn.Dense(4, in_units=3, device="cpu"),
        tnn.BatchNorm(axis=-1, in_channels=4, device="cpu")).initialize(0)
    params = net.collect_params()
    set_grad_req(params["0.bias"], "add")
    x = torch.rand(2, 3)
    net(x).sum().backward()
    assert net.cast("bfloat16") is net
    assert {p.dtype for p in net.parameters()} == {torch.bfloat16}
    assert {b.dtype for b in net.buffers()} == {torch.bfloat16}
    w, bias = params["0.weight"], params["0.bias"]
    assert w is net[0].weight and w.grad.dtype == torch.bfloat16
    assert float(w.grad.abs().sum()) == float(bias.grad.abs().sum()) == 0.0
    xb = x.bfloat16()
    net(xb).float().sum().backward()
    w_once, b_once = w.grad.clone(), bias.grad.clone()
    net(xb).float().sum().backward()
    assert torch.equal(w.grad, w_once)                      # write
    assert torch.equal(bias.grad, (2 * b_once.float()).bfloat16())  # add
    assert grad_req(bias) == "add" and grad_req(w) == "write"


# -------------------------------------------------------------- serving
def test_bf16_decode_server_matches_unbatched_forward():
    """A cast, bf16-cache TransformerLM behind ``register_decode``:
    greedy tokens equal a one-request loop on the CPU."""
    lm = transformer_lm(device="cpu", dtype=torch.bfloat16, **TINY)
    lm.initialize(seed=2).cast(torch.bfloat16)
    serve.register_decode("lm16", lm, slots=2, prompt_buckets=(8,),
                          capacity_buckets=(16, 32), max_new_tokens=6)
    try:
        rs = np.random.RandomState(9)
        prompts = [rs.randint(0, TINY["vocab_size"], n).tolist()
                   for n in (3, 8, 5)]
        futs = [serve.decode_submit("lm16", p) for p in prompts]
        got = [f.result(60.0) for f in futs]
    finally:
        serve.shutdown_decode(30.0)
    for prompt, toks in zip(prompts, got):
        cache = lm.begin_cache(1, 16)
        assert cache[0][0].dtype == torch.bfloat16
        logits, cache = lm(np.asarray([prompt]), cache, [0], [len(prompt)])
        want = [int(logits[0, -1].float().argmax())]
        for i in range(5):
            logits, cache = lm(np.asarray([[want[-1]]]), cache,
                               [len(prompt) + i], [1])
            want.append(int(logits[0, 0].float().argmax()))
        assert toks == want


def test_bf16_batch_server_matches_unbatched_forward():
    """A cast bf16 BERT behind ``serve.register`` / ``Server``: each answer
    equals a one-request forward (bf16 values, handed out as f32 numpy)."""
    _, tb = _twin_berts()
    tb.cast(torch.bfloat16)
    serve.register("bert16", tb, bucketer={0: [1, 2, 4], 1: ("pow2", 8, 32)},
                   sample=(np.zeros(8, np.int32), np.zeros(8, np.int32),
                           np.asarray(8, np.int32)))
    srv = serve.Server(max_wait_ms=5, max_batch=4)
    try:
        tokens, types, lens = _bert_batch()
        reqs = [(tokens[i, :n], types[i, :n], np.asarray(n, np.int32))
                for i, n in enumerate(lens)]
        outs = [f.result(60.0) for f in [srv.submit("bert16", *r)
                                         for r in reqs]]
    finally:
        srv.close(30.0)
        serve.unregister("bert16")
    for (tok, seg, n), (seq, pooled) in zip(reqs, outs):
        with torch.inference_mode():
            rseq, rpooled = tb(tok[None], seg[None], np.asarray([int(n)]))
        assert seq.dtype == np.float32 and seq.shape == (int(n), 32)
        np.testing.assert_array_equal(seq, rseq[0].float().numpy())
        np.testing.assert_array_equal(pooled, rpooled[0].float().numpy())
