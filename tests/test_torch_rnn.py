"""The port's recurrent ops, layers and cells against the JAX package's,
on the CPU.

Weights and inputs are drawn with numpy from a seed; the JAX blocks get
them by ``Parameter.set_data`` and the port's by ``convert.load_into``.
Bars: the fused recurrence and the cells within 1e-5 (f32, the same
order of operations, other summation orders in the products); the
gradients of the fused recurrence (torch autograd against
``jax.grad``) within 1e-4; the activations within 1e-6.  Dropout masks
come from the port's own seeded generator (a deliberate difference), so
dropout is held exactly at rate 0 and by its kept share (within 3
standard deviations) and kept values at rate 0.5.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import rnn as jrnn
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops import rnn as jops
from mxnet_tpu_torch import autograd, convert
from mxnet_tpu_torch import numpy_extension as npx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon import rnn as trnn
from mxnet_tpu_torch.ops import nn as tops_nn
from mxnet_tpu_torch.ops import rnn as tops

MODES = ("lstm", "gru", "rnn_relu", "rnn_tanh")
T, B, C, H = 7, 3, 5, 6


def _uniform(rs, shape, scale=0.4):
    return rs.uniform(-scale, scale, size=shape).astype("float32")


def _twin(jblock, tblock, seed):
    """Seeded uniform(-0.4, 0.4) values into both blocks (biases too)."""
    rs = np.random.RandomState(seed)
    params = {n: _uniform(rs, p.shape)
              for n, p in sorted(jblock.collect_params().items())}
    for n, p in jblock.collect_params().items():
        p.set_data(params[n])
    convert.load_into(tblock, params)
    return params


def _close(got, want, tol, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    want = want.asnumpy() if hasattr(want, "asnumpy") else np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=msg)


# --------------------------------------------------- the parameter layout
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layers,bidir", [(1, False), (2, True)])
def test_pack_and_unpack_bit_for_bit(mode, layers, bidir):
    n = jops.param_size(mode, C, H, layers, bidir)
    assert tops.param_size(mode, C, H, layers, bidir) == n
    flat = np.random.RandomState(1).randn(n).astype("float32")
    want = jops.unpack_params(jnp.asarray(flat), mode, C, H, layers, bidir)
    got = tops.unpack_params(torch.from_numpy(flat), mode, C, H, layers,
                             bidir)
    assert len(got) == len(want) == layers * (2 if bidir else 1)
    for g, w in zip(got, want):
        for gt, wt in zip(g, w):
            assert tuple(gt.shape) == wt.shape
            np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_array_equal(tops.pack_params(got).numpy(), flat)
    np.testing.assert_array_equal(
        np.asarray(jops.pack_params(want)), tops.pack_params(got).numpy())
    with pytest.raises(MXNetError):
        tops.unpack_params(torch.zeros(n + 1), mode, C, H, layers, bidir)


# ---------------------------------------------------- the fused recurrence
FUSED_CASES = [(m, l, bd, sl) for m in MODES
               for (l, bd, sl) in ((1, False, False), (2, True, True),
                                   (2, False, True))]


def _fused_inputs(mode, layers, bidir, seed):
    rs = np.random.RandomState(seed)
    d = 2 if bidir else 1
    n = jops.param_size(mode, C, H, layers, bidir)
    return dict(x=_uniform(rs, (T, B, C), 1.0),
                params=_uniform(rs, (n,), 0.5),
                h0=_uniform(rs, (layers * d, B, H), 0.5),
                c0=_uniform(rs, (layers * d, B, H), 0.5),
                lens=np.asarray([T, 3, 1], np.int32),
                heads=[_uniform(rs, s, 1.0) for s in
                       ((T, B, d * H), (layers * d, B, H),
                        (layers * d, B, H))])


@pytest.mark.parametrize("mode,layers,bidir,seq", FUSED_CASES)
def test_rnn_fused_and_its_gradients_match_jax(mode, layers, bidir, seq):
    v = _fused_inputs(mode, layers, bidir, seed=layers * 7 + bidir + seq)
    kw = dict(mode=mode, state_size=H, num_layers=layers,
              bidirectional=bidir, use_sequence_length=seq)
    lstm = mode == "lstm"

    def jloss(x, params, h0, c0):
        res = jops.rnn_fused(x, params, h0, c0 if lstm else None,
                             sequence_length=jnp.asarray(v["lens"]), **kw)
        return sum(jnp.sum(r * jnp.asarray(w))
                   for r, w in zip(res, v["heads"])), res

    names = ("x", "params", "h0", "c0")
    (_, jres), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                           has_aux=True)(
        *(jnp.asarray(v[k]) for k in names))
    ts = {k: torch.tensor(v[k], requires_grad=True) for k in names}
    res = tops.rnn_fused(ts["x"], ts["params"], ts["h0"],
                         ts["c0"] if lstm else None,
                         sequence_length=torch.from_numpy(v["lens"]), **kw)
    assert len(res) == len(jres) == (3 if lstm else 2)
    for r, w in zip(res, jres):
        _close(r, w, 1e-5, mode)
    sum((r * torch.from_numpy(w)).sum()
        for r, w in zip(res, v["heads"])).backward()
    for k, g in zip(names, jgrads):
        if k == "c0" and not lstm:
            assert ts[k].grad is None
            continue
        _close(ts[k].grad, g, 1e-4, f"d{k}")


def test_sequence_length_freezes_states_and_repeats_outputs():
    v = _fused_inputs("lstm", 1, False, seed=3)
    out, hy, cy = tops.rnn_fused(
        torch.from_numpy(v["x"]), torch.from_numpy(v["params"]),
        torch.from_numpy(v["h0"]), torch.from_numpy(v["c0"]),
        state_size=H, sequence_length=torch.from_numpy(v["lens"]),
        use_sequence_length=True)
    for b, n in enumerate(v["lens"]):
        for t in range(n, T):           # past the row's end: the last h
            assert torch.equal(out[t, b], out[n - 1, b])
        assert torch.equal(hy[0, b], out[n - 1, b])


def test_projection_size_raises_as_in_jax():
    v = _fused_inputs("lstm", 1, False, seed=0)
    with pytest.raises(MXNetError, match="projection_size"):
        tops.rnn_fused(torch.from_numpy(v["x"]),
                       torch.from_numpy(v["params"]),
                       torch.from_numpy(v["h0"]), torch.from_numpy(v["c0"]),
                       projection_size=3)


# ------------------------------------------------------------- the layers
LAYER_CASES = {
    "lstm_tnc": (jrnn.LSTM, trnn.LSTM, {"num_layers": 2}),
    "lstm_ntc_bidir": (jrnn.LSTM, trnn.LSTM, {"layout": "NTC",
                                               "bidirectional": True}),
    "gru_bidir_2": (jrnn.GRU, trnn.GRU, {"num_layers": 2,
                                          "bidirectional": True}),
    "rnn_relu": (jrnn.RNN, trnn.RNN, {}),
    "rnn_tanh_2": (jrnn.RNN, trnn.RNN, {"num_layers": 2,
                                         "activation": "tanh"}),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
@pytest.mark.parametrize("with_states", [False, True],
                         ids=["no_states", "states"])
def test_layers_match_jax(case, with_states):
    jcls, tcls, kw = LAYER_CASES[case]
    jl = jcls(H, input_size=C, **kw)
    jl.initialize(mx.init.Xavier())
    tl = tcls(H, input_size=C, device="cpu", **kw)
    _twin(jl, tl, seed=len(case))
    assert [n for n, _ in tl.named_parameters()] == list(jl.collect_params())
    rs = np.random.RandomState(5)
    shape = (B, T, C) if kw.get("layout") == "NTC" else (T, B, C)
    x = _uniform(rs, shape, 1.0)
    if not with_states:
        _close(tl(torch.from_numpy(x)), jl(mx.np.array(x)), 1e-5)
        return
    states = [_uniform(rs, i["shape"], 0.5) for i in jl.state_info(B)]
    jout, jst = jl(mx.np.array(x), [mx.np.array(s) for s in states])
    tout, tst = tl(torch.from_numpy(x), [torch.from_numpy(s)
                                         for s in states])
    _close(tout, jout, 1e-5)
    assert len(tst) == len(jst) == len(states)
    for g, w in zip(tst, jst):
        _close(g, w, 1e-5)


def test_layer_sequence_length_matches_jax():
    jl = jrnn.LSTM(H, num_layers=2, bidirectional=True, input_size=C,
                   use_sequence_length=True)
    jl.initialize(mx.init.Xavier())
    tl = trnn.LSTM(H, num_layers=2, bidirectional=True, input_size=C,
                   use_sequence_length=True, device="cpu")
    _twin(jl, tl, seed=9)
    x = _uniform(np.random.RandomState(6), (T, B, C), 1.0)
    lens = np.asarray([4, T, 2], np.int32)
    _close(tl(torch.from_numpy(x), sequence_length=torch.from_numpy(lens)),
           jl(mx.np.array(x), sequence_length=mx.np.array(lens)), 1e-5)
    with pytest.raises(MXNetError, match="sequence_length"):
        tl(torch.from_numpy(x))


def test_npx_rnn_takes_the_flat_vector_with_the_layers_results():
    tl = trnn.GRU(H, num_layers=2, bidirectional=True, input_size=C,
                  device="cpu")
    jl = jrnn.GRU(H, num_layers=2, bidirectional=True, input_size=C)
    jl.initialize(mx.init.Xavier())
    _twin(jl, tl, seed=4)
    x = torch.from_numpy(_uniform(np.random.RandomState(7), (T, B, C), 1.0))
    h0 = tl.begin_state(B)[0]
    flat = tops.pack_params(tl._per_layer())
    assert flat.numel() == tops.param_size("gru", C, H, 2, True)
    out, hy = npx.rnn(x, flat, h0, mode="gru", state_size=H, num_layers=2,
                      bidirectional=True)
    want, (want_h,) = tl(x, [h0])
    assert torch.equal(out, want) and torch.equal(hy, want_h)
    assert torch.equal(npx.rnn(x, flat, h0, mode="gru", num_layers=2,
                               bidirectional=True, state_outputs=False),
                       want)
    with pytest.raises(MXNetError, match="state_cell"):
        npx.rnn(x, flat, h0, mode="lstm")


def test_layer_state_info_begin_state_and_repr():
    tl = trnn.LSTM(H, num_layers=3, bidirectional=True, input_size=C,
                   device="cpu")
    jl = jrnn.LSTM(H, num_layers=3, bidirectional=True, input_size=C)
    assert tl.state_info(4) == jl.state_info(4)
    st = tl.begin_state(4)
    assert [tuple(s.shape) for s in st] == [(6, 4, H)] * 2
    assert all(s.device.type == "cpu" and not s.any() for s in st)
    assert repr(tl) == repr(jl) == \
        "LSTM(6, num_layers=3, bidirectional=True, layout=TNC)"
    assert len(trnn.GRU(H, input_size=C, device="cpu").state_info(2)) == 1
    with pytest.raises(MXNetError):
        trnn.RNN(H, activation="sigmoid", input_size=C, device="cpu")
    with pytest.raises(MXNetError):
        trnn.LSTM(H, layout="CTN", input_size=C, device="cpu")


# -------------------------------------------------------------- the cells
def _cells(pkg, dev):
    """Every cell of the JAX module up to LSTMPCell, built alike in both
    packages (``pkg`` is the JAX ``rnn`` or the port's)."""
    kw = {} if dev is None else {"device": dev}

    def seq():
        s = pkg.SequentialRNNCell()
        s.add(pkg.LSTMCell(H, input_size=C, **kw))
        s.add(pkg.DropoutCell(0.5))
        s.add(pkg.GRUCell(H, input_size=H, **kw))
        return s

    def hseq():
        s = pkg.HybridSequentialRNNCell()
        s.add(pkg.RNNCell(H, input_size=C, **kw))
        s.add(pkg.ResidualCell(pkg.LSTMCell(H, input_size=H, **kw)))
        return s

    return {
        "rnn_tanh": lambda: pkg.RNNCell(H, input_size=C, **kw),
        "rnn_relu": lambda: pkg.RNNCell(H, activation="relu", input_size=C,
                                        **kw),
        "lstm": lambda: pkg.LSTMCell(H, input_size=C, **kw),
        "gru": lambda: pkg.GRUCell(H, input_size=C, **kw),
        "lstmp": lambda: pkg.LSTMPCell(H, 4, input_size=C, **kw),
        "sequential": seq,
        "hybrid_sequential": hseq,
        "residual": lambda: pkg.ResidualCell(pkg.GRUCell(C, input_size=C,
                                                         **kw)),
        "zoneout": lambda: pkg.ZoneoutCell(pkg.LSTMCell(H, input_size=C,
                                                        **kw), 0.5, 0.5),
        "variational": lambda: pkg.VariationalDropoutCell(
            pkg.GRUCell(H, input_size=C, **kw), 0.5, 0.5, 0.5),
        "bidirectional": lambda: pkg.BidirectionalCell(
            pkg.LSTMCell(H, input_size=C, **kw),
            pkg.GRUCell(H, input_size=C, **kw)),
    }


UNROLLS = {
    "ntc": dict(layout="NTC"),
    "tnc_valid_length": dict(layout="TNC", valid_length=[T, 2, 5]),
    "list_unmerged": dict(layout="NTC", merge_outputs=False),
}


@pytest.mark.parametrize("how", sorted(UNROLLS))
@pytest.mark.parametrize("name", sorted(_cells(trnn, "cpu")))
def test_cells_unroll_as_jax(name, how):
    """Outside training (the dropout and zoneout cells are identities
    there, as in the JAX package)."""
    jc, tc = _cells(jrnn, None)[name](), _cells(trnn, "cpu")[name]()
    jc.initialize(mx.init.Xavier())
    _twin(jc, tc, seed=len(name) + len(how))
    assert sorted(n for n, _ in tc.named_parameters()) == \
        sorted(jc.collect_params())
    spec = dict(UNROLLS[how])
    rs = np.random.RandomState(8)
    x = _uniform(rs, (T, B, C) if spec["layout"] == "TNC" else (B, T, C),
                 1.0)
    jx, tx = mx.np.array(x), torch.from_numpy(x)
    if spec.get("merge_outputs") is False:
        jx = [jx[:, t] for t in range(T)]
        tx = [tx[:, t] for t in range(T)]
    if "valid_length" in spec:
        lens = np.asarray(spec.pop("valid_length"), np.int32)
        spec["valid_length"] = mx.np.array(lens)
        jout, jst = jc.unroll(T, jx, **spec)
        spec["valid_length"] = torch.from_numpy(lens)
    else:
        jout, jst = jc.unroll(T, jx, **spec)
    tout, tst = tc.unroll(T, tx, **spec)
    if spec.get("merge_outputs") is False:
        assert len(tout) == len(jout) == T
        for g, w in zip(tout, jout):
            _close(g, w, 1e-5, name)
    else:
        _close(tout, jout, 1e-5, name)
    assert len(tst) == len(jst)
    for g, w in zip(tst, jst):
        _close(g, w, 1e-5, f"{name} state")


@pytest.mark.parametrize("name", ["lstm", "gru", "rnn_tanh", "lstmp"])
def test_one_cell_step_with_given_states_as_jax(name):
    jc, tc = _cells(jrnn, None)[name](), _cells(trnn, "cpu")[name]()
    jc.initialize(mx.init.Xavier())
    _twin(jc, tc, seed=11)
    rs = np.random.RandomState(12)
    x = _uniform(rs, (B, C), 1.0)
    states = [_uniform(rs, i["shape"], 0.5) for i in jc.state_info(B)]
    assert [i["shape"] for i in tc.state_info(B)] == \
        [i["shape"] for i in jc.state_info(B)]
    jout, jst = jc(mx.np.array(x), [mx.np.array(s) for s in states])
    tout, tst = tc(torch.from_numpy(x), [torch.from_numpy(s) for s in states])
    _close(tout, jout, 1e-5)
    for g, w in zip(tst, jst):
        _close(g, w, 1e-5)


def test_bidirectional_cell_cannot_be_stepped():
    c = trnn.BidirectionalCell(trnn.LSTMCell(H, input_size=C, device="cpu"),
                               trnn.LSTMCell(H, input_size=C, device="cpu"))
    with pytest.raises(MXNetError, match="unroll"):
        c(torch.zeros(B, C))


# ----------------------------------------------------------------- dropout
N_DRAW = 4096


def _share_ok(kept: int, n: int, p_keep: float = 0.5):
    sigma = np.sqrt(p_keep * (1 - p_keep) / n)
    assert abs(kept / n - p_keep) <= 3 * sigma, (kept, n)


def _identity_relu_rnn(rate):
    """A 2-layer relu RNN whose layers pass a positive input through
    (Wi = I, Wh = 0, biases 0): its output is the inter-layer dropout
    applied to the input."""
    layer = trnn.RNN(N_DRAW, num_layers=2, dropout=rate, input_size=N_DRAW,
                     device="cpu")
    with torch.no_grad():
        for n, p in layer.named_parameters():
            p.copy_(torch.eye(N_DRAW) if n.endswith("i2h_weight")
                    else torch.zeros_like(p))
    return layer


def test_layer_inter_layer_dropout():
    x = torch.rand(1, 1, N_DRAW) + 0.5
    assert torch.equal(_identity_relu_rnn(0.5)(x), x)   # not training
    with autograd.record():
        assert torch.equal(_identity_relu_rnn(0.0)(x), x)
        out = _identity_relu_rnn(0.5)(x)
    kept = out != 0
    _share_ok(int(kept.sum()), N_DRAW)
    assert torch.equal(out[kept], x[kept] / 0.5)


def test_dropout_cells_keep_their_share():
    x = torch.rand(2, N_DRAW) + 0.5
    cell = trnn.DropoutCell(0.5)
    assert torch.equal(cell(x, [])[0], x)                # not training
    with autograd.record():
        assert torch.equal(trnn.DropoutCell(0.0)(x, [])[0], x)
        out, _ = cell(x, [])
    kept = out != 0
    _share_ok(int(kept.sum()), x.numel())
    assert torch.equal(out[kept], x[kept] / 0.5)


def test_variational_dropout_keeps_one_mask_a_sequence():
    base = trnn.RNNCell(64, input_size=8, device="cpu")
    mx_init(base)
    cell = trnn.VariationalDropoutCell(base, drop_outputs=0.5)
    x = torch.rand(3, 64, 8)
    with autograd.record():
        outs, _ = cell.unroll(3, x, layout="TNC", merge_outputs=False)
    masks = [o != 0 for o in outs]
    assert all(torch.equal(m, masks[0]) for m in masks)
    _share_ok(int(masks[0].sum()), masks[0].numel())
    cell.reset()
    assert cell._mask_o is None


def test_zoneout_mixes_against_zeros_at_the_first_step():
    base = trnn.LSTMCell(64, input_size=8, device="cpu")
    mx_init(base)
    x = torch.rand(64, 8)
    new, _ = base(x)
    cell = trnn.ZoneoutCell(base, zoneout_outputs=0.5)
    with autograd.record():
        out, _ = cell(x)
    kept = out != 0
    _share_ok(int(kept.sum()), out.numel())
    assert torch.equal(out[kept], new[kept])
    with autograd.record():
        same, _ = trnn.ZoneoutCell(base)(x)
    assert torch.equal(same, new)


def mx_init(block, seed=0):
    from mxnet_tpu_torch.test_utils import xavier_init
    xavier_init(block, seed)


# ------------------------------------------------------------ activations
ACTS = ("relu", "sigmoid", "tanh", "softrelu", "softsign", "log_sigmoid",
        "mish", "gelu", "erf_gelu", "silu")


@pytest.mark.parametrize("act", ACTS)
def test_activation_matches_jax(act):
    x = np.concatenate([np.linspace(-12, 12, 481, dtype="float32"),
                        np.random.RandomState(2).randn(500).astype("f4")])
    want = np.asarray(jnn.activation(jnp.asarray(x), act))
    got = npx.activation(torch.from_numpy(x), act_type=act)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert tnn.Activation(act)(torch.from_numpy(x)).equal(got)
    assert tops_nn.activation(torch.from_numpy(x), act).equal(got)


def test_unknown_activation_raises():
    with pytest.raises(MXNetError, match="unknown activation"):
        npx.activation(torch.zeros(2), act_type="swish")


# -------------------------------------------------------------- not ported
@pytest.mark.parametrize("make", [
    lambda: trnn.Conv2DLSTMCell((3, 8, 8), 4),
    lambda: trnn.Conv1DRNNCell((3, 8), 4),
    lambda: trnn.Conv3DGRUCell((3, 4, 8, 8), 4),
], ids=["conv2d_lstm_cell", "conv1d_rnn_cell", "conv3d_gru_cell"])
def test_not_ported_raises_naming_a6(make):
    with pytest.raises(MXNetError, match="A6"):
        make()


# ---------------------------------------------------- C12: bare layers
C12_LAYERS = {
    "dense": lambda **kw: tnn.Dense(3, in_units=2, **kw),
    "embedding": lambda **kw: tnn.Embedding(5, 3, **kw),
    "layer_norm": lambda **kw: tnn.LayerNorm(in_channels=4, **kw),
    "batch_norm": lambda **kw: tnn.BatchNorm(in_channels=4, **kw),
    "batch_norm_relu": lambda **kw: tnn.BatchNormReLU(in_channels=4, **kw),
    "conv2d": lambda **kw: tnn.Conv2D(2, 3, in_channels=1, **kw),
    "rnn_lstm": lambda **kw: trnn.LSTM(4, input_size=3, **kw),
    "lstm_cell": lambda **kw: trnn.LSTMCell(4, input_size=3, **kw),
}


@pytest.mark.parametrize("name", sorted(C12_LAYERS))
def test_bare_layer_defaults_to_the_card(name):
    """A layer built with no device is on ``cuda:0``, or raises where
    there is no card; ``device="cpu"`` builds it on the CPU, and
    ``initialize()`` leaves it there."""
    make = C12_LAYERS[name]
    if torch.cuda.is_available():
        tensors = list(make().parameters()) + list(make().buffers())
        assert {t.device for t in tensors} == {torch.device("cuda", 0)}
    else:
        with pytest.raises(MXNetError, match="device='cpu'"):
            make()
    block = make(device="cpu")
    mx_init(block)
    assert {t.device.type for t in block.parameters()} == {"cpu"}


def test_layer_initializers_route_by_name_as_jax_does():
    """``LSTMBias`` given for an ``*_i2h_bias`` goes to zeros by the name
    routing, in both packages; the weights take their own initializer."""
    import mxnet_tpu_torch as tmx

    jl = jrnn.LSTM(H, input_size=C, i2h_bias_initializer=mx.init.LSTMBias(1.0),
                   h2h_weight_initializer=mx.init.One())
    jl.initialize(mx.init.Xavier())
    tl = trnn.LSTM(H, input_size=C, device="cpu",
                   i2h_bias_initializer=tmx.init.LSTMBias(1.0),
                   h2h_weight_initializer=tmx.init.One())
    mx_init(tl)
    for name in ("l0_i2h_bias", "l0_h2h_weight"):
        want = jl.collect_params()[name].data().asnumpy()
        np.testing.assert_array_equal(getattr(tl, name).detach().numpy(),
                                      want, err_msg=name)
