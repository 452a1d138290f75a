"""Deferred shape inference in the port (``gluon.parameter``), on the CPU.

A layer given a width of 0 holds ``UninitializedParameter`` /
``UninitializedBuffer`` subclasses until its first forward reads the
width off the input, as the JAX layers do (``mxnet_tpu/gluon/
parameter.py``, ``block.py:249-267``).  Held here:

* every inferring layer against its twin built with the width (same
  shapes; same outputs once the twin carries its values), the recurrent
  layers and cells against the JAX ones as well;
* ``initialize`` before the first call (values drawn at it, the
  explicit twin's draws for a single layer) and after it (kept unless
  ``force_reinit``), and a call before ``initialize`` refused;
* ``collect_params`` and ``grad_req`` across materialization: the same
  tensor objects, "write" overwriting and "add" summing;
* ``cast`` and device moves before materialization;
* ``save_parameters`` / ``load_parameters`` and ``convert.load_into``
  into a deferred block;
* ``hybridize`` on a deferred block (the CPU cached op's signature
  table after the eager first call);
* ``gluon.Trainer`` skipping a deferred tensor, ``ShardedTrainer``
  refusing one.

Tolerances: outputs of a layer and its twin equal bit for bit (the same
function on the same values); against the JAX recurrent layers 1e-5
(f32, another summation order).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd, convert, gluon, telemetry
from mxnet_tpu_torch.base import DeferredInitializationError, MXNetError
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon import rnn as trnn
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.parameter import grad_req, is_deferred
from mxnet_tpu_torch.parallel import ShardedTrainer

CPU = {"device": "cpu"}

# (deferred layer, explicit twin, input shape)
TWINS = {
    "dense": (lambda: tnn.Dense(5, **CPU),
              lambda: tnn.Dense(5, in_units=24, **CPU), (3, 2, 3, 4)),
    "dense_keep_axes": (lambda: tnn.Dense(5, flatten=False, **CPU),
                        lambda: tnn.Dense(5, flatten=False, in_units=4,
                                          **CPU), (3, 2, 4)),
    "conv2d": (lambda: tnn.Conv2D(4, 3, padding=1, **CPU),
               lambda: tnn.Conv2D(4, 3, padding=1, in_channels=3, **CPU),
               (2, 3, 5, 5)),
    "conv2d_nhwc_groups": (
        lambda: tnn.Conv2D(4, 3, groups=2, layout="NHWC", **CPU),
        lambda: tnn.Conv2D(4, 3, groups=2, layout="NHWC", in_channels=6,
                           **CPU), (2, 5, 5, 6)),
    "conv2d_transpose": (
        lambda: tnn.Conv2DTranspose(4, 3, 2, 1, 1, **CPU),
        lambda: tnn.Conv2DTranspose(4, 3, 2, 1, 1, in_channels=3, **CPU),
        (2, 3, 4, 4)),
    "batch_norm": (lambda: tnn.BatchNorm(**CPU),
                   lambda: tnn.BatchNorm(in_channels=3, **CPU), (4, 3, 2, 2)),
    "batch_norm_nhwc": (lambda: tnn.BatchNorm(axis=-1, **CPU),
                        lambda: tnn.BatchNorm(axis=-1, in_channels=5, **CPU),
                        (4, 2, 2, 5)),
    "layer_norm": (lambda: tnn.LayerNorm(**CPU),
                   lambda: tnn.LayerNorm(in_channels=6, **CPU), (3, 6)),
    "group_norm": (lambda: tnn.GroupNorm(2, **CPU),
                   lambda: tnn.GroupNorm(2, in_channels=4, **CPU),
                   (2, 4, 3, 3)),
    "instance_norm": (lambda: tnn.InstanceNorm(**CPU),
                      lambda: tnn.InstanceNorm(in_channels=4, **CPU),
                      (2, 4, 3, 3)),
    "rnn": (lambda: trnn.RNN(6, 2, **CPU),
            lambda: trnn.RNN(6, 2, input_size=5, **CPU), (4, 2, 5)),
    "lstm_ntc_bidirectional": (
        lambda: trnn.LSTM(6, layout="NTC", bidirectional=True, **CPU),
        lambda: trnn.LSTM(6, layout="NTC", bidirectional=True, input_size=5,
                          **CPU), (2, 4, 5)),
    "gru": (lambda: trnn.GRU(6, **CPU),
            lambda: trnn.GRU(6, input_size=5, **CPU), (4, 2, 5)),
}


def _ran(block, x):
    with autograd.record():
        return block(x)


@pytest.mark.parametrize("case", sorted(TWINS))
def test_inferring_layer_equals_its_explicit_twin(case):
    make, make_twin, shape = TWINS[case]
    late, twin = make(), make_twin()
    assert any(is_deferred(t) for t in late.parameters())
    tmx.random.seed(3)
    late.initialize(tmx.init.Xavier())
    twin.initialize(tmx.init.Xavier())
    x = torch.from_numpy(np.random.RandomState(0).rand(*shape).astype("f4"))
    out = _ran(late, x)
    assert not any(is_deferred(t) for t in list(late.parameters())
                   + list(late.buffers()))
    got = {n: tuple(t.shape) for n, t in late.state_dict().items()}
    assert got == {n: tuple(t.shape) for n, t in twin.state_dict().items()}
    before = {n: t.clone() for n, t in late.state_dict().items()}
    twin.load_state_dict(before)
    want = _ran(twin, x)
    torch.testing.assert_close(out, want, rtol=0, atol=0)


@pytest.mark.parametrize("make", [
    lambda: tnn.Dense(7, **CPU),
    lambda: tnn.Conv2D(4, 3, use_bias=False, **CPU)], ids=["dense", "conv"])
def test_one_layer_draws_what_its_twin_draws(make):
    """A single layer's deferred weight is drawn at the first call from
    the generator as ``initialize`` left it: the explicit twin's values
    for the same seed."""
    late, twin = make(), make()
    x = torch.rand(2, 3, 4, 4)
    twin.infer_shape(x)
    for t in twin.parameters():
        if is_deferred(t):
            t.materialize(t._mx_shape)
    tmx.random.seed(11)
    late.initialize(tmx.init.Xavier())
    late(x)
    tmx.random.seed(11)
    twin.initialize(tmx.init.Xavier())
    assert torch.equal(late.weight, twin.weight)


RECURRENT = {
    "rnn": ("RNN", {}), "lstm": ("LSTM", {}),
    "gru_2_layers": ("GRU", {"num_layers": 2}),
    "rnn_cell": ("RNNCell", {}), "lstm_cell": ("LSTMCell", {}),
    "gru_cell": ("GRUCell", {}),
}


@pytest.mark.parametrize("case", sorted(RECURRENT))
def test_recurrent_input_size_0_matches_jax(case):
    """``input_size=0`` (the default) in both packages: the width comes
    from the first input; the JAX layer's values carried after it."""
    name, kw = RECURRENT[case]
    cell = name.endswith("Cell")
    jl = getattr(mx.gluon.rnn, name)(6, **kw)
    tl = getattr(trnn, name)(6, **kw, **CPU)
    rs = np.random.RandomState(4)
    x = rs.rand(*((3, 5) if cell else (4, 3, 5))).astype("f4") - 0.5
    states = [rs.rand(3, 6).astype("f4")
              for _ in range(2 if name == "LSTMCell" else 1)]

    def run():
        if not cell:
            return jl(mx.np.array(x)), tl(torch.from_numpy(x))
        want, _ = jl(mx.np.array(x), [mx.np.array(s) for s in states])
        got, _ = tl(torch.from_numpy(x), [torch.from_numpy(s)
                                          for s in states])
        return want, got

    jl.initialize(mx.init.Xavier())
    tl.initialize(tmx.init.Xavier())
    deferred = tl.i2h_weight if cell else tl.l0_i2h_weight
    assert is_deferred(deferred)
    run()
    assert deferred.shape[1] == 5
    convert.load_into(tl, {n: p.data().asnumpy()
                           for n, p in jl.collect_params().items()})
    want, got = run()
    np.testing.assert_allclose(got.detach().numpy(), want.asnumpy(),
                               rtol=1e-5, atol=1e-5)


def _net():
    return tnn.HybridSequential().add(
        tnn.Conv2D(4, 3, padding=1, **CPU), tnn.BatchNorm(**CPU),
        tnn.Activation("relu"), tnn.Dense(3, **CPU))


def test_a_call_before_initialize_is_refused_as_jax_refuses_it():
    net = _net()
    with pytest.raises(MXNetError, match="has not been initialized"):
        net(torch.rand(2, 2, 4, 4))
    net.initialize(tmx.init.Xavier())
    assert net(torch.rand(2, 2, 4, 4)).shape == (2, 3)


def test_initialize_after_the_first_call_keeps_values_unless_forced():
    tmx.random.seed(0)
    net = _net().initialize(tmx.init.Xavier())
    x = torch.rand(2, 2, 4, 4)
    net(x)
    w = net[0].weight.detach().clone()
    net.initialize(tmx.init.Xavier())
    assert torch.equal(net[0].weight, w)
    net.initialize(tmx.init.Xavier(), force_reinit=True)
    assert not torch.equal(net[0].weight, w)
    assert net(x).shape == (2, 3)


def test_use_of_a_deferred_tensor_raises_the_deferred_error():
    d = tnn.Dense(3, **CPU)
    for use in (lambda: d.weight.shape, lambda: d.weight + 1,
                lambda: d.weight.to(torch.float64), lambda: d.weight.numel(),
                lambda: torch.matmul(torch.ones(2, 2), d.weight)):
        with pytest.raises(DeferredInitializationError):
            use()
    assert d.weight.dtype == torch.float32 and d.weight.device.type == "cpu"


@pytest.mark.parametrize("req", ["write", "add"])
def test_collect_params_and_grad_req_across_materialization(req):
    net = _net()
    params = net.collect_params()
    assert sum(is_deferred(p) for p in params.values()) == 4
    net.setattr("grad_req", req)
    assert all(grad_req(p) == req for p in params.values())
    tmx.random.seed(1)
    net.initialize(tmx.init.Xavier())
    x = torch.rand(2, 2, 4, 4)
    grads = []
    for _ in range(2):               # the same gradient twice, bit for bit
        with autograd.record():
            y = net(x)
        y.sum().backward()
        grads.append(net[0].weight.grad.clone())
    after = net.collect_params()
    assert all(after[n] is p for n, p in params.items())
    assert not any(is_deferred(p) for p in after.values())
    want = grads[0] if req == "write" else grads[0] * 2
    torch.testing.assert_close(grads[1], want, rtol=0, atol=0)


def test_cast_and_moves_before_materialization():
    """A deferred tensor takes the new type (and device: the card tests
    move one from the CPU to the card) for when it materializes."""
    net = _net()
    net.cast("bfloat16")
    assert net[0].weight.dtype == torch.bfloat16
    assert net[1].running_mean.dtype == torch.bfloat16
    net.initialize(tmx.init.Xavier(), device="cpu")
    assert net[0].weight.device.type == "cpu" and is_deferred(net[0].weight)
    assert net[1].running_var.device.type == "cpu"
    y = net(torch.rand(2, 2, 4, 4, dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16
    assert {t.dtype for t in net.state_dict().values()} == {torch.bfloat16}
    assert torch.equal(net[1].running_var.float(), torch.ones(4))


def test_save_and_load_parameters_into_a_deferred_block(tmp_path):
    tmx.random.seed(2)
    src = _net().initialize(tmx.init.Xavier())
    early = str(tmp_path / "early.params")
    src.save_parameters(early)                      # only the known widths
    assert sorted(tmx.ndarray.load(early)) == ["0.bias", "3.bias"]
    x = torch.rand(2, 2, 4, 4)
    want = src(x)
    path = str(tmp_path / "net.params")
    src.save_parameters(path)
    dst = _net()
    dst.load_parameters(path)
    assert not any(is_deferred(t) for t in dst.state_dict().values())
    torch.testing.assert_close(dst(x), want, rtol=0, atol=0)
    dst.initialize(tmx.init.Xavier())               # keeps the loaded values
    torch.testing.assert_close(dst(x), want, rtol=0, atol=0)


def test_convert_load_into_finishes_a_deferred_block():
    jnet = mx.gluon.nn.HybridSequential()
    jnet.add(mx.gluon.nn.Conv2D(4, 3, padding=1), mx.gluon.nn.BatchNorm(),
             mx.gluon.nn.Activation("relu"), mx.gluon.nn.Dense(3))
    jnet.initialize(mx.init.Xavier())
    x = np.random.RandomState(3).rand(2, 2, 4, 4).astype("f4")
    want = jnet(mx.np.array(x)).asnumpy()
    tnet = convert.load_into(_net(), {
        n: p.data().asnumpy() for n, p in jnet.collect_params().items()})
    np.testing.assert_allclose(tnet(torch.from_numpy(x)).detach().numpy(),
                               want, rtol=1e-5, atol=1e-5)


def test_hybridize_on_a_deferred_block():
    """The eager first call materializes; the cached op's signature table
    is read only after it, and the calls after it agree with eager."""
    tmx.random.seed(4)
    net = _net().initialize(tmx.init.Xavier())
    net.hybridize()
    x = torch.rand(2, 2, 4, 4)
    was = telemetry.set_enabled(True)
    telemetry.reset()
    first = net(x)
    assert not any(is_deferred(t) for t in net.state_dict().values())
    second, third = net(x), net(x)
    snap = telemetry.snapshot()
    telemetry.set_enabled(was)
    assert snap["hybridize.cache_misses"]["value"] == 1
    assert snap["hybridize.cache_hits"]["value"] == 1
    net.hybridize(False)
    eager = net(x)
    for y in (first, second, third):
        torch.testing.assert_close(y, eager, rtol=0, atol=0)


def test_gluon_trainer_skips_deferred_tensors():
    tmx.random.seed(5)
    net = _net().initialize(tmx.init.Xavier())
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.5})
    bias = net[0].bias.detach().clone()
    tr.step(2)                        # nothing has a shape or a gradient yet
    assert is_deferred(net[0].weight) and torch.equal(net[0].bias, bias)
    x, y = torch.rand(4, 2, 4, 4), torch.tensor([0, 1, 2, 1])
    with autograd.record():
        loss = SoftmaxCrossEntropyLoss()(net(x), y)
    loss.backward()
    w = net[0].weight.detach().clone()
    tr.step(4)
    assert not torch.equal(net[0].weight, w)
    assert not torch.equal(net[0].bias, bias)


def test_sharded_trainer_refuses_a_deferred_net_naming_it():
    tmx.random.seed(6)
    net = _net().initialize(tmx.init.Xavier())
    with pytest.raises(DeferredInitializationError, match="'0.weight'.*run"):
        ShardedTrainer(net, SoftmaxCrossEntropyLoss(), optimizer="sgd")
    net(torch.rand(2, 2, 4, 4))
    tr = ShardedTrainer(net, SoftmaxCrossEntropyLoss(), optimizer="sgd",
                        learning_rate=0.1, momentum=0.9)
    x = np.random.RandomState(0).rand(4, 2, 4, 4).astype("f4")
    y = np.array([0, 1, 2, 1], "i4")
    losses = [tr.step(x, y, block=True) for _ in range(3)]
    assert losses[-1] < losses[0]


def test_torch_conversions_and_state_dicts_of_a_deferred_block():
    """torch's own conversions (``to``, ``double``, ``float``,
    ``requires_grad_``) reach a deferred tensor as ``cast`` does: it takes
    the type (and the flag) for when it materializes.  ``state_dict()``
    raises while a tensor is deferred (no value to save), and
    ``load_state_dict`` materializes one at the loaded shape, as
    ``load_parameters`` does."""
    net = _net()
    net.to(torch.float64)
    assert is_deferred(net[0].weight) and net[0].weight.dtype == torch.float64
    assert net[1].running_mean.dtype == torch.float64
    assert net[0].bias.dtype == torch.float64          # a known width too
    net.float().requires_grad_(False)
    assert net[0].weight.dtype == torch.float32
    assert not net[0].weight.requires_grad and not net[3].bias.requires_grad
    net.requires_grad_(True)
    with pytest.raises(DeferredInitializationError):
        net.state_dict()
    tmx.random.seed(7)
    src = _net().initialize(tmx.init.Xavier())
    x = torch.rand(2, 2, 4, 4)
    want = src(x)
    net.load_state_dict(src.state_dict())
    assert not any(is_deferred(t) for t in net.state_dict().values())
    assert net[0].weight.requires_grad
    torch.testing.assert_close(net(x), want, rtol=0, atol=0)


def test_resnet_v1_stem_takes_3_channels_where_jax_infers_them():
    """A recorded difference (ROADMAP C): the port's ResNet v1 is built
    with every width given (the stem's 3 channels among them), where the
    JAX stem's input width waits for the first forward; once the JAX
    net has run, the same values give the same logits (1e-4)."""
    from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
    from mxnet_tpu_torch.gluon.model_zoo import get_model

    kw = dict(classes=10, layout="NHWC")
    jnet = jresnet.get_resnet(1, 18, **kw)
    tnet = get_model("resnet18_v1", device="cpu", **kw)
    assert 0 in tuple(jnet.features[0].weight.shape)
    assert not any(is_deferred(p) for p in tnet.parameters())
    assert tuple(tnet.features[0].weight.shape) == (64, 7, 7, 3)
    jnet.initialize(mx.init.Xavier())
    x = np.random.RandomState(9).rand(2, 32, 32, 3).astype("f4")
    want = jnet(mx.np.array(x)).asnumpy()
    convert.load_into(tnet, {n: p.data().asnumpy()
                             for n, p in jnet.collect_params().items()})
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    # Xavier's logits are small (|want| <= 1.6e-4): held to their scale;
    # the measured error was 4.8e-7 of it
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
