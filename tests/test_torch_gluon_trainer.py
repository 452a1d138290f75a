"""The port's eager Gluon path (``autograd.record`` -> loss ->
``backward`` -> ``gluon.Trainer.step``) against the JAX package's, on
the CPU.

Weights: the JAX model is initialized (Xavier) and its values carried to
the port with ``convert.load_into``; inputs are the class-templated
MNIST-shaped images of the JAX package's synthetic set (numpy, from a
seed).  The JAX user block runs the Pallas kernels of
``example/extensions/pallas_ops.py`` in interpret mode; the port's runs
the plain versions of ``kernels/ext_ops.py`` (its tensors lie on the
CPU).

Tolerances: LeNet-5 at its published widths, 8 steps at B=16: losses
within 1e-5 relative for sgd + momentum and 1e-4 for adam (Adam divides
by sqrt(v), which magnifies last-bit differences of small gradients: an
update near a zero gradient can flip sign, a step of up to lr, so adam
runs with epsilon 1e-6, which bounds that step), every parameter within
1e-4; the extension
block the same over 3 steps; BatchNorm's training under ``record()``
within 1e-5 in loss and running statistics.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import library as jlibrary
from mxnet_tpu import rtc as jrtc
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd, convert, gluon, library, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.parameter import is_deferred
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo import get_model
from mxnet_tpu_torch.kernels import registry
from mxnet_tpu_torch.test_utils import xavier_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PALLAS_OPS = os.path.join(REPO, "example", "extensions", "pallas_ops.py")
MNIST_AB = (1 / 0.3081, -0.1307 / 0.3081)


@contextlib.contextmanager
def jax_pallas_ops():
    """``mx.npx.pallas_squared_relu`` / ``pallas_axpb`` of the JAX
    example for the block: loaded when absent and removed again after,
    so that ``tests/test_extensions.py``, which loads them itself, can
    run later in the same process."""
    names = ("pallas_squared_relu", "pallas_axpb")
    added = not hasattr(mx.npx, names[0])
    if added:
        mx.library.load(PALLAS_OPS)
    try:
        yield
    finally:
        if added:
            for name in names:
                jrtc._KERNELS.pop(name, None)
                jlibrary._LOADED.pop(name, None)
                if hasattr(mx.npx, name):
                    delattr(mx.npx, name)


def _mnist(num, seed):
    """The JAX package's synthetic MNIST (``datasets.py``
    ``_synthetic_images``, templates from seed 1234), as NCHW f32 in [0,
    1] (``ToTensor``)."""
    templates = np.random.RandomState(1234).uniform(
        0, 1.0, (10, 28, 28)).astype(np.float32)
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, num).astype(np.int32)
    noise = rng.normal(0, 0.3, (num, 28, 28)).astype(np.float32)
    images = (np.clip(templates[labels] * 0.7 + noise, 0, 1) * 255
              ).astype(np.uint8)
    return images[:, None].astype(np.float32) / 255, labels


def _carry(jnet, tnet, sample, seed=0):
    """Initialize ``jnet`` from ``seed`` (a forward infers its shapes)
    and load its values into ``tnet``."""
    mx.random.seed(seed)
    jnet.initialize(mx.init.Xavier())
    jnet(mx.np.array(sample))
    params = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    convert.load_into(tnet, params)
    return params


def _train_both(jnet, tnet, opt, opt_params, xs, ys, steps, batch):
    jtr = mx.gluon.Trainer(jnet.collect_params(), opt, dict(opt_params))
    ttr = gluon.Trainer(tnet.collect_params(), opt, dict(opt_params))
    jloss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    tloss_fn = SoftmaxCrossEntropyLoss()
    jl, tl = [], []
    for i in range(steps):
        x, y = xs[i * batch:(i + 1) * batch], ys[i * batch:(i + 1) * batch]
        with mx.autograd.record():
            jloss = jloss_fn(jnet(mx.np.array(x)), mx.np.array(y))
        jloss.backward()
        jtr.step(batch)
        with autograd.record():
            tloss = tloss_fn(tnet(torch.from_numpy(x)), torch.from_numpy(y))
        autograd.backward(tloss)
        ttr.step(batch)
        jl.append(float(jloss.asnumpy().mean()))
        tl.append(float(tloss.detach().mean()))
    return jl, tl, ttr


def _params_close(jnet, tnet, tol):
    tparams = tnet.collect_params()
    jparams = jnet.collect_params()
    assert sorted(tparams) == sorted(jparams)
    for name, p in jparams.items():
        np.testing.assert_allclose(tparams[name].detach().numpy(),
                                   p.data().asnumpy(), rtol=tol, atol=tol,
                                   err_msg=name)


# ------------------------------------------------------------- LeNet-5
@pytest.mark.parametrize("opt,opt_params,tol", [
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9}, 1e-5),
    ("adam", {"learning_rate": 1e-3, "epsilon": 1e-6}, 1e-4)],
    ids=["sgd", "adam"])
def test_lenet_trajectory_matches_jax_trainer(opt, opt_params, tol):
    xs, ys = _mnist(128, 7)
    jnet = mx.gluon.model_zoo.vision.get_model("lenet")
    tnet = get_model("lenet", device="cpu")
    _carry(jnet, tnet, xs[:1])
    tnet.hybridize()
    registry.reset_launches()
    jl, tl, ttr = _train_both(jnet, tnet, opt, opt_params, xs, ys, 8, 16)
    assert not any(registry.launches().values())   # CPU: plain versions
    np.testing.assert_allclose(tl, jl, rtol=tol, atol=0)
    assert opt == "adam" or tl[-1] < tl[0]      # sgd's 8 steps train
    _params_close(jnet, tnet, 1e-4)
    assert ttr.learning_rate == opt_params["learning_rate"]


def test_lenet_names_shapes_and_seeded_initialize():
    net = xavier_init(get_model("lenet", device="cpu"), 3)
    shapes = {n: tuple(p.shape) for n, p in net.collect_params().items()}
    assert shapes == {
        "features.0.weight": (20, 1, 5, 5), "features.0.bias": (20,),
        "features.2.weight": (50, 20, 5, 5), "features.2.bias": (50,),
        "features.5.weight": (500, 800), "features.5.bias": (500,),
        "output.weight": (10, 500), "output.bias": (10,)}
    again = xavier_init(get_model("lenet", device="cpu"), 3)
    for (name, a), b in zip(net.state_dict().items(),
                            again.state_dict().values()):
        assert torch.equal(a, b), name
    assert not net.features[0].bias.any()
    assert list(net.collect_params("features.*weight")) == [
        "features.0.weight", "features.2.weight", "features.5.weight"]
    out = net(torch.zeros(2, 1, 28, 28))
    assert out.shape == (2, 10)


# -------------------------------------------------- the extension block
class _JExtLeNet(mx.gluon.HybridBlock):
    """LeNet's layers with the input normalized by ``pallas_axpb`` and
    the hidden layer's activation ``pallas_squared_relu`` (JAX)."""

    def __init__(self):
        super().__init__()
        nn = mx.gluon.nn
        self.features = nn.HybridSequential()
        self.features.add(nn.Conv2D(20, 5, activation="tanh"),
                          nn.MaxPool2D(2, 2),
                          nn.Conv2D(50, 5, activation="tanh"),
                          nn.MaxPool2D(2, 2), nn.Flatten())
        self.hidden = nn.Dense(500)
        self.output = nn.Dense(10)

    def forward(self, x):
        x = mx.npx.pallas_axpb(x, a=MNIST_AB[0], b=MNIST_AB[1])
        h = mx.npx.pallas_squared_relu(self.hidden(self.features(x)))
        return self.output(h)


class _TExtLeNet(gluon.HybridBlock):
    """The same block on the port."""

    def __init__(self):
        super().__init__()
        kw = dict(device="cpu")
        self.features = tnn.HybridSequential().add(
            tnn.Conv2D(20, 5, activation="tanh", in_channels=1, **kw),
            tnn.MaxPool2D(2, 2),
            tnn.Conv2D(50, 5, activation="tanh", in_channels=20, **kw),
            tnn.MaxPool2D(2, 2), tnn.Flatten())
        self.hidden = tnn.Dense(500, in_units=800, **kw)
        self.output = tnn.Dense(10, in_units=500, **kw)

    def forward(self, x):
        x = tmx.npx.pallas_axpb(x, a=MNIST_AB[0], b=MNIST_AB[1])
        h = tmx.npx.pallas_squared_relu(self.hidden(self.features(x)))
        return self.output(h)


def test_extension_block_matches_jax():
    if not hasattr(tmx.npx, "pallas_squared_relu"):
        library.load(os.path.join(REPO, "example", "extensions",
                                  "torch_ops.py"))
    with jax_pallas_ops():
        _extension_block_matches_jax()


def _extension_block_matches_jax():
    xs, ys = _mnist(48, 9)
    jnet, tnet = _JExtLeNet(), _TExtLeNet()
    _carry(jnet, tnet, xs[:1])
    jnet.hybridize()
    tnet.hybridize()
    jl, tl, _ = _train_both(jnet, tnet, "sgd",
                            {"learning_rate": 0.01, "momentum": 0.9},
                            xs, ys, 3, 16)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    _params_close(jnet, tnet, 1e-4)


# ------------------------------------- BatchNorm trains under record()
def test_batchnorm_and_dropout_train_under_record_in_both_packages():
    """The repaired fault: BatchNorm (and Dropout, rate 0) decide from
    ``autograd.is_training()``, so three steps under ``record()`` run
    BatchNorm in training mode in both packages."""
    rs = np.random.RandomState(2)
    x = rs.rand(24, 6).astype("f4") * 2 + 1     # mean far from 0
    y = rs.randint(0, 4, 24).astype("i4")
    jnet = mx.gluon.nn.HybridSequential()
    jnet.add(mx.gluon.nn.Dense(8, in_units=6), mx.gluon.nn.BatchNorm(),
             mx.gluon.nn.Dropout(0.0), mx.gluon.nn.Dense(4, in_units=8))
    tnet = tnn.HybridSequential().add(
        tnn.Dense(8, in_units=6, device="cpu"),
        tnn.BatchNorm(axis=1, in_channels=8, device="cpu"),
        tnn.Dropout(0.0), tnn.Dense(4, in_units=8, device="cpu"))
    jnet.initialize(mx.init.Xavier())
    jnet(mx.np.array(x[:2]))
    params = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    convert.load_into(tnet, params)
    jl, tl = [], []
    jtr = mx.gluon.Trainer(jnet.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9})
    ttr = gluon.Trainer(tnet.collect_params(), "sgd",
                        {"learning_rate": 0.1, "momentum": 0.9})
    for i in range(3):
        b = slice(8 * i, 8 * i + 8)
        with mx.autograd.record():
            jloss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
                jnet(mx.np.array(x[b])), mx.np.array(y[b]))
        jloss.backward()
        jtr.step(8)
        with autograd.record():
            tloss = SoftmaxCrossEntropyLoss()(tnet(torch.from_numpy(x[b])),
                                              torch.from_numpy(y[b]))
        autograd.backward(tloss)
        ttr.step(8)
        jl.append(float(jloss.asnumpy().mean()))
        tl.append(float(tloss.detach().mean()))
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    state = tnet.state_dict()
    for name, p in jnet.collect_params().items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(state[name].numpy(), p.data().asnumpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
    assert state["1.running_mean"].abs().min() > 0  # trained: stats moved
    assert not torch.equal(state["1.running_var"], torch.ones(8))
    before = state["1.running_mean"].clone()
    tnet(torch.from_numpy(x[:8]))               # outside record(): inference
    assert torch.equal(state["1.running_mean"], before)


# ---------------------------------------- multi_precision master weights
def test_multi_precision_keeps_an_f32_master_as_jax_does():
    """A ``.half()`` Dense under ``Trainer("sgd", lr 1e-4,
    multi_precision=True)`` with gradient 1e-3: each update (1e-7) rounds
    away in f16 but not in the f32 master that both packages keep, update
    and write back.  Over 20 steps the f16 weights move, bit for bit as
    JAX's do, and the masters match JAX's."""
    rs = np.random.RandomState(5)
    w = ((rs.rand(3, 4) - 0.5) * 4e-3).astype("f2")
    b = ((rs.rand(3) - 0.5) * 4e-3).astype("f2")
    jd = mx.gluon.nn.Dense(3, in_units=4)
    jd.initialize()
    jd.cast("float16")
    jd.weight.set_data(w)
    jd.bias.set_data(b)
    td = tnn.Dense(3, in_units=4, device="cpu").half()
    with torch.no_grad():
        td.weight.copy_(torch.from_numpy(w))
        td.bias.copy_(torch.from_numpy(b))
    opt = {"learning_rate": 1e-4, "multi_precision": True}
    jtr = mx.gluon.Trainer(jd.collect_params(), "sgd", dict(opt))
    ttr = gluon.Trainer(td.collect_params(), "sgd", dict(opt))
    for p in jd.collect_params().values():
        p.grad()._set_data(mx.np.full(p.shape, 1e-3, "float16")._data)
    for p in td.parameters():
        p.grad = torch.full_like(p, 1e-3)
    names = sorted(td.collect_params())
    for _ in range(20):
        jtr.step(1)
        ttr.step(1)
        for n in names:
            np.testing.assert_array_equal(
                td.collect_params()[n].detach().numpy(),
                jd.collect_params()[n].data().asnumpy(), err_msg=n)
    assert td.weight.dtype == torch.float16
    assert not np.array_equal(td.weight.detach().numpy(), w)   # moved
    jstates, tstates = jtr._updaters[0].states, ttr._updater.states
    assert sorted(jstates) == sorted(tstates) == [0, 1]
    for i in tstates:
        master, inner = tstates[i]
        assert master.dtype == torch.float32 and inner is None
        np.testing.assert_allclose(master.numpy(),
                                   jstates[i][0].asnumpy(), rtol=1e-6,
                                   atol=0)


# ------------------------------------------- Dense's reference signature
def test_dense_takes_the_reference_signature():
    """``Dense(units, activation=None, use_bias=True, flatten=True, ...,
    in_units=0)`` as the reference orders it: ``Dense(10, "relu")`` right
    after a convolution, with no ``Flatten``, matches JAX; ``flatten=False``
    keeps the leading axes; ``in_units=0`` (the default) defers the
    weight until the first input gives its width."""
    x = np.random.RandomState(3).rand(4, 2, 8, 8).astype("f4") - 0.5
    jnet = mx.gluon.nn.HybridSequential()
    jnet.add(mx.gluon.nn.Conv2D(3, 3, in_channels=2),
             mx.gluon.nn.Dense(10, "relu", in_units=3 * 6 * 6),
             mx.gluon.nn.Dense(5, in_units=10))
    tnet = tnn.HybridSequential().add(
        tnn.Conv2D(3, 3, in_channels=2, device="cpu"),
        tnn.Dense(10, "relu", in_units=3 * 6 * 6, device="cpu"),
        tnn.Dense(5, in_units=10, device="cpu"))
    mx.random.seed(0)
    jnet.initialize(mx.init.Xavier())
    want = jnet(mx.np.array(x)).asnumpy()
    convert.load_into(tnet, {n: p.data().asnumpy()
                             for n, p in jnet.collect_params().items()})
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
        hidden = tnet[1](tnet[0](torch.from_numpy(x)))
    assert got.shape == want.shape == (4, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert hidden.shape == (4, 10) and (hidden >= 0).all()
    keep = tnn.Dense(7, flatten=False, in_units=6, use_bias=False,
                     device="cpu")
    assert keep.bias is None and keep(torch.ones(2, 3, 6)).shape == (2, 3, 7)
    late = tnn.Dense(10, "relu", device="cpu").initialize(tmx.init.Xavier())
    assert is_deferred(late.weight) and tuple(late.bias.shape) == (10,)
    assert late(torch.from_numpy(x)).shape == (4, 10)
    assert tuple(late.weight.shape) == (10, 2 * 8 * 8)


def test_embedding_casts_float_ids_as_jax_does():
    """Float ids gather the rows the JAX package's ``Embedding`` gathers
    (it takes ``indices.astype(int32)``); ``dtype`` is the third
    positional, as in the reference."""
    ids = np.array([[1, 2, 3], [0, 4, 1]], "f4")
    jemb = mx.gluon.nn.Embedding(5, 3)
    jemb.initialize(mx.init.Xavier())
    want = jemb(mx.np.array(ids)).asnumpy()
    temb = tnn.Embedding(5, 3, torch.float32, device="cpu")
    convert.load_into(temb, {n: p.data().asnumpy()
                             for n, p in jemb.collect_params().items()})
    for dt in (torch.float32, torch.float64, torch.int64):
        got = temb(torch.from_numpy(ids).to(dt))
        np.testing.assert_array_equal(got.detach().numpy(), want)
    assert tnn.Embedding(5, 3, torch.bfloat16,
                         device="cpu").weight.dtype == torch.bfloat16
    # sparse_grad=True takes a dense gradient of the JAX values (ROADMAP
    # C; tests/test_torch_gluon_layers.py holds it to the JAX layer)
    sparse = tnn.Embedding(5, 3, sparse_grad=True, device="cpu")
    convert.load_into(sparse, {n: p.data().asnumpy()
                               for n, p in jemb.collect_params().items()})
    np.testing.assert_array_equal(
        sparse(torch.from_numpy(ids)).detach().numpy(), want)


@pytest.mark.parametrize("center,scale", [(True, True), (False, True),
                                          (True, False), (False, False)])
def test_layer_norm_takes_the_reference_signature(center, scale):
    """``LayerNorm(axis=-1, epsilon=1e-5, center=True, scale=True,
    beta_initializer, gamma_initializer, in_channels=0)`` as the reference
    orders it: outputs within 1e-5 of the JAX layer's, beta / gamma fixed
    (no gradient) when ``center`` / ``scale`` is False; ``axis=0``
    normalizes over axis 0 and ``in_channels=0`` defers the width to the
    first input."""
    rs = np.random.RandomState(4)
    x = rs.rand(3, 4, 6).astype("f4") - 0.5
    jln = mx.gluon.nn.LayerNorm(-1, 1e-3, center, scale, in_channels=6)
    jln.initialize(mx.init.Xavier())
    for name, p in jln.collect_params().items():
        p.set_data(rs.rand(6).astype("f4") + 0.5)
    want = jln(mx.np.array(x)).asnumpy()
    tln = tnn.LayerNorm(-1, 1e-3, center, scale, in_channels=6,
                        device="cpu")
    convert.load_into(tln, {n: p.data().asnumpy()
                            for n, p in jln.collect_params().items()})
    leaf = torch.from_numpy(x).requires_grad_()
    got = tln(leaf)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    got.sum().backward()
    assert (tln.beta.grad is not None) == center
    assert (tln.gamma.grad is not None) == scale
    assert [p.requires_grad for p in (tln.gamma, tln.beta)] == [scale,
                                                                 center]
    # the initializers go through mx.init's name routing (fault C11):
    # beta 0 and gamma 1 whatever they name, as the JAX layer gives them
    fresh = tnn.LayerNorm(beta_initializer="ones",
                          gamma_initializer="zeros", in_channels=6,
                          device="cpu").initialize(tmx.init.Xavier())
    jfresh = mx.gluon.nn.LayerNorm(beta_initializer="ones",
                                   gamma_initializer="zeros", in_channels=6)
    jfresh.initialize(mx.init.Xavier())
    for name in ("beta", "gamma"):
        np.testing.assert_array_equal(
            getattr(fresh, name).detach().numpy(),
            getattr(jfresh, name).data().asnumpy())
    assert not fresh.beta.detach().any()
    assert torch.equal(fresh.gamma.detach(), torch.ones(6))
    jfirst = mx.gluon.nn.LayerNorm(axis=0, center=center, scale=scale)
    jfirst.initialize(mx.init.Xavier())
    first = tnn.LayerNorm(axis=0, center=center, scale=scale, device="cpu")
    first.initialize(tmx.init.Xavier())
    x0 = x.reshape(3, 24)
    np.testing.assert_allclose(
        first(torch.from_numpy(x0)).detach().numpy(),
        jfirst(mx.np.array(x0)).asnumpy(), rtol=1e-5, atol=1e-5)
    assert tuple(first.gamma.shape) == (3,)
    assert is_deferred(tnn.LayerNorm(device="cpu").gamma)


def test_softmax_ce_picks_the_label_along_a_non_last_axis():
    """``SoftmaxCrossEntropyLoss(axis=1)`` with sparse labels picks each
    label's log-probability along ``axis``, against a numpy log-softmax
    pick.  A deliberate difference: the JAX package raises here (its
    ``take_along_axis`` pick squeezes the wrong axis)."""
    rs = np.random.RandomState(9)
    pred = rs.randn(2, 5, 3).astype("f4")
    label = rs.randint(0, 5, (2, 3)).astype("i4")
    got = SoftmaxCrossEntropyLoss(axis=1)(torch.from_numpy(pred),
                                          torch.from_numpy(label))
    p64 = pred.astype("f8")
    logp = p64 - np.log(np.exp(p64 - p64.max(1, keepdims=True)).sum(
        1, keepdims=True)) - p64.max(1, keepdims=True)
    pick = -np.take_along_axis(logp, label[:, None, :], axis=1)[:, 0, :]
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), pick.mean(1), rtol=1e-6,
                               atol=1e-6)
    from mxnet_tpu.gluon import loss as jloss
    with pytest.raises(Exception):
        jloss.SoftmaxCrossEntropyLoss(axis=1)(mx.np.array(pred),
                                              mx.np.array(label))


def _c10_pairs():
    """(port layer, JAX layer) built with the reference's positions, the
    initializer arguments among them (fault C10)."""
    f32 = torch.float32
    return {
        "BatchNorm": (
            tnn.BatchNorm(1, 0.9, 1e-5, True, True, False, "zeros", "ones",
                          "zeros", "ones", 4, device="cpu"),
            mx.gluon.nn.BatchNorm(1, 0.9, 1e-5, True, True, False, "zeros",
                                  "ones", "zeros", "ones", 4)),
        "Dense": (
            tnn.Dense(5, "relu", True, True, f32, None, "zeros", 6,
                      device="cpu"),
            mx.gluon.nn.Dense(5, "relu", True, True, np.float32, None,
                              "zeros", 6)),
        "Conv2D": (
            tnn.Conv2D(3, 3, (1, 1), (1, 1), (1, 1), 1, "NCHW", "tanh", True,
                       None, "zeros", 4, device="cpu"),
            mx.gluon.nn.Conv2D(3, 3, (1, 1), (1, 1), (1, 1), 1, "NCHW",
                               "tanh", True, None, "zeros", 4)),
        "MaxPool2D": (tnn.MaxPool2D(2, 2, 0, "NCHW", False),
                      mx.gluon.nn.MaxPool2D(2, 2, 0, "NCHW", False)),
        "Dropout": (tnn.Dropout(0.3, ()), mx.gluon.nn.Dropout(0.3, ())),
    }


@pytest.mark.parametrize("name", ["BatchNorm", "Dense", "Conv2D",
                                  "MaxPool2D", "Dropout"])
def test_layers_take_the_reference_arguments(name):
    """Fault C10: ``BatchNorm``'s four initializers before
    ``in_channels``, ``Dense``'s and ``Conv2D``'s weight / bias
    initializers before ``in_units`` / ``in_channels``, ``MaxPool2D``'s
    ``ceil_mode`` and ``Dropout``'s ``axes``, by position and by keyword:
    the same parameters and outputs as the JAX layer (inference)."""
    tl, jl = _c10_pairs()[name]
    x = np.random.RandomState(6).rand(2, 4, 6, 6).astype("f4") - 0.5
    if name == "Dense":
        x = x.reshape(2, 4 * 6 * 6)[:, :6]
    jl.initialize(mx.init.Xavier())
    want = jl(mx.np.array(x)).asnumpy()
    params = {n: p.data().asnumpy() for n, p in jl.collect_params().items()}
    if params:
        convert.load_into(tl, params)
    with torch.no_grad():
        got = tl(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the keywords, as the reference spells them
    kw = {"BatchNorm": lambda: tnn.BatchNorm(
              beta_initializer="zeros", gamma_initializer="ones",
              running_mean_initializer="zeros",
              running_variance_initializer="ones", in_channels=4,
              device="cpu"),
          "Dense": lambda: tnn.Dense(10, weight_initializer=None,
                                     bias_initializer="zeros", in_units=3,
                                     device="cpu"),
          "Conv2D": lambda: tnn.Conv2D(3, 3, weight_initializer=None,
                                       bias_initializer="zeros",
                                       in_channels=2, device="cpu"),
          "MaxPool2D": lambda: tnn.MaxPool2D(ceil_mode=False),
          "Dropout": lambda: tnn.Dropout(0.1, axes=())}[name]
    kw()


def test_max_pool_ceil_mode_raises_naming_a6():
    """``ceil_mode=True`` is ported (the JAX "full" convention, held to
    the JAX layer here and in tests/test_torch_gluon_layers.py); a pool
    of another rank still raises naming A6."""
    x = np.random.RandomState(7).rand(2, 3, 7, 7).astype("f4")
    want = mx.gluon.nn.MaxPool2D(2, 2, ceil_mode=True)(
        mx.np.array(x)).asnumpy()
    got = tnn.MaxPool2D(2, 2, ceil_mode=True)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 3, 4, 4)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(MXNetError, match="A6"):
        tmx.npx.pooling(torch.zeros(1, 2, 4, 4, 4), kernel=2)


def test_dropout_axes_shares_its_mask_as_jax_does():
    """``Dropout(rate, axes=(1,))``: one draw keeps or drops a whole
    slice along axis 1 (size 1 there, broadcast), kept values ``x /
    keep``; the kept share is the rate's, as the JAX ``dropout`` gives."""
    x = torch.ones(64, 6, 256)
    tmx.random.seed(0)
    with autograd.record():
        y = tnn.Dropout(0.25, axes=(1,))(x)
    jy = mx.gluon.nn.Dropout(0.25, axes=(1,))
    with mx.autograd.record():
        jout = jy(mx.np.ones((64, 6, 256))).asnumpy()
    for out in (y.numpy(), jout):
        assert (out == out[:, :1, :]).all()
        assert set(np.unique(out)) <= {0.0, np.float32(1 / 0.75)}
        share = (out[:, 0, :] != 0).mean()
        assert abs(share - 0.75) < 0.02
    assert torch.equal(tnn.Dropout(0.25, axes=(1,))(x), x)   # inference


def test_layer_initializers_route_by_name_as_jax_does():
    """Fault C11: ``LayerNorm(beta_initializer="ones")`` gets beta 0,
    ``Dense(bias_initializer="ones")`` a zero bias and
    ``BatchNorm(gamma_initializer="zeros")`` gamma 1, as the JAX
    package's name routing gives them."""
    pairs = [
        (tnn.LayerNorm(beta_initializer="ones", in_channels=4, device="cpu"),
         mx.gluon.nn.LayerNorm(beta_initializer="ones", in_channels=4)),
        (tnn.Dense(3, bias_initializer="ones", in_units=2, device="cpu"),
         mx.gluon.nn.Dense(3, bias_initializer="ones", in_units=2)),
        (tnn.BatchNorm(gamma_initializer="zeros", in_channels=4,
                       device="cpu"),
         mx.gluon.nn.BatchNorm(gamma_initializer="zeros", in_channels=4)),
    ]
    for tl, jl in pairs:
        tl.initialize(tmx.init.Xavier())
        jl.initialize(mx.init.Xavier())
        for n, p in jl.collect_params().items():
            if n.endswith(("bias", "beta", "gamma", "running_mean",
                           "running_var")):
                got = getattr(tl, n).detach().numpy()
                np.testing.assert_array_equal(got, p.data().asnumpy(), n)
    assert not pairs[0][0].beta.detach().any()
    assert not pairs[1][0].bias.detach().any()
    assert torch.equal(pairs[2][0].gamma.detach(), torch.ones(4))


# ----------------------------------------------------- Trainer surface
def test_trainer_orders_parameters_sorted_and_skips_null():
    net = xavier_init(get_model("lenet", device="cpu"), 0)
    params = net.collect_params()
    tr = gluon.Trainer(params, "sgd", {"learning_rate": 0.1})
    assert [id(p) for p in tr._params] == [id(params[k])
                                          for k in sorted(params)]
    net.output.bias.lr_mult = 0.0               # read through param_dict
    params["features.0.weight"].grad_req = "ignored"   # a plain attribute
    gluon.parameter.set_grad_req(net.features[0].weight, "null")
    frozen = net.features[0].weight.detach().clone()
    bias = net.output.bias.detach().clone()
    with autograd.record():
        loss = net(torch.rand(2, 1, 28, 28)).sum()
    autograd.backward(loss)
    telemetry.reset()
    tr.step(2)
    assert torch.equal(net.features[0].weight.detach(), frozen)
    assert torch.equal(net.output.bias.detach(), bias)
    assert not torch.equal(net.output.weight.grad,
                           torch.zeros_like(net.output.weight))
    assert telemetry.snapshot()["trainer.step_seconds"]["count"] == 1
    tr.zero_grad()
    assert not net.output.weight.grad.any()
    tr.set_learning_rate(0.5)
    assert tr.learning_rate == 0.5 and tr.optimizer.lr == 0.5
    tr.drain()


def test_trainer_refuses_what_one_device_does_not_port():
    net = get_model("lenet", device="cpu")
    # a dist store is ported (ROADMAP A6a); an unknown one still raises
    dist_tr = gluon.Trainer(net.collect_params(), "sgd", kvstore="dist_sync")
    dist_tr.allreduce_grads()                   # one process: a no-op
    with pytest.raises(MXNetError, match="unknown kvstore"):
        gluon.Trainer(net.collect_params(), "sgd",
                      kvstore="no_such_store").allreduce_grads()
    with pytest.raises(MXNetError, match="Parameters"):
        gluon.Trainer([torch.zeros(2)], "sgd")
    tr = gluon.Trainer(net.collect_params(), "sgd")
    tr.allreduce_grads()                        # one device: a no-op
