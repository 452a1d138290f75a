"""The port's Gluon layers of ROADMAP A6c against the JAX package's, on
the CPU: the normalizations (GroupNorm, InstanceNorm, LayerNorm on any
axis, SyncBatchNorm), the convolutions (Conv2DTranspose, Conv2D with a
deferred width), the pools (AvgPool2D, GlobalMaxPool2D, ``ceil_mode``),
the activations, the shape layers (ReflectionPad2D, PixelShuffle2D,
Identity, the lambdas) and the containers (Sequential, Concatenate,
HybridConcatenate), plus ``Embedding(sparse_grad=True)``.

Each case builds the JAX layer and the port's with the same arguments
(widths left to deferred inference), runs the JAX one once so its
shapes are known, draws every parameter with numpy from a seed, sets it
into both (``convert.load_into`` materializes the port's deferred
tensors) and compares the forward and the input's gradient for a
seeded head gradient, both under ``autograd.record()``.

Tolerance: 1e-5 absolute and relative (f32, another summation order).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu_torch import autograd, convert
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.ops import nn as tops

TOL = 1e-5
CPU = {"device": "cpu"}


def _values(named_shapes, seed):
    """Seeded numpy values: weights uniform in +-sqrt(3 / fan_in),
    gammas and PReLU slopes around 1 / 0.25, running variances in
    [0.5, 1.5]."""
    rs = np.random.RandomState(seed)
    out = {}
    for name, shape in sorted(named_shapes.items()):
        if name.endswith("running_var"):
            v = rs.uniform(0.5, 1.5, size=shape)
        elif name.endswith("gamma"):
            v = 1.0 + rs.uniform(-0.3, 0.3, size=shape)
        elif name.endswith("alpha"):
            v = rs.uniform(0.1, 0.4, size=shape)
        elif len(shape) >= 2:
            bound = np.sqrt(3.0 / np.prod(shape[1:]))
            v = rs.uniform(-bound, bound, size=shape)
        else:
            v = rs.uniform(-0.3, 0.3, size=shape)
        out[name] = v.astype("f4")
    return out


def _match(make, shape, seed=0, scale=1.0, train=True):
    """Build ``make(nn, kw)`` in both packages, carry seeded weights and
    compare outputs and input gradients (module docstring)."""
    rs = np.random.RandomState(seed + 100)
    x = ((rs.rand(*shape) - 0.5) * 2 * scale).astype("f4")
    jblock = make(mx.gluon.nn, {})
    tblock = make(tnn, CPU)
    jparams = jblock.collect_params()
    if jparams:
        jblock.initialize(mx.init.Xavier())
        jblock(mx.np.array(x))
        values = _values({n: p.shape for n, p in jparams.items()}, seed)
        for n, p in jparams.items():
            p.set_data(values[n])
        convert.load_into(tblock, values)
    y0 = jblock(mx.np.array(x))
    head = rs.rand(*y0.shape).astype("f4") - 0.5
    jx = mx.np.array(x)
    jx.attach_grad()
    with mx.autograd.record(train_mode=train):
        jy = jblock(jx)
    jy.backward(mx.np.array(head))
    tx = torch.from_numpy(x).requires_grad_()
    with autograd.record(train_mode=train):
        ty = tblock(tx)
    ty.backward(torch.from_numpy(head))
    assert tuple(ty.shape) == tuple(jy.shape)
    np.testing.assert_allclose(ty.detach().numpy(), jy.asnumpy(), rtol=TOL,
                               atol=TOL, err_msg="forward")
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.asnumpy(), rtol=TOL,
                               atol=TOL, err_msg="input gradient")
    return jblock, tblock


NORMS = {
    "group_norm_2": (lambda nn, kw: nn.GroupNorm(2, **kw), (2, 4, 5, 6)),
    "group_norm_1_eps": (lambda nn, kw: nn.GroupNorm(1, 1e-3, **kw),
                         (3, 6, 4, 4)),
    "group_norm_fixed": (lambda nn, kw: nn.GroupNorm(4, center=False,
                                                     scale=False, **kw),
                         (2, 8, 3, 5)),
    "instance_norm": (lambda nn, kw: nn.InstanceNorm(**kw), (2, 4, 5, 6)),
    "instance_norm_eps": (lambda nn, kw: nn.InstanceNorm(1, 1e-3, **kw),
                          (3, 5, 7)),
    "layer_norm_axis1": (lambda nn, kw: nn.LayerNorm(axis=1, **kw),
                         (2, 4, 5, 6)),
    "layer_norm_axis0": (lambda nn, kw: nn.LayerNorm(axis=0, **kw), (5, 6)),
    "layer_norm_last": (lambda nn, kw: nn.LayerNorm(**kw), (2, 3, 7)),
    "sync_batch_norm": (lambda nn, kw: nn.SyncBatchNorm(
        num_devices=1, momentum=0.8, **kw), (4, 3, 5, 5)),
    "sync_batch_norm_nhwc": (lambda nn, kw: nn.SyncBatchNorm(
        axis=-1, epsilon=1e-3, **kw), (4, 5, 5, 3)),
    "batch_norm_deferred": (lambda nn, kw: nn.BatchNorm(**kw), (4, 3, 5, 5)),
}


@pytest.mark.parametrize("case", sorted(NORMS))
def test_normalization_layers_match_jax(case):
    make, shape = NORMS[case]
    jblock, tblock = _match(make, shape, scale=2.0)
    if "batch_norm" in case:       # the running statistics moved alike
        for name in ("running_mean", "running_var"):
            np.testing.assert_allclose(
                getattr(tblock, name).numpy(),
                getattr(jblock, name).data().asnumpy(), rtol=TOL, atol=TOL)


CONVS = {
    "conv2d_nchw": (lambda nn, kw: nn.Conv2D(6, 3, 2, 1, **kw),
                    (2, 4, 9, 9)),
    "conv2d_nhwc_groups": (lambda nn, kw: nn.Conv2D(
        6, (3, 1), padding=(1, 0), groups=2, layout="NHWC", **kw),
        (2, 7, 5, 4)),
    "conv2d_act_nobias": (lambda nn, kw: nn.Conv2D(
        5, 3, dilation=2, activation="relu", use_bias=False, **kw),
        (2, 3, 9, 8)),
    "transpose_s2_p1_adj1": (lambda nn, kw: nn.Conv2DTranspose(
        5, 3, strides=2, padding=1, output_padding=1, **kw), (2, 4, 5, 6)),
    "transpose_plain": (lambda nn, kw: nn.Conv2DTranspose(3, (2, 3), **kw),
                        (2, 4, 5, 5)),
    "transpose_groups_dilate": (lambda nn, kw: nn.Conv2DTranspose(
        6, 3, strides=(2, 1), padding=(0, 1), dilation=2, groups=2, **kw),
        (2, 4, 4, 5)),
    "transpose_nhwc": (lambda nn, kw: nn.Conv2DTranspose(
        4, 4, strides=2, padding=1, layout="NHWC", activation="tanh", **kw),
        (2, 5, 5, 3)),
    "transpose_adj_past_stride": (lambda nn, kw: nn.Conv2DTranspose(
        3, 2, strides=1, output_padding=(2, 1), use_bias=False, **kw),
        (1, 2, 4, 4)),
}


@pytest.mark.parametrize("case", sorted(CONVS))
def test_convolution_layers_match_jax(case):
    make, shape = CONVS[case]
    _match(make, shape)


POOLS = {
    "avg_3_2_1": (lambda nn, kw: nn.AvgPool2D(3, 2, 1), (2, 3, 8, 9)),
    "avg_ceil": (lambda nn, kw: nn.AvgPool2D(3, 2, 1, ceil_mode=True),
                 (2, 3, 8, 9)),
    "avg_ceil_exclude_pad": (lambda nn, kw: nn.AvgPool2D(
        3, 2, 1, ceil_mode=True, count_include_pad=False), (2, 3, 8, 9)),
    "avg_exclude_pad": (lambda nn, kw: nn.AvgPool2D(
        (3, 2), (1, 2), (1, 0), count_include_pad=False), (2, 3, 7, 6)),
    "avg_nhwc_ceil": (lambda nn, kw: nn.AvgPool2D(
        2, 3, layout="NHWC", ceil_mode=True), (2, 8, 7, 3)),
    "max_ceil": (lambda nn, kw: nn.MaxPool2D(3, 2, ceil_mode=True),
                 (2, 3, 8, 8)),
    "max_ceil_pad_nhwc": (lambda nn, kw: nn.MaxPool2D(
        3, 2, 1, layout="NHWC", ceil_mode=True), (2, 10, 9, 3)),
    "global_max": (lambda nn, kw: nn.GlobalMaxPool2D(), (2, 3, 5, 4)),
    "global_max_nhwc": (lambda nn, kw: nn.GlobalMaxPool2D("NHWC"),
                        (2, 5, 4, 3)),
}


@pytest.mark.parametrize("case", sorted(POOLS))
def test_pooling_layers_match_jax(case):
    make, shape = POOLS[case]
    _match(make, shape)


ACTIVATIONS = {
    "leaky_relu": (lambda nn, kw: nn.LeakyReLU(0.1), (3, 4, 5)),
    "prelu": (lambda nn, kw: nn.PReLU(**kw), (2, 3, 4, 4)),
    "prelu_channels": (lambda nn, kw: nn.PReLU(in_channels=3, **kw),
                       (2, 3, 4, 4)),
    "elu": (lambda nn, kw: nn.ELU(0.7), (3, 4, 5)),
    "selu": (lambda nn, kw: nn.SELU(), (3, 4, 5)),
    "gelu_erf": (lambda nn, kw: nn.GELU(), (3, 4, 5)),
    "gelu_tanh": (lambda nn, kw: nn.GELU("tanh"), (3, 4, 5)),
    "swish": (lambda nn, kw: nn.Swish(1.5), (3, 4, 5)),
    "silu": (lambda nn, kw: nn.SiLU(), (3, 4, 5)),
    "activation_softrelu": (lambda nn, kw: nn.Activation("softrelu"),
                            (3, 4, 5)),
}


@pytest.mark.parametrize("case", sorted(ACTIVATIONS))
def test_activation_layers_match_jax(case):
    make, shape = ACTIVATIONS[case]
    _match(make, shape, scale=3.0)


def _stack(nn, kw, cls):
    s = getattr(nn, cls)()
    s.add(nn.Dense(6, **kw), nn.Activation("relu"), nn.Dense(4, **kw))
    return s


def _identity(nn):
    # a graph to differentiate: the JAX tape has no node for x itself
    s = nn.HybridSequential()
    s.add(nn.Identity(), nn.Activation("tanh"), nn.Identity())
    return s


def _concat(nn, kw, cls):
    c = getattr(nn, cls)(axis=1)
    c.add(nn.Conv2D(3, 1, **kw), nn.Identity(),
          nn.Conv2D(2, 3, padding=1, activation="relu", **kw))
    return c


SHAPES = {
    "reflection_pad": (lambda nn, kw: nn.ReflectionPad2D(2), (2, 3, 5, 6)),
    "reflection_pad_sides": (lambda nn, kw: nn.ReflectionPad2D((1, 2, 0, 3)),
                             (2, 3, 5, 6)),
    "pixel_shuffle": (lambda nn, kw: nn.PixelShuffle2D(2), (2, 8, 3, 4)),
    "pixel_shuffle_rect": (lambda nn, kw: nn.PixelShuffle2D((2, 3)),
                           (2, 12, 3, 2)),
    "identity": (lambda nn, kw: _identity(nn), (2, 3, 4)),
    "flatten": (lambda nn, kw: nn.Flatten(), (2, 3, 4)),
    "hybrid_lambda_name": (lambda nn, kw: nn.HybridLambda("tanh"), (2, 3, 4)),
    "lambda_callable": (lambda nn, kw: nn.Lambda(lambda x: x * 2 + 1),
                        (2, 3, 4)),
    "sequential": (lambda nn, kw: _stack(nn, kw, "Sequential"), (3, 2, 5)),
    "hybrid_sequential": (lambda nn, kw: _stack(nn, kw, "HybridSequential"),
                          (3, 2, 5)),
    "concatenate": (lambda nn, kw: _concat(nn, kw, "Concatenate"),
                    (2, 3, 4, 5)),
    "hybrid_concatenate": (lambda nn, kw: _concat(nn, kw,
                                                  "HybridConcatenate"),
                           (2, 3, 4, 5)),
    "dense_deferred_flatten": (lambda nn, kw: nn.Dense(7, "tanh", **kw),
                               (3, 2, 4, 5)),
    "dense_deferred_keep_axes": (lambda nn, kw: nn.Dense(
        7, flatten=False, **kw), (3, 2, 5)),
}


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_shape_and_container_layers_match_jax(case):
    make, shape = SHAPES[case]
    jblock, tblock = _match(make, shape)
    if "sequential" in case or "concatenate" in case:
        assert sorted(dict(tblock.named_parameters())) == sorted(
            jblock.collect_params())


def test_embedding_sparse_grad_takes_jax_values_densely():
    """``Embedding(sparse_grad=True)``: the JAX layer's gradient is a
    ``RowSparseNDArray`` of the touched rows; the port's is the dense
    gradient of the same values (ROADMAP C)."""
    ids = np.array([[1, 3, 3], [0, 6, 1]], "f4")
    head = np.random.RandomState(1).rand(2, 3, 4).astype("f4")
    jemb = mx.gluon.nn.Embedding(7, 4, sparse_grad=True)
    jemb.initialize(mx.init.Xavier())
    temb = tnn.Embedding(7, 4, sparse_grad=True, **CPU)
    convert.load_into(temb, {"weight": jemb.weight.data().asnumpy()})
    with mx.autograd.record():
        jy = jemb(mx.np.array(ids))
    jy.backward(mx.np.array(head))
    with autograd.record():
        ty = temb(torch.from_numpy(ids))
    ty.backward(torch.from_numpy(head))
    np.testing.assert_array_equal(ty.detach().numpy(), jy.asnumpy())
    assert jemb.weight.grad_stype == "row_sparse"
    dense = jemb.weight.list_grad()[0].asnumpy()
    np.testing.assert_allclose(temb.weight.grad.numpy(), dense, rtol=TOL,
                               atol=TOL)
    assert not temb.weight.grad.is_sparse
    assert set(np.nonzero(dense.any(1))[0]) == {0, 1, 3, 6}


@pytest.mark.parametrize("kw", [
    dict(pool_type="max", pooling_convention="full", pad=1),
    dict(pool_type="avg", pooling_convention="full", count_include_pad=True),
    dict(pool_type="avg", pooling_convention="full",
         count_include_pad=False, pad=1)], ids=["max", "avg", "avg_nopad"])
def test_full_pooling_convention_pads_the_high_edge_as_jax(kw):
    """The op under the layers' ``ceil_mode``: the high edge padded by
    ``pad + stride - 1`` and an avg window's divisor as the JAX op counts
    it (torch's own ``ceil_mode`` clips the last window instead)."""
    from mxnet_tpu.ops import nn as jops

    x = np.random.RandomState(5).rand(2, 3, 7, 10).astype("f4")
    want = np.asarray(jops.pooling(mx.np.array(x)._data, kernel=3, stride=2,
                                   **kw))
    got = tops.pooling(torch.from_numpy(x), kernel=3, stride=2, **kw)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_activation_keeps_its_import_path_and_layers_reexport_blocks():
    from mxnet_tpu_torch.gluon.block import Block, HybridBlock
    from mxnet_tpu_torch.gluon.nn.activations import Activation

    assert tnn.Activation is Activation
    assert tnn.Block is Block and tnn.HybridBlock is HybridBlock
    net = tnn.HybridSequential()
    child = net.register_child(tnn.Dense(3, in_units=2, **CPU), "head")
    assert child is net.head and list(dict(net.named_parameters())) == [
        "head.weight", "head.bias"]


def _public(module):
    """The module's public names: those without a leading underscore,
    less what it imports for its own annotations (``from __future__
    import annotations``, ``typing``)."""
    import __future__
    import typing

    return sorted(n for n in dir(module) if not n.startswith("_")
                  and not isinstance(getattr(module, n), __future__._Feature)
                  and getattr(module, n) is not getattr(typing, n, None))


@pytest.mark.parametrize("path", ["", "gluon", "gluon.nn", "npx"])
def test_every_jax_public_name_is_ported_or_names_its_item(path):
    """Each public name of ``mxnet_tpu{path}`` is in the port's module,
    or reading it raises ``MXNetError`` naming its ROADMAP item
    (``_not_ported``); a name neither package has stays an
    ``AttributeError``."""
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.base import MXNetError

    jmod, tmod = mx, tmx
    for part in filter(None, path.split(".")):
        jmod, tmod = getattr(jmod, part), getattr(tmod, part)
    names = _public(jmod)
    assert len(names) > 15
    missing = []
    for name in names:
        try:
            getattr(tmod, name)
        except MXNetError as e:
            if "ROADMAP" not in str(e):
                missing.append((name, str(e)))
        except AttributeError:
            missing.append((name, "AttributeError"))
    assert not missing, missing
    with pytest.raises(AttributeError):
        getattr(tmod, "no_such_name_in_either_package")


NPX_OPS = {
    "deconvolution": (lambda npx, x, w: npx.deconvolution(
        x, w[0], w[1], stride=2, pad=1, adj=1), (2, 3, 5, 5),
        [(3, 4, 3, 3), (4,)]),
    "deconvolution_nhwc_groups": (lambda npx, x, w: npx.deconvolution(
        x, w[0], None, stride=(1, 2), num_group=2, no_bias=True,
        layout="NHWC"), (2, 5, 4, 4), [(4, 3, 3, 3)]),
    "layer_norm_axis_1": (lambda npx, x, w: npx.layer_norm(
        x, w[0], w[1], axis=1, eps=1e-3), (2, 5, 3), [(5,), (5,)]),
    "group_norm": (lambda npx, x, w: npx.group_norm(
        x, w[0], w[1], num_groups=3), (2, 6, 4, 3), [(6,), (6,)]),
    "instance_norm": (lambda npx, x, w: npx.instance_norm(
        x, w[0], w[1], eps=1e-4), (2, 4, 5, 3), [(4,), (4,)]),
    "leaky_relu_prelu": (lambda npx, x, w: npx.leaky_relu(
        x, w[0], act_type="prelu"), (2, 4, 3, 3), [(4,)]),
    "leaky_relu_elu": (lambda npx, x, w: npx.leaky_relu(
        x, act_type="elu", slope=0.4), (3, 7), []),
    "leaky_relu_gelu": (lambda npx, x, w: npx.leaky_relu(
        x, act_type="gelu"), (3, 7), []),
    "leaky_relu_rrelu_mean": (lambda npx, x, w: npx.leaky_relu(
        x, act_type="rrelu"), (3, 7), []),
}


@pytest.mark.parametrize("case", sorted(NPX_OPS))
def test_npx_operators_of_the_layers_match_jax(case):
    """The ``npx`` operators under the new layers, with the JAX npx
    signatures, on the same seeded inputs (rrelu outside training: the
    mean slope in both packages)."""
    import mxnet_tpu_torch as tmx

    op, shape, wshapes = NPX_OPS[case]
    rs = np.random.RandomState(11)
    x = rs.rand(*shape).astype("f4") - 0.5
    ws = [rs.rand(*s).astype("f4") - 0.25 for s in wshapes]
    want = op(mx.npx, mx.np.array(x), [mx.np.array(w) for w in ws])
    got = op(tmx.npx, torch.from_numpy(x), [torch.from_numpy(w) for w in ws])
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want.asnumpy(), rtol=TOL,
                               atol=TOL)


def test_rrelu_draws_its_slopes_in_training_from_the_seeded_generator():
    """rrelu in training: each negative value takes a slope in
    ``[lower_bound, upper_bound)`` from the port's seeded generator (the
    JAX op from its key: the law, not the draws)."""
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import autograd as tag

    x = -torch.ones(2000)
    runs = []
    for _ in range(2):
        tmx.random.seed(3)
        with tag.train_mode():
            runs.append(tmx.npx.leaky_relu(x, act_type="rrelu",
                                           lower_bound=0.1, upper_bound=0.3))
    assert torch.equal(runs[0], runs[1])
    slopes = -runs[0]
    assert float(slopes.min()) >= 0.1 and float(slopes.max()) < 0.3
    assert abs(float(slopes.mean()) - 0.2) < 0.01
    assert len(torch.unique(slopes)) > 1000
