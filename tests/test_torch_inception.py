"""The port's Inception v3 (``get_model("inceptionv3")``) against the
JAX zoo's, on the CPU, at its one input size: 299 x 299 (the tail's
``AvgPool2D(8)`` needs the last map to be 8 x 8, as ``bench.py:713-714``
notes).

Both nets are built with every width deferred, run once so their shapes
are known, and share seeded numpy weights (the port's through
``convert.load_into``, by the JAX names).  The logits are compared in
both layouts at B = 1 outside training (running statistics), and one
``ShardedTrainer`` step (sgd, momentum) at B = 2 against the JAX
trainer's step, as ``tests/test_torch_trainer.py`` holds its trainers.
Dropout's masks come from each package's own generator, so the step is
taken with the dropout layer's rate at 0 in both nets (the one layer of
the net that draws).

Tolerances: logits within 1e-4 (f32 through 94 convolution + BN
layers); the step's loss within 1e-5 relative of the port's float64
forward on the same weights, in both packages (each package's f32 sum
orders move Inception's training loss by about 6e-6 of itself, in
either direction, so the two f32 losses are held to the exact one
rather than to each other).  The same holds after the step: the
backward through 94 train-mode batch norms at B = 2 moves the first
layers' f32 gradients by about 3% in both packages, so the parameters
are held to the float64 step: their largest and their summed distance
from it each within three times the JAX step's (``chip_smoke.py`` phase
38's rule; tensor by tensor the two packages' errors are alike, a median
ratio of 1.07, but either can be the larger).  Every running statistic
is within 1e-5 of the JAX step's.
"""
from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.vision import get_model as jget_model
from mxnet_tpu.kernels import registry as jkreg
from mxnet_tpu.parallel.mesh import make_mesh
from mxnet_tpu.parallel.trainer import ShardedTrainer as JTrainer
from mxnet_tpu_torch import autograd, convert
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.model_zoo import get_model
from mxnet_tpu_torch.gluon.model_zoo.vision import inception_v3
from mxnet_tpu_torch.gluon.parameter import is_deferred
from mxnet_tpu_torch.parallel import ShardedTrainer

SIZE = 299


def _values(named_shapes, seed):
    """Weights uniform in +-sqrt(3 / fan_in), gammas around 1, betas and
    running means small, running variances in [0.5, 1.5]: activations
    stay O(1) through 94 layers."""
    rs = np.random.RandomState(seed)
    out = {}
    for name, shape in sorted(named_shapes.items()):
        if name.endswith("running_var"):
            v = rs.uniform(0.5, 1.5, size=shape)
        elif name.endswith("gamma"):
            v = 1.0 + rs.uniform(-0.2, 0.2, size=shape)
        elif len(shape) >= 2:
            bound = np.sqrt(3.0 / np.prod(shape[1:]))
            v = rs.uniform(-bound, bound, size=shape)
        else:
            v = rs.uniform(-0.1, 0.1, size=shape)
        out[name] = v.astype("f4")
    return out


def _twins(layout, classes=10, seed=0):
    jnet = jget_model("inceptionv3", classes=classes, layout=layout)
    tnet = get_model("inceptionv3", classes=classes, layout=layout,
                     device="cpu")
    shape = (1, 3, SIZE, SIZE) if layout == "NCHW" else (1, SIZE, SIZE, 3)
    jnet.initialize(mx.init.Xavier())
    jnet(mx.np.zeros(shape))
    jparams = jnet.collect_params()
    values = _values({n: p.shape for n, p in jparams.items()}, seed)
    for n, p in jparams.items():
        p.set_data(values[n])
    assert any(is_deferred(p) for p in tnet.parameters())
    convert.load_into(tnet, values)
    assert sorted(values) == sorted(tnet.state_dict())
    return jnet, tnet, shape


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_inception_v3_logits_match_jax(layout):
    jnet, tnet, shape = _twins(layout)
    x = np.random.RandomState(1).rand(*shape).astype("f4")
    want = jnet(mx.np.array(x)).asnumpy()
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 10)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_inception_v3_names_sizes_and_deferred_widths():
    net = inception_v3(layout="NHWC", device="cpu")
    params = dict(net.named_parameters())
    assert len(params) == 284 and len(dict(net.named_buffers())) == 188
    deferred = [n for n, p in params.items() if is_deferred(p)]
    assert deferred == [n for n in params if not n.endswith("output.bias")]
    net.initialize()
    with torch.no_grad():
        net(torch.zeros(1, SIZE, SIZE, 3))
    assert sum(p.numel() for p in net.parameters()) == 23_834_568
    for name, shape in (("features.0.0.weight", (32, 3, 3, 3)),
                        ("features.16.b1a.0.weight", (384, 1, 3, 384)),
                        ("features.7.3.1.1.running_var", (32,)),
                        ("output.weight", (1000, 2048))):
        assert tuple(net.state_dict()[name].shape) == shape, name
    with pytest.raises(MXNetError, match="pretrained"):
        inception_v3(pretrained=True, device="cpu")


def _jax_ce(pred, y):
    logp = jax.nn.log_softmax(pred.astype(jnp.float32))
    return -jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0]


def test_one_sharded_trainer_step_matches_jax():
    jnet, tnet, _ = _twins("NHWC", seed=2)
    for net in (jnet, tnet):                     # module docstring
        net.features[19]._rate = 0.0
    rs = np.random.RandomState(3)
    x = rs.rand(2, SIZE, SIZE, 3).astype("f4")
    y = np.array([3, 7], "i4")
    with jkreg.override("interpret"):
        jtr = JTrainer(jnet, _jax_ce,
                       mesh=make_mesh({"dp": -1}, devices=jax.devices()[:1]),
                       optimizer="sgd", learning_rate=0.05, momentum=0.9,
                       fused_opt="arena")
        want = float(jtr.step(x, y, block=True))
    ref = copy.deepcopy(tnet).cast("float64")
    with autograd.record():
        loss = tloss.SoftmaxCELoss()(ref(torch.from_numpy(x).double()),
                                     torch.from_numpy(y).long()).mean()
    loss.backward()
    loss = loss.item()
    exact = {n: (p - 0.05 * p.grad).detach().numpy()  # sgd's first step
             for n, p in ref.named_parameters()}
    exact.update((n, b.numpy()) for n, b in ref.named_buffers())
    tr = ShardedTrainer(tnet, tloss.SoftmaxCELoss(), optimizer="sgd",
                        learning_rate=0.05, momentum=0.9)
    assert tr.uses_arena
    got = tr.step(x, y, block=True)
    np.testing.assert_allclose(got, loss, rtol=1e-5, atol=0)
    np.testing.assert_allclose(want, loss, rtol=1e-5, atol=0)
    state = tnet.state_dict()
    errs = np.array([[np.abs(state[n].numpy() - exact[n]).max(),
                      np.abs(np.asarray(v) - exact[n]).max(),
                      np.abs(state[n].numpy() - exact[n]).sum(),
                      np.abs(np.asarray(v) - exact[n]).sum()]
                     for n, v in zip(jtr.train_names, jtr.pvals)])
    port_max, jax_max, port_sum, jax_sum = errs[:, :2].max(0).tolist() + \
        errs[:, 2:].sum(0).tolist()
    assert port_max <= max(1e-4, 3 * jax_max), (port_max, jax_max)
    assert port_sum <= 3 * jax_sum, (port_sum, jax_sum)
    for name, value in zip(jtr.aux_names, jtr.avals):
        np.testing.assert_allclose(state[name].numpy(), np.asarray(value),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
