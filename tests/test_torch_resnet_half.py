"""The port's 16-bit batch norm and 16-bit ResNet training against the
JAX package's, on the CPU.

The same seeded numpy inputs go through ``mxnet_tpu`` (the Pallas
``bn_act`` kernels in interpret mode, its jitted ``batch_norm_train``,
its ``ShardedTrainer(compute_dtype=...)`` under
``kernels.registry.override("interpret")``) and through the port (the
kernels' plain versions, since the tensors lie on the CPU).

Tolerances, each with what was measured:

* y of the fused op: equal, or 1 ulp of x's type where the statistics'
  summation order (the port sums in float64, the TPU kernel in f32)
  moves a rounded scale or shift; at most 1% of the elements, or one
  (measured 0 on these inputs, bf16 and f16).  The composed ops' ``out``
  and the blended running statistics in a 16-bit buffer, against the
  JAX ops under ``jit`` as its trainer runs them (op by op, XLA rounds
  the bf16 blend's product where the jitted program does not): the same
  bar (measured 0).
* mean and var within 1e-5 relative (f32 statistics in another order).
* gradients within 2^-6 (bf16) / 2^-9 (f16) x max|g| (the backward in
  f32 in both, dx rounded to x's type).
* A tiny ResNet (``TINY``, bottleneck [1, 1]), both BN variants, three
  sgd-momentum steps: the loss within 2e-2 relative in bf16 and 1e-2 in
  f16 (measured within 3e-3 and 3e-5); after the first step (zero
  momentum, so each parameter moved by lr x g of JAX's gradient g) every
  parameter within 2^-4 x lr x max|g|, in f16 max|g| of the parameter's
  own gradient (measured 2^-6.1 and 2^-6.8), in bf16 the network's
  max|g| (measured 2^-4.4 and 2^-5.3).  A bf16 bias of the last stage
  lies 2^-1.8 of its own max|g| apart: there the gradient is a sum that
  nearly cancels, and each package's bf16 gradient lies 16-45% of its
  max from its own f32 gradient of the same step.  After three steps
  the running statistics within 2^-4 x max|stat| (measured 7e-3 and
  below), stored as f32; the f16 loss scale and skip sequence equal to
  JAX's.
"""
from __future__ import annotations

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.kernels import bn_act as jbn
from mxnet_tpu.kernels import registry as jkreg
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.parallel.mesh import make_mesh
from mxnet_tpu.parallel.trainer import ShardedTrainer as JTrainer
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.kernels import bn_act as tbn
from mxnet_tpu_torch.kernels import registry as tkreg
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.parallel import ShardedTrainer

from test_torch_resnet import _jax_ce, _tiny_twins, _twin

DTYPES = [(jnp.bfloat16, torch.bfloat16), (jnp.float16, torch.float16)]
IDS = ["bf16", "f16"]
GRAD_TOL = {torch.bfloat16: 2.0 ** -6, torch.float16: 2.0 ** -9}
LOSS_RTOL = {torch.bfloat16: 2e-2, torch.float16: 1e-2}
ULP_SHARE = 0.01     # elements allowed 1 ulp apart (module docstring)


def _inputs(shape, seed, offset=0.0):
    rs = np.random.RandomState(seed)
    c = shape[-1]
    x = (rs.rand(*shape) * 4 - 2 + offset).astype("f4")
    gamma = (rs.rand(c) + 0.5).astype("f4")
    beta = (rs.rand(c) - 0.5).astype("f4")
    return x, gamma, beta


def _pair(a, jdt, tdt):
    """``a`` (f32 numpy) rounded to the 16-bit type: the JAX array and
    the torch tensor of the same values."""
    j = jnp.asarray(a).astype(jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _np(a):
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _ulps(got, want, tdt):
    """How far apart two 16-bit arrays are in ulps of ``tdt``, per
    element (the integer distance of their bit patterns, same sign)."""
    g = torch.from_numpy(np.ascontiguousarray(got)).to(tdt).view(torch.int16)
    w = torch.from_numpy(np.ascontiguousarray(want)).to(tdt).view(torch.int16)
    return (g.int() - w.int()).abs()


def _assert_16bit_close(got, want, tdt, what):
    """Equal, or 1 ulp apart in at most ULP_SHARE of the elements."""
    d = _ulps(_np(got), _np(want), tdt)
    assert int(d.max()) <= 1, f"{what}: {int(d.max())} ulps"
    assert int((d > 0).sum()) <= max(1, ULP_SHARE * d.numel()), \
        f"{what}: {int((d > 0).sum())} of {d.numel()} elements 1 ulp apart"


# ------------------------------------------------- the fused op (kernels)
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=IDS)
@pytest.mark.parametrize("act", ["relu", "identity"])
@pytest.mark.parametrize("shape,offset", [((4, 4, 4, 16), 0.0),
                                          ((8, 2, 2, 12), -1.5),
                                          ((2, 8, 8, 24), 3.0)])
def test_16bit_plain_kernels_match_interpret_kernel(jdt, tdt, act, shape,
                                                    offset):
    """bn_stats_plain + bn_apply_plain in bf16 / f16 against the TPU
    kernels' interpret mode (``bn_act_train``), y, statistics and the
    gradients of x, gamma and beta."""
    x, gamma, beta = _inputs(shape, seed=shape[-1], offset=offset)
    (jx, tx), (jg, tg), (jb, tb) = (_pair(a, jdt, tdt)
                                    for a in (x, gamma, beta))
    w = np.random.RandomState(1).rand(*shape).astype("f4") - 0.5
    jw, tw = _pair(w, jdt, tdt)

    def jloss(x, g, b):
        y, _, _ = jbn.bn_act_train(x, g, b, 1e-5, act, True)
        return (y.astype(jnp.float32) * jw.astype(jnp.float32)).sum()

    y, mean, var = jbn.bn_act_train(jx, jg, jb, 1e-5, act, True)
    want = jax.grad(jloss, (0, 1, 2))(jx, jg, jb)
    leaves = [t.clone().requires_grad_() for t in (tx, tg, tb)]
    ty, tmean, tvar = tbn.bn_act_train(*leaves, 1e-5, act)
    assert ty.dtype == tdt and tmean.dtype == tvar.dtype == torch.float32
    _assert_16bit_close(ty, y, tdt, "y")
    for a, b in ((tmean, mean), (tvar, var)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)
    (ty.float() * tw.float()).sum().backward()
    for leaf, ref, name in zip(leaves, want, ("x", "gamma", "beta")):
        assert leaf.grad.dtype == tdt, name
        top = np.abs(_np(ref)).max()
        np.testing.assert_allclose(_np(leaf.grad), _np(ref), rtol=0,
                                   atol=GRAD_TOL[tdt] * top, err_msg=name)


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=IDS)
def test_16bit_apply_rounds_as_xla_on_the_cpu(jdt, tdt):
    """The apply alone on the same 16-bit x, scale and shift: bit for
    bit with the TPU kernel in interpret mode.  bf16 rounds the product
    and then the sum, f16 the f32 sum once; the other rounding differs
    in thousands of the 12,288 outputs."""
    rs = np.random.RandomState(5)
    x = (rs.randn(512, 24) * 3).astype("f4")
    scale = (rs.rand(24) * 2 + 0.1).astype("f4")
    shift = (rs.randn(24)).astype("f4")
    (jx, tx), (js, ts), (jh, th) = (_pair(a, jdt, tdt)
                                    for a in (x, scale, shift))
    want = _np(jbn._apply_pallas(jx, js, jh, "identity", 128, True))
    got = tbn.bn_apply_plain(tx, ts, th, "identity")
    assert got.dtype == tdt
    np.testing.assert_array_equal(_np(got), want)
    other = (tx.float() * ts.float() + th.float()).to(tdt) \
        if tdt == torch.bfloat16 else tx * ts + th
    assert int((_np(other) != want).sum()) > 1000


def test_16bit_f16_apply_overflows_to_inf_as_jax():
    x = np.array([[60000.0, -60000.0, 1.0]], "f4")
    scale = np.array([2.0, 2.0, 1.0], "f4")
    shift = np.zeros(3, "f4")
    jx, tx = _pair(x, jnp.float16, torch.float16)
    (js, ts), (jh, th) = (_pair(a, jnp.float16, torch.float16)
                          for a in (scale, shift))
    want = _np(jbn._apply_pallas(jx, js, jh, "identity", 1, True))
    got = _np(tbn.bn_apply_plain(tx, ts, th, "identity"))
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[0, :2]).all() and got[0, 2] == 1.0


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=IDS)
def test_16bit_stats_fold_rounds_scale_and_shift_as_jax(monkeypatch, jdt,
                                                         tdt):
    """scale and shift in x's type: the f32 fold rounded once, against
    what the TPU path hands its apply kernel."""
    seen = {}
    apply = jbn._apply_pallas

    def spy(x2d, scale, shift, *rest):
        seen["scale"], seen["shift"] = scale, shift
        return apply(x2d, scale, shift, *rest)

    monkeypatch.setattr(jbn, "_apply_pallas", spy)
    x, gamma, beta = _inputs((4, 4, 4, 32), seed=3, offset=0.5)
    (jx, tx), (jg, tg), (jb, tb) = (_pair(a, jdt, tdt)
                                    for a in (x, gamma, beta))
    jbn._bn_act_fwd_impl(jx, jg, jb, 1e-5, "relu", True)
    mean, var, scale, shift = tbn.bn_stats_plain(tx.reshape(-1, 32), tg, tb,
                                                 1e-5)
    assert scale.dtype == shift.dtype == tdt
    assert seen["scale"].dtype == jdt
    _assert_16bit_close(scale, seen["scale"], tdt, "scale")
    _assert_16bit_close(shift, seen["shift"], tdt, "shift")


# ------------------------------------------------ the composed ops (nn)
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=IDS)
@pytest.mark.parametrize("op,shape", [
    ("batch_norm_train", (3, 5, 5, 8)),
    ("batch_norm_act_train", (2, 4, 4, 16)),     # JAX tiles 32 rows
    ("batch_norm_act_train", (1, 3, 3, 8))],     # 9 rows: JAX composes
    ids=["train", "act-tiled", "act-untiled"])
def test_16bit_batch_norm_ops_match_jax(jdt, tdt, op, shape):
    """``out`` in x's type and the new moving statistics blended into
    16-bit buffers (the trainer's cast copies) against the JAX ops."""
    x, gamma, beta = _inputs(shape, seed=11, offset=0.3)
    c = shape[-1]
    rm = np.linspace(-2.5, 2.5, c).astype("f4")
    rv = np.linspace(0.5, 3.0, c).astype("f4")
    pairs = [_pair(a, jdt, tdt) for a in (x, gamma, beta, rm, rv)]
    rows = int(np.prod(shape[:-1]))
    if op == "batch_norm_act_train":          # JAX's kernel or composition
        assert (jbn.pick_row_block(rows) == 0) == (rows == 9)
    with jkreg.override("interpret"), warnings.catch_warnings():
        warnings.simplefilter("ignore")       # JAX: "not tile-able" at 9
        want = jax.jit(lambda *a: getattr(jnn, op)(*a, axis=-1,
                                                   momentum=0.9))(
            *[j for j, _ in pairs])
    got = getattr(tnn, op)(*[t for _, t in pairs], axis=-1, momentum=0.9)
    assert [g.dtype for g in got] == [tdt] * 3
    for g, w, what in zip(got, want, ("out", "moving mean", "moving var")):
        _assert_16bit_close(g, w, tdt, what)


@pytest.mark.parametrize("tdt", [torch.bfloat16, torch.float16], ids=IDS)
def test_16bit_blend_takes_the_momentum_in_the_buffers_type(tdt):
    """The JAX blend's weakly typed momentum is rounded to the buffer's
    type: 0.8984375 for 0.9 in bf16.  Kept at a batch mean of 0, the
    blend is that product alone."""
    moving = torch.tensor([3.0, 5.0, 7.0], dtype=tdt)
    got = tnn._blend(moving, torch.zeros(3), 0.9)
    m = torch.tensor(0.9, dtype=tdt).item()
    want = (moving.float() * m).to(tdt)
    assert torch.equal(got, want)
    if tdt == torch.bfloat16:
        assert m == 0.8984375 and not torch.equal(got, moving * 0.9)


# ------------------------------------------------ ResNet, the trainer
def _trainer_pair(fused, jdt, tdt, **kw):
    jnet, tnet = _tiny_twins(fused)
    _twin(jnet, tnet, (4, 8, 8, 3), seed=9)
    with jkreg.override("interpret"):
        jtr = JTrainer(jnet, _jax_ce,
                       mesh=make_mesh({"dp": -1}, devices=jax.devices()[:1]),
                       optimizer="sgd", learning_rate=0.05, momentum=0.9,
                       fused_opt="arena", compute_dtype=jdt, **kw)
    tr = ShardedTrainer(tnet, lambda p, y: tloss.SoftmaxCELoss()(p.float(),
                                                                 y),
                        optimizer="sgd", learning_rate=0.05, momentum=0.9,
                        compute_dtype=tdt, **kw)
    return jtr, tr, tnet


def _batch():
    rs = np.random.RandomState(0)
    return (rs.rand(8, 8, 8, 3).astype("f4"),
            rs.randint(0, 10, size=(8,)).astype("i4"))


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=IDS)
@pytest.mark.parametrize("fused", [False, True],
                         ids=["BatchNorm", "BatchNormReLU"])
def test_tiny_resnet_16bit_sgd_momentum_matches_jax_trainer(fused, jdt, tdt):
    jtr, tr, tnet = _trainer_pair(fused, jdt, tdt)
    x, y = _batch()
    # the same f32 masters and buffers at the start (convert.load_into)
    state = tnet.state_dict()
    start = {n: state[n].clone() for n in state}
    for name, value in zip(jtr.train_names + jtr.aux_names,
                           list(jtr.pvals) + list(jtr.avals)):
        assert state[name].dtype == torch.float32
        np.testing.assert_array_equal(state[name].numpy(), np.asarray(value))
    with jkreg.override("interpret"):
        want = [(float(jtr.step(x, y, block=True)), jtr.loss_scale,
                 jtr.skipped_steps)]
    tkreg.reset_launches()
    got = [(tr.step(x, y, block=True), tr.loss_scale, tr.skipped_steps)]
    # one step from zero momentum moves each parameter by lr * g
    lr = 0.05
    moved = {n: np.asarray(v) - start[n].numpy()
             for n, v in zip(jtr.train_names, jtr.pvals)}
    g_max = max(np.abs(m).max() for m in moved.values()) / lr
    state = tnet.state_dict()
    for name, value in zip(jtr.train_names, jtr.pvals):
        scale = lr * (g_max if tdt == torch.bfloat16
                      else np.abs(moved[name]).max() / lr)
        np.testing.assert_allclose(state[name].numpy(), np.asarray(value),
                                   rtol=0, atol=2.0 ** -4 * scale,
                                   err_msg=name)
    with jkreg.override("interpret"):
        want += [(float(jtr.step(x, y, block=True)), jtr.loss_scale,
                  jtr.skipped_steps) for _ in range(2)]
    got += [(tr.step(x, y, block=True), tr.loss_scale, tr.skipped_steps)
            for _ in range(2)]
    assert not any(tkreg.launches().values())       # CPU: plain versions
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=LOSS_RTOL[tdt], atol=0)
    assert [g[1:] for g in got] == [w[1:] for w in want]
    assert got[-1][0] < got[0][0]
    state = tnet.state_dict()
    assert sorted(tr.aux_names) == sorted(jtr.aux_names)
    for name, value in zip(jtr.aux_names, jtr.avals):
        value = np.asarray(value)
        assert value.dtype == np.float32
        assert state[name].dtype == torch.float32, name
        assert not torch.equal(state[name], start[name]), name
        np.testing.assert_allclose(state[name].numpy(), value, rtol=0,
                                   atol=2.0 ** -4 * np.abs(value).max(),
                                   err_msg=name)
    assert all(p.dtype == torch.float32 for p in tnet.parameters())


def test_tiny_resnet_f16_skips_as_jax_and_keeps_the_blended_statistics():
    """From a loss scale that overflows, the skip sequence and the scale
    equal JAX's; a skipped step leaves every parameter as it was and
    keeps the running statistics it blended, as the JAX trainer does."""
    jtr, tr, tnet = _trainer_pair(True, jnp.float16, torch.float16,
                                  init_loss_scale=2.0 ** 40)
    x, y = _batch()
    with jkreg.override("interpret"):
        want = []
        for _ in range(4):
            jtr.step(x, y, block=True)
            want.append((jtr.loss_scale, jtr.skipped_steps))
    got = []
    for _ in range(4):
        params = [p.detach().clone() for p in tr.params]
        stats = {n: b.clone() for n, b in tnet.named_buffers()}
        skipped = tr.skipped_steps
        tr.step(x, y, block=True)
        got.append((tr.loss_scale, tr.skipped_steps))
        if tr.skipped_steps > skipped:
            assert all(torch.equal(a, b) for a, b in zip(params, tr.params))
            assert all(not torch.equal(stats[n], b)
                       for n, b in tnet.named_buffers())
    assert got == want
    assert got[0][1] == 1
    state = tnet.state_dict()
    for name, value in zip(jtr.aux_names, jtr.avals):
        value = np.asarray(value)
        np.testing.assert_allclose(state[name].numpy(), value, rtol=0,
                                   atol=2.0 ** -4 * np.abs(value).max(),
                                   err_msg=name)
