"""The port's ``autograd`` and ``grad_req`` against the JAX package's, on
the CPU.

Each test runs the same sequence in both packages on the same numpy
inputs from a seed: the scope flags; ``backward`` with and without head
gradients; ``grad``; a custom ``Function``; and the "write" / "add" /
"null" gradient requests of two backwards before one ``gluon.Trainer``
step.  Tolerance 1e-6 (f32 elementwise ops and one small matmul, another
summation order).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.nn import Dense
from mxnet_tpu_torch.gluon.parameter import grad_req, set_grad_req

TOL = 1e-6


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=what)


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else t.asnumpy()


# ------------------------------------------------------------- scopes
def _flag_trace(ag):
    """The flags (recording, training) after each step of one sequence
    of scopes, including their restoration on exit."""
    out = [(ag.is_recording(), ag.is_training())]

    def note():
        out.append((ag.is_recording(), ag.is_training()))

    with ag.record():
        note()
        with ag.pause():
            note()
            with ag.train_mode():
                note()
            note()
        with ag.predict_mode():
            note()
        note()
    note()
    with ag.record(train_mode=False):
        note()
    with ag.pause(train_mode=True):
        note()
    prev = ag.set_training(True)
    out.append(prev)
    note()
    ag.set_training(prev)
    prev = ag.set_recording(True)
    out.append(prev)
    note()
    ag.set_recording(prev)
    note()

    @ag.record()
    def inside():
        return (ag.is_recording(), ag.is_training())

    out.append(inside())
    note()
    return out


def test_scope_flags_follow_the_jax_package():
    assert _flag_trace(autograd) == _flag_trace(mx.autograd)


def test_scopes_set_and_restore_torch_grad_mode():
    assert torch.is_grad_enabled()
    with autograd.record():
        assert torch.is_grad_enabled()
        with autograd.pause():
            assert not torch.is_grad_enabled()
        assert torch.is_grad_enabled()
    with torch.no_grad():
        with autograd.record():
            assert torch.is_grad_enabled()
        assert not torch.is_grad_enabled()
    with autograd.train_mode():                 # flags only
        assert torch.is_grad_enabled()
    assert torch.is_grad_enabled() and not autograd.is_recording()


# ----------------------------------------------------- backward, grad
def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(3, 4).astype("f4") - 0.5, rs.rand(3).astype("f4") + 0.5)


def test_backward_with_and_without_head_grads_matches_jax():
    x, hg = _inputs()
    for head in (hg, None):
        jx = mx.nd.array(x)
        jx.attach_grad()
        with mx.autograd.record():
            jy = (mx.nd.tanh(jx) * jx).sum(axis=1) * 2
        mx.autograd.backward([jy], None if head is None
                             else [mx.nd.array(head)])
        tx = torch.from_numpy(x.copy()).requires_grad_()
        with autograd.record():
            ty = (torch.tanh(tx) * tx).sum(1) * 2
        autograd.backward(ty, None if head is None
                          else torch.from_numpy(head))
        _close(_np(tx.grad), _np(jx.grad), f"head {head}")
    with pytest.raises(MXNetError, match="record"):
        autograd.backward(torch.ones(3))
    with pytest.raises(MXNetError, match="head_grads"):
        autograd.backward([ty], [torch.ones(3), torch.ones(3)])


def test_grad_matches_jax_and_leaves_grad_buffers_alone():
    x, _ = _inputs(1)
    jx = mx.nd.array(x)
    jx.attach_grad()
    with mx.autograd.record():
        jz = mx.nd.tanh(jx) * jx
    want = mx.autograd.grad([jz], [jx])[0]
    tx = torch.from_numpy(x.copy()).requires_grad_()
    tx.grad = torch.full_like(tx, 7.0)
    w = torch.nn.Parameter(torch.ones(3, 4))
    gluon.HybridBlock().collect_params()        # no params: a no-op
    with autograd.record():
        tz = torch.tanh(tx) * tx * w
    got = autograd.grad(tz, tx)
    _close(_np(got), _np(want))
    assert torch.equal(tx.grad, torch.full_like(tx, 7.0))
    assert w.grad is None
    unused = torch.zeros(2, requires_grad=True)
    with autograd.record():
        tz = (tx * 3).sum()
    g_x, g_unused = autograd.grad(tz, [tx, unused])
    assert torch.equal(g_x, torch.full_like(tx, 3.0))
    assert torch.equal(g_unused, torch.zeros(2))


class _JSigmoid(mx.autograd.Function):
    def forward(self, x):
        y = 1 / (1 + mx.nd.exp(-x))
        self.save_for_backward(y)
        return y

    def backward(self, dy):
        y, = self.saved_tensors
        return dy * y * (1 - y)


class _TSigmoid(autograd.Function):
    def forward(self, x):
        y = 1 / (1 + torch.exp(-x))
        self.save_for_backward(y)
        return y

    def backward(self, dy):
        y, = self.saved_tensors
        return dy * y * (1 - y)


def test_custom_function_matches_jax():
    x, hg = _inputs(2)
    jx = mx.nd.array(x)
    jx.attach_grad()
    with mx.autograd.record():
        jy = _JSigmoid()(jx) * 3
    jy.backward()
    tx = torch.from_numpy(x.copy()).requires_grad_()
    with autograd.record():
        ty = _TSigmoid()(tx) * 3
    autograd.backward(ty)
    _close(_np(ty), _np(jy))
    _close(_np(tx.grad), _np(jx.grad))
    out = _TSigmoid()(tx)                       # outside record(): no node
    assert out.grad_fn is None

    class Two(autograd.Function):
        def forward(self, a, b):
            return [a * b, a + b]

        def backward(self, d_prod, d_sum):
            a, b = self.saved_tensors
            return d_prod * b + d_sum, d_prod * a + d_sum

    two = Two()
    a = torch.tensor([2.0], requires_grad=True)
    b = torch.tensor([5.0], requires_grad=True)
    two.save_for_backward(a.detach(), b.detach())
    with autograd.record():
        p, s = two(a, b)
    autograd.backward([p, s])
    assert float(a.grad) == 6.0 and float(b.grad) == 3.0


# --------------------------------------------------------- grad_req
def _twin_dense(seed=4):
    rs = np.random.RandomState(seed)
    w = rs.rand(4, 3).astype("f4") - 0.5
    b = rs.rand(4).astype("f4") - 0.5
    jd = mx.gluon.nn.Dense(4, in_units=3)
    jd.initialize()
    jd.collect_params()["weight"].set_data(w)
    jd.collect_params()["bias"].set_data(b)
    td = Dense(4, in_units=3, device="cpu")
    with torch.no_grad():
        td.weight.copy_(torch.from_numpy(w))
        td.bias.copy_(torch.from_numpy(b))
    return jd, td


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_grad_req_two_backwards_then_one_step_match_jax(req):
    """Two backwards before one ``Trainer.step``: "write" keeps the
    second gradient, "add" their sum, "null" none (and no update); the
    request is the weight's, the bias keeps "write"."""
    rs = np.random.RandomState(5)
    xs = [rs.rand(2, 3).astype("f4") for _ in range(2)]
    jd, td = _twin_dense()
    jd.collect_params()["weight"].grad_req = req
    set_grad_req(td.weight, req)
    jtr = mx.gluon.Trainer(jd.collect_params(), "sgd",
                           {"learning_rate": 0.1})
    ttr = gluon.Trainer(td.collect_params(), "sgd", {"learning_rate": 0.1})
    per_pass = []
    for x in xs:
        with mx.autograd.record():
            jl = (jd(mx.nd.array(x)) ** 2).sum()
        jl.backward()
        with autograd.record():
            tl = (td(torch.from_numpy(x)) ** 2).sum()
        if req != "null":                       # this pass's own gradient
            per_pass.append(autograd.grad(tl, td.weight, retain_graph=True))
        autograd.backward(tl)
    _close(_np(td.bias.grad), _np(jd.collect_params()["bias"].grad()))
    if req == "null":
        assert td.weight.grad is None and not td.weight.requires_grad
    else:
        _close(_np(td.weight.grad), _np(jd.collect_params()["weight"].grad()))
        want = per_pass[1] if req == "write" else per_pass[0] + per_pass[1]
        _close(_np(td.weight.grad), _np(want))
    jtr.step(2)
    ttr.step(2)
    for name in ("weight", "bias"):
        _close(_np(getattr(td, name)),
               jd.collect_params()[name].data().asnumpy(), name)


def test_grad_req_values_and_mark_variables():
    p = torch.nn.Parameter(torch.ones(2))
    assert grad_req(p) == "write"
    with pytest.raises(MXNetError, match="grad_req"):
        set_grad_req(p, "sometimes")
    x = torch.ones(3)
    buf = torch.zeros(3)
    autograd.mark_variables(x, buf)             # "write"
    assert x.requires_grad and x.grad is buf
    for k in (2.0, 5.0):
        with autograd.record():
            y = (x * k).sum()
        autograd.backward(y)
    assert torch.equal(x.grad, torch.full((3,), 5.0))
    assert x.grad.data_ptr() == buf.data_ptr()  # overwritten in place
    jx = mx.nd.ones((3,))
    mx.autograd.mark_variables([jx], [mx.nd.zeros((3,))])
    for k in (2.0, 5.0):
        with mx.autograd.record():
            jy = (jx * k).sum()
        jy.backward()
    _close(_np(x.grad), _np(jx.grad))
