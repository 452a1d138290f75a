"""The port's 16-bit training policy and ``amp`` against the JAX package,
on the CPU.

``ShardedTrainer(compute_dtype=...)`` in both packages gets the same
weights and batches (numpy, from a seed); the JAX trainer runs BERT's
attention through its Pallas kernels in interpret mode
(``kreg.override("interpret")``), the port through the kernels' plain
versions.

Tolerances: the tiny BERT's bf16 losses over 3 ``adamw`` steps within
rtol 2e-2 (bf16 forward and backward, rounded at other places in the two
frameworks; measured within 1e-3).  Adam moves every weight by about
+-lr whatever its gradient, so the parameters are compared after one
``sgd`` step: the f32 masters within 2^-4 * lr * max|g| of each
parameter's gradient g.  That is loosened from 2^-6: the worst measured
is 2^-4.71 (``bert.pooler.bias``; ``nsp.weight`` 2^-5.08), and it is the
bf16 noise of this tiny model, not a drift of one package: each
package's bf16 gradient lies 1.1-2.7% of max|g| from the f32 gradient
of the same step, the two 2.5-3.8% from each other.  fp16 with dynamic loss scaling: the scale and
skip sequence equal JAX's exactly, losses within rtol 1e-2 (measured
within 3e-5).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import amp as jamp
from mxnet_tpu.amp import LossScaler as JLossScaler
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu.kernels import registry as jkreg
from mxnet_tpu.parallel.trainer import ShardedTrainer as JTrainer
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.amp import LossScaler
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.nn import Dense
from mxnet_tpu_torch.parallel import ShardedTrainer

from test_torch_trainer import (_data, _jax_ce, _jax_mlp, _jax_pretrain_loss,
                                _mesh1, _pretrain_batch, _torch_mlp,
                                _twin_pretrain)


def _torch_ce(pred, y):
    """``_jax_ce``: cross entropy of the scores cast to f32."""
    return tloss.SoftmaxCELoss()(pred.float(), y)


# ------------------------------------------------------ bf16, tiny BERT
def test_tiny_bert_bf16_adamw_matches_jax():
    jnet, tnet = _twin_pretrain()
    x, y = _pretrain_batch()
    with jkreg.override("interpret"):
        jtr = JTrainer(jnet, _jax_pretrain_loss, mesh=_mesh1(),
                       optimizer="adamw", learning_rate=1e-3,
                       weight_decay=0.01, compute_dtype=jnp.bfloat16)
        want = [float(jtr.step(x, y, block=True)) for _ in range(3)]
    tr = ShardedTrainer(tnet, tbert.pretrain_loss, optimizer="adamw",
                        learning_rate=1e-3, weight_decay=0.01,
                        compute_dtype=torch.bfloat16)
    got = [tr.step(x, y, block=True) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=0)
    assert got[-1] < got[0]
    assert tr.loss_scale == 1.0 and tr.skipped_steps == 0
    assert all(p.dtype == torch.float32 for p in tnet.parameters())


def test_tiny_bert_bf16_sgd_masters_match_jax():
    jnet, tnet = _twin_pretrain()
    before = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    x, y = _pretrain_batch()
    lr = 0.1
    with jkreg.override("interpret"):
        jtr = JTrainer(jnet, _jax_pretrain_loss, mesh=_mesh1(),
                       optimizer="sgd", momentum=0.0, learning_rate=lr,
                       compute_dtype=jnp.bfloat16)
        jtr.step(x, y, block=True)
    tr = ShardedTrainer(tnet, tbert.pretrain_loss, optimizer="sgd",
                        momentum=0.0, learning_rate=lr,
                        compute_dtype=torch.bfloat16)
    tr.step(x, y, block=True)
    jafter = {n: np.asarray(v) for n, v in zip(jtr.train_names, jtr.pvals)}
    tparams = dict(tnet.named_parameters())
    assert sorted(jafter) == sorted(tparams)
    for name, want in jafter.items():
        g = (before[name] - want) / lr          # JAX's f32 gradient
        atol = 2.0 ** -4 * lr * max(float(np.abs(g).max()), 1e-30)
        np.testing.assert_allclose(tparams[name].detach().numpy(), want,
                                   rtol=0, atol=atol, err_msg=name)


# ------------------------------------------- fp16, dynamic loss scaling
def _state_leaves(tr):
    from mxnet_tpu_torch.parallel.trainer import _tensors

    return [t.clone() for t in tr.params + _tensors(tr._adapter.states)]


@pytest.mark.parametrize("opt,kw", [("sgd", {"momentum": 0.9}),
                                    ("adamw", {"weight_decay": 0.01})],
                         ids=["momentum_arena", "adamw_per_parameter"])
def test_fp16_dynamic_loss_scaling_matches_jax(opt, kw):
    net = _jax_mlp()
    params = {n: p.data().asnumpy() for n, p in net.collect_params().items()}
    x, y = _data()
    with jkreg.override("off"):
        jtr = JTrainer(net, _jax_ce, mesh=_mesh1(), optimizer=opt,
                       learning_rate=0.05, compute_dtype=jnp.float16,
                       init_loss_scale=2.0 ** 20, **kw)
        want = []
        for _ in range(6):
            loss = float(jtr.step(x, y, block=True))
            want.append((loss, jtr.loss_scale, jtr.skipped_steps))
    tr = ShardedTrainer(_torch_mlp(params), _torch_ce, optimizer=opt,
                        learning_rate=0.05, compute_dtype=torch.float16,
                        init_loss_scale=2.0 ** 20, **kw)
    assert tr.uses_arena == (opt == "sgd")
    got = []
    for _ in range(6):
        leaves = _state_leaves(tr)
        skipped = tr.skipped_steps
        loss = tr.step(x, y, block=True)
        got.append((loss, tr.loss_scale, tr.skipped_steps))
        if tr.skipped_steps > skipped:       # nothing moved, bit for bit
            for a, b in zip(leaves, _state_leaves(tr)):
                assert torch.equal(a, b)
    assert [g[1:] for g in got] == [w[1:] for w in want]
    assert got[0][2] >= 1 and got[-1][2] < 6    # skipped, then stepped
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=1e-2, atol=0)
    assert got[-1][0] < got[0][0]


def test_fp16_scale_halves_to_one_and_gauges_publish(monkeypatch):
    params = {n: p.data().asnumpy() for n, p in _jax_mlp()
              .collect_params().items()}
    x, y = _data()
    tr = ShardedTrainer(_torch_mlp(params), _torch_ce, optimizer="sgd",
                        learning_rate=0.05, compute_dtype="float16",
                        init_loss_scale=4.0)
    tr._amp_tel_every = 1
    ttel.reset()
    x_bad = x.copy()
    x_bad[0, 0] = np.inf                        # every step overflows
    for _ in range(4):
        tr.step(x_bad, y, block=True)
    assert tr.loss_scale == 1.0 and tr.skipped_steps == 4
    snap = ttel.snapshot()
    assert snap["amp.loss_scale"]["value"] == 1.0
    assert snap["amp.skipped_steps"]["value"] == 4


def test_all_finite_matches_jax():
    from mxnet_tpu.parallel.trainer import all_finite as jall_finite
    from mxnet_tpu_torch.parallel.trainer import all_finite

    big = np.full(4, 3e38, np.float32)           # finite, its sum is not
    for bad in (None, np.nan, np.inf, "big"):
        gs = [np.ones((2, 3), np.float32), np.arange(5, dtype=np.float32)]
        if bad == "big":
            gs.append(big)
        elif bad is not None:
            gs[1][2] = bad
        want = bool(jall_finite([jnp.asarray(g) for g in gs]))
        got = all_finite([torch.from_numpy(g) for g in gs])
        assert got.dtype == torch.bool and bool(got) == want == (bad is None)


def test_loss_scaler_matches_jax_and_round_trips():
    flags = [True, True, False, True, True, True, False, False, True, True]
    t, j = LossScaler(2.0 ** 4, scale_window=2), \
        JLossScaler(2.0 ** 4, scale_window=2)
    for ok in flags:
        tg = [torch.ones(3), torch.tensor([1.0, 2.0 if ok else np.nan])]
        jg = [mx.np.ones((3,)), mx.np.array([1.0, 2.0 if ok else np.nan])]
        assert t.post_backward(tg) == j.post_backward(jg) == (not ok)
        assert t.loss_scale == j.loss_scale
        assert t.skipped_steps == j.skipped_steps
    assert t.state_dict() == j.state_dict()
    r = LossScaler(1.0, scale_factor=4.0, scale_window=99)
    r.load_state_dict(t.state_dict())
    assert r.state_dict() == t.state_dict()
    old = LossScaler(2.0, scale_window=7)
    old.load_state_dict({"loss_scale": 32.0})
    assert old.loss_scale == 32.0 and old._scale_window == 7


# ------------------------------------------------------------------ amp
@pytest.fixture()
def fresh_amp(monkeypatch):
    """Both packages' amp state as before ``init``; put back after."""
    for mod in (tamp, jamp):
        monkeypatch.setattr(mod, "_state", dict(mod._state))
        mod._state.update(initialized=False, loss_scaler=None)
    return tamp, jamp


def test_amp_policy_calls_and_errors_match_jax(fresh_amp):
    with pytest.raises(MXNetError):
        tamp.trainer_kwargs()
    with pytest.raises(JMXNetError):
        jamp.trainer_kwargs()
    with pytest.raises(MXNetError):
        tamp.init_trainer(None)
    with pytest.raises(JMXNetError):
        jamp.init_trainer(None)
    assert tamp.list_bf16_ops() == jamp.list_bf16_ops()
    assert tamp.list_fp32_ops() == jamp.list_fp32_ops()

    net = _jax_mlp()
    params = {n: p.data().asnumpy() for n, p in net.collect_params().items()}
    for name, tdt, jdt in (("bfloat16", torch.bfloat16, jnp.bfloat16),
                           ("float16", torch.float16, jnp.float16)):
        tamp.init(name)
        jamp.init(name)
        assert tamp.trainer_kwargs() == {"compute_dtype": tdt,
                                         "loss_scaling": "auto"}
        assert jamp.trainer_kwargs() == {"compute_dtype": jdt,
                                         "loss_scaling": "auto"}
        with jkreg.override("off"):
            jgood = JTrainer(net, _jax_ce, mesh=_mesh1(),
                             **jamp.trainer_kwargs())
            jplain = JTrainer(net, _jax_ce, mesh=_mesh1())
        tgood = ShardedTrainer(_torch_mlp(params), _torch_ce,
                               **tamp.trainer_kwargs())
        tplain = ShardedTrainer(_torch_mlp(params), _torch_ce)
        tamp.init_trainer(tgood)
        jamp.init_trainer(jgood)
        with pytest.raises(MXNetError, match="compute_dtype"):
            tamp.init_trainer(tplain)
        with pytest.raises(JMXNetError, match="compute_dtype"):
            jamp.init_trainer(jplain)
    # f16 with scaling switched off
    with jkreg.override("off"):
        jbad = JTrainer(net, _jax_ce, mesh=_mesh1(),
                        compute_dtype=jnp.float16, loss_scaling=False)
    tbad = ShardedTrainer(_torch_mlp(params), _torch_ce,
                          compute_dtype=torch.float16, loss_scaling=False)
    with pytest.raises(MXNetError, match="loss scaling"):
        tamp.init_trainer(tbad)
    with pytest.raises(JMXNetError, match="loss scaling"):
        jamp.init_trainer(jbad)
    with pytest.raises(MXNetError, match="A6"):
        tamp.convert_symbol(None)


def test_eager_fp16_step_through_scale_loss_matches_jax(fresh_amp):
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch import gluon as tgluon

    mx.random.seed(0)
    jnet = mx.gluon.nn.Dense(4, in_units=8)
    jnet.initialize(mx.init.Xavier())
    w = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    tnet = convert.load_into(Dense(4, in_units=8, device="cpu"), w)
    jtr = mx.gluon.Trainer(jnet.collect_params(), "sgd",
                           {"learning_rate": 0.1})
    ttr = tgluon.Trainer(tnet.collect_params(), "sgd",
                         {"learning_rate": 0.1})
    tamp.init("float16")
    jamp.init("float16")
    tamp.init_trainer(ttr)
    jamp.init_trainer(jtr)
    ttr._amp_loss_scaler.loss_scale = jtr._amp_loss_scaler.loss_scale = 2.0 ** 8
    x = np.random.RandomState(3).rand(2, 8).astype("f4")
    for blow_up in (False, True):
        k = np.inf if blow_up else 1.0
        with mx.autograd.record():
            jloss = (jnet(mx.np.array(x)) * k).sum()
            with jamp.scale_loss(jloss, jtr) as scaled:
                scaled.backward()
        with autograd.record():
            tloss_ = (tnet(torch.from_numpy(x)) * k).sum()
            with tamp.scale_loss(tloss_, ttr) as scaled:
                scaled.backward()
        for tr, amp in ((jtr, jamp), (ttr, tamp)):
            assert tr._amp_loss_scaler.has_overflow == blow_up
            if not blow_up:                 # the loop skips on overflow
                amp.unscale(tr)
                tr.step(2)
        assert ttr._amp_loss_scaler.state_dict() == \
            jtr._amp_loss_scaler.state_dict()
        for name, p in tnet.collect_params().items():
            np.testing.assert_allclose(
                p.detach().numpy(),
                jnet.collect_params()[name].data().asnumpy(),
                rtol=1e-6, atol=1e-7, err_msg=name)


def test_convert_hybrid_block_keeps_the_jax_f32_parameters(fresh_amp):
    jnet, tnet = _twin_pretrain()
    jamp.convert_hybrid_block(jnet, "bfloat16")
    tamp.convert_hybrid_block(tnet, "bfloat16")
    jkept = sorted(n for n, p in jnet.collect_params().items()
                   if jnp.dtype(p.data()._data.dtype) == jnp.float32)
    tkept = sorted(n for n, p in tnet.named_parameters()
                   if p.dtype == torch.float32)
    assert tkept == jkept and tkept
    assert all(p.dtype in (torch.float32, torch.bfloat16)
               for p in tnet.parameters())
    assert tnet.bert.word_embed.weight.dtype == torch.bfloat16
