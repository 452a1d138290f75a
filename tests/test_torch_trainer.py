"""The port's ``ShardedTrainer`` against the JAX package's, on the CPU.

Both trainers get the same weights and batches (numpy, from a seed).
The JAX trainer runs on a 1-device mesh with ``fused_opt="arena"`` under
``kreg.override("interpret")``, so its update is the Pallas arena kernel
(and BERT's attention the Pallas flash kernels) in interpret mode, as
``tests/test_kernels.py`` runs them; the port's runs the kernels' plain
versions, since its tensors lie on the CPU.

Tolerances: loss trajectories of sgd / momentum / nag within 1e-5
relative (f32 forward and backward in another summation order, carried
through 8 steps); adam within 1e-4, since Adam divides by sqrt(v) and so
magnifies the last-bit differences of small gradients; the tiny BERT's
parameters after 3 Adam steps within 1e-4 absolute (lr 1e-3: an update
is at most ~1e-3, and a last-bit difference in a tiny gradient can move
its sign).  Each JAX run is kept tiny so the suite stays fast.
"""
from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.bert import BERTForPretrain as JBERTForPretrain
from mxnet_tpu.gluon.model_zoo.bert import get_bert as jax_get_bert
from mxnet_tpu.kernels import registry as jkreg
from mxnet_tpu.parallel.mesh import make_mesh
from mxnet_tpu.parallel.trainer import ShardedTrainer as JTrainer
from mxnet_tpu.parallel.trainer import _ArenaOptAdapter as JArena
from mxnet_tpu_torch import autograd, convert
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.nn import Dense, Dropout
from mxnet_tpu_torch.parallel import ShardedTrainer

from torch_parity import nd_i32, seeded_params


def _mesh1():
    return make_mesh({"dp": -1}, devices=jax.devices()[:1])


# ------------------------------------------------------------- the MLP
def _jax_ce(pred, y):
    logp = jax.nn.log_softmax(pred.astype(jnp.float32))
    return -jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0]


def _jax_mlp():
    """The MLP of ``tests/test_kernels.py``."""
    mx.random.seed(0)
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(32, activation="relu"), mx.gluon.nn.Dense(10))
    net.initialize(mx.init.Xavier())
    net(mx.np.zeros((2, 12)))
    return net


def _torch_mlp(params):
    net = torch.nn.Sequential(Dense(32, "relu", in_units=12, device="cpu"),
                              Dense(10, in_units=32, device="cpu"))
    return convert.load_into(net, params)


def _data(b=16, n=12):
    rs = np.random.RandomState(0)
    return (rs.rand(b, n).astype("f4"),
            rs.randint(0, 10, size=(b,)).astype("i4"))


MLP_CASES = {"sgd": ("sgd", {"momentum": 0.0}, 1e-5),
             "momentum": ("sgd", {"momentum": 0.9}, 1e-5),
             "nag": ("nag", {"momentum": 0.9}, 1e-5),
             "adam": ("adam", {}, 1e-4)}


def _jax_losses(opt, fused_opt, steps=8, **kw):
    net = _jax_mlp()
    params = {n: p.data().asnumpy() for n, p in net.collect_params().items()}
    with jkreg.override("interpret" if fused_opt == "arena" else "off"):
        tr = JTrainer(net, _jax_ce, mesh=_mesh1(), optimizer=opt,
                      learning_rate=0.05, fused_opt=fused_opt, **kw)
        x, y = _data()
        losses = [float(tr.step(x, y, block=True)) for _ in range(steps)]
    return params, tr, losses


@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_mlp_loss_trajectory_matches_jax_arena(case):
    opt, kw, tol = MLP_CASES[case]
    params, jtr, want = _jax_losses(opt, "arena", **kw)
    assert isinstance(jtr._adapter, JArena)
    tr = ShardedTrainer(_torch_mlp(params), tloss.SoftmaxCELoss(),
                        optimizer=opt, learning_rate=0.05, **kw)
    assert tr.uses_arena
    x, y = _data()
    got = [tr.step(x, y, block=True) for _ in range(8)]
    np.testing.assert_allclose(got, want, rtol=tol, atol=0)


def test_adamw_takes_the_per_parameter_adapter_and_matches_jax():
    params, jtr, want = _jax_losses("adamw", None, weight_decay=0.01)
    assert not isinstance(jtr._adapter, JArena)
    tr = ShardedTrainer(_torch_mlp(params), tloss.SoftmaxCELoss(),
                        optimizer="adamw", learning_rate=0.05,
                        weight_decay=0.01)
    assert not tr.uses_arena and "AdamW" in tr.arena_refused
    x, y = _data()
    got = [tr.step(x, y, block=True) for _ in range(8)]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    with pytest.raises(MXNetError, match="arena"):
        ShardedTrainer(_torch_mlp(params), tloss.SoftmaxCELoss(),
                       optimizer="adamw", fused_opt="arena")


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_arena_and_per_parameter_adapters_agree(opt):
    params = {n: p.data().asnumpy()
              for n, p in _jax_mlp().collect_params().items()}
    x, y = _data()
    runs = []
    for fused_opt in (None, "off"):
        tr = ShardedTrainer(_torch_mlp(params), tloss.SoftmaxCELoss(),
                            optimizer=opt, learning_rate=0.05,
                            weight_decay=0.01, fused_opt=fused_opt)
        assert tr.uses_arena == (fused_opt is None)
        runs.append([tr.step(x, y, block=True) for _ in range(5)])
    np.testing.assert_allclose(runs[0], runs[1], rtol=1e-5, atol=0)


def test_grad_views_survive_zero_grad_and_the_net_mode_is_kept():
    params = {n: p.data().asnumpy()
              for n, p in _jax_mlp().collect_params().items()}
    x, y = _data()
    ref = ShardedTrainer(_torch_mlp(params), tloss.SoftmaxCELoss(),
                         optimizer="adam", learning_rate=0.05)
    want = [ref.step(x, y, block=True) for _ in range(4)]
    net = _torch_mlp(params).eval()
    tr = ShardedTrainer(net, tloss.SoftmaxCELoss(), optimizer="adam",
                        learning_rate=0.05)
    got = []
    for _ in range(4):
        net.zero_grad(set_to_none=True)        # drops the arena views
        loss = tr.step(x, y)
        assert torch.is_tensor(loss) and loss.ndim == 0
        got.append(float(loss))
        assert not net.training                # put back in eval mode
    assert got == want
    assert all(p.grad.data_ptr() == v.data_ptr()
               for p, v in zip(tr.params, tr._gviews))


# ---------------------------------------------------------- tiny BERT
TINY = dict(num_layers=2, units=32, hidden_size=64, num_heads=4,
            vocab_size=97, max_length=32, dropout=0.0)


def _jax_pretrain_loss(pred, y):
    """``bench.py``'s BERT pretraining loss."""
    mlm_scores, nsp_scores = pred
    mlm_y, nsp_y = y
    lp = jax.nn.log_softmax(mlm_scores.astype(jnp.float32), -1)
    mlm = -jnp.take_along_axis(lp, mlm_y[..., None], -1)[..., 0]
    lp2 = jax.nn.log_softmax(nsp_scores.astype(jnp.float32), -1)
    nsp = -jnp.take_along_axis(lp2, nsp_y[:, None], -1)[:, 0]
    return jnp.mean(mlm, axis=-1) + nsp


def _pretrain_batch(b=3, t=32, n_pred=5, seed=4):
    rs = np.random.RandomState(seed)
    lens = rs.randint(8, t + 1, size=b).astype(np.int32)
    lens[0] = t
    tokens = rs.randint(0, TINY["vocab_size"], (b, t)).astype(np.int32)
    types = (np.arange(t)[None, :] >= lens[:, None] // 2).astype(np.int32)
    pos = np.stack([rs.choice(n, n_pred, replace=False)
                    for n in lens]).astype(np.int32)
    mlm_y = rs.randint(0, TINY["vocab_size"], (b, n_pred)).astype(np.int32)
    nsp_y = (np.arange(b) % 2).astype(np.int32)
    return (tokens, types, lens, pos), (mlm_y, nsp_y)


def _twin_pretrain():
    jnet = JBERTForPretrain(jax_get_bert(**TINY))
    jnet.initialize(mx.init.Xavier())
    (tok, typ, lens, pos), _ = _pretrain_batch()
    jnet(nd_i32(tok), nd_i32(typ), nd_i32(lens), nd_i32(pos))
    params = seeded_params(jnet, seed=8)
    for name, p in jnet.collect_params().items():
        p.set_data(params[name])
    tnet = tbert.BERTForPretrain(tbert.get_bert(device="cpu", **TINY))
    convert.load_into(tnet, params)
    return jnet, tnet


def test_tiny_bert_pretraining_matches_jax():
    jnet, tnet = _twin_pretrain()
    x, y = _pretrain_batch()
    with jkreg.override("interpret"):
        jtr = JTrainer(jnet, _jax_pretrain_loss, mesh=_mesh1(),
                       optimizer="adam", learning_rate=1e-3,
                       weight_decay=0.01, fused_opt="arena")
        want = [float(jtr.step(x, y, block=True)) for _ in range(3)]
    assert isinstance(jtr._adapter, JArena)
    tr = ShardedTrainer(tnet, tbert.pretrain_loss, optimizer="adam",
                        learning_rate=1e-3, weight_decay=0.01)
    assert tr.uses_arena
    got = [tr.step(x, y, block=True) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    jparams = {n: np.asarray(v) for n, v in zip(jtr.train_names, jtr.pvals)}
    tparams = dict(tnet.named_parameters())
    assert sorted(jparams) == sorted(tparams)
    for name, want_p in jparams.items():
        np.testing.assert_allclose(tparams[name].detach().numpy(), want_p,
                                   rtol=0, atol=1e-4, err_msg=name)


def test_pretrain_names_and_tied_decoder():
    jnet, tnet = _twin_pretrain()
    assert sorted(dict(tnet.named_parameters())) == \
        sorted(jnet.collect_params())
    assert not any(n.startswith("mlm_decoder") for n, _ in
                   tnet.named_parameters())
    # the tied weight gets both contributions in its arena view
    tr = ShardedTrainer(tnet, tbert.pretrain_loss, optimizer="sgd",
                        learning_rate=0.0, momentum=0.0)
    x, y = _pretrain_batch()
    tr.step(x, y, block=True)
    w = tnet.bert.word_embed.weight
    tied = w.grad.clone()
    (tok, typ, lens, pos), (mlm_y, nsp_y) = x, y
    net2 = tbert.BERTForPretrain(tbert.get_bert(device="cpu", **TINY))
    net2.load_state_dict(tnet.state_dict())
    with autograd.record():
        loss = tbert.pretrain_loss(net2(tok, typ, lens, pos),
                                   (torch.from_numpy(mlm_y),
                                    torch.from_numpy(nsp_y))).mean()
    loss.backward()
    torch.testing.assert_close(tied, net2.bert.word_embed.weight.grad,
                               rtol=1e-6, atol=1e-7)


# ---------------------------------------------------- dropout and limits
def test_dropout_draws_from_the_seeded_generator_only():
    drop = Dropout(0.25)
    x = torch.ones(4096)
    state = torch.random.get_rng_state()
    with autograd.train_mode():
        trandom.seed(11)
        a = drop(x)
        trandom.seed(11)
        b = drop(x)
    assert torch.equal(torch.random.get_rng_state(), state)
    assert torch.equal(a, b)
    kept = a != 0
    assert 0.65 < float(kept.float().mean()) < 0.85
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.75))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_16bit_dropout_keeps_the_share_and_jax_values(dtype):
    """Fault C5: the keep-mask's uniform was drawn in x's type; 4 M bf16
    draws take ~2,000 distinct values and kept 0.898 at rate 0.1.  Now
    it is drawn in f32: the kept share is within 1e-3 of 0.9, and every
    kept value equals the JAX package's ``x / keep`` in x's type (JAX
    rounds ``keep`` to that type first: for bf16, x / 0.8984375)."""
    rs = np.random.RandomState(5)
    xf = rs.randn(1 << 22).astype("float32")
    x = torch.from_numpy(xf).to(dtype)
    trandom.seed(3)
    with autograd.record():
        y = Dropout(0.1)(x)
    assert y.dtype == dtype
    kept = (y != 0).numpy() & (xf != 0)
    assert abs(float(kept.mean()) - 0.9) < 1e-3
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    want = np.asarray((jnp.asarray(x.float().numpy()).astype(jdt) / 0.9)
                      .astype(jnp.float32))
    got = y.float().numpy()
    np.testing.assert_array_equal(got[kept], want[kept])
    assert not got[~kept].any()


@pytest.mark.parametrize("kw", [
    dict(mesh=types.SimpleNamespace(size=4)), dict(partition="zero1"),
    dict(overlap=True), dict(loss_scaling=True), dict(fused_opt="bogus"),
    dict(grad_accum=0)],
    ids=lambda kw: next(iter(kw)))
def test_unported_options_raise(kw):
    net = _torch_mlp({n: p.data().asnumpy()
                      for n, p in _jax_mlp().collect_params().items()})
    with pytest.raises(MXNetError):
        ShardedTrainer(net, tloss.SoftmaxCELoss(), **kw)


def test_loss_scaling_without_compute_dtype_raises_in_both_packages():
    from mxnet_tpu.base import MXNetError as JMXNetError

    jnet = _jax_mlp()
    with pytest.raises(JMXNetError, match="loss_scaling=True"):
        JTrainer(jnet, _jax_ce, mesh=_mesh1(), loss_scaling=True)
    net = _torch_mlp({n: p.data().asnumpy()
                      for n, p in jnet.collect_params().items()})
    with pytest.raises(MXNetError, match="loss_scaling=True"):
        ShardedTrainer(net, tloss.SoftmaxCELoss(), loss_scaling=True)
    with pytest.raises(MXNetError, match="loss_scaling"):
        ShardedTrainer(net, tloss.SoftmaxCELoss(), loss_scaling="always",
                       compute_dtype=torch.float16)


def test_batchnorm_under_compute_dtype_raises_naming_the_later_slice():
    """The later slice (ROADMAP A1.4.1b) is in: a net with BatchNorm
    trains under ``compute_dtype``, and its running statistics stay f32
    buffers that the 16-bit step moves."""
    from mxnet_tpu_torch.gluon.nn import BatchNorm, HybridSequential

    for dt in (torch.bfloat16, torch.float16):
        net = HybridSequential().add(
            Dense(8, in_units=4, device="cpu"),
            BatchNorm(in_channels=8, device="cpu")).initialize(0)
        tr = ShardedTrainer(net, tloss.SoftmaxCELoss(), compute_dtype=dt)
        loss = tr.step(np.random.RandomState(0).rand(6, 4).astype("f4"),
                       np.arange(6, dtype="i4") % 8, block=True)
        assert np.isfinite(loss)
        assert net[1].running_mean.dtype == torch.float32
        assert net[1].running_mean.abs().sum() > 0
    ShardedTrainer(net, tloss.SoftmaxCELoss())           # f32 trains


def test_softmax_ce_loss_matches_jax():
    from mxnet_tpu.gluon import loss as jloss

    rs = np.random.RandomState(2)
    pred = rs.randn(3, 4, 7).astype("f4")
    label = rs.randint(0, 7, (3, 4)).astype("i4")
    dense = rs.rand(3, 4, 7).astype("f4")
    sw = rs.rand(3, 4).astype("f4")
    for kw, lab, extra in (({}, label, {}), ({"sparse_label": False}, dense,
                                             {}),
                           ({"from_logits": True}, label, {}),
                           ({}, label, {"sample_weight": sw})):
        want = jloss.SoftmaxCELoss(**kw)(
            mx.np.array(pred), mx.np.array(lab),
            *([mx.np.array(sw)] if extra else [])).asnumpy()
        got = tloss.SoftmaxCELoss(**kw)(
            torch.from_numpy(pred), torch.from_numpy(lab),
            *([torch.from_numpy(sw)] if extra else []))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ------------------------------------- multi-tensor, schedules, accumulation
@pytest.mark.parametrize("opt", ["adamw", "lamb"])
def test_multi_tensor_bert_matches_jax_multi_tensor(opt):
    """3 steps of the tiny BERT with ``multi_tensor=True`` in both
    packages: losses within 1e-5 relative, parameters within 1e-5
    absolute (lr 1e-3), epsilon 1e-6 (LAMB's default; at 1e-8 Adam's
    normalized step turns a near-zero gradient's last-bit difference
    into up to +-lr).  The key third of each ``qkv.bias`` is held within
    2 x lr x steps: its gradient is 0 in exact arithmetic (a bias on the
    keys adds the same ``q . b`` to every score of a row, which the
    softmax removes), so AdamW steps it by the sign of rounding noise in
    either package."""
    from mxnet_tpu import optimizer as jopt
    from mxnet_tpu.parallel.trainer import _FusedOptAdapter as JFused
    from mxnet_tpu_torch import optimizer as topt

    kw = dict(learning_rate=1e-3, wd=0.01, epsilon=1e-6)
    jnet, tnet = _twin_pretrain()
    x, y = _pretrain_batch()
    with jkreg.override("interpret"):
        jtr = JTrainer(jnet, _jax_pretrain_loss, mesh=_mesh1(),
                       optimizer=jopt.create(opt, **kw), multi_tensor=True)
        want = [float(jtr.step(x, y, block=True)) for _ in range(3)]
    assert type(jtr._adapter) is JFused
    tr = ShardedTrainer(tnet, tbert.pretrain_loss,
                        optimizer=topt.create(opt, **kw), multi_tensor=True)
    assert not tr.uses_arena and tr.arena_refused
    assert max(len(g) for g in tr._adapter.groups) > 1
    got = [tr.step(x, y, block=True) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    tparams = dict(tnet.named_parameters())
    keys = np.r_[TINY["units"]:2 * TINY["units"]]
    for name, v in zip(jtr.train_names, jtr.pvals):
        got, want = tparams[name].detach().numpy(), np.asarray(v)
        if name.endswith("qkv.bias"):
            np.testing.assert_allclose(got[keys], want[keys], rtol=0,
                                       atol=2 * 1e-3 * 3, err_msg=name)
            got, want = np.delete(got, keys), np.delete(want, keys)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("opt", ["sgd", "adamw", "lamb", "lars", "signum",
                                 "dcasgd", "nadam", "sgld"])
def test_multi_tensor_trainer_equals_per_parameter_bit_for_bit(opt):
    """The multi-tensor trainer against the per-parameter one on the BERT
    of the tests (groups of 2 and more) with an lr multiplier that splits
    the LayerNorm groups (``param_dict`` in the trainer's order)."""
    from mxnet_tpu_torch import optimizer as topt

    _, tnet = _twin_pretrain()
    x, y = _pretrain_batch()
    runs = []
    for multi in (False, True):
        net = tbert.BERTForPretrain(tbert.get_bert(device="cpu", **TINY))
        net.load_state_dict(tnet.state_dict())
        net.bert.encoder.layers[0].layer_norm_att.gamma.lr_mult = 0.5
        optimizer = topt.create(opt, learning_rate=1e-3, wd=0.01,
                                param_dict=dict(enumerate(
                                    p for _, p in sorted(
                                        net.named_parameters()))))
        trandom.seed(2)
        tr = ShardedTrainer(net, tbert.pretrain_loss, optimizer=optimizer,
                            multi_tensor=multi, fused_opt="off")
        losses = [tr.step(x, y, block=True) for _ in range(3)]
        runs.append((losses, net, tr))
    (l0, n0, t0), (l1, n1, t1) = runs
    assert l0 == l1
    for (name, a), b in zip(n0.named_parameters(), n1.parameters()):
        assert torch.equal(a, b), name
    for a, b in zip(t0._adapter.leaves(), t1._adapter.leaves()):
        assert torch.equal(a, b)
    groups = t1._adapter.groups
    if opt in ("nadam", "sgld"):
        assert max(len(g) for g in groups) == 1
    else:
        sig = {t1._adapter._index_sig(g[0]) for g in groups}
        assert (0.5, 1.0) in sig and max(len(g) for g in groups) > 1


def test_multi_tensor_parameters_are_views_of_one_stack():
    _, tnet = _twin_pretrain()
    tr = ShardedTrainer(tnet, tbert.pretrain_loss, optimizer="adamw",
                        multi_tensor=True)
    ad = tr._adapter
    for g, stack in zip(ad.groups, ad._stacks):
        if stack is None:
            continue
        w, leaves = stack
        for j, i in enumerate(g):
            assert tr.params[i].data_ptr() == w[j].data_ptr()
            assert tr.params[i].grad.data_ptr() == \
                tr._gviews[g[0]].data_ptr() + j * w[j].numel() * 4
            for k, leaf in enumerate(ad.states[i]):
                assert leaf.data_ptr() == leaves[k][j].data_ptr()
    # explicit multi_tensor bypasses the arena; fused_opt="arena" wins
    assert not ShardedTrainer(_torch_mlp(_mlp_params()),
                              tloss.SoftmaxCELoss(), optimizer="adam",
                              multi_tensor=True).uses_arena
    assert ShardedTrainer(_torch_mlp(_mlp_params()), tloss.SoftmaxCELoss(),
                          optimizer="adam", multi_tensor=True,
                          fused_opt="arena").uses_arena


def _mlp_params():
    return {n: p.data().asnumpy()
            for n, p in _jax_mlp().collect_params().items()}


@pytest.mark.parametrize("opt,fused_opt", [("adam", "arena"),
                                           ("adamw", None), ("sgd", "arena")])
def test_lr_scheduler_trajectory_matches_jax(opt, fused_opt):
    """A warmup-then-poly schedule through both trainers: losses within
    1e-5 relative over 8 steps, and update k runs at ``scheduler(k)``."""
    from mxnet_tpu import lr_scheduler as jlrs
    from mxnet_tpu_torch import lr_scheduler as tlrs

    kw = dict(max_update=10, base_lr=0.05, pwr=1, warmup_steps=3)
    params, jtr, want = _jax_losses(opt, fused_opt,
                                    lr_scheduler=jlrs.PolyScheduler(**kw))
    sched = tlrs.PolyScheduler(**kw)
    tr = ShardedTrainer(_torch_mlp(params), tloss.SoftmaxCELoss(),
                        optimizer=opt, learning_rate=0.05,
                        lr_scheduler=sched)
    assert tr.uses_arena == (fused_opt == "arena")
    x, y = _data()
    got, lrs = [], []
    for _ in range(8):
        got.append(tr.step(x, y, block=True))
        lrs.append(tr.learning_rate)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert lrs == [sched(t) for t in range(1, 9)]
    assert jtr.learning_rate == tr.learning_rate
    with pytest.raises(MXNetError, match="LRScheduler"):
        tr.set_learning_rate(0.1)
    # the optimizer's own schedule is taken when the trainer has none
    from mxnet_tpu_torch import optimizer as topt

    own = topt.create(opt, learning_rate=0.05,
                      lr_scheduler=tlrs.PolyScheduler(**kw),
                      **({"momentum": 0.9} if opt == "sgd" else {}))
    tr2 = ShardedTrainer(_torch_mlp(params), tloss.SoftmaxCELoss(),
                         optimizer=own)
    assert tr2.lr_scheduler is own.lr_scheduler
    got2 = [tr2.step(x, y, block=True) for _ in range(8)]
    np.testing.assert_allclose(got2, got, rtol=1e-6, atol=0)


def _jax_bn_mlp():
    mx.random.seed(0)
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(16, in_units=12, use_bias=False),
            mx.gluon.nn.BatchNorm(in_channels=16),
            mx.gluon.nn.Activation("relu"), mx.gluon.nn.Dense(10,
                                                               in_units=16))
    net.initialize(mx.init.Xavier())
    net(mx.np.zeros((2, 12)))
    return net


def _torch_bn_mlp(params):
    from mxnet_tpu_torch.gluon.nn import Activation, BatchNorm, \
        HybridSequential

    net = HybridSequential().add(
        Dense(16, in_units=12, use_bias=False, device="cpu"),
        BatchNorm(in_channels=16, device="cpu"), Activation("relu"),
        Dense(10, in_units=16, device="cpu"))
    return convert.load_into(net, params)


@pytest.mark.parametrize("opt,fused_opt", [("sgd", "arena"),
                                           ("adamw", None)])
def test_grad_accum_matches_jax(opt, fused_opt):
    """``grad_accum=2`` over 2 windows (4 micro-batches of 8) of an MLP
    with BatchNorm in both packages: losses, parameters and running
    statistics within 1e-5.  The Dense before the BatchNorm has no bias:
    the normalization removes it, so its gradient would be rounding
    noise that AdamW's normalized step turns into +-lr.)"""
    jnet = _jax_bn_mlp()
    params = {n: p.data().asnumpy() for n, p in
              jnet.collect_params().items()}
    rs = np.random.RandomState(9)
    batches = [(rs.rand(8, 12).astype("f4"),
                rs.randint(0, 10, 8).astype("i4")) for _ in range(4)]
    with jkreg.override("interpret" if fused_opt == "arena" else "off"):
        jtr = JTrainer(jnet, _jax_ce, mesh=_mesh1(), optimizer=opt,
                       learning_rate=0.05, weight_decay=0.01,
                       fused_opt=fused_opt, grad_accum=2)
        want = [float(jtr.step(x, y, block=True)) for x, y in batches]
    tnet = _torch_bn_mlp(params)
    tr = ShardedTrainer(tnet, tloss.SoftmaxCELoss(), optimizer=opt,
                        learning_rate=0.05, weight_decay=0.01, grad_accum=2,
                        fused_opt=fused_opt)
    got = []
    for k, (x, y) in enumerate(batches):
        got.append(tr.step(x, y, block=True))
        assert tr._t == (k + 1) // 2
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    jvals = dict(zip(jtr.train_names, jtr.pvals))
    jvals.update(zip(jtr.aux_names, jtr.avals))
    own = dict(tnet.named_parameters())
    own.update(tnet.named_buffers())
    assert sorted(own) == sorted(jvals)
    for name, v in jvals.items():
        np.testing.assert_allclose(own[name].detach().numpy(),
                                   np.asarray(v), rtol=0, atol=1e-5,
                                   err_msg=name)


def test_grad_accum_window_equals_one_large_step():
    """Two halves of a batch through ``grad_accum=2`` land where one step
    of the whole batch does (f32 sums in another order: within 1e-6 of
    the parameters' max)."""
    params = _mlp_params()
    rs = np.random.RandomState(4)
    x, y = rs.rand(16, 12).astype("f4"), rs.randint(0, 10, 16).astype("i4")
    nets = []
    for accum, batches in ((1, [(x, y)]),
                           (2, [(x[:8], y[:8]), (x[8:], y[8:])])):
        net = _torch_mlp(params)
        tr = ShardedTrainer(net, tloss.SoftmaxCELoss(), optimizer="adam",
                            learning_rate=0.01, grad_accum=accum)
        for b in batches:
            tr.step(*b, block=True)
        nets.append(net)
    for a, b in zip(nets[0].parameters(), nets[1].parameters()):
        top = float(a.detach().abs().max())
        assert float((a - b).detach().abs().max()) <= 1e-6 * top


def test_grad_accum_under_loss_scaling_unscales_each_micro_batch():
    """f16 with dynamic loss scaling and ``grad_accum=2``: an overflow in
    one micro-batch skips the window's update and halves the scale;
    otherwise the window updates."""
    params = _mlp_params()
    x, y = _data()
    tr = ShardedTrainer(_torch_mlp(params), tloss.SoftmaxCELoss(),
                        optimizer="adam", learning_rate=0.01, grad_accum=2,
                        compute_dtype=torch.float16,
                        init_loss_scale=2.0 ** 30)
    before = [p.detach().clone() for p in tr.params]
    tr.step(x, y)
    tr.step(x, y, block=True)
    assert tr.skipped_steps == 1 and tr.loss_scale == 2.0 ** 29
    assert all(torch.equal(a, b) for a, b in zip(before, tr.params))
    tr2 = ShardedTrainer(_torch_mlp(params), tloss.SoftmaxCELoss(),
                         optimizer="adam", learning_rate=0.01, grad_accum=2,
                         compute_dtype=torch.float16, init_loss_scale=256.0)
    tr2.step(x, y)
    tr2.step(x, y, block=True)
    assert tr2.skipped_steps == 0 and tr2._t == 1
    assert not all(torch.equal(a, b) for a, b in zip(before, tr2.params))
