"""Checkpoints of the port against the JAX package's, on the CPU.

* ``ShardedTrainer.save_states`` / ``load_states``: a checkpoint that
  the JAX trainer wrote (per-parameter AdamW, and the arena's Adam) on an
  MLP whose names agree loads into the port, and the next 2 steps match
  the JAX trainer's own within 1e-5 (losses relative, parameters
  absolute); a per-parameter checkpoint on an arena trainer, and the
  other way round, raises.  Save, load and resume in the port equals the
  uninterrupted run bit for bit: dropout's generator, the loss-scale
  state, a schedule and gradient accumulation included.
* ``gluon.Trainer.save_states`` / ``load_states`` and
  ``Block.save_parameters`` / ``load_parameters``: files written by
  either package load into the other and continue LeNet-5's trajectory
  within 1e-5.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.kernels import registry as jkreg
from mxnet_tpu.parallel.mesh import make_mesh
from mxnet_tpu.parallel.trainer import ShardedTrainer as JTrainer
from mxnet_tpu_torch import autograd, convert, gluon
from mxnet_tpu_torch import lr_scheduler as tlrs
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.gluon.model_zoo import get_model
from mxnet_tpu_torch.gluon.nn import Dense
from mxnet_tpu_torch.parallel import ShardedTrainer
from mxnet_tpu_torch.resilience import write_payload


# ------------------------------------------------------------- the MLP
def _jax_ce(pred, y):
    logp = jax.nn.log_softmax(pred.astype(jnp.float32))
    return -jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0]


def _jax_mlp(seed=0):
    mx.random.seed(seed)
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(32, activation="relu"), mx.gluon.nn.Dense(10))
    net.initialize(mx.init.Xavier())
    net(mx.np.zeros((2, 12)))
    return net


def _torch_mlp(params=None):
    net = torch.nn.Sequential(Dense(32, "relu", in_units=12, device="cpu"),
                              Dense(10, in_units=32, device="cpu"))
    if params is None:
        params = {n: p.data().asnumpy()
                  for n, p in _jax_mlp(seed=5).collect_params().items()}
    return convert.load_into(net, params)


def _batches(n, b=16):
    rs = np.random.RandomState(0)
    return [(rs.rand(b, 12).astype("f4"), rs.randint(0, 10, b).astype("i4"))
            for _ in range(n)]


JAX_LAYOUTS = {"adamw": ("adamw", None, False),
               "arena_adam": ("adam", "arena", True)}


def _jax_checkpoint(tmp_path, case):
    opt, fused_opt, arena = JAX_LAYOUTS[case]
    batches = _batches(4)
    with jkreg.override("interpret" if arena else "off"):
        jtr = JTrainer(_jax_mlp(), _jax_ce, mesh=make_mesh(
            {"dp": -1}, devices=jax.devices()[:1]), optimizer=opt,
            learning_rate=0.01, weight_decay=0.01, fused_opt=fused_opt)
        for x, y in batches[:2]:
            jtr.step(x, y, block=True)
        path = str(tmp_path / f"jax_{case}.npz")
        jtr.save_states(path)
        want = [float(jtr.step(x, y, block=True)) for x, y in batches[2:]]
    return path, jtr, want, batches


@pytest.mark.parametrize("case", sorted(JAX_LAYOUTS))
def test_jax_checkpoint_resumes_in_the_port(tmp_path, case):
    path, jtr, want, batches = _jax_checkpoint(tmp_path, case)
    opt, fused_opt, arena = JAX_LAYOUTS[case]
    net = _torch_mlp()
    tr = ShardedTrainer(net, tloss.SoftmaxCELoss(), optimizer=opt,
                        learning_rate=0.01, weight_decay=0.01,
                        fused_opt=fused_opt)
    assert tr.uses_arena == arena
    tr.load_states(path)
    assert tr._t == 2
    got = [tr.step(x, y, block=True) for x, y in batches[2:]]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    own = dict(net.named_parameters())
    for name, v in zip(jtr.train_names, jtr.pvals):
        np.testing.assert_allclose(own[name].detach().numpy(),
                                   np.asarray(v), rtol=0, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("case", sorted(JAX_LAYOUTS))
def test_a_checkpoint_of_the_other_layout_is_refused(tmp_path, case):
    path, _, _, _ = _jax_checkpoint(tmp_path, case)
    arena = JAX_LAYOUTS[case][2]
    # the other layout: per-parameter adam for an arena file, the arena
    # for a per-parameter one
    tr = ShardedTrainer(_torch_mlp(), tloss.SoftmaxCELoss(), optimizer="adam",
                        fused_opt="off" if arena else "arena")
    with pytest.raises(MXNetError, match="layout"):
        tr.load_states(path)
    port_path = str(tmp_path / "port.npz")
    tr.save_states(port_path)
    other = ShardedTrainer(_torch_mlp(), tloss.SoftmaxCELoss(),
                           optimizer="adam",
                           fused_opt="arena" if arena else "off")
    with pytest.raises(MXNetError, match="layout"):
        other.load_states(port_path)


# -------------------------------------------------- port resume, bit for bit
TINY = dict(num_layers=2, units=32, hidden_size=64, num_heads=4,
            vocab_size=97, max_length=32, dropout=0.1)


def _pretrain_batch(seed):
    rs = np.random.RandomState(seed)
    b, t, n_pred = 3, 32, 5
    lens = rs.randint(8, t + 1, size=b).astype(np.int32)
    tokens = rs.randint(0, TINY["vocab_size"], (b, t)).astype(np.int32)
    types = (np.arange(t)[None, :] >= lens[:, None] // 2).astype(np.int32)
    pos = np.stack([rs.choice(n, n_pred, replace=False)
                    for n in lens]).astype(np.int32)
    y = (rs.randint(0, TINY["vocab_size"], (b, n_pred)).astype(np.int32),
         (np.arange(b) % 2).astype(np.int32))
    return (tokens, types, lens, pos), y


def _bert(seed):
    return tbert.BERTForPretrain(tbert.get_bert(device="cpu", **TINY)
                                 ).initialize(seed)


RESUME = {
    "multi_tensor_adamw": dict(optimizer="adamw", multi_tensor=True,
                               learning_rate=1e-3, weight_decay=0.01),
    "arena_schedule_accum": dict(
        optimizer="adam", learning_rate=1e-3, grad_accum=2,
        lr_scheduler=tlrs.PolyScheduler(max_update=6, base_lr=1e-3,
                                        warmup_steps=2)),
    "f16_lamb": dict(optimizer="lamb", multi_tensor=True, learning_rate=1e-3,
                     compute_dtype=torch.float16, init_loss_scale=2.0 ** 40),
}


@pytest.mark.parametrize("case", sorted(RESUME))
def test_save_load_resume_equals_the_uninterrupted_run(tmp_path, case):
    kw = RESUME[case]
    calls = 4 * kw.get("grad_accum", 1)
    batches = [_pretrain_batch(s) for s in range(2 * calls)]
    trandom.seed(1)
    net = _bert(0)
    tr = ShardedTrainer(net, tbert.pretrain_loss, **kw)
    whole = [tr.step(x, y, block=True) for x, y in batches]

    trandom.seed(1)
    first = ShardedTrainer(_bert(0), tbert.pretrain_loss, **kw)
    for x, y in batches[:calls]:
        first.step(x, y, block=True)
    path = str(tmp_path / "ckpt.npz")
    first.save_states(path)
    trandom.seed(77)                       # the file must carry the draws
    net2 = _bert(3)
    tr2 = ShardedTrainer(net2, tbert.pretrain_loss, **kw)
    tr2.load_states(path)
    assert (tr2.loss_scale, tr2.skipped_steps, tr2._t) == \
        (first.loss_scale, first.skipped_steps, first._t)
    rest = [tr2.step(x, y, block=True) for x, y in batches[calls:]]
    assert rest == whole[calls:]
    for (name, a), b in zip(net.named_parameters(), net2.parameters()):
        assert torch.equal(a, b), name
    for a, b in zip(tr._adapter.leaves(), tr2._adapter.leaves()):
        assert torch.equal(a, b)
    if "compute_dtype" in kw:
        assert tr.skipped_steps > 0 and tr.loss_scale < 2.0 ** 40
    with np.load(path) as z:
        keys = set(z.files)
    assert {"meta/t", "meta/scale", "meta/good", "meta/skipped",
            "meta/torch_generator"} <= keys
    assert sum(k.startswith("opt/") for k in keys) == len(tr._adapter.leaves())


def test_save_states_mid_window_raises(tmp_path):
    tr = ShardedTrainer(_torch_mlp(), tloss.SoftmaxCELoss(), optimizer="adam",
                        grad_accum=2)
    x, y = _batches(1)[0]
    tr.step(x, y)
    with pytest.raises(MXNetError, match="mid gradient-accumulation"):
        tr.save_states(str(tmp_path / "x.npz"))
    tr.step(x, y)
    tr.save_states(str(tmp_path / "x.npz"))


def test_write_payload_keeps_the_old_file_when_the_writer_fails(tmp_path):
    path = str(tmp_path / "f.bin")
    write_payload(path, b"old")

    def boom(f):
        f.write(b"half")
        raise OSError("disk gone")

    with pytest.raises(OSError):
        write_payload(path, boom)
    assert open(path, "rb").read() == b"old"
    assert os.listdir(tmp_path) == ["f.bin"]


# ---------------------------------------------- gluon: states, parameters
def _mnist(num, seed):
    rs = np.random.RandomState(seed)
    return (rs.rand(num, 1, 28, 28).astype("float32"),
            rs.randint(0, 10, num).astype("int32"))


def _jax_steps(net, tr, xs, ys):
    lf = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    out = []
    for x, y in zip(xs, ys):
        with mx.autograd.record():
            loss = lf(net(mx.np.array(x)), mx.np.array(y))
        loss.backward()
        tr.step(len(x))
        out.append(float(loss.asnumpy().mean()))
    return out


def _port_steps(net, tr, xs, ys):
    lf = SoftmaxCrossEntropyLoss()
    out = []
    for x, y in zip(xs, ys):
        with autograd.record():
            loss = lf(net(torch.from_numpy(x)), torch.from_numpy(y))
        autograd.backward(loss)
        tr.step(len(x))
        out.append(float(loss.detach().mean()))
    return out


OPT = ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4})


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_gluon_states_and_parameters_cross_packages(tmp_path, writer):
    """One package trains LeNet 2 steps and saves its parameters and its
    trainer's states; a fresh net and trainer of the other package load
    both and take 2 more steps, which match the writer's own within
    1e-5."""
    data = _mnist(64, 3)
    xs, ys = np.split(data[0], 4), np.split(data[1], 4)
    jnet = mx.gluon.model_zoo.vision.get_model("lenet")
    mx.random.seed(0)
    jnet.initialize(mx.init.Xavier())
    jnet(mx.np.array(xs[0][:1]))
    tnet = get_model("lenet", device="cpu")
    convert.load_into(tnet, {n: p.data().asnumpy()
                             for n, p in jnet.collect_params().items()})
    params, states = str(tmp_path / "p.params"), str(tmp_path / "s.states")
    if writer == "jax":
        jtr = mx.gluon.Trainer(jnet.collect_params(), OPT[0], dict(OPT[1]))
        _jax_steps(jnet, jtr, xs[:2], ys[:2])
        jnet.save_parameters(params)
        jtr.save_states(states)
        want = _jax_steps(jnet, jtr, xs[2:], ys[2:])
        fresh = get_model("lenet", device="cpu").initialize(9)
        fresh.load_parameters(params)
        ttr = gluon.Trainer(fresh.collect_params(), OPT[0], dict(OPT[1]))
        ttr.load_states(states)
        got = _port_steps(fresh, ttr, xs[2:], ys[2:])
        done = {n: p.data().asnumpy()
                for n, p in jnet.collect_params().items()}
        mine = {n: p.detach().numpy() for n, p in fresh.named_parameters()}
    else:
        ttr = gluon.Trainer(tnet.collect_params(), OPT[0], dict(OPT[1]))
        _port_steps(tnet, ttr, xs[:2], ys[:2])
        tnet.save_parameters(params)
        ttr.save_states(states)
        want = _port_steps(tnet, ttr, xs[2:], ys[2:])
        fresh = mx.gluon.model_zoo.vision.get_model("lenet")
        mx.random.seed(9)
        fresh.initialize(mx.init.Xavier())
        fresh(mx.np.array(xs[0][:1]))
        fresh.load_parameters(params)
        jtr = mx.gluon.Trainer(fresh.collect_params(), OPT[0], dict(OPT[1]))
        jtr.load_states(states)
        got = _jax_steps(fresh, jtr, xs[2:], ys[2:])
        done = {n: p.detach().numpy() for n, p in tnet.named_parameters()}
        mine = {n: p.data().asnumpy()
                for n, p in fresh.collect_params().items()}
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert sorted(done) == sorted(mine)
    for name in done:
        np.testing.assert_allclose(mine[name], done[name], rtol=0,
                                   atol=1e-5, err_msg=name)


def test_gluon_trainer_resumes_bit_for_bit_under_a_schedule(tmp_path):
    """Adam under a FactorScheduler: 2 steps, save, a fresh net and trainer
    (``begin_num_update`` carries the count, as in the JAX package),
    load, 2 steps: equal to 4 uninterrupted steps."""
    data = _mnist(64, 4)
    xs, ys = np.split(data[0], 4), np.split(data[1], 4)

    def trainer(net, begin=0):
        return gluon.Trainer(net.collect_params(), "adam", {
            "learning_rate": 1e-3, "begin_num_update": begin,
            "lr_scheduler": tlrs.FactorScheduler(step=1, factor=0.5,
                                                 base_lr=1e-3)})

    net = get_model("lenet", device="cpu").initialize(0)
    tr = trainer(net)
    whole = _port_steps(net, tr, xs, ys)
    assert tr.learning_rate == pytest.approx(1e-3 * 0.5 ** 4)
    net1 = get_model("lenet", device="cpu").initialize(0)
    tr1 = trainer(net1)
    _port_steps(net1, tr1, xs[:2], ys[:2])
    net1.save_parameters(str(tmp_path / "p"))
    tr1.save_states(str(tmp_path / "s"))
    net2 = get_model("lenet", device="cpu").initialize(5)
    net2.load_parameters(str(tmp_path / "p"))
    tr2 = trainer(net2, begin=2)
    tr2.load_states(str(tmp_path / "s"))
    assert _port_steps(net2, tr2, xs[2:], ys[2:]) == whole[2:]
    for (name, a), b in zip(net.named_parameters(), net2.parameters()):
        assert torch.equal(a, b), name


def test_parameters_file_format_and_options(tmp_path):
    from mxnet_tpu.ndarray import utils as jutils
    from mxnet_tpu_torch.gluon.nn import BatchNorm, HybridSequential

    net = HybridSequential().add(Dense(4, in_units=3, device="cpu"),
                                 BatchNorm(in_channels=4, device="cpu"))
    net.initialize(1)
    net[1].running_mean.fill_(0.25)
    path = str(tmp_path / "net.params")
    net.save_parameters(path)
    jax_side = jutils.load(path)              # the JAX reader takes it
    assert sorted(jax_side) == sorted(
        ["0.weight", "0.bias", "1.gamma", "1.beta", "1.running_mean",
         "1.running_var"])
    np.testing.assert_array_equal(jax_side["1.running_mean"].asnumpy(),
                                  np.full(4, 0.25, "f4"))
    other = HybridSequential().add(Dense(4, in_units=3, device="cpu"),
                                   BatchNorm(in_channels=4, device="cpu"))
    other.load_parameters(path)
    x = torch.rand(5, 3)
    assert torch.equal(net(x), other(x))
    # bf16 in the JAX package's tagged uint16, both ways
    t = {"a": torch.rand(3, 2).to(torch.bfloat16), "b": torch.arange(4)}
    tnd.save(str(tmp_path / "bf"), t)
    back = jutils.load(str(tmp_path / "bf"))
    assert back["a"].dtype == jnp.bfloat16
    jutils.save(str(tmp_path / "bf2"), back)
    again = tnd.load(str(tmp_path / "bf2"))
    assert torch.equal(again["a"], t["a"]) and torch.equal(again["b"], t["b"])
    assert tnd.load(str(tmp_path / "bf2")) .keys() == t.keys()
    tnd.save(str(tmp_path / "l"), [t["a"], t["b"]])
    lst = tnd.load(str(tmp_path / "l"))
    assert torch.equal(lst[1], t["b"])
    # missing / extra / cast_dtype
    small = HybridSequential().add(Dense(4, in_units=3, device="cpu"))
    with pytest.raises(MXNetError, match="not present"):
        small.load_parameters(path)
    small.load_parameters(path, ignore_extra=True)
    with pytest.raises(MXNetError, match="missing"):
        other.load_parameters(str(tmp_path / "bf2"), ignore_extra=True)
    tnd.save(str(tmp_path / "w16"), {"0.weight": torch.ones(4, 3,
                                                            dtype=torch.half)})
    small.load_parameters(str(tmp_path / "w16"), allow_missing=True)
    assert small[0].weight.dtype == torch.float32
    small.load_parameters(str(tmp_path / "w16"), allow_missing=True,
                          cast_dtype=True)
    assert small[0].weight.dtype == torch.float16
