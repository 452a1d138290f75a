"""Every registry optimizer of the port against the JAX package's, on the
CPU, and the multi-tensor update against the per-parameter one.

Each optimizer runs at its defaults and with one non-default setting at
a time (weight decay, a gradient clip, an lr multiplier on one index,
and momentum / a variant where the optimizer has one): 5 updates of 3
tensors, the same weights and gradients (numpy, from a seed) in both
packages.  Tolerance: every weight and state leaf within 1e-6 of the
JAX value relative to that tensor's largest magnitude (both packages
perform the same float32 operations in the same order; XLA may contract
a product and a sum into one FMA, and torch divides some tensors by a
scalar as a product with its reciprocal, a rounding apart).

SGLD's noise comes from the port's seeded generator, not a JAX key (a
deliberate difference): the parity test zeroes the noise in both
packages and holds the drift; a second test holds the noise's moments
and its repeatability from the seed.

The multi-tensor update (``torch.func.vmap`` of the per-parameter
``update`` over a stack of same-shaped tensors, as
``ShardedTrainer(multi_tensor=True)`` runs it) equals the per-parameter
loop bit for bit for every optimizer, on a net whose groups are split
by an lr multiplier.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import optimizer as jopt
from mxnet_tpu.ndarray.ndarray import NDArray
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch import random as trandom

RTOL = 1e-6
SHAPES = [(4, 5), (4, 5), (7,)]

# name -> the non-default settings each case adds (the defaults always run)
NON_DEFAULT = {
    "sgd": {"momentum": dict(momentum=0.9)},
    "nag": {"momentum": dict(momentum=0.9)},
    "adam": {"betas": dict(beta1=0.8, beta2=0.99)},
    "adamw": {"eta": dict(eta=0.5, wd=0.05)},
    "sgld": {},
    "adamax": {"betas": dict(beta1=0.8, beta2=0.99)},
    "nadam": {"decay": dict(schedule_decay=0.01)},
    "rmsprop": {"centered": dict(centered=True, clip_weights=0.45)},
    "adagrad": {"eps": dict(epsilon=1e-4)},
    "adadelta": {"rho": dict(rho=0.8)},
    "ftrl": {"lamda1": dict(lamda1=0.2, beta=0.5)},
    "signum": {"momentum": dict(momentum=0.0, wd_lh=0.01)},
    "lars": {"momentum": dict(momentum=0.0, eta=0.01)},
    "lamb": {"bounds": dict(lower_bound=0.5, upper_bound=0.9,
                            bias_correction=False)},
    "ftml": {"betas": dict(beta1=0.7, beta2=0.99)},
    "lans": {"bounds": dict(lower_bound=0.5, upper_bound=0.9)},
    "lbsgd": {"momentum": dict(momentum=0.9, warmup_strategy="power2",
                               batch_scale=4, warmup_epochs=1,
                               updates_per_epoch=3)},
    "dcasgd": {"momentum": dict(momentum=0.9, lamda=0.1)},
    "test": {},
}
COMMON = {"wd": dict(wd=0.01), "clip": dict(clip_gradient=0.2),
          "lr_mult": {}}
CASES = [(name, setting) for name in sorted(NON_DEFAULT)
         for setting in ["default", *COMMON, *NON_DEFAULT[name]]]


def _settings(name, setting):
    kw = dict(COMMON.get(setting, {}))
    kw.update(NON_DEFAULT[name].get(setting, {}))
    if name in ("adadelta", "test") or setting != "lr_mult":
        return kw, {}
    return kw, {1: 0.5}


def _inputs(seed, steps=5):
    rs = np.random.RandomState(seed)
    ws = [(rs.rand(*s) - 0.5).astype("float32") for s in SHAPES]
    gs = [[(rs.rand(*s) - 0.5).astype("float32") for s in SHAPES]
          for _ in range(steps)]
    return ws, gs


def _flat(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _flat(s)]
    return [state]


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: {err:.3e} > {RTOL} x {scale:.3e}"


def _run_port(name, kw, lr_mult, ws, gs):
    opt = topt.create(name, **kw)
    opt.set_lr_mult(lr_mult)
    tw = [torch.from_numpy(w.copy()) for w in ws]
    ts = [opt.create_state(i, w) for i, w in enumerate(tw)]
    for step in gs:
        for i, g in enumerate(step):
            opt.update(i, tw[i], torch.from_numpy(g), ts[i])
    return tw, ts


@pytest.mark.parametrize("name,setting", CASES,
                         ids=[f"{n}-{s}" for n, s in CASES])
def test_registry_optimizer_matches_jax(name, setting, monkeypatch):
    kw, lr_mult = _settings(name, setting)
    ws, gs = _inputs(sum(map(ord, name + setting)))
    if name == "sgld":       # the drift only (module docstring)
        monkeypatch.setattr(jax.random, "normal",
                            lambda key, shape, dtype: jnp.zeros(shape, dtype))
        monkeypatch.setattr(torch, "randn",
                            lambda shape, **k: torch.zeros(
                                shape, dtype=k["dtype"], device=k["device"]))
    jo = jopt.create(name, **kw)
    jo.set_lr_mult(lr_mult)
    jw = [NDArray(jnp.asarray(w)) for w in ws]
    js = [jo.create_state(i, w) for i, w in enumerate(jw)]
    for step in gs:
        for i, g in enumerate(step):
            jo.update(i, jw[i], NDArray(jnp.asarray(g)), js[i])
    tw, ts = _run_port(name, kw, lr_mult, ws, gs)
    for i in range(len(SHAPES)):
        _close(tw[i].numpy(), jw[i].asnumpy(), f"weight {i}")
        fj, ft = _flat(js[i]), _flat(ts[i])
        assert len(fj) == len(ft)
        for k, (a, b) in enumerate(zip(ft, fj)):
            _close(a.numpy(), b.asnumpy(), f"state {i}.{k}")
        assert not any(a.data_ptr() == tw[i].data_ptr() for a in ft)
    moved = [not np.array_equal(w.numpy(), w0) for w, w0 in zip(tw, ws)]
    assert all(moved), moved


def test_sgld_noise_is_seeded_with_the_expected_moments():
    w0 = np.zeros((256, 256), "float32")
    g = np.zeros_like(w0)
    runs = []
    for _ in range(2):
        trandom.seed(11)
        opt = topt.create("sgld", learning_rate=0.04)
        w = torch.from_numpy(w0.copy())
        opt.update(0, w, torch.from_numpy(g), None)
        runs.append(w.numpy())
    np.testing.assert_array_equal(runs[0], runs[1])
    noise = runs[0]
    assert abs(float(noise.mean())) < 3 * 0.2 / 256
    assert abs(float(noise.std()) - 0.2) < 0.2 * 0.01


def _adapter_run(multi, name, kw, lr_mult, ws, gs):
    """The trainer's per-parameter adapter, or its multi-tensor one (the
    tensors of one (shape, lr_mult) group stacked, one vmap of
    ``update`` a group), over 5 steps of the trainer's step count."""
    from mxnet_tpu_torch.kernels.opt_arena import build_layout
    from mxnet_tpu_torch.parallel.trainer import _FusedOptAdapter, \
        _OptAdapter

    opt = topt.create(name, **kw)
    opt.set_lr_mult(lr_mult)
    params = [torch.nn.Parameter(torch.from_numpy(w.copy()))
              for w in ws]
    adapter = (_FusedOptAdapter if multi else _OptAdapter)(opt)
    order = adapter.order(params)         # the trainer's gradient arena
    layout = build_layout([tuple(params[i].shape) for i in order])
    garena = torch.zeros(layout.padded)
    views = [None] * len(params)
    for i, off, size, shape in zip(order, layout.offsets, layout.sizes,
                                   layout.shapes):
        views[i] = garena[off:off + size].view(shape)
    adapter.init_state(params, layout)
    with torch.no_grad():
        for t, step in enumerate(gs, 1):
            for v, g in zip(views, step):
                v.copy_(torch.from_numpy(g))
            adapter.update(params, views, garena, opt.lr, t)
    return [p.detach() for p in params], adapter


@pytest.mark.parametrize("name,setting",
                         [c for c in CASES if c[1] in ("default",
                                                       "lr_mult")],
                         ids=[f"{n}-{s}" for n, s in CASES
                              if s in ("default", "lr_mult")])
def test_multi_tensor_equals_per_parameter_bit_for_bit(name, setting):
    kw, lr_mult = _settings(name, setting)
    ws, gs = _inputs(7)
    runs = []
    for multi in (False, True):
        trandom.seed(5)
        runs.append(_adapter_run(multi, name, kw, lr_mult, ws, gs))
    (tw, ref), (vw, adapter) = runs
    groups = sorted(len(g) for g in adapter.groups)
    if name in ("sgld", "nadam") or lr_mult:
        assert groups == [1, 1, 1]
    else:
        assert groups == [1, 2]
    for i in range(len(SHAPES)):
        assert torch.equal(vw[i], tw[i]), (name, i)
        for a, b in zip(_flat(adapter.states[i]), _flat(ref.states[i])):
            assert torch.equal(a, b), (name, i)
    assert not np.array_equal(vw[0].numpy(), ws[0])
