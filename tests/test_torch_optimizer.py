"""The port's per-parameter optimizers against the JAX package's, on the
CPU.

The same weights, gradients and hyperparameters (numpy, from a seed) go
through ``update(index, weight, grad, state)`` of both packages for three
steps.  Tolerance ``rtol = 1e-6, atol = 1e-7``: both perform the same
float32 operations in the same order (XLA may contract a product and a
sum into one FMA, a rounding apart).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu import optimizer as jopt
from mxnet_tpu.ndarray.ndarray import NDArray
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.base import MXNetError

TOL = dict(rtol=1e-6, atol=1e-7)

CASES = {
    "sgd": ("sgd", dict(learning_rate=0.1)),
    "sgd_wd_clip": ("sgd", dict(learning_rate=0.1, wd=0.01,
                                clip_gradient=0.3, rescale_grad=0.5)),
    "momentum": ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.001)),
    "nag": ("nag", dict(learning_rate=0.1, momentum=0.9, wd=0.001)),
    "adam": ("adam", dict(learning_rate=0.01, wd=0.01)),
    "adam_clip": ("adam", dict(learning_rate=0.01, clip_gradient=0.2,
                               beta1=0.8, beta2=0.99, epsilon=1e-6)),
    "adamw": ("adamw", dict(learning_rate=0.01, wd=0.01)),
    "adamw_eta": ("adamw", dict(learning_rate=0.01, wd=0.05, eta=0.5)),
}


def _flat(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _flat(s)]
    return [state]


@pytest.mark.parametrize("case", sorted(CASES))
def test_updates_match_jax(case):
    name, kw = CASES[case]
    rs = np.random.RandomState(len(case))
    w0 = (rs.rand(4, 5) - 0.5).astype("float32")
    grads = [(rs.rand(4, 5) - 0.5).astype("float32") for _ in range(3)]
    jo, to = jopt.create(name, **kw), topt.create(name, **kw)
    jw, tw = NDArray(jnp.asarray(w0)), torch.from_numpy(w0.copy())
    js, ts = jo.create_state(0, jw), to.create_state(0, tw)
    for g in grads:
        jo.update(0, jw, NDArray(jnp.asarray(g)), js)
        to.update(0, tw, torch.from_numpy(g), ts)
        np.testing.assert_allclose(tw.numpy(), jw.asnumpy(), **TOL)
        for a, b in zip(_flat(ts), _flat(js)):
            np.testing.assert_allclose(a.numpy(), b.asnumpy(), **TOL)
    assert to._index_update_count[0] == 3


def test_registry_and_bookkeeping():
    assert isinstance(topt.create("adam"), topt.Adam)
    assert isinstance(topt.create("NAG"), topt.NAG)
    opt = topt.SGD(learning_rate=0.5)
    assert topt.create(opt) is opt
    with pytest.raises(MXNetError):
        topt.create("no_such_optimizer")
    with pytest.raises(TypeError):
        topt.Adam(learning_rat=0.1)
    opt.set_lr_mult({0: 0.1})
    opt.set_wd_mult({"w": 2.0})
    opt.idx2name[1] = "w"
    opt.wd = 0.25
    assert opt._get_lr(0) == pytest.approx(0.05) and opt._get_lr(1) == 0.5
    assert opt._get_wd(1) == 0.5 and opt._get_wd(0) == 0.25
    opt.learning_rate = 0.2
    assert opt.learning_rate == 0.2
    assert topt.bias_correction(0.9, 2) == pytest.approx(0.19, rel=1e-6)
