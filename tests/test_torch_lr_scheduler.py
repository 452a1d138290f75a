"""The port's learning-rate schedulers against the JAX package's, on the
CPU: ``lr(t)`` for t in 0..50 equals the JAX value exactly (both are the
same Python float arithmetic), for every class with linear and constant
warmup; and an optimizer with a schedule reads it with its update count
in both packages.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu import lr_scheduler as jlrs
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.ndarray.ndarray import NDArray
from mxnet_tpu_torch import lr_scheduler as tlrs
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.base import MXNetError

SCHEDULERS = {
    "factor": ("FactorScheduler", dict(step=7, factor=0.5, base_lr=0.1)),
    "multifactor": ("MultiFactorScheduler",
                    dict(step=[5, 17, 30], factor=0.3, base_lr=0.2)),
    "poly": ("PolyScheduler", dict(max_update=40, base_lr=0.1, pwr=2,
                                   final_lr=1e-3)),
    "cosine": ("CosineScheduler", dict(max_update=45, base_lr=0.1,
                                       final_lr=1e-4)),
}


@pytest.mark.parametrize("warmup", ["linear", "constant"])
@pytest.mark.parametrize("case", sorted(SCHEDULERS))
def test_lr_schedulers_equal_jax_exactly(case, warmup):
    cls, kw = SCHEDULERS[case]
    kw = dict(kw, warmup_steps=6, warmup_begin_lr=0.01, warmup_mode=warmup)
    js, ts = getattr(jlrs, cls)(**kw), getattr(tlrs, cls)(**kw)
    assert [ts(t) for t in range(51)] == [js(t) for t in range(51)]

def test_scheduler_arguments_are_checked_as_in_jax():
    with pytest.raises(MXNetError):
        tlrs.FactorScheduler(step=0)
    with pytest.raises(MXNetError):
        tlrs.MultiFactorScheduler(step=[5, 3])
    with pytest.raises(MXNetError):
        tlrs.PolyScheduler(max_update=10, warmup_mode="cubic")


@pytest.mark.parametrize("name", ["sgd", "adam", "lamb"])
def test_optimizer_reads_its_schedule_with_the_update_count(name):
    kw = dict(step=2, factor=0.5, warmup_steps=1, warmup_begin_lr=0.01)
    rs = np.random.RandomState(3)
    w0 = (rs.rand(3, 4) - 0.5).astype("float32")
    grads = [(rs.rand(3, 4) - 0.5).astype("float32") for _ in range(6)]
    jo = jopt.create(name, learning_rate=0.1,
                     lr_scheduler=jlrs.FactorScheduler(**kw))
    to = topt.create(name, learning_rate=0.1,
                     lr_scheduler=tlrs.FactorScheduler(**kw))
    assert to.lr_scheduler.base_lr == 0.1
    jw, tw = NDArray(jnp.asarray(w0)), torch.from_numpy(w0.copy())
    js, ts = jo.create_state(0, jw), to.create_state(0, tw)
    for g in grads:
        jo.update(0, jw, NDArray(jnp.asarray(g)), js)
        to.update(0, tw, torch.from_numpy(g), ts)
        assert to.learning_rate == jo.learning_rate
        np.testing.assert_allclose(tw.numpy(), jw.asnumpy(), rtol=1e-6,
                                   atol=1e-7)
    assert to.num_update == 6
    with pytest.raises(MXNetError, match="LRScheduler"):
        to.set_learning_rate(0.2)
    resumed = topt.create(name, learning_rate=0.1, begin_num_update=6,
                          lr_scheduler=tlrs.FactorScheduler(**kw))
    assert resumed.learning_rate == to.learning_rate
