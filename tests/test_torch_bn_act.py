"""The port's batch-norm + activation op against the JAX package's, on
the CPU, and the convolution, pooling and batch-norm ops around it.

The same seeded numpy inputs go through ``mxnet_tpu.kernels.bn_act``
(the Pallas stats and apply kernels in interpret mode, as
``tests/test_kernels.py`` runs them) and through the port's
``kernels.bn_act`` (its plain versions, since the tensors lie on the
CPU).  Tolerances: y, mean and var within 1e-5 (f32 sums in another
order); gradients within 2e-4 of ``jax.grad`` (the bar the JAX package
holds its own fused BN gradient to); the composed ops within 1e-5, the
convolutions within 1e-5 (f32, another summation order).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.kernels import bn_act as jbn
from mxnet_tpu.kernels import registry as jkreg
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import bn_act as tbn
from mxnet_tpu_torch.ops import nn as tnn

TOL = 1e-5
GRAD_TOL = 2e-4


def _inputs(shape, seed, offset=0.0):
    rs = np.random.RandomState(seed)
    c = shape[-1]
    x = (rs.rand(*shape).astype("f4") * 2 - 1 + offset).astype("f4")
    gamma = (rs.rand(c) + 0.5).astype("f4")
    beta = (rs.rand(c) - 0.5).astype("f4")
    return x, gamma, beta


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("act", ["relu", "identity"])
@pytest.mark.parametrize("shape,offset", [((4, 4, 4, 16), 0.0),
                                          ((2, 8, 8, 8), 3.0),
                                          ((8, 2, 2, 12), -1.5)])
def test_forward_matches_interpret_kernel(act, shape, offset):
    x, gamma, beta = _inputs(shape, seed=shape[-1], offset=offset)
    y, mean, var = jbn.bn_act_train(jnp.asarray(x), jnp.asarray(gamma),
                                    jnp.asarray(beta), 1e-5, act, True)
    ty, tmean, tvar = tbn.bn_act_train(_t(x), _t(gamma), _t(beta), 1e-5,
                                       act)
    for got, want in ((ty, y), (tmean, mean), (tvar, var)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("act", ["relu", "identity"])
@pytest.mark.parametrize("through_stats", [False, True],
                         ids=["y", "y+stats"])
def test_gradients_match_jax_grad(act, through_stats):
    x, gamma, beta = _inputs((2, 4, 4, 8), seed=2, offset=0.5)
    rs = np.random.RandomState(3)
    w, wm, wv = (rs.rand(*s).astype("f4") - 0.5
                 for s in ((2, 4, 4, 8), (8,), (8,)))
    k = 1.0 if through_stats else 0.0

    def jloss(x, g, b):
        y, m, v = jbn.bn_act_train(x, g, b, 1e-5, act, True)
        return (y * w).sum() + k * ((m * wm).sum() + (v * wv).sum())

    want = jax.grad(jloss, (0, 1, 2))(jnp.asarray(x), jnp.asarray(gamma),
                                      jnp.asarray(beta))
    leaves = [_t(a).requires_grad_() for a in (x, gamma, beta)]
    y, m, v = tbn.bn_act_train(*leaves, 1e-5, act)
    loss = (y * _t(w)).sum()
    if through_stats:
        loss = loss + (m * _t(wm)).sum() + (v * _t(wv)).sum()
    loss.backward()
    for leaf, ref in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


def test_rows_jax_cannot_tile_take_the_kernel_path():
    """1x3x3x8 has 9 rows, which no preferred block divides: the JAX
    package falls back to its composition, the port's kernels (here
    their plain versions) take any row count."""
    x, gamma, beta = _inputs((1, 3, 3, 8), seed=5)
    rm = np.linspace(-0.2, 0.2, 8).astype("f4")
    rv = np.linspace(0.5, 1.5, 8).astype("f4")
    with jkreg.override("interpret"), pytest.warns(RuntimeWarning,
                                                   match="tile-able"):
        want = jnn.batch_norm_act_train(
            jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
            jnp.asarray(rm), jnp.asarray(rv), axis=-1)
    got = tnn.batch_norm_act_train(_t(x), _t(gamma), _t(beta), _t(rm),
                                   _t(rv), axis=-1)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("axis,act", [(-1, "relu"), (3, "identity"),
                                      (1, "relu"), (-1, "tanh")])
def test_batch_norm_act_train_matches_jax(axis, act):
    """The kernel path (channel-last, relu / identity) and the composed
    fallbacks (channel-first, another activation) against the JAX
    dispatch, moving statistics included."""
    x, gamma, beta = _inputs((2, 4, 4, 8), seed=7, offset=1.0)
    if axis == 1:
        x = np.ascontiguousarray(np.moveaxis(x, -1, 1))
    c = gamma.shape[0]
    rm = np.full(c, 0.1, "f4")
    rv = np.full(c, 0.9, "f4")
    with jkreg.override("interpret"):
        want = jnn.batch_norm_act_train(
            jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
            jnp.asarray(rm), jnp.asarray(rv), axis=axis, act_type=act)
    got = tnn.batch_norm_act_train(_t(x), _t(gamma), _t(beta), _t(rm),
                                   _t(rv), axis=axis, act_type=act)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("fix_gamma,use_global", [(False, False),
                                                  (True, False),
                                                  (False, True)])
def test_batch_norm_train_and_infer_match_jax(fix_gamma, use_global):
    x, gamma, beta = _inputs((3, 5, 5, 6), seed=11, offset=0.3)
    rm = np.linspace(-0.5, 0.5, 6).astype("f4")
    rv = np.linspace(0.5, 2.0, 6).astype("f4")
    jargs = [jnp.asarray(a) for a in (x, gamma, beta, rm, rv)]
    targs = [_t(a) for a in (x, gamma, beta, rm, rv)]
    want = jnn.batch_norm_train(*jargs, axis=-1, momentum=0.8,
                                fix_gamma=fix_gamma,
                                use_global_stats=use_global)
    got = tnn.batch_norm_train(*targs, axis=-1, momentum=0.8,
                               fix_gamma=fix_gamma,
                               use_global_stats=use_global)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    want = jnn.batch_norm_infer(*jargs, axis=-1, fix_gamma=fix_gamma)
    got = tnn.batch_norm_infer(*targs, axis=-1, fix_gamma=fix_gamma)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_one_pass_variance_clamps_a_constant_channel():
    x = np.random.RandomState(1).rand(37, 5).astype("f4")
    x[:, 2] = 0.1                   # constant: var -> 0, never negative
    x[:, 4] += 3.0                  # offset mean
    mean, var, _, _ = tbn.bn_stats_plain(_t(x), torch.ones(5),
                                         torch.zeros(5), 1e-5)
    x64 = x.astype("f8")
    np.testing.assert_allclose(mean.numpy(), x64.mean(0), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(var.numpy(), x64.var(0), rtol=0,
                               atol=1e-5 * (x64 ** 2).mean(0).max())
    assert float(var[2]) >= 0.0 and float(var[2]) < 1e-6
    y, m, v = tbn.bn_act_train(_t(x), torch.ones(5), torch.zeros(5), 1e-5,
                               "identity")
    assert torch.isfinite(y).all()
    assert float(y[:, 2].abs().max()) < 1e-3


@pytest.mark.parametrize("rows,c,sms", [(1, 3, 132), (9, 8, 132),
                                        (4097, 64, 132), (1605632, 64, 132),
                                        (6272, 2048, 132), (1000003, 64, 2),
                                        (5, 2048, 1), (100, 1, 132)])
def test_plan_covers_every_row_and_channel(rows, c, sms):
    p = tbn.plan(rows, c, sms)
    assert p.vec == (4 if c % 4 == 0 else 1)
    assert 1 <= p.tx <= 32 and 256 % p.tx == 0
    assert p.col_blocks * p.tx * p.vec >= c
    assert (p.col_blocks - 1) * p.tx * p.vec < c
    assert p.splits * p.rows_per_split >= rows
    assert (p.splits - 1) * p.rows_per_split < rows
    assert 1 <= p.splits <= 65535
    assert p.splits * p.col_blocks < 4 * sms + p.col_blocks


@pytest.mark.parametrize("rows,c", [(1605632, 64), (401408, 64),
                                    (100352, 128), (25088, 256), (6272, 512),
                                    (4097, 77), (9, 3)])
def test_stats_plan_reads_narrow_column_blocks(rows, c):
    """The stats kernel's grid: every row and channel covered, at most
    STATS_COLS columns a block, so its last-arriver combine (2 CB sums
    over 256 threads) has at least 8 threads a sum."""
    p = tbn.plan(rows, c, 132, tbn.STATS_COLS)
    assert p.tx * p.vec <= tbn.STATS_COLS
    assert 256 // (2 * p.tx * p.vec) >= 8
    assert p.col_blocks * p.tx * p.vec >= c
    assert p.splits * p.rows_per_split >= rows
    assert (p.splits - 1) * p.rows_per_split < rows


def test_wrappers_refuse_other_devices_and_activations():
    x = torch.zeros(4, 8, device="meta")
    with pytest.raises(MXNetError):
        tbn.bn_stats(x, torch.ones(8, device="meta"),
                     torch.zeros(8, device="meta"), 1e-5)
    with pytest.raises(MXNetError):
        tbn.bn_apply(x, torch.zeros(8, device="meta"),
                     torch.zeros(8, device="meta"), "relu")
    with pytest.raises(MXNetError, match="not fused"):
        tbn.bn_apply(torch.zeros(4, 8), torch.zeros(8), torch.zeros(8),
                     "tanh")
    with pytest.raises(MXNetError, match="empty"):
        tbn.plan(0, 8, 132)


@pytest.mark.parametrize("shape,offset", [((4, 4, 4, 16), 0.0),
                                          ((8, 2, 2, 12), -0.5),
                                          ((2, 8, 8, 8), 0.25)])
def test_stats_fold_matches_jax_scale_and_shift(monkeypatch, shape, offset):
    """The plain stats-and-fold (the kernel's signature on the CPU)
    against the scale and shift the JAX package's ``_bn_act_fwd_impl``
    hands its apply kernel (Pallas, interpret mode): within 1e-6 of
    |scale|, and of the larger of |beta| and |mean * gamma * inv| for
    shift, a difference of those two terms."""
    seen = {}
    apply = jbn._apply_pallas

    def spy(x2d, scale, shift, *rest):
        seen["scale"], seen["shift"] = np.asarray(scale), np.asarray(shift)
        return apply(x2d, scale, shift, *rest)

    monkeypatch.setattr(jbn, "_apply_pallas", spy)
    x, gamma, beta = _inputs(shape, seed=shape[-1] + 7, offset=offset)
    jbn._bn_act_fwd_impl(jnp.asarray(x), jnp.asarray(gamma),
                         jnp.asarray(beta), 1e-5, "relu", True)
    c = shape[-1]
    mean, var, scale, shift = tbn.bn_stats_plain(
        _t(x).reshape(-1, c), _t(gamma), _t(beta), 1e-5)
    np.testing.assert_allclose(scale.numpy(), seen["scale"], rtol=1e-6,
                               atol=0)
    big = np.maximum(np.abs(beta), np.abs((mean * scale).numpy()))
    assert (np.abs(shift.numpy() - seen["shift"]) <= 1e-6 * big).all()


def _combine_in_kernel_order(part, paired):
    """The stats kernel's last-arriver combine of one column block's
    partials ``part`` (splits, 2, CB), in float64: each sum has G threads
    (G = 256 / CB where neighbouring sums go in pairs, C and CB even; else
    256 / (2 CB)), thread j adding splits j, j + G, ... in turn, then the
    G sums added in order (``bn_act.cu``)."""
    splits, cb = part.shape[0], part.shape[2]
    g = 256 // cb if paired else 256 // (2 * cb)
    red = np.zeros((g, 2, cb))
    for j in range(g):
        for i in range(j, splits, g):
            red[j] = red[j] + part[i]
    out = red[0]
    for j in range(1, g):
        out = out + red[j]
    return out


def _emulate_stats_fold(x, gamma, beta, eps, p, order):
    """The one-launch stats kernel on the CPU for the plan ``p``: blocks
    (column block, split) finish in ``order``; each writes its split's
    float64 partial (its rows summed in one fixed order: here each thread
    row's rows in turn, then the thread rows in order) and takes a
    ticket; the block that draws the last ticket of its column block
    combines that block's partials (``_combine_in_kernel_order``) and
    folds them."""
    rows, c = x.shape
    ty_rows = 256 // p.tx
    xd = x.astype(np.float64)
    part = np.empty((p.splits, 2, c))
    tickets = [0] * p.col_blocks
    sums = np.empty((2, c))
    for cb, sp in order:
        r0, r1 = sp * p.rows_per_split, min(rows, (sp + 1) * p.rows_per_split)
        blk = xd[r0:r1]
        red = np.zeros((ty_rows, 2, c))
        for ty in range(min(ty_rows, len(blk))):   # rows in turn (d * d is
            mine = blk[ty::ty_rows]                 # exact in float64)
            red[ty, 0] = np.cumsum(mine, axis=0)[-1]
            red[ty, 1] = np.cumsum(mine * mine, axis=0)[-1]
        part[sp] = np.cumsum(red, axis=0)[-1]
        tickets[cb] += 1
        if tickets[cb] == p.splits:             # the last to arrive
            width = p.tx * p.vec
            blk = np.zeros((p.splits, 2, width))   # columns past C: zeros
            got = part[:, :, cb * width:(cb + 1) * width]
            blk[:, :, :got.shape[2]] = got
            sums[:, cb * width:(cb + 1) * width] = \
                _combine_in_kernel_order(blk, c % 2 == 0 and width % 2 == 0)[
                    :, :got.shape[2]]
    mean = (sums[0] / rows).astype(np.float32)
    var = np.maximum(sums[1] / rows - (sums[0] / rows) ** 2,
                     0.0).astype(np.float32)
    inv = (1.0 / np.sqrt(np.float64(var + np.float32(eps)))).astype(
        np.float32)
    return mean, var, gamma * inv, beta - mean * gamma * inv


@pytest.mark.parametrize("rows,c,sms", [(20011, 12, 3), (6000, 40, 2),
                                        (3000, 3, 5), (3000, 130, 8)])
def test_last_arriver_combine_gives_the_same_bits_in_any_order(rows, c, sms):
    """Whichever block arrives last combines its column block's partials
    in the same fixed order, so every arrival order gives the same bits
    (and the plain version's statistics and fold within 1e-6, float64
    sums in other orders); a combine that summed in arrival order would
    differ between orders."""
    x, gamma, beta = _inputs((rows, c), seed=rows, offset=2.0)
    p = tbn.plan(rows, c, sms, tbn.STATS_COLS)
    assert p.splits > 1
    blocks = [(cb, sp) for sp in range(p.splits)
              for cb in range(p.col_blocks)]
    rs = np.random.RandomState(c)
    runs = [_emulate_stats_fold(x, gamma, beta, 1e-5, p, order) for order in
            [blocks, blocks[::-1]] + [[blocks[i] for i in rs.permutation(
                len(blocks))] for _ in range(4)]]
    for run in runs[1:]:
        for a, b in zip(run, runs[0]):
            assert np.array_equal(a, b)
    want = tbn.bn_stats_plain(_t(x), _t(gamma), _t(beta), 1e-5)
    for a, b in zip(runs[0], want):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-6, atol=1e-6)
    # what the fixed order guards against: sums of squares (f32 values
    # sum exactly in float64, their squares do not) in arrival order
    xd = x.astype(np.float64)
    rps = p.rows_per_split
    parts = [(xd[i * rps:(i + 1) * rps] ** 2).sum(0)
             for i in range(p.splits)]
    arrival = {tuple(np.sum([parts[i] for i in rs.permutation(p.splits)],
                            axis=0).tolist()) for _ in range(8)}
    assert len(arrival) > 1


# ------------------------------------------------- convolution, pooling
@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
@pytest.mark.parametrize("k,stride,pad,groups", [(3, 1, 1, 1), (7, 2, 3, 1),
                                                 (1, 2, 0, 1), (3, 1, 1, 2)])
def test_convolution_matches_jax(layout, k, stride, pad, groups):
    rs = np.random.RandomState(k * 10 + stride)
    x = rs.rand(2, 9, 9, 4).astype("f4") - 0.5            # NHWC
    w = rs.rand(6, k, k, 4 // groups).astype("f4") - 0.5  # OHWI
    b = rs.rand(6).astype("f4")
    if layout == "NCHW":
        x = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
        w = np.ascontiguousarray(w.transpose(0, 3, 1, 2))
    want = jnn.convolution(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           stride=stride, pad=pad, num_group=groups,
                           layout=layout)
    got = tnn.convolution(_t(x), _t(w), _t(b), stride=stride, pad=pad,
                          num_group=groups, layout=layout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
@pytest.mark.parametrize("kw", [
    dict(kernel=3, stride=2, pad=1, pool_type="max"),
    dict(kernel=2, pool_type="max"),
    dict(kernel=3, stride=2, pad=1, pool_type="avg"),
    dict(kernel=3, stride=1, pad=1, pool_type="avg", count_include_pad=False),
    dict(global_pool=True, pool_type="avg"),
    dict(global_pool=True, pool_type="max")], ids=str)
def test_pooling_matches_jax(layout, kw):
    x = np.random.RandomState(4).rand(2, 7, 7, 3).astype("f4") - 0.5
    if layout == "NCHW":
        x = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    want = jnn.pooling(jnp.asarray(x), layout=layout, **kw)
    got = tnn.pooling(_t(x), layout=layout, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_unported_pooling_and_layouts_raise():
    x = torch.zeros(1, 4, 4, 2)
    for kw in (dict(pool_type="lp"), dict(pool_type="sum"),
               dict(pooling_convention="same"), dict(layout="NCDHW")):
        with pytest.raises(MXNetError):
            tnn.pooling(x, kernel=2, **kw)
    with pytest.raises(MXNetError, match="2-D"):
        tnn.convolution(torch.zeros(1, 2, 5), torch.zeros(1, 2, 3))
