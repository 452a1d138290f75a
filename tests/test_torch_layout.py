"""The port's ``parallel.layout`` against the JAX package's, on the same
seeded boxes: every function returns what the JAX one returns, a copy
plan over a disjoint layout rebuilds any target (``cover_volume`` the
witness), and ``scatter_into`` writes numpy arrays and torch tensors
alike (nothing where the boxes are disjoint)."""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from mxnet_tpu.base import MXNetError as JaxMXNetError
from mxnet_tpu.parallel import layout as jlay

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import layout as tlay

SEEDS = range(6)


def _box(rs, shape):
    """A random box inside ``shape`` (possibly empty on a dim), from a
    seed."""
    out = []
    for d in shape:
        a, b = sorted(rs.randint(0, d + 1, size=2))
        out.append((int(a), int(b)))
    return tuple(out)


def _pair(seed, ndim=3):
    rs = np.random.RandomState(seed)
    shape = tuple(int(x) for x in rs.randint(2, 9, size=ndim))
    return shape, _box(rs, shape), _box(rs, shape)


@pytest.mark.parametrize("seed", SEEDS)
def test_box_algebra_equals_jax(seed):
    shape, a, b = _pair(seed)
    assert tlay.intersect_box(a, b) == jlay.intersect_box(a, b)
    assert tlay.box_shape(a) == jlay.box_shape(a)
    assert tlay.box_volume(a) == jlay.box_volume(a)
    pad = tuple(d + 3 for d in shape)
    big = tuple((x, min(y + 3, p)) for (x, y), p in zip(a, pad))
    assert tlay.clip_box(big, shape) == jlay.clip_box(big, shape)
    inter = jlay.intersect_box(a, b)
    if inter is not None:
        assert tlay.rel_slices(a, inter) == jlay.rel_slices(a, inter)
    index = tuple(slice(x, y) for x, y in a[:2])
    assert tlay.box_of(index, shape) == jlay.box_of(index, shape)


def test_box_of_and_clip_edges_equal_jax():
    shape = (8, 6)
    for index in [(slice(2, 5), slice(None)), (slice(0, 4),),
                  (slice(-3, None), slice(None, 2))]:
        assert tlay.box_of(index, shape) == jlay.box_of(index, shape)
    with pytest.raises(MXNetError):
        tlay.box_of((slice(0, 8, 2),), shape)
    with pytest.raises(JaxMXNetError):
        jlay.box_of((slice(0, 8, 2),), shape)
    for box, ext in [(((8, 16),), (10,)), (((12, 16),), (10,)),
                     (((0, 4), (6, 9)), (8, 6))]:
        assert tlay.clip_box(box, ext) == jlay.clip_box(box, ext)
    # edge-touching boxes do not intersect
    assert tlay.intersect_box(((0, 4), (2, 8)), ((4, 8), (0, 4))) is None


def _grid_layout(shape, splits):
    edges = []
    for d, cuts in zip(shape, splits):
        pts = [0] + sorted(cuts) + [d]
        edges.append(list(zip(pts, pts[1:])))
    return [tuple(b) for b in itertools.product(*edges)]


TARGETS = [((0, 12), (0, 10)), ((3, 8), (2, 9)), ((5, 6), (4, 5)),
           ((9, 12), (0, 4))]


@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("target", TARGETS, ids=lambda t: str(t))
def test_copy_plan_rebuilds_any_target_as_jax(kind, target):
    rs = np.random.RandomState(3)
    shape = (12, 10)
    full = rs.randn(*shape).astype("float32")
    whole = ((0, shape[0]), (0, shape[1]))
    sources = _grid_layout(shape, [(5, 9), (4,)])
    pieces = [full[jlay.rel_slices(whole, b)] for b in sources]
    plan = tlay.copy_plan(target, sources)
    assert plan == jlay.copy_plan(target, sources)
    assert tlay.cover_volume(target, sources) == \
        jlay.cover_volume(target, sources) == tlay.box_volume(target)
    if kind == "torch":
        got = torch.full(tlay.box_shape(target), float("nan"))
        pieces = [torch.from_numpy(p.copy()) for p in pieces]
    else:
        got = np.full(tlay.box_shape(target), np.nan, "float32")
    copied = sum(tlay.scatter_into(got, target, sources[i], pieces[i])
                 for i, _ in plan)
    assert copied == tlay.box_volume(target)
    want = np.full(jlay.box_shape(target), np.nan, "float32")
    for i, _ in plan:
        jlay.scatter_into(want, target, sources[i],
                          full[jlay.rel_slices(whole, sources[i])])
    np.testing.assert_array_equal(np.asarray(got), want)
    np.testing.assert_array_equal(np.asarray(got),
                                  full[jlay.rel_slices(whole, target)])


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_scatter_into_disjoint_is_noop(kind):
    if kind == "torch":
        out, data = torch.zeros(4, 4), torch.ones(4, 4)
    else:
        out, data = np.zeros((4, 4)), np.ones((4, 4))
    n = tlay.scatter_into(out, ((0, 4), (0, 4)), ((4, 8), (0, 4)), data)
    assert n == 0 == jlay.scatter_into(np.zeros((4, 4)), ((0, 4), (0, 4)),
                                       ((4, 8), (0, 4)), np.ones((4, 4)))
    assert float(out.sum()) == 0


def test_partial_cover_volume_equals_jax():
    sources = [((0, 4), (0, 4)), ((4, 8), (0, 2))]
    target = ((2, 6), (0, 4))
    assert tlay.cover_volume(target, sources) == \
        jlay.cover_volume(target, sources) == 12
    assert tlay.cover_volume(target, sources) < tlay.box_volume(target)
