"""N-d box algebra and slice-mapped redistribution: the port's copy of
``mxnet_tpu/parallel/layout.py``.

A *box* is ``((start, stop), ...)`` per dimension, in the logical
coordinates of the leaf it describes; the boxes of a layout are disjoint
and (for a complete layout) cover the extent exactly.  The port plans
two moves with it:

* **prefill->decode cache shipment** (:mod:`~mxnet_tpu_torch.serve.
  decode`): :func:`intersect_box` over the capacity axis gives the page
  window the ``_CacheMover`` graph copies from a prefill's
  ``(1, H, C_src, dh)`` row cache into the batch's ``(S, H, C_dst, dh)``;
* **prefix-cache assembly** (:mod:`~mxnet_tpu_torch.serve.prefix`):
  retained block pages scatter into a fresh row cache through
  :func:`scatter_into`.

Everything here is integer arithmetic plus one sliced assignment;
:func:`scatter_into` takes numpy arrays and torch tensors alike (on the
card its copy runs there).
"""
from __future__ import annotations

from typing import Any, Iterable, List, Optional, Sequence, Tuple

from ..base import MXNetError

__all__ = ["Box", "box_of", "clip_box", "intersect_box", "box_shape",
           "box_volume", "rel_slices", "copy_plan", "scatter_into",
           "cover_volume"]

#: an N-d box: ``((start, stop), ...)`` per dim, in leaf-logical coords
Box = Tuple[Tuple[int, int], ...]


def box_of(index, shape: Sequence[int]) -> Box:
    """Normalize an index (a tuple of slices, shorter than ``shape`` for
    unsliced trailing dims) into a concrete box over ``shape``."""
    out = []
    for k, d in enumerate(shape):
        s = index[k] if k < len(index) else slice(None)
        start, stop, step = s.indices(int(d))
        if step != 1:
            raise MXNetError(f"non-unit-stride shard index {s!r} is not "
                             "redistribution-compatible")
        out.append((start, stop))
    return tuple(out)


def clip_box(box: Box, shape: Sequence[int]) -> Optional[Box]:
    """Clip ``box`` to ``shape`` (the unpadded logical extent); None when
    the box lies entirely inside the padding."""
    out = []
    for (a, b), d in zip(box, shape):
        a, b = min(a, int(d)), min(b, int(d))
        if a >= b:
            return None
        out.append((a, b))
    return tuple(out)


def intersect_box(a: Box, b: Box) -> Optional[Box]:
    """The common sub-box of ``a`` and ``b``, or None when disjoint."""
    out = []
    for (a0, a1), (b0, b1) in zip(a, b):
        lo, hi = max(a0, b0), min(a1, b1)
        if lo >= hi:
            return None
        out.append((lo, hi))
    return tuple(out)


def box_shape(box: Box) -> Tuple[int, ...]:
    """The extent of ``box`` per dimension."""
    return tuple(b - a for a, b in box)


def box_volume(box: Box) -> int:
    """Number of elements inside ``box``."""
    n = 1
    for a, b in box:
        n *= b - a
    return n


def rel_slices(outer: Box, inner: Box) -> Tuple[slice, ...]:
    """``inner`` as index slices relative to ``outer``'s origin — the
    indexing form both sides of a slice copy use (read the piece out of
    its source box, write it into its target box)."""
    return tuple(slice(i0 - o0, i1 - o0)
                 for (o0, _), (i0, i1) in zip(outer, inner))


def copy_plan(target: Box, sources: Sequence[Box]
              ) -> List[Tuple[int, Box]]:
    """Which source boxes a copy into ``target`` must touch: ``(index
    into sources, intersection box)`` per intersecting source, in
    source order.  The planning half of a redistribution — the caller
    fetches each listed source (checkpoint slice read, device page
    window, retained prefix block) and scatters the intersection."""
    out: List[Tuple[int, Box]] = []
    for i, s in enumerate(sources):
        inter = intersect_box(s, target)
        if inter is not None:
            out.append((i, inter))
    return out


def scatter_into(out: Any, out_box: Box, src_box: Box, data: Any) -> int:
    """Write the part of ``data`` (covering ``src_box``) that intersects
    ``out_box`` into ``out`` (covering ``out_box``); returns the copied
    volume (0 when disjoint).  ``out`` and ``data`` are numpy arrays or
    torch tensors (a tensor on the card copies there) — the execution
    half of a redistribution plan."""
    inter = intersect_box(src_box, out_box)
    if inter is None:
        return 0
    out[rel_slices(out_box, inter)] = data[rel_slices(src_box, inter)]
    return box_volume(inter)


def cover_volume(target: Box, sources: Iterable[Box]) -> int:
    """Total volume of ``target`` covered by ``sources`` (assumed
    disjoint) — the completeness check a lossless redistribution
    asserts: ``cover_volume(box, layout) == box_volume(box)``."""
    total = 0
    for s in sources:
        inter = intersect_box(s, target)
        if inter is not None:
            total += box_volume(inter)
    return total
