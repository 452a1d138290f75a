"""Multi-model registry — the model half of the batch tier.

The port of ``mxnet_tpu/serve/registry.py``.  A :class:`ModelEntry`
binds one block to the :class:`~mxnet_tpu_torch.jit.ShapeBucketer` that
bounds the batch shapes it sees, hybridizes it with that bucketer, and
captures the FULL bucket grid at registration (``warm``: one CUDA graph
per shape of ``bucketer.expand``; on the CPU the grid's signatures are
recorded and each forward runs eagerly), so the first real request pays
no capture, kernel build or cuBLAS set-up.  ``warm(background=True)``
captures on a thread of its own while the dispatcher serves, as the JAX
entry compiles; the dispatcher replays the graphs.

The entry also owns the model-shaped halves of the data path: request
normalization, batch -> device placement, the device -> host copy, and
cutting each request's rows back out of the batched output (the inverse
of ``pad_requests``).  The copy back starts right after the forward,
non-blocking into pinned host memory, and a CUDA event is recorded
behind it: the completer thread waits on that event alone, so batch t
retires as soon as its own work is done, not behind batch t+1 that the
dispatcher has queued on the same stream since.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import telemetry as _tel
from ..base import MXNetError
from ..jit import ShapeBucketer

__all__ = ["ModelEntry", "Registry", "default_registry", "normalize_request"]


def _np_leaf(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def normalize_request(args) -> Any:
    """Normalize ``submit(model, *args)`` leaves to host numpy: a single
    arg stays a bare leaf, several become a tuple — the tree shapes
    ``ShapeBucketer.pad_requests`` stacks."""
    if not args:
        raise MXNetError("serve: a request needs at least one array")
    if len(args) == 1 and not isinstance(args[0], (tuple, list)):
        return _np_leaf(args[0])
    if len(args) == 1:
        return tuple(_np_leaf(x) for x in args[0])
    return tuple(_np_leaf(x) for x in args)


def map_tree(o, fn):
    """Apply ``fn`` to every non-container leaf of a tuple/list tree."""
    if isinstance(o, (tuple, list)):
        return type(o)(map_tree(v, fn) for v in o)
    return fn(o)


class Staged:
    """One dispatched batch: its output tree on the host side (pinned
    tensors whose copy may still be running, or the CPU outputs), and the
    CUDA event recorded behind the copy (None on the CPU)."""

    __slots__ = ("host", "event")

    def __init__(self, host, event):
        self.host = host
        self.event = event


def _start_d2h(leaf):
    """Start the copy of a CUDA output leaf into pinned host memory."""
    if not torch.is_tensor(leaf) or leaf.device.type != "cuda":
        return leaf
    dst = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
    dst.copy_(leaf, non_blocking=True)
    return dst


def _host_numpy(leaf):
    if not torch.is_tensor(leaf):
        return leaf
    leaf = leaf.cpu()
    return (leaf.float() if leaf.dtype == torch.bfloat16 else leaf).numpy()


class ModelEntry:
    """One registered model (module docstring).  Serving runs outside any
    ``autograd.record()`` scope, so the port's layers run no dropout and
    BatchNorm normalizes with its running statistics; the block is also
    put in torch's eval mode, for torch's own layers in it."""

    def __init__(self, name: str, block, bucketer=None, sample=None):
        if not isinstance(block, torch.nn.Module):
            raise MXNetError(
                f"serve.register({name!r}): block must be a torch.nn.Module "
                f"(got {type(block).__name__})")
        if isinstance(bucketer, dict):
            bucketer = ShapeBucketer(bucketer)
        if bucketer is None:
            raise MXNetError(
                f"serve.register({name!r}) needs a ShapeBucketer: it bounds "
                "the batch shapes a ragged request stream produces")
        if 0 not in bucketer.spec:
            raise MXNetError(
                f"serve.register({name!r}): the bucketer must bucket axis "
                "0 (the batch axis) — the coalescer's batch size varies "
                "per tick")
        self.name = name
        self.block = block.eval()
        self.bucketer = bucketer
        self.sample = (normalize_request((sample,))
                       if sample is not None else None)
        self.device = getattr(block, "device", None) or \
            next(block.parameters()).device
        self.max_rows: Optional[int] = bucketer.axis_bound(0)
        # the grid's new captures (shapes run, unhybridized): ``warmed``,
        # and ``compiled`` as the JAX entry names it
        self.warmed: Optional[int] = None
        self.compiled: Optional[int] = None
        self.warmup_handle = None
        # attach the bucketer at the hybridize seam unless it already is
        # (a torch module that is no HybridBlock runs eagerly)
        if hasattr(block, "hybridize") and (
                not getattr(block, "_active", False) or
                getattr(block, "_bucketer", None) is not bucketer):
            block.hybridize(bucketer=bucketer)

    # -- warmup -----------------------------------------------------------
    def warm(self, background: bool = False):
        """Capture the full bucket grid (inference mode; ``bucketer.expand``
        of the padded sample).  Returns the number of new captures, or a
        :class:`~mxnet_tpu_torch.gluon.block.WarmupHandle` when
        ``background=True`` (kept on ``warmup_handle`` too).  A block
        that is not hybridized runs once on every shape instead."""
        if self.sample is None:
            raise MXNetError(
                f"serve.register({self.name!r}): warmup needs a sample "
                "request (pass sample=..., or warmup=False)")
        batch, _mask, _slices = self.bucketer.pad_requests(
            [self.sample], with_mask=False)
        args = batch if isinstance(batch, tuple) else (batch,)
        if getattr(self.block, "_active", False):
            with torch.inference_mode():
                res = self.block.warmup(tuple(args), train_mode=False,
                                        background=background)
            if background:
                self.warmup_handle = res
                return res
            self.warmed = self.compiled = res
            return res
        ref = max(args, key=lambda l: l.ndim).shape
        n = 0
        for shape in self.bucketer.expand(ref):
            grid = []
            for leaf in args:
                sh = list(leaf.shape)
                for a in self.bucketer.spec:
                    if a < len(sh):
                        sh[a] = shape[a]
                grid.append(np.zeros(sh, leaf.dtype))
            self.to_host(self(tuple(grid) if isinstance(batch, tuple)
                              else grid[0]))
            n += 1
        self.warmed = self.compiled = n
        return n

    def warmup_done(self) -> bool:
        """True when no background warmup is still capturing (a
        synchronous or skipped warmup counts as done)."""
        return self.warmup_handle is None or self.warmup_handle.done()

    # -- data path --------------------------------------------------------
    def validate(self, req):
        """Cheap admission check against the registration sample (leaf
        count, rank, dtype, unbucketed axis sizes, bucket bounds), so a
        malformed request is refused AT SUBMIT, attributed to its sender,
        instead of failing every request in its coalesced batch.  No
        sample registered -> no check."""
        if self.sample is None:
            return
        s_leaves = self.sample if isinstance(self.sample, tuple) \
            else (self.sample,)
        r_leaves = req if isinstance(req, tuple) else (req,)
        if len(s_leaves) != len(r_leaves):
            raise MXNetError(
                f"serve:{self.name}: request has {len(r_leaves)} array "
                f"leaves, the registered sample has {len(s_leaves)}")
        for j, (s, r) in enumerate(zip(s_leaves, r_leaves)):
            if r.ndim != s.ndim:
                raise MXNetError(
                    f"serve:{self.name}: leaf {j} rank {r.ndim} != "
                    f"sample rank {s.ndim} (requests carry NO batch "
                    "axis — the coalescer stacks them)")
            if r.dtype != s.dtype:
                raise MXNetError(
                    f"serve:{self.name}: leaf {j} dtype {r.dtype} != "
                    f"sample dtype {s.dtype}")
            for a in range(r.ndim):
                pol = self.bucketer.spec.get(a + 1)
                if pol is None:
                    if r.shape[a] != s.shape[a]:
                        raise MXNetError(
                            f"serve:{self.name}: leaf {j} axis {a} size "
                            f"{r.shape[a]} != sample size {s.shape[a]} "
                            f"and stacked axis {a + 1} has no bucket "
                            "policy — ragged requests need one")
                else:
                    pol.bucket(r.shape[a])  # raises past a bounded grid

    def pad_requests(self, requests: List[Any]):
        # no mask on the serving path: models consume valid-length leaves
        return self.bucketer.pad_requests(requests, with_mask=False)

    def __call__(self, batch) -> Staged:
        """Run one coalesced batch: H2D with ``torch.as_tensor(...,
        device=)``, the forward, then the non-blocking copy of every CUDA
        output leaf into pinned host memory and an event behind it.
        Returns at once; :meth:`to_host` waits."""
        leaves = batch if isinstance(batch, tuple) else (batch,)
        with torch.inference_mode():
            out = self.block(*(torch.as_tensor(l, device=self.device)
                               for l in leaves))
            host = map_tree(out, _start_d2h)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return Staged(host, event)

    @staticmethod
    def to_host(out: Staged):
        """Wait for the batch's copy to the host, then its output tree as
        numpy (views of the pinned buffers: no second host copy).  numpy
        has no bfloat16 of its own, so a bf16 leaf comes back as f32 with
        the same values (the JAX package hands out the ``bfloat16`` type
        of the package it depends on, which the port does not import)."""
        if out.event is not None:
            out.event.synchronize()
        return map_tree(out.host, _host_numpy)

    def slice_out(self, np_out, sl: Tuple, ref_shape: Tuple[int, ...]):
        """Cut request ``sl``'s rows out of a batched host output tree.

        Axis 0 is indexed by the request's row whenever the leaf carries
        the batch axis (size == padded rows).  A later output axis
        ``k - 1`` is sliced back to the request's valid size (``sl[k]``)
        iff stacked axis ``k`` HAS a bucket policy — only policy axes are
        ever padded — AND the output axis still carries the padded extent
        (size == ``ref_shape[k]``).  Both are batch-level facts, so every
        request of a batch gets the same cut decision per leaf axis.  An
        output dimension that happens to equal the padded extent of a
        policy axis at the same position is cut too: pick bucket sizes
        that avoid it."""
        b_pad = ref_shape[0]
        spec = self.bucketer.spec

        def cut(leaf):
            if getattr(leaf, "ndim", 0) < 1 or leaf.shape[0] != b_pad:
                return leaf  # no batch axis: shared across the batch
            row = leaf[sl[0]]
            for k in range(1, len(sl)):
                if (k in spec and row.ndim >= k
                        and row.shape[k - 1] == ref_shape[k]):
                    row = row[(slice(None),) * (k - 1) + (sl[k],)]
            return row

        return map_tree(np_out, cut)


class Registry:
    """Thread-safe name -> :class:`ModelEntry` map."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, ModelEntry] = {}

    def register(self, name: str, block, bucketer=None, sample=None,
                 warmup: bool = True, background: bool = False,
                 lint_budget=None, precision=None) -> ModelEntry:
        """Register (or replace) a model.  ``warmup=True`` (default)
        captures the full bucket grid before the entry goes live;
        ``background=True`` captures it on a thread of its own (call
        ``entry.warmup_handle.wait()`` before traffic where the
        no-capture guarantee matters).
        ``precision="int8"`` (post-training quantization) and
        ``lint_budget`` (the graph lint) are not ported yet and raise."""
        if precision is not None:
            raise MXNetError(
                f"serve.register({name!r}): precision={precision!r} needs "
                "contrib/quantization, not ported yet (ROADMAP A6); the "
                "batch tier serves the model in its own dtype")
        if lint_budget is not None:
            raise MXNetError(
                f"serve.register({name!r}): lint_budget needs the graph "
                "lint of analysis/, not ported yet (ROADMAP A6)")
        entry = ModelEntry(name, block, bucketer, sample)
        if warmup:
            entry.warm(background=background)
        with self._lock:
            self._entries[name] = entry
            n = len(self._entries)
        if _tel._ENABLED:
            _tel.set_gauge("serve.models", n)
        return entry

    def unregister(self, name: str):
        with self._lock:
            self._entries.pop(name, None)
            n = len(self._entries)
        if _tel._ENABLED:
            _tel.set_gauge("serve.models", n)

    def get(self, name: str) -> ModelEntry:
        with self._lock:
            e = self._entries.get(name)
            have = sorted(self._entries)
        if e is None:
            raise MXNetError(
                f"serve: no model {name!r} registered (have {have})")
        return e

    def models(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)


_DEFAULT = Registry()


def default_registry() -> Registry:
    """The process-global registry the module-level serve API uses."""
    return _DEFAULT
