"""The trainer of the port: ``ShardedTrainer``, on one device or a data-
parallel mesh of ranks.

The port of ``mxnet_tpu/parallel/trainer.py`` along its ``dp`` axis.  A
step mirrors the JAX package's ``loss_of`` and ``apply_update``: ``loss =
mean(loss_fn(net(*x), y))``, the backward pass, then the optimizer
update through one of these adapters:

* :class:`_ArenaOptAdapter` (the default for exact ``SGD`` / ``NAG`` /
  ``Adam`` with f32 parameters and uniform lr/wd multipliers): weight
  decay and clipping are folded into each gradient, ONE launch of the
  flat-arena kernel (``kernels/opt_arena.py``) updates every element and
  its state arenas, and ``p += delta`` is applied per leaf;
* :class:`_FusedOptAdapter` (``multi_tensor=True``, any registry
  optimizer): parameters that share shape, dtype, state structure, lr /
  wd multipliers and state shapes form a group, and ONE
  ``torch.func.vmap`` of the optimizer's own ``update`` updates a group,
  so norm-based optimizers (LAMB, LARS, LANS, LBSGD) keep one norm per
  tensor.  A group's parameters and states are views into one stacked
  tensor each, set up once (``param.data = stack[j]``), and the gradient
  arena is laid out group by group, so a group's gradients are one view
  of the arena: a step stacks and unstacks nothing.  A group of one runs
  the plain update, as does every tensor of an optimizer that is not
  ``vmappable`` (``optimizer`` module docstring);
* :class:`_OptAdapter`: the optimizer's per-parameter ``update`` (AdamW,
  or ``fused_opt="off"``).

The learning rate of update ``k`` is ``lr_scheduler(k)`` when the trainer
(or its optimizer) has a schedule, read on the host after the step count
rises and handed to the update (the arena kernel too) as a host scalar.
``grad_accum=k`` runs ``k`` calls of :meth:`ShardedTrainer.step` a
window: each micro-batch's gradients are unscaled in f32 and summed into
an f32 accumulator of the arena's layout, in the JAX package's order
(``acc = g1; acc = acc + g2; ...``); the k-th call writes ``acc / k``
into the gradient arena, and the update, the finite check and the
loss-scale rule read that.  The buffers update at every micro-batch.
:meth:`ShardedTrainer.save_states` / :meth:`ShardedTrainer.load_states`
write and read the JAX trainer's ``.npz`` (``param/<name>``,
``aux/<name>``, ``opt/<i>`` in per-parameter leaf order or the arena's
state arenas stripped of padding, ``meta/t``, ``meta/scale``,
``meta/good``, ``meta/skipped``, and ``meta/key``: the raw
``PRNGKey`` of the port's seed, so that the JAX trainer loads the file);
the port's dropout generator's state goes under ``meta/torch_generator``.

The net's buffers (BatchNorm's running statistics) are its auxiliary
state, :attr:`ShardedTrainer.aux_names`: the forward and backward of
each step run inside ``autograd.record()``, so the layers train
(``autograd.is_training()``, as the JAX trainer's
``pause(train_mode=True)``) and update them in place, as the JAX
trainer carries its mutated aux state out of the step.

Every trainable parameter's ``.grad`` is a view into one preallocated
flat gradient arena, so the backward writes (and, for a tied weight such
as BERT's word embedding, accumulates) straight into it: the port's
counterpart of the JAX step's single gradient concatenate.  The arena is
zeroed in place before each backward; a ``.grad`` that was replaced or
set to None (``zero_grad(set_to_none=True)``) is put back as the view.

Low precision (``compute_dtype=torch.bfloat16`` or ``torch.float16``)
is the JAX trainer's policy, not ``torch.autocast``: the master
parameters stay f32 and the optimizer sees f32 parameters and f32
gradients; once a step every floating parameter, buffer and input is
cast to ``compute_dtype`` (one cast a parameter, however often the net
uses it: BERT's tied decoder sums its 16-bit cotangents before the
cast's gradient, as in JAX), the forward runs on the cast copies
(``torch.func.functional_call``), and autograd through the casts writes
the f32 gradients into the arena.  The loss is ``mean(loss_fn(pred,
y))`` cast to f32.  Dynamic loss scaling (``loss_scaling="auto"``: on
exactly for f16) multiplies the loss by the scale before the backward,
divides the gradients by it in f32 and checks them as :func:`all_finite`
does; on overflow every parameter and optimizer state is left as it was
(a per-leaf select against a copy taken before the update), the scale
halves (floored at 1) and the skipped count rises;
after 2000 clean steps the scale doubles.  The check, the select and the
scale stay on the device, so a step never waits on the host.  The
buffers (BatchNorm's running statistics) are cast with the parameters;
the layers blend the batch statistics into the 16-bit copies in the
copies' type, and after the backward each copy that was written is
carried into its f32 buffer, as the JAX trainer casts its mutated aux
state back to f32.  A step that the loss scale skips keeps the
statistics it blended, as in the JAX trainer, which returns the mutated
aux state whatever the finite check says.

Each step records the JAX trainer's spans (``trainer.step`` with the
timer ``trainer.step_seconds`` under the correlation ``step=t+1``,
``trainer.dispatch``, ``trainer.apply_update`` at a window's end;
``ckpt.save_states`` / ``ckpt.load_states`` around the checkpoints), and
:meth:`ShardedTrainer.xla_cost` / :meth:`ShardedTrainer.
publish_xla_utilization` count a step's FLOPs and bytes (``trace.cost``)
without leaving a trace in the training state.

Steps are dispatched asynchronously: ``step`` returns the loss as a lazy
0-d tensor, and at most ``MXNET_MAX_INFLIGHT_STEPS`` (default 2) steps
are in flight (``engine.BoundedInflight`` waits on a CUDA event recorded
after each step).

**Data parallelism.**  On a mesh of N ranks (``parallel.mesh``: one rank
is one process and one device) ``step(x, y)`` takes this rank's own rows
of the global batch, as a multi-process JAX run takes its process-local
data.  The semantics are GSPMD's, as the JAX trainer jits its step over
a dp-sharded batch: the loss is the mean over the global batch (each
rank back-propagates its rows' mean over N and the returned loss is the
all-reduced sum), the gradients are summed over the ranks, and batch
norm takes its statistics and its backward's sums over the global batch
(``ops.nn.batch_stats_group``).  The weight update runs in one of these
layouts:

* ``partition="replicated"``: the gradient arena is all-reduced in one
  collective and every rank runs the full update;
* ``partition="zero1"`` with the flat arena: the arena is padded to a
  multiple of ``8192 * dp`` elements (``kernels.opt_arena.build_layout``
  with that ``shard_multiple``; the JAX trainer passes ``dp``) and
  reduce-scattered, each rank's state arenas hold its shard, ONE launch
  of ``opt_arena.cu`` updates the shard, and the delta arena is
  all-gathered and added per leaf;
* ``partition="zero1"`` per leaf (``Zero1Info``, the per-parameter and
  multi-tensor adapters): each parameter of at least
  ``MXNET_ZERO1_MIN_SIZE`` (default 2048) elements shards the dim with
  the least padding; the update runs on this rank's padded slice, whose
  optimizer state is all it keeps, and the slices are all-gathered;
* ``overlap=True`` (zero1 only): the gradients live in bucket arenas
  (``MXNET_OVERLAP_BUCKET_BYTES``, default 4 MiB, leaves in reverse
  order); each bucket's all-reduce is issued asynchronously, in bucket
  order, and each bucket, once reduced, updates this rank's flat segment
  with the registry optimizer and returns through
  ``collectives.ring_all_gather``.  The buckets are issued after the
  backward, not from inside it.

Checkpoints are the JAX files under every layout: ``save_states``
gathers the sharded optimizer state and parameters (padding stripped,
so a file loads on any mesh) and rank 0 writes; ``state_shards`` /
``load_state_shards`` write and read ``resilience.reshard``'s
manifest-v2 slices, each sharded leaf as its shards' boxes.

**The other mesh axes.**  The JAX trainer jits one GSPMD program over
the mesh; here each rank runs its share of that program:

* rows: a rank takes the rows of its index on the data axis; ranks
  that differ only on ``mp`` / ``tp`` / ``pp`` / ``sp`` / ``ep`` take
  the same rows, and the loss mean, the gradient sum and batch norm's
  statistics run over the data axis's group only;
* parameters sharded by ``spec_fn`` (``mp_spec_fn``, ``fsdp_spec_fn``):
  each rank stores only its shard of each parameter (the sanitized
  spec's block), and its optimizer state follows the shard.  The
  forward gathers every sharded parameter whole (``_GatherParam``) and
  runs the net on the gathered tensors (``functional_call``; they stay
  out of ``state_dict`` and of the optimizer).  The gather's backward
  takes this rank's block of the full gradient: summed by a
  reduce-scatter over the axes whose ranks hold different rows or
  stages (the data axis, ``pp``), sliced over the others, whose ranks
  computed the same gradient.  This computes GSPMD's function; it does
  not split the products over ``mp`` as Megatron does (ROADMAP C).
  The flat arena and ``overlap`` refuse sharded parameters, as in JAX;
* ``pp`` (GPipe, ``parallel.pipeline``): ``split_stages`` cuts
  ``pipeline_atoms(net)`` by parameter count, rank k of ``pp`` runs
  stage k, and ``grad_accum`` calls make one window: buffered calls
  return a 0 loss, the window's last call runs the schedule over the
  stacked micro-batches and returns the window's mean loss after one
  update.  Parameters stay whole on every ``pp`` rank; stage k's
  gradients come from rank k and are summed over ``pp`` with the data
  axis's sum, so every rank updates every parameter.  Before its first
  window the trainer checks that the stages' fold reproduces the net
  (rel 1e-5) and that no stage mutates state (batch-norm statistics,
  a random draw): either raises on every rank.

:func:`make_train_step` is the JAX builder's signature over tensors: its
functions run the trainer's own step (``_grad`` / ``_apply``), so the
two entry points share one path.
"""
from __future__ import annotations

import contextlib
import copy
import itertools
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import autograd as _ag
from .. import optimizer as _opt_mod
from .. import random as _random
from .. import telemetry as _tel
from ..base import DeferredInitializationError, MXNetError, get_env
from ..engine import BoundedInflight
from ..gluon.block import eager_calls
from ..kernels import opt_arena as _oa
from ..ops import nn as _nn
from ..trace import cost as _cost
from ..trace import recorder as _tr
from . import collectives as _coll
from .mesh import P, Mesh, default_mesh

__all__ = ["ShardedTrainer", "make_train_step", "all_finite",
           "shard_params", "replicated_spec_fn", "fsdp_spec_fn",
           "mp_spec_fn", "Zero1Info"]

PARTITIONS = ("replicated", "zero1")
_PP = "pp"


def _prod(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def replicated_spec_fn(name: str, shape) -> P:
    """Pure data parallelism: every parameter replicated."""
    return P()


def fsdp_spec_fn(axis: str = "dp", min_size: int = 2 ** 16):
    """The JAX spec of ZeRO-3-style sharding: the largest dim of each
    parameter of at least ``min_size`` elements over ``axis``."""

    def fn(name: str, shape) -> P:
        if not shape or _prod(shape) < min_size:
            return P()
        big = max(range(len(shape)), key=lambda i: shape[i])
        spec = [None] * len(shape)
        spec[big] = axis
        return P(*spec)

    return fn


def mp_spec_fn(axis: str = "mp", min_size: int = 2 ** 12,
               row_patterns: Tuple[str, ...] = ("proj", "ffn2", "ffn_2",
                                                "out", "down")):
    """The JAX spec of Megatron-style tensor parallelism over ``axis``:
    weights of at least ``min_size`` elements column-parallel (the output
    dim), row-parallel (the input dim) where the name holds one of
    ``row_patterns``; 1-D parameters replicated.  Dims the axis cannot
    divide are replicated by the sanitizer."""

    def fn(name: str, shape) -> P:
        if len(shape) < 2 or _prod(shape) < min_size:
            return P()
        j = 1 if any(p in name for p in row_patterns) else 0
        spec = [None] * len(shape)
        spec[j] = axis
        return P(*spec)

    return fn


def _sanitize_spec(mesh, spec: P, shape) -> P:
    """Spec entries the array's dims cannot divide evenly dropped (the
    JAX trainer's rule)."""
    out = []
    for i, e in enumerate(tuple(spec)[:len(shape)]):
        names = e if isinstance(e, tuple) else (e,)
        size = _prod(mesh.shape.get(n, 1) for n in names) if e else 1
        out.append(None if e is not None and shape[i] % size else e)
    return P(*out)


class _Sharded(NamedTuple):
    """How one parameter is stored on this rank: its sanitized spec, its
    whole shape, and for each dim split over more than one rank ``(dim,
    axes)`` (the spec entry as a tuple of axis names)."""

    spec: P
    full_shape: Tuple[int, ...]
    dims: Tuple[Tuple[int, Tuple[str, ...]], ...]


def _spec_axes(spec: P) -> set:
    """Every axis name a spec names."""
    out = set()
    for e in tuple(spec):
        if e is not None:
            out.update(e if isinstance(e, tuple) else (e,))
    return out


def _sharded_of(mesh, spec: P, shape) -> Optional[_Sharded]:
    """The storage plan of a parameter of ``shape`` under ``spec`` (None
    when no dim is split over more than one rank)."""
    dims = []
    for i, e in enumerate(tuple(spec)):
        if e is None:
            continue
        axes = e if isinstance(e, tuple) else (e,)
        if mesh.axis_size(axes) > 1:
            dims.append((i, tuple(axes)))
    if not dims:
        return None
    return _Sharded(spec, tuple(int(d) for d in shape), tuple(dims))


def _take_shard(full: torch.Tensor, plan: _Sharded, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``plan``."""
    for dim, axes in plan.dims:
        n = full.shape[dim] // mesh.axis_size(axes)
        full = full.narrow(dim, mesh.axis_index(axes) * n, n)
    return full


def _gather_whole(shard: torch.Tensor, plan: _Sharded, mesh
                  ) -> torch.Tensor:
    """The whole tensor from every rank's block (no autograd)."""
    for dim, axes in plan.dims:
        shard = _coll.all_gather(shard.detach(), axes, axis=dim, mesh=mesh)
    return shard


class _GatherParam(torch.autograd.Function):
    """The whole parameter from its shards (module docstring).  The
    backward takes this rank's block of the full gradient: the axes of a
    dim that are in ``sum_axes`` (the ranks' gradients differ) reduce-
    scatter, the others (the ranks' gradients agree) slice."""

    @staticmethod
    def forward(ctx, shard, plan, mesh, sum_axes):
        ctx.plan, ctx.mesh, ctx.sum_axes = plan, mesh, sum_axes
        with torch.no_grad():
            return _gather_whole(shard, plan, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        for dim, axes in reversed(ctx.plan.dims):
            sizes = [mesh.shape[a] for a in axes]
            blk = g.shape[dim] // mesh.axis_size(axes)
            g = g.unflatten(dim, sizes + [blk])
            keep = []
            for a in axes:
                if a in ctx.sum_axes:
                    keep.append(a)
                    continue
                g = g.narrow(dim + len(keep), mesh.axis_index(a), 1)
                g = g.squeeze(dim + len(keep))
            g = g.flatten(dim, dim + len(keep))
            if keep:
                _coll._note("reduce_scatter", g)
                g = _coll._reduce_scatter(
                    g, _coll._axis(tuple(keep), mesh), dim)
        return g.contiguous(), None, None, None


def _refuse_deferred(net):
    """The arena, zero1 and the spec plans need every shape: a net with a
    tensor whose width waits for the first forward raises, naming it, as
    the JAX trainer's ``Parameter.data()`` does."""
    from ..gluon.parameter import is_deferred

    for name, t in sorted(list(net.named_parameters())
                          + list(net.named_buffers())):
        if is_deferred(t):
            raise DeferredInitializationError(
                f"ShardedTrainer: parameter '{name}' has not been "
                "initialized yet because its initialization was deferred "
                "(a width of 0); run the block once on a batch, net(x), "
                "so every shape is known, then build the trainer")


def shard_params(net, mesh, spec_fn: Callable = replicated_spec_fn):
    """``(names, tensors, specs)`` of ``net``'s parameters, sorted by name
    as the JAX function sorts them, each spec sanitized against the mesh.
    Each parameter that the spec splits over more than one rank is
    replaced in ``net`` (every module that holds it) by a parameter of
    this rank's block: a rank stores only its shard.  The tensors
    returned are what the net holds afterwards."""
    named = sorted(net.named_parameters())
    if any(getattr(p, "_mx_sharded", None) is not None for _, p in named):
        raise MXNetError("shard_params: the net's parameters are already "
                         "sharded; shard a net once")
    specs = [_sanitize_spec(mesh, spec_fn(n, tuple(p.shape)), p.shape)
             for n, p in named]
    if not any(_sharded_of(mesh, s, p.shape) for (_, p), s in
               zip(named, specs)):
        return [n for n, _ in named], [p for _, p in named], specs
    owners: Dict[int, List[Tuple[torch.nn.Module, str]]] = {}
    for mod in net.modules():
        for attr, q in mod._parameters.items():
            if q is not None:
                owners.setdefault(id(q), []).append((mod, attr))
    out = []
    for (n, p), spec in zip(named, specs):
        plan = _sharded_of(mesh, spec, p.shape)
        if plan is None:
            out.append(p)
            continue
        with torch.no_grad():
            q = torch.nn.Parameter(_take_shard(p.detach(), plan,
                                               mesh).clone(),
                                   requires_grad=p.requires_grad)
        q._mx_sharded = plan
        for mod, attr in owners[id(p)]:
            mod._parameters[attr] = q
        out.append(q)
    return [n for n, _ in named], out, specs


class Zero1Info(NamedTuple):
    """The ZeRO-1 placement of one parameter: dim ``axis`` (``size``
    elements, padded to ``padded``, a multiple of dp) split over the
    ranks, this rank holding ``[rank * padded // dp, (rank + 1) * padded
    // dp)``."""

    axis: int
    size: int
    padded: int


def _zero1_infos(dp: int, shapes, min_size: Optional[int] = None,
                 specs=None, dp_axis: Optional[str] = "dp",
                 full_shapes=None) -> List[Optional[Zero1Info]]:
    """The JAX trainer's choice of each parameter's ZeRO-1 dim: the free
    dim (not split by the parameter's spec in ``specs``) with the least
    relative padding; parameters below ``min_size`` elements of their
    whole shape (``full_shapes``; ``MXNET_ZERO1_MIN_SIZE``, default
    2048), 0-d ones and those the spec already splits over ``dp_axis``
    (the ZeRO property holds) stay as they are (None).  ``shapes`` are
    the shapes a rank stores."""
    if min_size is None:
        min_size = get_env("MXNET_ZERO1_MIN_SIZE", 2048, int)
    infos: List[Optional[Zero1Info]] = []
    for i, shape in enumerate(shapes):
        full = full_shapes[i] if full_shapes is not None else shape
        spec = tuple(specs[i]) if specs is not None else ()
        free = [k for k in range(len(shape))
                if k >= len(spec) or spec[k] is None]
        if len(shape) == 0 or _prod(full) < min_size or not free or \
                (specs is not None and dp_axis in _spec_axes(specs[i])):
            infos.append(None)
            continue
        j = min(free, key=lambda k: (-(-shape[k] // dp) * dp) / shape[k])
        infos.append(Zero1Info(j, int(shape[j]), -(-shape[j] // dp) * dp))
    return infos


class _DP(NamedTuple):
    """The mesh axes as the trainer sees them: the mesh, the data axis's
    name, group (None on one rank), size and this rank's index on it;
    ``red_group``: the group over which gradients sum (the data axis and
    ``pp``); ``pp_group``, ``pp`` and ``pp_rank``: the pipeline axis."""

    mesh: Any
    axis: str
    group: Any
    size: int
    rank: int
    red_group: Any = None
    pp_group: Any = None
    pp: int = 1
    pp_rank: int = 0


# compute_dtype names -> torch dtypes
_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16, "fp16": torch.float16,
           "float32": torch.float32, "fp32": torch.float32}
_GROWTH_INTERVAL = 2000    # clean steps before the loss scale doubles


def all_finite(grads) -> torch.Tensor:
    """A 0-d bool tensor: whether every gradient's f32 sum is finite (the
    reference's all_finite op, as the JAX package ports it), on the
    gradients' device, with no host sync."""
    sums = torch.stack([g.float().sum() for g in grads])
    return torch.isfinite(sums).all()


def _tensors(tree) -> List[torch.Tensor]:
    """Every tensor of a state tree (None, a tensor, or tuples / lists of
    them), in order."""
    if tree is None:
        return []
    if torch.is_tensor(tree):
        return [tree]
    return [t for e in tree for t in _tensors(e)]


def _cast(x, dtype):
    """``x`` (a tensor, or a tuple / list of them) with every floating
    tensor cast to ``dtype``; integer tensors as they are."""
    if isinstance(x, (tuple, list)):
        return type(x)(_cast(e, dtype) for e in x)
    if torch.is_tensor(x) and x.is_floating_point():
        return x.to(dtype)
    return x

_LATER = "is not ported yet ({item}, a later slice of the trainer)"


def _not_ported(what: str, item: str = "ROADMAP A1") -> MXNetError:
    return MXNetError(f"ShardedTrainer: {what} " + _LATER.format(item=item))


def _make_opt(optimizer, learning_rate, weight_decay, momentum, **extra):
    """An optimizer instance from a name (the trainer's lr, wd and, for
    sgd / nag, momentum) or as given."""
    if isinstance(optimizer, _opt_mod.Optimizer):
        return optimizer
    kwargs = dict(learning_rate=learning_rate, wd=weight_decay, **extra)
    if optimizer in ("sgd", "nag", "signum"):
        kwargs["momentum"] = momentum
    return _opt_mod.create(optimizer, **kwargs)


class _StepCounts(dict):
    """Stands in for ``Optimizer._index_update_count`` during a trainer
    step: every index reads the trainer's step count (the JAX package's
    ``_TracedCounts``)."""

    def __init__(self, t):
        super().__init__()
        self._t = t

    def __getitem__(self, key):
        return self._t

    def setdefault(self, key, default=None):
        return self._t


def _rebuild(template, leaves):
    """A state tree of ``template``'s structure with its tensors taken in
    order from the iterator ``leaves``."""
    if template is None:
        return None
    if torch.is_tensor(template):
        return next(leaves)
    return tuple(_rebuild(t, leaves) for t in template)


def _struct(template) -> str:
    """The structure of a state tree: ``0`` for None, ``a`` for a tensor."""
    if template is None:
        return "0"
    if torch.is_tensor(template):
        return "a"
    return "(" + ",".join(_struct(t) for t in template) + ")"


class _OptAdapter:
    """Per-parameter update: the optimizer's own ``update`` on each
    parameter, with the trainer's lr and step count."""

    def __init__(self, optimizer):
        self.opt = optimizer
        self.states: List[Any] = []
        self.dp = _DP(None, "dp", None, 1, 0)
        #: ``(start, stop, group)`` spans of the gradient arena and the
        #: group each sums over (None: the whole arena over
        #: ``dp.red_group``); set by the trainer when parameters are
        #: sharded over a summed axis
        self.runs: Optional[List[Tuple[int, int, Any]]] = None

    def order(self, params: List[torch.Tensor]) -> List[int]:
        """The parameters' order in the gradient arena."""
        return list(range(len(params)))

    def arena_layout(self, shapes) -> _oa.ArenaLayout:
        """The gradient arena's layout for the parameters' shapes in
        :meth:`order`."""
        return _oa.build_layout(shapes)

    def reduce(self, garena: torch.Tensor) -> torch.Tensor:
        """Sum the gradients over the data axis (and ``pp``); returns the
        tensor the update reads them from (here the arena itself)."""
        if self.runs is None:
            return _coll.all_reduce_(garena, self.dp.red_group)
        for lo, hi, group in self.runs:
            _coll.all_reduce_(garena[lo:hi], group)
        return garena

    def owners(self) -> List[int]:
        """The parameter index of each leaf of :meth:`leaves`."""
        return [i for i, st in enumerate(self.states)
                for _ in _tensors(st)]

    def finite(self, g: torch.Tensor, segments) -> torch.Tensor:
        """A 0-d bool: whether the f32 sum of each gradient's segment of
        the reduced arena ``g`` is finite (:func:`all_finite`), the same
        on every rank."""
        # unsafe: the lengths are the layout's own, and their validation
        # reads them back to the host, a sync a step
        return torch.isfinite(torch.segment_reduce(
            g, "sum", lengths=segments, unsafe=True)).all()

    def ckpt_leaves(self) -> List[torch.Tensor]:
        """The optimizer state's leaves as the checkpoint holds them: in
        order, whole (gathered over the ranks) and without padding."""
        return self.leaves()

    def load_leaves(self, arrays) -> None:
        """Put :meth:`ckpt_leaves`-shaped arrays back (shapes checked by
        the caller against :meth:`ckpt_leaves`)."""
        for leaf, v in zip(self.leaves(), arrays):
            leaf.copy_(torch.as_tensor(v))

    def init_state(self, params: List[torch.Tensor], layout):
        with torch.no_grad():
            self.states = [self.opt.create_state(i, p)
                           for i, p in enumerate(params)]

    def leaves(self) -> List[torch.Tensor]:
        """The optimizer state's tensors in checkpoint order (``opt/<i>``
        of :meth:`ShardedTrainer.save_states`)."""
        return _tensors(self.states)

    def storages(self, params) -> List[torch.Tensor]:
        """Tensors that hold every parameter and state element once: what
        the loss-scale select keeps on a skipped step."""
        return list(params) + self.leaves()

    def _step_opt(self, lr, t):
        opt = copy.copy(self.opt)
        opt.rescale_grad = 1.0          # the loss mean already scaled
        opt.lr_scheduler = None
        opt.lr = lr
        opt._index_update_count = _StepCounts(t)
        opt._update_count = lambda *a, **k: None
        return opt

    def update(self, params, grads, garena, lr, t):
        opt = self._step_opt(lr, t)
        for i, (p, g) in enumerate(zip(params, grads)):
            opt.update(i, p, g, self.states[i])


class _FusedOptAdapter(_OptAdapter):
    """Multi-tensor update (module docstring): one ``torch.func.vmap`` of
    ``update`` for each group of parameters with the JAX package's
    grouping key (``mxnet_tpu/parallel/trainer.py:486-495``); a group's
    parameters and state leaves are views into stacked tensors made once.
    ``groups`` lists each group's parameter indices, in the order of
    their first member."""

    def __init__(self, optimizer):
        super().__init__(optimizer)
        self.groups: List[List[int]] = []
        self._stacks: List[Any] = []
        self._goff: List[int] = []
        self._fresh: Optional[List[Any]] = None

    def _index_sig(self, i):
        """The host-side lr / wd multipliers of index ``i`` (the lookups of
        ``Optimizer._get_lr`` / ``_get_wd``): a group shares its first
        member's."""
        opt = self.opt
        param = opt.param_dict.get(i)
        if param is not None:
            lm = getattr(param, "lr_mult", 1.0)
            wm = getattr(param, "wd_mult", 1.0)
        else:
            name = opt.idx2name.get(i)
            lm = opt.lr_mult.get(i, opt.lr_mult.get(name, 1.0))
            wm = opt.wd_mult.get(i, opt.wd_mult.get(name, 1.0))
        return (float(lm), float(wm))

    def _plan(self, params):
        with torch.no_grad():
            states = [self.opt.create_state(i, p)
                      for i, p in enumerate(params)]
        groups = {}
        for i, (p, st) in enumerate(zip(params, states)):
            if not self.opt.vmappable:
                key = i
            else:
                key = (tuple(p.shape), p.dtype, _struct(st),
                       self._index_sig(i),
                       tuple((tuple(t.shape), t.dtype)
                             for t in _tensors(st)))
            groups.setdefault(key, []).append(i)
        self.groups = sorted(groups.values(), key=lambda g: g[0])
        self._fresh = states

    def order(self, params):
        if not self.groups:
            self._plan(params)
        return [i for g in self.groups for i in g]

    @torch.no_grad()
    def init_state(self, params, layout):
        if not self.groups:
            self._plan(params)
        fresh, self._fresh = self._fresh, None
        self.states = list(fresh)
        self._stacks, self._goff = [], []
        pos = {i: k for k, i in enumerate(self.order(params))}
        for g in self.groups:
            self._goff.append(layout.offsets[pos[g[0]]])
            if len(g) == 1:
                self._stacks.append(None)
                continue
            stack = torch.stack([params[i].detach() for i in g])
            for j, i in enumerate(g):
                params[i].data = stack[j]
            leaves = [torch.stack(ls) for ls in
                      zip(*[_tensors(fresh[i]) for i in g])]
            for j, i in enumerate(g):
                self.states[i] = _rebuild(fresh[i],
                                          iter([l[j] for l in leaves]))
            self._stacks.append((stack, leaves))

    def storages(self, params):
        out: List[torch.Tensor] = []
        for g, stack in zip(self.groups, self._stacks):
            if stack is None:
                out += [params[g[0]]] + _tensors(self.states[g[0]])
            else:
                out += [stack[0]] + stack[1]
        return out

    def update(self, params, grads, garena, lr, t):
        opt = self._step_opt(lr, t)
        for g, stack, off in zip(self.groups, self._stacks, self._goff):
            i0 = g[0]
            if stack is None:
                opt.update(i0, params[i0], grads[i0], self.states[i0])
                continue
            w, leaves = stack
            gs = garena[off:off + w.numel()].view(w.shape)
            template = self.states[i0]

            def one(wj, gj, *lj, i0=i0, template=template):
                opt.update(i0, wj, gj, _rebuild(template, iter(lj)))
                return wj

            torch.func.vmap(one)(w, gs, *leaves)


class _ArenaOptAdapter(_OptAdapter):
    """Flat-arena update: one kernel launch per step for every parameter
    (module docstring).  State lives in flat arenas of the gradient
    arena's layout; the delta arena is allocated once and reused.  Under
    ``partition="zero1"`` on dp ranks (``zero1`` True, ``dp`` set by the
    trainer) the layout pads to ``8192 * dp`` elements, the gradient
    arena is reduce-scattered into this rank's shard, the state arenas
    and the kernel's launch cover the shard only, and the delta shards
    are all-gathered before ``p += delta``."""

    def __init__(self, optimizer):
        super().__init__(optimizer)
        self.layout: Optional[_oa.ArenaLayout] = None
        self._delta: Optional[torch.Tensor] = None
        self.zero1 = False
        name = type(optimizer).__name__
        if name in ("SGD", "NAG"):
            self.variant = "momentum" if getattr(optimizer, "momentum",
                                                 0.0) else "sgd"
            self._nesterov = name == "NAG"
        else:
            self.variant = "adam"
            self._nesterov = False

    @classmethod
    def supports(cls, opt):
        """Whether ``opt`` can run as a flat-arena update, with the reason
        when not.  Exact types only: subclasses (AdamW, ...) change the
        update math."""
        if type(opt) not in (_opt_mod.SGD, _opt_mod.NAG, _opt_mod.Adam):
            return False, (f"optimizer {type(opt).__name__} not "
                           "arena-fusible (elementwise sgd/momentum/adam "
                           "only)")
        if opt.lr_mult or opt.wd_mult:
            return False, "per-parameter lr/wd multipliers"
        for p in opt.param_dict.values():
            if getattr(p, "lr_mult", 1.0) != 1.0 or \
                    getattr(p, "wd_mult", 1.0) != 1.0:
                return False, "per-parameter lr/wd multipliers"
        return True, ""

    @property
    def _sharded(self) -> bool:
        return self.zero1 and self.dp.size > 1

    def arena_layout(self, shapes):
        # zero1: each rank's shard whole (64, 128) blocks (8192 * dp)
        return _oa.build_layout(
            shapes, shard_multiple=_oa.BLOCK * self.dp.size
            if self._sharded else 1)

    def init_state(self, params, layout):
        self.layout = layout
        kw = dict(dtype=torch.float32, device=params[0].device)
        n = layout.padded // self.dp.size if self._sharded else \
            layout.padded
        self.states = [torch.zeros(n, **kw)
                       for _ in range(_oa.VARIANT_STATES[self.variant])]
        self._delta = torch.empty(layout.padded, **kw)
        if self._sharded:
            self._gsh = torch.zeros(n, **kw)
            self._dsh = torch.empty(n, **kw)
            # the pieces of the flattened parameters inside this rank's
            # shard [lo, hi): (param, start, stop) in arena order
            lo = self.dp.rank * n
            hi = lo + n
            self._pieces = []
            for i, (off, size) in enumerate(zip(layout.offsets,
                                                layout.sizes)):
                a, b = max(off, lo), min(off + size, hi)
                if a < b:
                    self._pieces.append((i, a - off, b - off))
            self._tail = hi - min(hi, max(lo, layout.total))

    def reduce(self, garena):
        if not self._sharded:
            return super().reduce(garena)
        _coll.all_reduce_(garena, self.dp.pp_group)
        return _coll.reduce_scatter(garena, self.dp.axis, mesh=self.dp.mesh,
                                    out=self._gsh)

    def finite(self, g, segments):
        if not self._sharded:
            return super().finite(g, segments)
        # each rank checks its shard's elements; the verdict is the
        # minimum over the ranks (ROADMAP C: elementwise under zero1)
        ok = torch.isfinite(g).all().to(torch.int32)
        return _coll.all_reduce_(ok, self.dp.group, op="min").bool()

    def _param_shard(self, params):
        """This rank's shard of the flattened parameters (arena order)."""
        parts = [params[i].detach().reshape(-1)[a:b]
                 for i, a, b in self._pieces]
        if self._tail:
            parts.append(torch.zeros(self._tail, dtype=torch.float32,
                                     device=self._gsh.device))
        return torch.cat(parts)

    def update(self, params, grads, garena, lr, t):
        opt = self.opt
        wd = float(opt.wd)
        clip = float(opt.clip_gradient) if opt.clip_gradient is not None \
            else -1.0
        kw = {}
        if self.variant == "momentum":
            kw = dict(momentum=float(opt.momentum), nesterov=self._nesterov)
        elif self.variant == "adam":
            kw = dict(beta1=float(opt.beta1), beta2=float(opt.beta2),
                      eps=float(opt.epsilon))
        lay = self.layout
        if self._sharded:
            g = self._gsh
            if clip > 0:
                g.clamp_(-abs(clip), abs(clip))
            if wd:
                g.add_(self._param_shard(params) * float(np.float32(wd)))
            dsh, _ = _oa.arena_update(self.variant, g, self.states, lr, t,
                                      out=self._dsh, **kw)
            delta = _coll.all_gather(dsh, self.dp.axis, mesh=self.dp.mesh,
                                     out=self._delta)
        else:
            # per-leaf fold in the arena, in the order of the JAX adapter:
            # clip, then g + wd * p (reads the parameter, never packed)
            if clip > 0:
                for g in grads:
                    g.clamp_(-abs(clip), abs(clip))
            if wd:
                torch._foreach_add_(grads, torch._foreach_mul(
                    params, float(np.float32(wd))))
            delta, _ = _oa.arena_update(self.variant, garena, self.states,
                                        lr, t, out=self._delta, **kw)
        torch._foreach_add_(params, [
            delta[off:off + size].view(shape) for off, size, shape in
            zip(lay.offsets, lay.sizes, lay.shapes)])

    def ckpt_leaves(self):
        total = self.layout.total
        if not self._sharded:
            return [leaf[:total] for leaf in self.states]
        return [_coll.all_gather(leaf, self.dp.axis,
                                 mesh=self.dp.mesh)[:total]
                for leaf in self.states]

    def load_leaves(self, arrays):
        lay = self.layout
        n = self.states[0].numel() if self.states else 0
        lo = self.dp.rank * n if self._sharded else 0
        for leaf, v in zip(self.states, arrays):
            full = torch.zeros(lay.padded, dtype=torch.float32)
            full[:lay.total] = torch.as_tensor(v)
            leaf.copy_(full[lo:lo + leaf.numel()])


class _Zero1LeafAdapter(_OptAdapter):
    """``partition="zero1"`` per leaf (``Zero1Info``) around a
    per-parameter or multi-tensor adapter (``inner``): the inner adapter
    updates shard tensors, one per parameter (this rank's zero-padded
    slice of a sharded parameter; the parameter itself for one kept
    replicated), whose gradients are copied out of the reduced arena
    into a shard arena of the inner adapter's layout; the updated slices
    are then all-gathered into the parameters.  The optimizer state is
    the inner adapter's, over the shards: 1/dp of it a rank."""

    def __init__(self, inner: _OptAdapter, dp: _DP, specs=None,
                 full_shapes=None):
        super().__init__(inner.opt)
        self.inner = inner
        self.dp = dp
        self.infos: List[Optional[Zero1Info]] = []
        self.sp: List[torch.Tensor] = []
        self._specs, self._full = specs, full_shapes

    def _shards(self, params):
        if self.sp:
            return
        self.infos = _zero1_infos(self.dp.size,
                                  [tuple(p.shape) for p in params],
                                  specs=self._specs, dp_axis=self.dp.axis,
                                  full_shapes=self._full)
        for p, info in zip(params, self.infos):
            if info is None:
                self.sp.append(p)
                continue
            shape = list(p.shape)
            shape[info.axis] = info.padded // self.dp.size
            self.sp.append(torch.zeros(shape, dtype=p.dtype,
                                       device=p.device))

    def order(self, params):
        self._shards(params)
        return self.inner.order(self.sp)

    def init_state(self, params, layout):
        self._shards(params)
        order = self.inner.order(self.sp)
        self.sg_layout = _oa.build_layout([tuple(self.sp[i].shape)
                                           for i in order])
        self.sg = torch.zeros(self.sg_layout.padded, dtype=torch.float32,
                              device=params[0].device)
        self.sg_views: List[torch.Tensor] = [None] * len(params)
        for i, off, size, shape in zip(order, self.sg_layout.offsets,
                                       self.sg_layout.sizes,
                                       self.sg_layout.shapes):
            self.sg_views[i] = self.sg[off:off + size].view(shape)
        self.inner.init_state(self.sp, self.sg_layout)

    def _slice(self, t, info):
        """This rank's zero-padded slice of ``t`` along ``info.axis``."""
        n = info.padded // self.dp.size
        lo = self.dp.rank * n
        hi = min(lo + n, info.size)
        return t.narrow(info.axis, lo, max(0, hi - lo)), max(0, hi - lo)

    def update(self, params, grads, garena, lr, t):
        for i, (p, g, info) in enumerate(zip(params, grads, self.infos)):
            view = self.sg_views[i]
            if info is None:
                view.copy_(g)
                continue
            src, k = self._slice(g, info)
            view.zero_()
            view.narrow(info.axis, 0, k).copy_(src)
            src, k = self._slice(p.detach(), info)
            self.sp[i].zero_()
            self.sp[i].narrow(info.axis, 0, k).copy_(src)
        self.inner.update(self.sp, self.sg_views, self.sg, lr, t)
        for i, (p, info) in enumerate(zip(params, self.infos)):
            if info is None:
                continue
            full = _coll.all_gather(self.sp[i], self.dp.axis,
                                    axis=info.axis, mesh=self.dp.mesh)
            p.detach().copy_(full.narrow(info.axis, 0, info.size))

    def leaves(self):
        return self.inner.leaves()

    def owners(self):
        return self.inner.owners()

    def storages(self, params):
        return self.inner.storages(self.sp) + [
            p for p, info in zip(params, self.infos) if info is not None]

    def _owned(self):
        """``(leaf, info)`` of each state leaf: the owner's Zero1Info when
        the leaf is shaped as the owner's shard (so sharded), else None."""
        out = []
        for i, st in enumerate(self.inner.states):
            for leaf in _tensors(st):
                info = self.infos[i]
                sharded = info is not None and \
                    tuple(leaf.shape) == tuple(self.sp[i].shape)
                out.append((leaf, info if sharded else None))
        return out

    def ckpt_leaves(self):
        out = []
        for leaf, info in self._owned():
            if info is None:
                out.append(leaf)
                continue
            full = _coll.all_gather(leaf, self.dp.axis, axis=info.axis,
                                    mesh=self.dp.mesh)
            out.append(full.narrow(info.axis, 0, info.size))
        return out

    def load_leaves(self, arrays):
        for (leaf, info), v in zip(self._owned(), arrays):
            v = torch.as_tensor(v)
            if info is None:
                leaf.copy_(v)
                continue
            src, k = self._slice(v, info)
            leaf.zero_()
            leaf.narrow(info.axis, 0, k).copy_(src)


class _OverlapOptAdapter(_OptAdapter):
    """The bucketed update of ``overlap=True`` under zero1 (module
    docstring; the JAX ``_OverlapOptAdapter``).  The gradient arena is
    the bucket arenas one after another (leaves in reverse order,
    ``kernels.opt_arena.bucket_layouts``, each padded to ``8192 * dp``);
    :meth:`reduce` issues each bucket's all-reduce asynchronously, and
    :meth:`update` waits for a bucket, runs the registry optimizer on
    this rank's flat segment of it (elementwise, so leaf and shard
    boundaries may fall anywhere) and ring-gathers the updated segment.
    The state is one flat segment per bucket and slot."""

    def __init__(self, optimizer, bucket_bytes: Optional[int] = None):
        super().__init__(optimizer)
        if bucket_bytes is None:
            bucket_bytes = get_env("MXNET_OVERLAP_BUCKET_BYTES", 4 << 20,
                                   int)
        self.bucket_bytes = int(bucket_bytes)
        self.buckets: Tuple[Tuple[int, ...], ...] = ()
        self.layouts: Tuple[_oa.ArenaLayout, ...] = ()
        self._handles: List[Any] = []

    @classmethod
    def supports(cls, opt):
        """The flat arena's set (elementwise sgd / momentum / adam with
        uniform multipliers): norm-based optimizers read per-tensor
        reductions that flat segments would mix."""
        return _ArenaOptAdapter.supports(opt)

    def order(self, params):
        if not self.buckets:
            self.buckets, self.layouts = _oa.bucket_layouts(
                [tuple(p.shape) for p in params], self.bucket_bytes,
                shard_multiple=_oa.BLOCK * self.dp.size)
        return [i for b in self.buckets for i in b]

    def arena_layout(self, shapes):
        offsets, sizes, base = [], [], 0
        self.bases = []
        for lay in self.layouts:
            self.bases.append(base)
            offsets += [base + o for o in lay.offsets]
            sizes += list(lay.sizes)
            base += lay.padded
        return _oa.ArenaLayout(tuple(offsets), tuple(sizes),
                               tuple(tuple(s) for s in shapes),
                               sum(l.total for l in self.layouts), base)

    def init_state(self, params, layout):
        kw = dict(dtype=torch.float32, device=params[0].device)
        self._seg = []          # per bucket: (segment length, pieces)
        self.states = []
        self._btree = []
        for b, (idxs, lay) in enumerate(zip(self.buckets, self.layouts)):
            n = lay.padded // self.dp.size
            lo, hi = self.dp.rank * n, self.dp.rank * n + n
            pieces = []
            for i, off, size in zip(idxs, lay.offsets, lay.sizes):
                a, c = max(off, lo), min(off + size, hi)
                if a < c:
                    pieces.append((i, a - off, c - off, a - lo))
            self._seg.append((n, pieces))
            with torch.no_grad():
                tmpl = self.opt.create_state(b, torch.zeros(n, **kw))
            self._btree.append(tmpl)
            self.states.append(_rebuild(tmpl, iter(
                [t.clone() for t in _tensors(tmpl)])))

    def reduce(self, garena):
        self._handles = []
        for base, lay in zip(self.bases, self.layouts):
            seg = garena[base:base + lay.padded]
            if self.dp.red_group is None:
                self._handles.append(None)
                continue
            _coll._note("all_reduce", seg)
            self._handles.append(torch.distributed.all_reduce(
                seg, group=self.dp.red_group, async_op=True))
        return garena

    def wait(self, b: Optional[int] = None):
        """Wait for bucket ``b``'s all-reduce (every bucket's if None)."""
        for k, h in enumerate(self._handles):
            if h is not None and (b is None or k == b):
                h.wait()
                self._handles[k] = None

    def finite(self, g, segments):
        self.wait()
        return super().finite(g, segments)

    def update(self, params, grads, garena, lr, t):
        opt = self._step_opt(lr, t)
        for b, (base, lay) in enumerate(zip(self.bases, self.layouts)):
            self.wait(b)
            n, pieces = self._seg[b]
            lo = base + self.dp.rank * n
            g = garena[lo:lo + n]
            w = torch.zeros(n, dtype=torch.float32, device=garena.device)
            for i, a, c, at in pieces:
                w[at:at + c - a] = params[i].detach().reshape(-1)[a:c]
            opt.update(b, w, g, self.states[b])
            full = _coll.ring_all_gather(w, self.dp.axis, mesh=self.dp.mesh)
            for i, off, size, shape in zip(self.buckets[b], lay.offsets,
                                           lay.sizes, lay.shapes):
                params[i].detach().copy_(full[off:off + size].view(shape))

    def ckpt_leaves(self):
        out = []
        for st, lay in zip(self.states, self.layouts):
            for leaf in _tensors(st):
                full = _coll.all_gather(leaf, self.dp.axis,
                                        mesh=self.dp.mesh)
                out.append(full[:lay.total])
        return out

    def load_leaves(self, arrays):
        it = iter(arrays)
        for st, lay, (n, _) in zip(self.states, self.layouts, self._seg):
            lo = self.dp.rank * n
            for leaf in _tensors(st):
                full = torch.zeros(lay.padded, dtype=torch.float32)
                full[:lay.total] = torch.as_tensor(next(it))
                leaf.copy_(full[lo:lo + n])


def _pick_adapter(opt, multi_tensor: bool, fused_opt: Optional[str]):
    """``fused_opt``: ``None`` picks the arena whenever the optimizer is
    arena-fusible and ``multi_tensor`` was not asked for; ``"arena"``
    requires the arena (raises when it cannot run); ``"off"`` pins the
    per-parameter adapters.  Otherwise ``multi_tensor=True`` takes the
    multi-tensor adapter and ``False`` the per-parameter one, as
    ``mxnet_tpu/parallel/trainer.py:789-819`` picks.  Returns
    ``(adapter, reason)``: why the arena was not taken, or ``""``.  (The
    trainer takes f32 parameters only, which the arena needs.)"""
    if fused_opt not in (None, "arena", "off"):
        raise MXNetError(f"fused_opt={fused_opt!r} unknown; use None, "
                         "'arena' or 'off'")
    reason = "fused_opt='off'"
    if fused_opt == "arena" or (fused_opt is None and not multi_tensor):
        ok, reason = _ArenaOptAdapter.supports(opt)
        if ok:
            return _ArenaOptAdapter(opt), ""
        if fused_opt == "arena":
            raise MXNetError("fused_opt='arena' requested but unavailable: "
                             + reason)
    elif fused_opt is None:
        reason = "multi_tensor=True"
    if multi_tensor:
        return _FusedOptAdapter(opt), reason
    return _OptAdapter(opt), reason


def _pick_layout_adapter(opt, multi_tensor, fused_opt, partition, overlap,
                         dp: _DP, specs=None, full_shapes=None):
    """The adapter of the update layout (module docstring), with the JAX
    trainer's refusals for ``overlap`` and, when parameters are sharded
    by their spec, for the flat arena and ``overlap`` (the default
    turns the arena off); ``(adapter, arena_refused)``."""
    sharded = any(_spec_axes(sp) for sp in specs or ())
    if sharded:
        if fused_opt == "arena":
            raise MXNetError(
                "fused_opt='arena' cannot run with sharded parameters "
                "(mp/fsdp spec_fn): packing their gradients into one "
                "replicated arena would gather full-model grad bytes "
                "per device; use the per-param adapter")
        if overlap:
            raise MXNetError(
                "overlap=True cannot run with sharded parameters "
                "(mp/fsdp spec_fn): packing their gradients into bucket "
                "arenas would gather full-model grad bytes per device; "
                "use the per-leaf zero1 path")
        fused_opt = "off"
    if overlap:
        if partition != "zero1":
            raise MXNetError(
                "overlap=True is the zero1 latency-hiding path; it needs "
                "partition='zero1' (docs/sharding.md 'Latency hiding')")
        if fused_opt == "arena":
            raise MXNetError(
                "overlap=True supersedes fused_opt='arena': the bucketed "
                "flush IS the arena machinery, one layout per bucket — "
                "drop fused_opt")
        ok, reason = _OverlapOptAdapter.supports(opt)
        if not ok:
            raise MXNetError(f"overlap=True unavailable: {reason} "
                             "(docs/sharding.md 'Latency hiding')")
        ad = _OverlapOptAdapter(opt)
        ad.dp = dp
        return ad, "overlap=True"
    ad, reason = _pick_adapter(opt, multi_tensor, fused_opt)
    if sharded:
        reason = ("params sharded over mesh axes (mp/fsdp spec_fn): the "
                  "grad-arena pack would gather them replicated")
    if isinstance(ad, _ArenaOptAdapter):
        ad.dp, ad.zero1 = dp, partition == "zero1"
        return ad, reason
    ad.dp = dp
    if partition == "zero1" and dp.size > 1:
        return _Zero1LeafAdapter(ad, dp, specs, full_shapes), reason
    return ad, reason


def _on(x, device):
    """A host array or tensor as a tensor on ``device`` (a tuple or list
    element-wise)."""
    if isinstance(x, (tuple, list)):
        return tuple(_on(e, device) for e in x)
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device, non_blocking=True)


class ShardedTrainer:
    """End-to-end trainer for an ``nn.Module`` on one device or a mesh
    of ranks (module docstring).

    ``net`` is a port module whose parameters live on this rank's device
    (the trainer trains there); ``mesh`` a ``parallel.mesh.Mesh`` (default
    ``default_mesh()``: every rank of the group on ``dp``, or this one
    device), ``partition`` / ``overlap`` the update's layout,
    ``spec_fn`` the parameters' specs (``shard_params`` replaces each
    sharded parameter of ``net`` by this rank's shard), ``batch_spec``
    the data axis.  ``step(x, y)`` takes this rank's rows.  ``loss_fn(pred, y)`` returns per-sample losses
    and ``pred`` is ``net(*x)`` (a tuple of outputs passes as a tuple).
    ``optimizer`` is a registry name or an ``Optimizer``; names get the
    trainer's ``learning_rate``, ``weight_decay`` and, for sgd / nag,
    ``momentum``.  ``fused_opt`` and ``multi_tensor``: see
    :func:`_pick_adapter`; :attr:`uses_arena` says which adapter runs.
    ``train_names`` are the trained parameters' names, sorted as the JAX
    trainer sorts them (the optimizer's index ``i`` is the i-th), and
    ``aux_names`` the buffers' (module docstring).  ``lr_scheduler``,
    ``grad_accum`` and the checkpoints: module docstring."""

    def __init__(self, net, loss_fn, mesh=None, optimizer="sgd",
                 learning_rate: float = 0.01, weight_decay: float = 0.0,
                 momentum: float = 0.9, compute_dtype=None,
                 lr_scheduler=None, grad_accum: int = 1,
                 multi_tensor: bool = False,
                 max_inflight: Optional[int] = None,
                 partition: Optional[str] = None,
                 fused_opt: Optional[str] = None,
                 overlap: Optional[bool] = None,
                 init_loss_scale: float = 2.0 ** 16,
                 loss_scaling: Any = "auto",
                 spec_fn: Callable = replicated_spec_fn,
                 batch_spec: P = P("dp")):
        if partition is None:
            partition = get_env("MXNET_PARTITION", "replicated", str)
        if partition not in PARTITIONS:
            raise MXNetError(f"partition={partition!r} unknown; "
                             f"choose from {PARTITIONS}")
        if overlap is None:
            overlap = get_env("MXNET_OVERLAP", False, bool)
        self.partition = partition
        self.overlap = bool(overlap)
        if int(grad_accum) < 1:
            raise MXNetError(f"grad_accum={grad_accum} must be >= 1")
        self.grad_accum = int(grad_accum)
        self.net = net
        self.loss_fn = loss_fn
        self.mesh = mesh if mesh is not None else default_mesh()
        if not isinstance(self.mesh, Mesh):
            raise MXNetError(f"ShardedTrainer: mesh must be a "
                             f"parallel.mesh.Mesh, got {type(self.mesh)}")
        self._batch_spec = batch_spec
        self._dp = self._data_axis()
        self._pp_stages = None
        if self._dp.pp > 1:
            from .pipeline import split_stages

            self._pp_stages = split_stages(net, self._dp.pp)
        _refuse_deferred(net)
        # sorted by name, as the JAX trainer orders them: the index an
        # optimizer sees, the order of the checkpoint's leaves and the
        # arena's layout are the JAX package's
        names, _, specs = shard_params(net, self.mesh, spec_fn)
        spec_of = dict(zip(names, specs))
        named = sorted((n, p) for n, p in net.named_parameters()
                       if p.requires_grad)
        if not named:
            raise MXNetError("ShardedTrainer: the net has no trainable "
                             "parameters")
        self.train_names = [n for n, _ in named]
        self.params = [p for _, p in named]
        #: each trained parameter's sanitized spec (the JAX trainer's)
        self.specs = [spec_of[n] for n in self.train_names]
        self._shards: Dict[int, _Sharded] = {}
        full_shapes = []
        for i, (p, spec) in enumerate(zip(self.params, self.specs)):
            plan = _sharded_of(self.mesh, spec, self._full_shape(p, spec))
            if plan is not None:
                self._shards[i] = plan
            full_shapes.append(plan.full_shape if plan is not None
                               else tuple(p.shape))
        self._full_shapes = full_shapes
        devices = {p.device for p in self.params}
        if len(devices) != 1:
            raise MXNetError(
                f"ShardedTrainer: parameters on {sorted(map(str, devices))}"
                ": a rank trains on one device (its parameters all there); "
                "several devices are several ranks (parallel.dist)")
        self.device = devices.pop()
        if self.mesh.size > 1 and self.device != self.mesh.device:
            raise MXNetError(
                f"ShardedTrainer: parameters on {self.device}, but this "
                f"rank's device is {self.mesh.device}")
        buffers = sorted(net.named_buffers())
        self.aux_names = [n for n, _ in buffers]
        away = sorted(n for n, b in buffers if b.device != self.device)
        if away:
            raise MXNetError(f"ShardedTrainer: buffers {away} are not on "
                             f"the parameters' device {self.device}")
        if any(p.dtype != torch.float32 for p in self.params):
            raise _not_ported("non-f32 parameters")
        opt = _make_opt(optimizer, learning_rate, weight_decay, momentum)
        self._adapter, self.arena_refused = _pick_layout_adapter(
            opt, bool(multi_tensor), fused_opt, partition, self.overlap,
            self._dp, self.specs, full_shapes)
        # the arena in the adapter's order: a multi-tensor group's
        # gradients are one contiguous view; parameters whose gradients
        # sum over the same axes lie together
        red = [self._red_axes(i) for i in range(len(self.params))]
        order = self._adapter.order(self.params)
        if self._shards and type(self._adapter) is _OptAdapter:
            order = sorted(order, key=lambda i: red[i])
        self.layout = self._adapter.arena_layout(
            [tuple(self.params[i].shape) for i in order])
        self._order = order
        if self._shards:
            self._adapter.runs = self._runs(order, red)
        self._garena = torch.zeros(self.layout.padded, dtype=torch.float32,
                                   device=self.device)
        self._gviews: List[torch.Tensor] = [None] * len(self.params)
        for i, off, size, shape in zip(order, self.layout.offsets,
                                       self.layout.sizes,
                                       self.layout.shapes):
            self._gviews[i] = self._garena[off:off + size].view(shape)
        self._attach_grads()
        self._init_policy(compute_dtype, loss_scaling, init_loss_scale)
        self._adapter.init_state(self.params, self.layout)
        self._lr = float(opt.lr) if optimizer is opt else float(learning_rate)
        #: the schedule of the learning rate (the optimizer's when none is
        #: given); update k runs at ``lr_scheduler(k)``
        self.lr_scheduler = lr_scheduler if lr_scheduler is not None \
            else opt.lr_scheduler
        self._t = 0
        self._micro = 0
        self._accum: Optional[torch.Tensor] = None
        self._pp_buf: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self._pp_shapes: Optional[List[Tuple[int, ...]]] = None
        self._inflight = BoundedInflight(max_inflight)
        #: byte accounting of the last :meth:`load_state_shards` (None
        #: until then), the JAX trainer's attribute
        self.last_restore_stats: Optional[Dict[str, int]] = None
        self._publish_layout_gauges()

    def _data_axis(self) -> _DP:
        """The data axis: the first named entry of ``batch_spec``, else
        ``dp`` when the mesh has one, else its first axis other than
        ``pp`` (a mesh of ``pp`` alone has no data axis: one rank's
        rows); with the pipeline axis and the group over which gradients
        sum."""
        m = self.mesh
        name = next((e[0] if isinstance(e, tuple) else e
                     for e in tuple(self._batch_spec) if e is not None),
                    None)
        if name is None or name not in m.shape:
            name = "dp" if "dp" in m.shape else next(
                (a for a in m.axis_names if a != _PP), None)
        pp = m.shape.get(_PP, 1) if name != _PP else 1
        pipe = (m.group(_PP) if pp > 1 else None, pp,
                m.axis_index(_PP) if pp > 1 else 0)
        summed = tuple(a for a in m.axis_names if a in (name, _PP))
        if name is None:
            return _DP(m, None, None, 1, 0, m.group(summed), *pipe)
        return _DP(m, name, m.group(name), m.shape[name],
                   m.axis_index(name), m.group(summed), *pipe)

    def _full_shape(self, p, spec) -> Tuple[int, ...]:
        """The whole shape of parameter ``p`` (stored as this rank's
        shard of ``spec``)."""
        shape = list(p.shape)
        for k, e in enumerate(tuple(spec)):
            if e is not None:
                shape[k] *= self.mesh.axis_size(e)
        return tuple(shape)

    def _summed_axes(self) -> Tuple[str, ...]:
        """The axes over which gradients sum: the data axis and ``pp``
        (those of more than one rank)."""
        m = self.mesh
        return tuple(a for a in m.axis_names
                     if a in (self._dp.axis, _PP) and m.shape[a] > 1)

    def _red_axes(self, i: int) -> Tuple[str, ...]:
        """The summed axes left to reduce parameter ``i``'s gradient over
        after its gather's backward (which sums over the summed axes its
        spec splits)."""
        plan = self._shards.get(i)
        done = set() if plan is None else {a for _, axes in plan.dims
                                           for a in axes}
        return tuple(a for a in self._summed_axes() if a not in done)

    def _runs(self, order, red):
        """The arena's spans of parameters with the same axes to sum
        over, each with that group (``_OptAdapter.runs``)."""
        runs = []
        lay = self.layout
        for k, i in enumerate(order):
            lo = lay.offsets[k]
            hi = lay.offsets[k + 1] if k + 1 < len(order) else lay.padded
            axes = red[i]
            if runs and runs[-1][2] == axes and runs[-1][1] == lo:
                runs[-1][1] = hi
            else:
                runs.append([lo, hi, axes])
        return [(lo, hi, self.mesh.group(axes)) for lo, hi, axes in runs
                if axes]

    # -- memory / collective accounting --------------------------------------
    def _publish_layout_gauges(self):
        if _tel._ENABLED:
            _tel.set_gauge("trainer.opt_state_bytes_per_device",
                           self.opt_state_bytes_per_device)
            _tel.set_gauge("trainer.param_gather_bytes",
                           self.param_gather_bytes)
            if isinstance(self._adapter, _OverlapOptAdapter):
                _tel.set_gauge("trainer.overlap_bucket_count",
                               len(self._adapter.buckets))
            if self._pp_stages is not None:
                _tel.set_gauge("trainer.pp_bubble_fraction",
                               self.pp_bubble_fraction)

    @property
    def opt_state_bytes_per_device(self) -> int:
        """Bytes of optimizer state on THIS rank: the full state when
        replicated, about 1/dp of it under zero1 (plus padding and the
        leaves kept replicated)."""
        return sum(t.numel() * t.element_size()
                   for t in self._adapter.leaves())

    @property
    def param_gather_bytes(self) -> int:
        """Bytes each rank receives in a step's parameter (or delta)
        gather under zero1 (the JAX trainer's accounting); 0 when
        replicated."""
        dp = self._dp.size
        if dp <= 1 or self.partition != "zero1":
            return 0
        ad = self._adapter
        if isinstance(ad, _OverlapOptAdapter):
            return sum(lay.padded * 4 for lay in ad.layouts) * (dp - 1) // dp
        if isinstance(ad, _ArenaOptAdapter):
            return self.layout.padded * 4 * (dp - 1) // dp
        total = 0
        for p, info in zip(self.params, ad.infos):
            if info is not None:
                padded = p.numel() // max(info.size, 1) * info.padded
                total += padded * p.element_size() * (dp - 1) // dp
        return total

    @property
    def collective_bytes_per_step(self) -> int:
        """Bytes a rank moves in ONE step's collectives (the JAX trainer's
        model): the gradient reduction (an all-reduce moves 2 (dp-1)/dp
        of the whole parameters' gradient bytes, the reduce-scatter of
        zero1 half that) plus the parameter gather."""
        dp = self._dp.size
        if dp <= 1:
            return 0
        gbytes = sum(_prod(s) * 4 for s in self._full_shapes)
        classic_z1 = self.partition == "zero1" and \
            not isinstance(self._adapter, _OverlapOptAdapter)
        red = (1 if classic_z1 else 2) * gbytes * (dp - 1) // dp
        return red + self.param_gather_bytes

    @property
    def dp_size(self) -> int:
        """The ranks of the data axis."""
        return self._dp.size

    @property
    def _gathers_on_save(self) -> bool:
        """Whether a checkpoint capture is collective (every rank calls
        ``save_states`` / ``state_shards``; rank 0 writes)."""
        return self.mesh.size > 1

    # -- the low-precision policy -------------------------------------------
    def _init_policy(self, compute_dtype, loss_scaling, init_loss_scale):
        """``compute_dtype`` and dynamic loss scaling (module docstring),
        with the JAX trainer's errors."""
        if isinstance(compute_dtype, str):
            if compute_dtype not in _DTYPES:
                raise MXNetError(f"compute_dtype={compute_dtype!r} unknown; "
                                 f"use one of {sorted(_DTYPES)}")
            compute_dtype = _DTYPES[compute_dtype]
        if compute_dtype is not None and (
                not isinstance(compute_dtype, torch.dtype)
                or not compute_dtype.is_floating_point):
            raise MXNetError(f"compute_dtype={compute_dtype!r} is not a "
                             "floating torch dtype")
        #: the policy's forward dtype (None = pure f32)
        self.compute_dtype = compute_dtype
        if loss_scaling not in ("auto", True, False):
            raise MXNetError(f"loss_scaling={loss_scaling!r} unknown; use "
                             "'auto', True or False")
        if loss_scaling == "auto":
            dynamic = compute_dtype == torch.float16
        else:
            dynamic = bool(loss_scaling)
            if dynamic and compute_dtype is None:
                raise MXNetError(
                    "loss_scaling=True without a compute_dtype: f32 steps "
                    "cannot overflow, scaling would only mask a config bug")
        self._dynamic_scaling = dynamic
        self._growth = _GROWTH_INTERVAL
        self._buffer_copies = []
        kw = dict(device=self.device)
        # the arena's segments: each leaf, and each run of padding
        lay = self.layout
        segs, at = [], 0
        for off, size in sorted(zip(lay.offsets, lay.sizes)):
            if off > at:
                segs.append(off - at)
            segs.append(size)
            at = off + size
        if lay.padded > at:
            segs.append(lay.padded - at)
        self._segments = torch.tensor(segs, **kw)
        self._scale = torch.tensor(float(init_loss_scale) if dynamic else 1.0,
                                   dtype=torch.float32, **kw)
        self._good = torch.zeros((), dtype=torch.int32, **kw)
        self._skipped = torch.zeros((), dtype=torch.int32, **kw)
        self._amp_tel_every = int(get_env("MXNET_AMP_TELEMETRY_EVERY", 50,
                                          int))

    @property
    def loss_scale(self) -> float:
        """The dynamic loss scale (1.0 when scaling is off); reading it
        waits for the last dispatched step."""
        return float(self._scale)

    @property
    def skipped_steps(self) -> int:
        """Updates skipped on non-finite gradients since construction
        (dynamic loss scaling only; 0 otherwise).  Reading it waits for
        the last dispatched step."""
        return int(self._skipped)

    def _swap(self) -> Dict[str, torch.Tensor]:
        """The tensors the forward runs on in place of the net's own: each
        sharded parameter gathered whole (``_GatherParam``), and under
        ``compute_dtype`` every floating parameter and buffer cast (the
        buffers' copies kept, with their version counters, for
        :meth:`_carry_buffers`)."""
        swap = {}
        summed = set(self._summed_axes())
        for i, plan in self._shards.items():
            swap[self.train_names[i]] = _GatherParam.apply(
                self.params[i], plan, self.mesh, summed)
        if self.compute_dtype is None:
            return swap
        dt = self.compute_dtype
        for n, t in self.net.named_parameters():
            swap[n] = _cast(swap.get(n, t), dt)
        self._buffer_copies = []
        for n, b in self.net.named_buffers():
            swap[n] = _cast(b, dt)
            if swap[n] is not b:
                self._buffer_copies.append((b, swap[n], swap[n]._version))
        return swap

    def _forward(self, xs):
        """The net on ``xs``, under the policy and the sharding: the f32
        net as it is, or the net on :meth:`_swap`'s tensors
        (``torch.func.functional_call``), the floating inputs cast to
        ``compute_dtype``.  A hybridized net runs eagerly here: the step
        is a program of its own (the JAX trainer jits the whole step),
        and the swapped tensors are new every step."""
        with eager_calls():
            swap = self._swap()
            if not swap:
                return self.net(*xs)
            if self.compute_dtype is not None:
                xs = _cast(xs, self.compute_dtype)
            return torch.func.functional_call(self.net, swap, xs)

    def _carry_buffers(self):
        """Write every buffer copy that the 16-bit forward wrote in place
        (BatchNorm's blended running statistics) into its f32 buffer."""
        for buf, copy16, version in self._buffer_copies:
            if copy16._version != version:
                buf.copy_(copy16)
        self._buffer_copies = []

    def _update_scaled(self, lr, unscale: bool = True):
        """The update under dynamic loss scaling: unscale (unless a
        gradient-accumulation window already did), check, update, then
        keep the old parameters and optimizer states where the check
        failed, and move the scale; all on the device.

        The check is :func:`all_finite` on the arena: the f32 sum of each
        gradient's segment.  The select works on the f32 storages' bits
        as int32 (``new * ok + old * (1 - ok)`` is exact in integers,
        where in floats a NaN or inf of a skipped update would survive a
        multiply by 0): a copy before the update and three multi-tensor
        ops after it, over the adapter's storages (a multi-tensor group's
        stacked tensors, not its views)."""
        g = self._gred
        if unscale:
            g.div_(self._scale)
        ok = self._adapter.finite(g, self._segments)
        leaves = [t.view(torch.int32)
                  for t in self._adapter.storages(self.params)]
        old = torch._foreach_mul(leaves, 1)
        self._adapter.update(self.params, self._gviews, self._garena, lr,
                             self._t)
        keep = ok.to(torch.int32)
        torch._foreach_mul_(leaves, keep)
        torch._foreach_add_(leaves, torch._foreach_mul(old, 1 - keep))
        grown = self._good + 1 >= self._growth
        self._scale = torch.where(
            ok, torch.where(grown, self._scale * 2.0, self._scale),
            torch.clamp(self._scale * 0.5, min=1.0))
        self._good = torch.where(ok, torch.where(grown, 0, self._good + 1),
                                 0).to(torch.int32)
        self._skipped = torch.where(ok, self._skipped, self._skipped + 1)

    def _publish_amp_gauges(self):
        """``amp.loss_scale`` / ``amp.skipped_steps`` every
        ``MXNET_AMP_TELEMETRY_EVERY`` (default 50) steps: the read waits
        for the step, so it is gated to keep the in-flight window deep."""
        if not (self._dynamic_scaling and _tel._ENABLED
                and self._amp_tel_every
                and self._t % self._amp_tel_every == 0):
            return
        _tel.set_gauge("amp.loss_scale", self.loss_scale)
        _tel.set_gauge("amp.skipped_steps", self.skipped_steps)

    # -- adapters -----------------------------------------------------------
    @property
    def uses_arena(self) -> bool:
        """True when the flat-arena kernel runs the update."""
        return isinstance(self._adapter, _ArenaOptAdapter)

    # -- lr ------------------------------------------------------------------
    @property
    def learning_rate(self) -> float:
        """The lr of the last update (``lr_scheduler(t)`` under a
        schedule), and so of the next one without a schedule."""
        if self.lr_scheduler is not None:
            return float(self.lr_scheduler(self._t))
        return self._lr

    def set_learning_rate(self, lr: float):
        if self.lr_scheduler is not None:
            raise MXNetError(
                "LRScheduler of the trainer has already been defined; "
                "mutate the scheduler instead of calling set_learning_rate")
        self._lr = float(lr)

    # -- the step ------------------------------------------------------------
    def _attach_grads(self):
        """Point every ``.grad`` at its view of the gradient arena (again,
        where something replaced it)."""
        for p, view in zip(self.params, self._gviews):
            if p.grad is not view:
                p.grad = view

    def step(self, x, y, block: bool = False):
        """One training step on batch ``(x, y)`` (host arrays or tensors;
        ``x`` a tuple for a multi-input net).  Returns the loss as a lazy
        0-d tensor; ``block=True`` drains the in-flight steps and returns
        a float.

        The step records the JAX trainer's spans: ``trainer.step`` (timer
        ``trainer.step_seconds``) under the correlation ``step=t+1`` (a
        grad-accumulation window's micro-batches all belong to the
        upcoming update), around ``trainer.dispatch`` (the forward,
        backward and update, or a micro-batch's forward and backward
        with ``micro=``) and, at a window's last micro-batch,
        ``trainer.apply_update``.  ``aot`` is always False: the port
        has no compiled executables."""
        with _tr.correlate(step=self._t + 1), \
                _tr.span("trainer.step", timer="trainer.step_seconds",
                         timer_on_error=True):
            loss = self._step(_on(x, self.device), _on(y, self.device))
        if block:
            self.drain()
            return float(loss)
        return loss

    def _grad(self, xs, y):
        """The forward and backward of one batch into the gradient arena
        (the buffers' 16-bit copies carried back after); the loss.  On
        the pipeline axis ``xs`` is one window ``(m, rows, ...)`` and the
        loss is the window's mean."""
        self._attach_grads()
        self._garena.zero_()
        dp = self._dp
        with _ag.record(), _nn.batch_stats_group(dp.group):
            if self._pp_stages is not None:
                pred = self._pp_forward(xs[0])
                pred = pred.flatten(0, 1)
                y = y.flatten(0, 1)
            else:
                pred = self._forward(xs)
            loss = self.loss_fn(pred, y).mean().float()
            if dp.size > 1:
                # this rank's rows' share of the global mean
                loss = loss / dp.size
            (loss * self._scale if self._dynamic_scaling else loss).backward()
        if self.compute_dtype is not None:
            with torch.no_grad():
                self._carry_buffers()
        if dp.size > 1:
            loss = _coll.all_reduce_(loss.detach().clone(), dp.group)
        return loss

    def _step(self, xs, y):
        if not self.mesh.member:
            raise MXNetError(
                f"ShardedTrainer: rank {_rank()} lies outside the mesh "
                f"{self.mesh.shape} (make_mesh devices=): it has no rows, "
                "no shard and no group to step with")
        xs = xs if isinstance(xs, tuple) else (xs,)
        if self._pp_stages is not None:
            loss = self._pp_step(xs, y)
        elif self.grad_accum <= 1:
            self._t += 1
            with _tr.span("trainer.dispatch", aot=False):
                loss = self._grad(xs, y)
                with torch.no_grad():
                    self._apply(unscale=True)
        else:
            with _tr.span("trainer.dispatch", aot=False, micro=self._micro):
                loss = self._grad(xs, y)
            with torch.no_grad():
                if self._accumulate():
                    self._t += 1
                    with _tr.span("trainer.apply_update", aot=False):
                        self._apply_window()
        self._publish_amp_gauges()
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        self._inflight.push(event)
        return loss.detach()

    # -- the pipeline ('pp') axis ---------------------------------------------
    def _pp_step(self, xs, y):
        """A pipeline micro-batch (module docstring): buffered until the
        window's ``grad_accum``-th call, which runs the GPipe schedule
        over the stacked window, updates once and returns the window's
        mean loss; the others return 0."""
        if len(xs) != 1 or isinstance(y, tuple):
            raise MXNetError("pipeline ('pp') trainers take single-array "
                             "x/y batches (tuple batches unsupported)")
        self._pp_validate(xs[0])
        self._pp_buf.append((xs[0], y))
        self._micro += 1
        if self._micro < self.grad_accum:
            return torch.zeros((), dtype=torch.float32, device=self.device)
        xb = torch.stack([b[0] for b in self._pp_buf])
        yb = torch.stack([b[1] for b in self._pp_buf])
        self._pp_buf, self._micro = [], 0
        self._t += 1
        with _tr.span("trainer.dispatch", aot=False, pp=self._dp.pp):
            loss = self._grad((xb,), yb)
            with torch.no_grad():
                self._apply(unscale=True)
        return loss

    def _gathered(self) -> Dict[str, torch.Tensor]:
        """Every sharded parameter whole, outside autograd."""
        return {self.train_names[i]: _gather_whole(self.params[i], plan,
                                                   self.mesh)
                for i, plan in self._shards.items()}

    def _swapped(self, swap):
        """A block in which the net's modules hold ``swap``'s tensors."""
        if not swap:
            return contextlib.nullcontext()
        from torch.nn.utils.stateless import _reparametrize_module

        return _reparametrize_module(self.net, swap, tie_weights=True)

    @torch.no_grad()
    def _pp_validate(self, x):
        """Before the first window, on every rank alike: the stages' fold
        must reproduce the net's forward (rel 1e-5, inference mode), and
        no stage may mutate state in training mode (a buffer written, a
        random draw).  Records each stage's output shape (the carrier's
        layout)."""
        if self._pp_shapes is not None:
            return
        x = x.float() if x.is_floating_point() else x
        with eager_calls(), self._swapped(self._gathered()):
            with _ag.pause(train_mode=False):
                want = self.net(x)
                got, shapes = x, []
                for st in self._pp_stages:
                    got = st(got)
                    shapes.append(tuple(got.shape[1:]))
            scale = max(float(want.abs().max()), 1e-6)
            rel = float((want - got).abs().max()) / scale
            if rel > 1e-5:
                raise MXNetError(
                    f"pipeline stage split does not reproduce the net's "
                    f"forward (rel err {rel:.2e}): the net's forward is not "
                    "the fold of its registered children; restructure it "
                    "as (Hybrid)Sequential chains or drop the 'pp' axis")
            buffers = list(self.net.named_buffers())
            saved = [b.clone() for _, b in buffers]
            gen = _random.generator(x.device)
            gen_state = gen.get_state()
            try:
                h = x
                with _ag.train_mode():
                    for k, st in enumerate(self._pp_stages):
                        before = [(id(b), b._version) for _, b in
                                  self.net.named_buffers()]
                        g0 = gen.get_state()
                        h = st(h)
                        after = [(id(b), b._version) for _, b in
                                 self.net.named_buffers()]
                        moved = sum(a != b for a, b in zip(before, after))
                        drew = not torch.equal(g0, gen.get_state())
                        if moved or drew:
                            raise MXNetError(
                                f"pipeline stage {k} mutated "
                                f"{moved + int(drew)} state array(s): the "
                                "'pp' axis needs mutation-free forwards "
                                "(BatchNorm running stats / RNG draws "
                                "update outside the GPipe schedule)")
            finally:
                for (_, b), v in zip(buffers, saved):
                    b.copy_(v)
                gen.set_state(gen_state)
        self._pp_shapes = shapes

    def _pp_forward(self, xb):
        """The GPipe schedule over the window ``xb`` ``(m, rows, ...)``:
        this rank runs its stage (``pipeline_apply_stages`` over ``pp``)
        on the swapped tensors; the last stage's outputs, ``(m, rows,
        ...)``, on every rank."""
        from .pipeline import _flat, pipeline_apply_stages

        shapes = self._pp_shapes
        widths = [_prod(t) for t in shapes]
        cw, stages = max(widths), self._pp_stages
        dt = self.compute_dtype

        def call(j, a):
            if j > 0:
                a = a[:, :widths[j - 1]].reshape((a.shape[0],)
                                                 + shapes[j - 1])
            return _flat(stages[j](a), cw)

        calls = [lambda a, j=j: call(j, a) for j in range(len(stages))]
        m, rows = xb.shape[0], xb.shape[1]
        with eager_calls(), self._swapped(self._swap()):
            flat = pipeline_apply_stages(
                calls, _cast(xb, dt) if dt is not None else xb, cw,
                widths[-1], _PP, mesh=self.mesh,
                dtype=dt if dt is not None else torch.float32)
        return flat.reshape((m, rows) + shapes[-1])

    @property
    def pp_bubble_fraction(self) -> float:
        """GPipe's idle share of this trainer's window (0 without
        ``pp``), the ``trainer.pp_bubble_fraction`` gauge."""
        from .pipeline import bubble_fraction

        return bubble_fraction(self._dp.pp, self.grad_accum) \
            if self._pp_stages is not None else 0.0

    def _apply_window(self):
        """A window's update: the mean of its accumulated gradients into
        the arena, then the optimizer."""
        torch.div(self._accum, self.grad_accum, out=self._garena)
        self._apply(unscale=False)

    def _accumulate(self) -> bool:
        """Add this micro-batch's unscaled f32 gradients to the window's
        accumulator, in the JAX order; True on the window's last one."""
        g = self._garena
        if self._dynamic_scaling:
            g = g.div_(self._scale)
        if self._micro == 0:
            if self._accum is None:
                self._accum = torch.empty_like(self._garena)
            self._accum.copy_(g)
        else:
            self._accum.add_(g)
        self._micro += 1
        if self._micro < self.grad_accum:
            return False
        self._micro = 0
        return True

    def _apply(self, unscale: bool, lr: Optional[float] = None):
        """The optimizer update of step ``self._t`` from the gradient
        arena, at ``lr`` (default the lr read after the count rose)."""
        lr = self.learning_rate if lr is None else float(lr)
        self._gred = self._adapter.reduce(self._garena)
        if self._dynamic_scaling:
            self._update_scaled(lr, unscale)
        else:
            self._adapter.update(self.params, self._gviews, self._garena,
                                 lr, self._t)

    def drain(self):
        """Wait for every in-flight step."""
        self._inflight.drain()

    # -- cost attribution (trace.cost) ----------------------------------------
    @staticmethod
    def _batch_sig(xs, y) -> tuple:
        def leaf(v):
            if isinstance(v, (tuple, list)):
                return tuple(leaf(e) for e in v)
            return (tuple(v.shape), str(v.dtype).replace("torch.", ""))

        return (leaf(xs), leaf(y))

    def _cost_key(self, sig) -> tuple:
        fused = self.grad_accum <= 1 or self._pp_stages is not None
        return ("trainer", type(self.net).__name__,
                "step" if fused else "grad+apply", sig)

    @contextlib.contextmanager
    def _kept_state(self):
        """Run a block that trains (a count) and then put every piece of
        the trainer's state back as it was, bit for bit and in the same
        storages: parameters, buffers, optimizer state, the gradient
        arena (and the arena adapter's delta, the window's accumulator),
        the step and micro-batch counts, the loss-scale state and the
        dropout generator."""
        ad = self._adapter
        kept = [self._garena] + list(ad.storages(self.params)) + \
            [b for _, b in self.net.named_buffers()]
        if isinstance(ad, _ArenaOptAdapter):
            kept.append(ad._delta)
        if self._accum is not None:
            kept.append(self._accum)
        seen, unique = set(), []
        for t in kept:
            if id(t) not in seen:
                seen.add(id(t))
                unique.append(t)
        with torch.no_grad():
            saved = [t.clone() for t in unique]
        scalars = (self._t, self._micro, self._accum, self._scale,
                   self._good, self._skipped)
        amp = [t.clone() for t in scalars[3:]]
        gen = _random.generator(self.device)
        gen_state = gen.get_state()
        try:
            yield
        finally:
            with torch.no_grad():
                for t, v in zip(unique, saved):
                    t.copy_(v)
                for t, v in zip(scalars[3:], amp):
                    t.copy_(v)
            (self._t, self._micro, self._accum, self._scale, self._good,
             self._skipped) = scalars
            self._buffer_copies = []
            gen.set_state(gen_state)
            self._attach_grads()

    def _cost_info(self, batch):
        xs, y = _on(batch[0], self.device), _on(batch[1], self.device)
        key = self._cost_key(self._batch_sig(xs, y))
        info = _cost.get(key)
        if info is not None:
            return key, info
        if self.device.type == "cuda" and \
                torch.cuda.is_current_stream_capturing():
            raise MXNetError("ShardedTrainer.xla_cost: a count runs the "
                             "step eagerly and cannot run inside a CUDA "
                             "graph capture")
        xs = xs if isinstance(xs, tuple) else (xs,)
        self.drain()
        if self._pp_stages is not None:
            return key, self._pp_cost(key, xs, y)
        with self._kept_state(), eager_calls():
            if self.grad_accum <= 1:
                def step():
                    self._t += 1
                    self._grad(xs, y)
                    with torch.no_grad():
                        self._apply(unscale=True)

                return key, _cost.register(key, step)
            _cost.register(key, lambda: self._grad(xs, y))
            with torch.no_grad():
                if self._dynamic_scaling:
                    self._garena.div_(self._scale)
                self._accum = self._garena.clone()
                self._t += 1
            # one update a window of k step() calls: amortized so the
            # stored cost is what ONE call runs
            apply = _cost.extract(torch.no_grad()(self._apply_window))
            k = float(self.grad_accum)
            _cost.register(key, info={
                "flops": apply["flops"] / k,
                "bytes_accessed": apply["bytes_accessed"] / k},
                accumulate=True)
        return key, _cost.get(key)

    def _pp_cost(self, key, xs, y):
        """A pipelined window of ``grad_accum`` copies of the batch,
        counted and amortized to one ``step()`` call (the JAX trainer's
        rule: the window runs once every ``grad_accum`` calls)."""
        if len(xs) != 1 or isinstance(y, tuple):
            raise MXNetError("pipeline ('pp') trainers take single-array "
                             "x/y batches (tuple batches unsupported)")
        self._pp_validate(xs[0])
        k = self.grad_accum
        xb, yb = torch.stack([xs[0]] * k), torch.stack([y] * k)

        def window():
            self._t += 1
            self._grad((xb,), yb)
            with torch.no_grad():
                self._apply(unscale=True)

        with self._kept_state(), eager_calls():
            info = _cost.extract(window)
        return _cost.register(key, info={
            "flops": info["flops"] / k,
            "bytes_accessed": info["bytes_accessed"] / k})

    def xla_cost(self, batch) -> Optional[Dict[str, Any]]:
        """The counted work of ONE ``step()`` call for ``batch``'s shapes
        and types: ``{"flops": ..., "bytes_accessed": ...}``
        (``trace.cost``: PyTorch's FLOP counter plus the kernels'
        reported work; the key is the JAX trainer's).  Under
        ``grad_accum=k`` a call runs one forward and backward and 1/k of
        an update, so the update's count is amortized over the window
        before summing.  The first call for a batch signature runs a
        forward, a backward and an update eagerly to count them, and
        then puts the whole training state back as it was (parameters,
        buffers, optimizer state, the gradient arena, the counts, the
        loss-scale state, the dropout generator); later calls read the
        registry."""
        return self._cost_info(batch)[1]

    def publish_xla_utilization(self, batch, seconds_per_step: float,
                                prefix: str = "trainer") -> Dict[str, Any]:
        """Publish the achieved-vs-counted utilization gauges
        (``trainer.xla_utilization`` & co, ``trace.cost``) for a measured
        ``seconds_per_step`` — seconds per ``step()`` CALL (grad-accum
        included; :meth:`xla_cost` amortizes the update to match) — on
        ``batch``'s shapes, and return the row-ready dict ``bench.py``
        embeds.  ``collective_exposed_seconds`` is 0.0: the port does
        not yet split a step's time between compute and collectives (one
        device runs none; under dp the bytes are
        :attr:`collective_bytes_per_step`)."""
        key, info = self._cost_info(batch)
        if info is None:
            return {}
        cols = _cost.publish(key, seconds_per_step, prefix=prefix)
        if info.get("bytes_accessed"):
            if _tel._ENABLED:
                _tel.observe("trainer.collective_exposed_seconds", 0.0)
            cols = dict(cols)
            cols["collective_exposed_seconds"] = 0.0
        return cols

    # -- checkpoints ---------------------------------------------------------
    def _check_window(self, what: str):
        if self._micro != 0:
            raise MXNetError(
                f"{what} called mid gradient-accumulation window "
                f"({self._micro}/{self.grad_accum} micro-batches pending); "
                f"step to a window boundary first")

    def save_states(self, fname: Optional[str]):
        """The whole training state into one ``.npz`` in the JAX
        trainer's keys (module docstring), written atomically
        (``resilience.checkpoint.write_payload``).  On dp ranks every
        rank must call it (the sharded optimizer state is gathered) and
        rank 0 writes; another rank may pass ``fname=None``.  Raises in
        the middle of a gradient-accumulation window."""
        from ..resilience.checkpoint import write_payload

        self._check_window("save_states")
        self.drain()
        with _tr.span("ckpt.save_states", step=self._t):
            blob = self._state_blob()
            if self._dp.rank == 0 and _rank() == 0:
                if fname is None:
                    raise MXNetError("save_states: rank 0 needs a file name")
                write_payload(fname, lambda f: np.savez(f, **blob))

    def _state_blob(self) -> Dict[str, np.ndarray]:
        blob = {}
        for i, (n, p) in enumerate(zip(self.train_names, self.params)):
            blob[f"param/{n}"] = self._whole_param(i).cpu().numpy()
        for n, b in self.net.named_buffers():
            blob[f"aux/{n}"] = b.detach().cpu().numpy()
        for i, (leaf, plan) in enumerate(zip(self._adapter.ckpt_leaves(),
                                             self._opt_plans())):
            if plan is not None:
                leaf = _gather_whole(leaf, plan, self.mesh)
            blob[f"opt/{i}"] = leaf.detach().cpu().numpy()
        blob.update(self._meta_blob())
        return blob

    def _whole_param(self, i: int) -> torch.Tensor:
        """Trained parameter ``i`` whole (gathered when sharded)."""
        p = self.params[i].detach()
        plan = self._shards.get(i)
        return p if plan is None else _gather_whole(p, plan, self.mesh)

    def _opt_plans(self) -> List[Optional[_Sharded]]:
        """For each optimizer leaf (checkpoint order), its parameter's
        sharding when the leaf is shaped as the parameter's shard (the
        leaf is sharded with it), else None."""
        ad = self._adapter
        if not self._shards:
            return [None] * len(self._opt_storage())
        out = []
        for (leaf, _, clip), owner in zip(self._opt_storage(), ad.owners()):
            shape = clip if clip is not None else tuple(leaf.shape)
            plan = self._shards.get(owner)
            out.append(plan if plan is not None and tuple(shape) ==
                       tuple(self.params[owner].shape) else None)
        return out

    def _meta_blob(self):
        # meta/key: the JAX trainer reads a PRNG key (it has no torch
        # generator); the port writes jax.random.PRNGKey(seed)'s raw
        # [0, seed] of its own seed, and keeps its dropout generator's
        # state under meta/torch_generator
        return {"meta/t": np.asarray(self._t),
                "meta/key": np.asarray([0, _random._SEED & 0xFFFFFFFF],
                                       np.uint32),
                "meta/scale": np.asarray(float(self._scale), np.float32),
                "meta/good": np.asarray(int(self._good), np.int32),
                "meta/skipped": np.asarray(int(self._skipped), np.int32),
                "meta/torch_generator":
                    _random.generator(self.device).get_state().numpy()}

    def load_states(self, fname: str):
        """Restore a :meth:`save_states` checkpoint (the port's or the JAX
        trainer's, of any mesh and partition) into this trainer, in
        place: parameters, buffers, optimizer state (re-sharded onto this
        trainer's layout), step count and loss-scale state, and the
        dropout generator where the file holds the port's.  A
        per-parameter checkpoint on an arena trainer, or the other way
        round, raises."""
        with _tr.span("ckpt.load_states"):
            self.drain()
            with np.load(fname) as z:
                blob = {k: z[k] for k in z.files}
            self._load_blob(blob)

    def _ckpt_shapes(self):
        """The whole, unpadded shape of each optimizer leaf in a
        checkpoint."""
        out = []
        for (leaf, _, clip), plan in zip(self._opt_storage(),
                                         self._opt_plans()):
            shape = list(clip if clip is not None else leaf.shape)
            for dim, axes in (plan.dims if plan is not None else ()):
                shape[dim] *= self.mesh.axis_size(axes)
            out.append(tuple(shape))
        return out

    @torch.no_grad()
    def _load_blob(self, blob):
        for key in blob:
            if key.startswith("param/") and \
                    key[len("param/"):] not in self.train_names:
                raise MXNetError(f"checkpoint param '{key[6:]}' unknown")
        shapes = self._ckpt_shapes()
        n_blob = sum(1 for k in blob if k.startswith("opt/"))
        if n_blob != len(shapes):
            raise _layout_mismatch(f"{n_blob} saved leaves, {len(shapes)} "
                                   "expected")
        for i, want in enumerate(shapes):
            v = blob[f"opt/{i}"]
            if tuple(v.shape) != want:
                raise _layout_mismatch(f"leaf {i} has shape "
                                       f"{tuple(v.shape)}, expected {want}")
        from ..gluon.parameter import mark_initialized

        for i, (n, p) in enumerate(zip(self.train_names, self.params)):
            p.copy_(self._my_block(blob[f"param/{n}"], self._shards.get(i)))
            mark_initialized(p)
        for n, b in self.net.named_buffers():
            b.copy_(torch.from_numpy(np.asarray(blob[f"aux/{n}"])))
            mark_initialized(b)
        self._adapter.load_leaves([
            self._my_block(blob[f"opt/{i}"], plan)
            for i, plan in enumerate(self._opt_plans())])
        self._t = int(blob["meta/t"])
        self._scale.fill_(float(blob["meta/scale"]))
        self._good.fill_(int(blob["meta/good"]))
        self._skipped.fill_(int(blob.get("meta/skipped", 0)))
        if "meta/torch_generator" in blob:
            _random.generator(self.device).set_state(
                torch.from_numpy(np.asarray(blob["meta/torch_generator"])))
        self._micro, self._accum, self._pp_buf = 0, None, []
        self._publish_layout_gauges()

    def _my_block(self, whole, plan: Optional[_Sharded]) -> torch.Tensor:
        """This rank's block of a whole host array under ``plan`` (the
        whole array when None), as a CPU tensor."""
        t = torch.from_numpy(np.ascontiguousarray(whole))
        return t if plan is None else _take_shard(t, plan, self.mesh)

    # -- shard-wise checkpoints (manifest v2, resilience.reshard) ------------
    def _shard_leaves(self):
        """``(key, value, clip_shape)`` in checkpoint order, as the JAX
        trainer lists them: replicated leaves whole, and each sharded
        leaf (a parameter split by its spec, an optimizer leaf split by
        zero1 and / or its parameter's spec) as a ``reshard.Slices`` of
        its shards' boxes in the padded storage, clipped to the unpadded
        shape.  Collective: every rank calls it."""
        from ..resilience import reshard as _reshard

        mesh = self.mesh
        leaves = []
        for i, (n, p) in enumerate(zip(self.train_names, self.params)):
            plan = self._shards.get(i)
            if plan is None:
                leaves.append((f"param/{n}", p.detach().cpu().numpy(), None))
                continue
            whole = self._whole_param(i).cpu().numpy()
            splits = {d: mesh.axis_size(a) for d, a in plan.dims}
            leaves.append((f"param/{n}", _reshard.Slices(
                whole.shape, p.dtype, _boxes(whole, splits)), None))
        for n, b in self.net.named_buffers():
            leaves.append((f"aux/{n}", b.detach().cpu().numpy(), None))
        dp = self._dp
        for i, ((leaf, axis, clip), plan) in enumerate(zip(
                self._opt_storage(), self._opt_plans())):
            zero1 = axis is not None and dp.size > 1
            if not zero1 and plan is None:
                leaves.append((f"opt/{i}", leaf.detach().cpu().numpy(), clip))
                continue
            whole, splits = leaf.detach(), {}
            if zero1:
                whole = _coll.all_gather(whole, dp.axis, axis=axis,
                                         mesh=dp.mesh)
                splits[axis] = dp.size
            if plan is not None:
                whole = _gather_whole(whole, plan, mesh)
                splits.update({d: mesh.axis_size(a) for d, a in plan.dims})
            whole = whole.cpu().numpy()
            if clip is not None and plan is not None:
                clip = tuple(c * splits.get(d, 1) if d != axis else c
                             for d, c in enumerate(clip))
            leaves.append((f"opt/{i}", _reshard.Slices(
                whole.shape, leaf.dtype, _boxes(whole, splits)), clip))
        return leaves

    def _opt_storage(self):
        """``(leaf, sharded axis or None, unpadded shape or None)`` of each
        optimizer leaf as this rank stores it."""
        ad = self._adapter
        out = []
        if isinstance(ad, _ArenaOptAdapter):
            for leaf in ad.states:
                out.append((leaf, 0 if ad._sharded else None,
                            (self.layout.total,)))
        elif isinstance(ad, _OverlapOptAdapter):
            for st, lay in zip(ad.states, ad.layouts):
                for leaf in _tensors(st):
                    out.append((leaf, 0 if ad.dp.size > 1 else None,
                                (lay.total,)))
        elif isinstance(ad, _Zero1LeafAdapter):
            for leaf, info in ad._owned():
                if info is None:
                    out.append((leaf, None, None))
                else:
                    out.append((leaf, info.axis, tuple(
                        info.size if k == info.axis else d
                        for k, d in enumerate(leaf.shape))))
        else:
            out = [(leaf, None, None) for leaf in ad.leaves()]
        return out

    def state_shards(self, dirname: Optional[str]):
        """Write this trainer's whole state shard-wise under ``dirname``
        (one ``shards.bin``, ``resilience.reshard``): each optimizer leaf
        as its ranks' slices, padding clipped.  Returns the ``(leaves,
        meta)`` sections ``CheckpointManager`` puts in its manifest v2.
        On dp ranks every rank must call it; rank 0 writes (another rank
        may pass ``dirname=None`` and gets ``None``)."""
        from ..resilience import reshard as _reshard

        self._check_window("state_shards")
        self.drain()
        with _tr.span("ckpt.state_shards", step=self._t):
            triples = self._shard_leaves()
            gen = _random.generator(self.device).get_state().numpy()
            meta = {"t": int(self._t),
                    "key": gen.tolist(), "key_dtype": gen.dtype.name,
                    "scale": float(self._scale), "good": int(self._good),
                    "skipped": int(self._skipped)}
            if _rank() != 0:
                return None
            if dirname is None:
                raise MXNetError("state_shards: rank 0 needs a directory")
            leaves = _reshard.write_shards(dirname, triples)
        return leaves, meta

    def load_state_shards(self, dirname: str, manifest: dict):
        """Restore a manifest-v2 checkpoint (the port's or the JAX
        trainer's) onto this trainer's layout: each rank reads only the
        slices its own boxes intersect, padding re-added.  Leaf-count and
        shape mismatches (per-parameter against flat arena) raise.  The
        byte accounting lands on :attr:`last_restore_stats`; a restore
        across layouts ticks ``resilience.reshards``."""
        with _tr.span("ckpt.load_state_shards"):
            self._load_state_shards_impl(dirname, manifest)

    @torch.no_grad()
    def _load_state_shards_impl(self, dirname, manifest):
        from ..resilience import reshard as _reshard

        leaves = _reshard.leaves_from_json(manifest["leaves"])
        try:
            meta = manifest["meta"]
            meta_t = int(meta["t"])
            meta_scale = float(meta["scale"])
            meta_good = int(meta["good"])
            meta_skipped = int(meta.get("skipped", 0))
            meta_key = np.asarray(meta["key"], dtype=meta.get("key_dtype",
                                                              "uint32"))
        except (KeyError, TypeError, ValueError) as e:
            raise MXNetError(
                f"manifest v2 'meta' section is malformed: {e}") from e
        by_key = {leaf.key: leaf for leaf in leaves}
        for leaf in leaves:
            if leaf.key.startswith("param/") and \
                    leaf.key[len("param/"):] not in self.train_names:
                raise MXNetError(
                    f"checkpoint param '{leaf.key[len('param/'):]}' unknown")
        storage = self._opt_storage()
        shapes = self._ckpt_shapes()
        n_blob = sum(1 for k in by_key if k.startswith("opt/"))
        if n_blob != len(storage):
            raise _layout_mismatch(f"{n_blob} saved leaves, {len(storage)} "
                                   "expected")
        stats = {"bytes_read": 0, "sharded_full_bytes": 0,
                 "sharded_max_rank_bytes": 0, "leaves_resharded": 0}
        dp, mesh = self._dp, self.mesh
        plans = self._opt_plans()
        placed = {}
        with _reshard.ShardReader(dirname, leaves) as rdr:
            entries = [(f"param/{n}", self._full_shapes[i], cur,
                        self._shards.get(i)) for i, (n, cur) in
                       enumerate(zip(self.train_names, self.params))]
            entries += [(f"aux/{n}", tuple(b.shape), b, None)
                        for n, b in self.net.named_buffers()]
            for key, want, cur, plan in entries:
                rec = by_key.get(key)
                if rec is None:
                    raise MXNetError(f"checkpoint is missing leaf {key!r}")
                if tuple(rec.shape) != tuple(want):
                    raise MXNetError(
                        f"checkpoint leaf {key!r} has shape "
                        f"{tuple(rec.shape)}; this trainer expects "
                        f"{tuple(want)}")
                if plan is None:
                    placed[key] = rdr.read(key)
                    continue
                box = _my_box(cur.shape, {d: mesh.axis_index(a)
                                          for d, a in plan.dims})
                placed[key] = rdr.read(key, box)
            opt_vals = []
            rank_bytes = 0
            for i, ((leaf, axis, clip), want) in enumerate(zip(storage,
                                                               shapes)):
                rec = by_key.get(f"opt/{i}")
                if rec is None:
                    raise MXNetError(f"checkpoint is missing leaf "
                                     f"{f'opt/{i}'!r}")
                if len(rec.shape) != len(want):
                    raise _layout_mismatch(
                        f"leaf {i} has rank {len(rec.shape)}, expected rank "
                        f"{len(want)}")
                if tuple(rec.shape) != tuple(want):
                    raise _layout_mismatch(
                        f"leaf {i} has shape {tuple(rec.shape)}, expected "
                        f"unpadded shape {tuple(want)}")
                src_boxes = {sl.box for sl in rec.slices}
                at, splits = {}, {}
                if axis is not None and dp.size > 1:
                    at[axis], splits[axis] = dp.rank, dp.size
                for d, a in (plans[i].dims if plans[i] is not None else ()):
                    at[d], splits[d] = mesh.axis_index(a), mesh.axis_size(a)
                if not at:
                    v = rdr.read(rec.key)
                    whole = tuple((0, d) for d in rec.shape)
                    if src_boxes != {whole}:
                        stats["leaves_resharded"] += 1
                    opt_vals.append(("whole", v))
                    rank_bytes += _reshard.full_bytes(rec)
                    continue
                gbox = _my_box(leaf.shape, at)
                cbox = _reshard.clip_box(gbox, rec.shape)
                local = np.zeros(tuple(leaf.shape), rec.dtype)
                if cbox is not None:
                    sub = rdr.read(rec.key, cbox)
                    local[tuple(slice(c0 - g0, c1 - g0) for (g0, _), (c0, c1)
                                in zip(gbox, cbox))] = sub
                rank_bytes += _reshard.plan_bytes(
                    rec, [cbox] if cbox is not None else [])
                stats["sharded_full_bytes"] += _reshard.full_bytes(rec)
                tgt = {_reshard.clip_box(b, rec.shape) for b in
                       _all_boxes(leaf.shape, splits)} - {None}
                if tgt != src_boxes:
                    stats["leaves_resharded"] += 1
                opt_vals.append(("local", local))
            stats["bytes_read"] = rdr.bytes_read
        stats["sharded_max_rank_bytes"] = rank_bytes
        # every leaf read and checked: change the trainer from here
        from ..gluon.parameter import mark_initialized

        for n, p in zip(self.train_names, self.params):
            p.copy_(torch.from_numpy(np.ascontiguousarray(
                placed[f"param/{n}"])))
            mark_initialized(p)
        for n, b in self.net.named_buffers():
            b.copy_(torch.from_numpy(placed[f"aux/{n}"]))
            mark_initialized(b)
        whole = [v for kind, v in opt_vals if kind == "whole"]
        if len(whole) == len(opt_vals):
            self._adapter.load_leaves(whole)
        else:
            for (leaf, _, _), (kind, v) in zip(storage, opt_vals):
                if kind == "local":
                    leaf.copy_(torch.from_numpy(v))
                else:
                    leaf.copy_(torch.from_numpy(np.asarray(v)))
        self._t = meta_t
        self._scale.fill_(meta_scale)
        self._good.fill_(meta_good)
        self._skipped.fill_(meta_skipped)
        if meta_key.dtype == np.uint8 and meta_key.size > 2:
            # the port's generator state (a JAX version holds its key)
            _random.generator(self.device).set_state(
                torch.from_numpy(meta_key))
        self._micro, self._accum, self._pp_buf = 0, None, []
        if stats["leaves_resharded"]:
            _tel.inc("resilience.reshards")
        self.last_restore_stats = stats
        self._publish_layout_gauges()

    # -- batch placement -----------------------------------------------------
    def device_put(self, batch):
        """This rank's batch (a host array, tensor or tuple tree of them)
        on the trainer's device: the placement ``DevicePrefetcher`` /
        ``DataLoader(prefetch_to_device=trainer)`` calls, so prefetched
        batches arrive placed and ``step`` skips its own copy.  Under dp
        each rank passes its own rows, as a multi-process JAX run passes
        its process-local data."""
        return _on(batch, self.device)


def _all_boxes(local_shape, splits: Dict[int, int]):
    """Every rank's box (global coordinates) of a leaf stored as blocks
    of ``local_shape``, dim ``d`` split into ``splits[d]`` blocks."""
    dims = sorted(splits)
    out = []
    for idx in itertools.product(*[range(splits[d]) for d in dims]):
        out.append(_my_box(local_shape, dict(zip(dims, idx))))
    return out


def _my_box(local_shape, at: Dict[int, int]):
    """The box of the block at index ``at[d]`` along each split dim ``d``
    of a leaf stored as blocks of ``local_shape``."""
    return tuple((at[k] * n, (at[k] + 1) * n) if k in at else (0, n)
                 for k, n in enumerate(local_shape))


def _boxes(whole: np.ndarray, splits: Dict[int, int]):
    """``(box, block)`` of each distinct block of ``whole`` split into
    ``splits[d]`` blocks along dim ``d``."""
    local = tuple(n // splits.get(k, 1) for k, n in enumerate(whole.shape))
    return [(box, whole[tuple(slice(a, b) for a, b in box)])
            for box in _all_boxes(local, splits)]


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def _layout_mismatch(detail) -> MXNetError:
    """The JAX trainer's refusal to load optimizer state of another
    layout (per-parameter against flat arena)."""
    return MXNetError(
        f"checkpoint optimizer state does not match this trainer's layout "
        f"({detail}): it was saved under a different optimizer layout "
        "(per-param vs flat-arena) or optimizer; rebuild the trainer with "
        "the matching fused_opt setting")


def make_train_step(net, loss_fn, names=None, optimizer="sgd",
                    learning_rate: float = 0.01, weight_decay: float = 0.0,
                    momentum: float = 0.9, donate: bool = True,
                    compute_dtype=None,
                    loss_scale_growth_interval: int = _GROWTH_INTERVAL,
                    multi_tensor: bool = False, shardings_box=None,
                    partition: str = "replicated",
                    fused_opt: Optional[str] = None, overlap: bool = False,
                    pipeline: Optional[Dict[str, Any]] = None,
                    loss_scaling: Any = "auto", mesh=None,
                    spec_fn: Callable = replicated_spec_fn,
                    grad_accum: int = 1):
    """The JAX builder's signature over tensors: ``(step, grad_fn,
    apply_fn, adapter, holder)``.

    ``step(tvals, avals, rng, opt_state, t, lr, scale_state, x, y) ->
    (tvals', mutated, opt_state', scale_state', loss)``, ``grad_fn(tvals,
    avals, rng, scale, x, y) -> (grads, mutated, loss)`` and
    ``apply_fn(tvals, opt_state, t, lr, scale_state, grads) -> (tvals',
    opt_state', scale_state')``.  ``tvals`` are the trained parameters
    (sorted by name), ``avals`` the buffers, ``opt_state`` the optimizer
    leaves (``adapter.leaves()``), ``scale_state`` ``(scale, good,
    skipped)``, ``rng`` the dropout generator's state (or None).  The
    functions run a :class:`ShardedTrainer` built over ``net`` (``mesh``,
    else ``pipeline["mesh"]`` or ``shardings_box["mesh"]``, else the
    default mesh) through its own ``_grad`` and ``_apply``, in place on
    its tensors: a tensor passed in that is not the trainer's own is
    copied in first, and the returned ones are the trainer's.  Over
    ranks, ``grad_fn``'s gradients are this rank's share and
    ``apply_fn`` sums them as its first step (the port's step reduces
    in the update).  ``holder["trainer"]`` is the trainer; ``donate`` is
    accepted for the JAX signature (updates are in place)."""
    if pipeline is not None and mesh is None:
        mesh = pipeline.get("mesh")
    if mesh is None and shardings_box:
        mesh = shardings_box.get("mesh")
    tr = ShardedTrainer(net, loss_fn, mesh=mesh, optimizer=optimizer,
                        learning_rate=learning_rate,
                        weight_decay=weight_decay, momentum=momentum,
                        compute_dtype=compute_dtype,
                        multi_tensor=multi_tensor, partition=partition,
                        fused_opt=fused_opt, overlap=overlap,
                        loss_scaling=loss_scaling, spec_fn=spec_fn,
                        grad_accum=grad_accum)
    tr._growth = int(loss_scale_growth_interval)
    if names is not None:
        unknown = sorted(set(names) - set(tr.train_names) - set(tr.aux_names))
        if unknown:
            raise MXNetError(f"make_train_step: names {unknown[:4]} are "
                             "not the net's parameters or buffers")
    buffers = [b for _, b in sorted(tr.net.named_buffers())]

    def put(dst, src):
        with torch.no_grad():
            for d, v in zip(dst, src or ()):
                if v is not None and v is not d:
                    d.copy_(torch.as_tensor(v))

    def state_in(tvals, avals, opt_state, scale_state, rng):
        put(tr.params, tvals)
        put(buffers, avals)
        put(tr._adapter.leaves(), opt_state)
        if scale_state is not None:
            put([tr._scale, tr._good, tr._skipped], scale_state)
        if rng is not None:
            _random.generator(tr.device).set_state(torch.as_tensor(rng))

    def scale_out():
        return (tr._scale, tr._good, tr._skipped)

    def batch(x, y):
        xs = _on(x, tr.device)
        return (xs if isinstance(xs, tuple) else (xs,)), _on(y, tr.device)

    def step(tvals, avals, rng, opt_state, t, lr, scale_state, x, y):
        state_in(tvals, avals, opt_state, scale_state, rng)
        xs, yy = batch(x, y)
        tr._t = int(t)
        loss = tr._grad(xs, yy)
        with torch.no_grad():
            tr._apply(unscale=True, lr=lr)
        return (list(tr.params), buffers, tr._adapter.leaves(), scale_out(),
                loss.detach())

    def grad_fn(tvals, avals, rng, scale, x, y):
        state_in(tvals, avals, None, None, rng)
        if scale is not None:
            with torch.no_grad():
                tr._scale.fill_(float(scale))
        xs, yy = batch(x, y)
        loss = tr._grad(xs, yy)
        with torch.no_grad():
            g = tr._garena.clone()
            if tr._dynamic_scaling:
                g.div_(tr._scale)
        lay = tr.layout
        grads: List[torch.Tensor] = [None] * len(tr.params)
        for i, off, size, shape in zip(tr._order, lay.offsets, lay.sizes,
                                       lay.shapes):
            grads[i] = g[off:off + size].view(shape)
        return grads, buffers, loss.detach()

    def apply_fn(tvals, opt_state, t, lr, scale_state, grads):
        state_in(tvals, None, opt_state, scale_state, None)
        tr._attach_grads()
        with torch.no_grad():
            for view, g in zip(tr._gviews, grads):
                view.copy_(g)
            tr._t = int(t)
            tr._apply(unscale=False, lr=lr)
        return list(tr.params), tr._adapter.leaves(), scale_out()

    holder = {"trainer": tr, "train_names": list(tr.train_names),
              "aux_names": list(tr.aux_names)}
    return step, grad_fn, apply_fn, tr._adapter, holder
