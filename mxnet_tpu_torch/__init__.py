"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu, for one NVIDIA H100.

A package of its own beside ``mxnet_tpu`` (the JAX reference, which it
never imports), ported in slices:

* generative decode serving: the ``TransformerLM`` of
  ``gluon.model_zoo.decoder`` served by ``serve.register_decode``, with
  decode attention in a hand-written Hopper kernel
  (``csrc/decode_attention.cu``);
* batch serving: ``BERTModel`` (``gluon.model_zoo.bert``) behind
  ``serve.register`` / ``serve.Server``, which coalesces ragged requests
  into padded batches (``jit.ShapeBucketer``), with the encoder's
  attention in a hand-written Hopper flash-attention kernel
  (``csrc/flash_attention.cu``);
* BERT pretraining: ``BERTForPretrain`` trained by
  ``parallel.ShardedTrainer`` on one card, the attention's gradient in
  hand-written dq and dk/dv kernels (``csrc/flash_attention_bwd.cu``)
  and the sgd / momentum / adam update in one flat-arena kernel
  (``csrc/opt_arena.cu``);
* ResNet-50 v1 training (``gluon.model_zoo.vision``, NHWC, fused
  BatchNorm + relu in ``csrc/bn_act.cu``);
* the eager Gluon path: ``autograd.record()`` / ``backward`` /
  ``gluon.Trainer`` over ``gluon.Block`` / ``HybridBlock`` (LeNet-5 in
  the vision zoo), and user kernels as ops through ``rtc.register`` and
  ``library.load`` (the example's kernels in ``csrc/ext_ops.cu``);
* 16-bit training: ``ShardedTrainer(compute_dtype=torch.bfloat16)`` or
  ``torch.float16`` with dynamic loss scaling, f32 master parameters,
  and ``amp``; the attention's bf16 / f16 forward, dq and dk/dv in
  16-bit variants of the flash kernels;
* the rest of the trainer: ``ShardedTrainer(multi_tensor=True,
  lr_scheduler=..., grad_accum=k)``, ``save_states`` / ``load_states``
  in the JAX trainer's file, ``gluon.Trainer`` states,
  ``Block.save_parameters`` / ``load_parameters`` (``ndarray``),
  ``lr_scheduler`` and all 19 registry optimizers;
* ``mx.init`` (``initializer``: ``Xavier``, ``Uniform``, ``Mixed``, ...
  with the JAX package's name routing and laws) behind
  ``Block.initialize(init)``, ``gluon.data`` (datasets, samplers,
  ``DataLoader``, ``vision.MNIST`` / ``CIFAR10`` and ``transforms``)
  and ``gluon.metric``: the verify skill's LeNet drive runs with
  ``import mxnet_tpu_torch as mx``;
* the LSTM family: ``ops.rnn`` (the fused recurrence, PyTorch code as
  the JAX package's is ``lax.scan``), ``npx.rnn``, ``gluon.rnn``'s
  layers and cells, and ``LSTMLM`` behind ``serve.register_decode`` (a
  capacity-static cache); ``bench.py``'s LSTM LM trains through
  ``ShardedTrainer`` (the arena kernel's ``sgd`` mode).
* tracing and observability: ``telemetry`` (counters, gauges, timers),
  ``trace`` (spans across both serving tiers, the Perfetto export with
  a ``torch.profiler`` session's kernels aligned onto it, the flight
  recorder), ``obs`` (windowed histograms, SLOs, the Prometheus
  ``/metrics`` / ``/readyz`` / ``/statusz`` endpoint, fleet
  aggregation) and ``analysis.thread_check`` (the serving tier's named
  locks).
* the rest of the trainer's, loader's and checkpoint's seams
  (``trainer.step``, ``dataloader.fetch``, ``ckpt.*``), ``trace.cost``
  (the FLOPs and bytes of a step, kernels included, and the
  ``trainer.xla_utilization`` gauges), ``profiler`` (``mx.profiler``
  over ``torch.profiler``), and ``mx.np`` (``numpy``: numpy's names over
  torch, tensors on the card, the JAX package's 32-bit types) with its
  ``random``, ``linalg`` and ``fft``.

* Gluon's layers (``gluon.nn``: the 2-D layers, activations and
  containers) with deferred shape inference: a width of 0 is read off
  the first input, as the JAX layers read it; Inception v3 in the vision
  zoo.

Entry points run on ``cuda:0`` unless the caller passes ``device="cpu"``,
and so does a layer built bare (``nn.Dense(...)``, ``rnn.LSTM(...)``):
where there is no card it raises and names ``device="cpu"``.  A JAX
name not yet ported raises :class:`MXNetError` naming its ROADMAP item
(``_not_ported``).
"""
from . import analysis, telemetry, trace
from . import (amp, autograd, context, gluon, initializer, kvstore,
               library, lr_scheduler, ndarray, numpy, numpy_extension, ops,
               optimizer, parallel, profiler, random, resilience, rtc, serve)
from . import _not_ported, obs
from .base import MXNetError, get_env
from .lr_scheduler import LRScheduler

np = numpy
npx = numpy_extension
init = initializer  # mx.init alias like reference
kv = kvstore
rnd = random

__all__ = ["amp", "analysis", "autograd", "context", "gluon", "init",
           "initializer", "kv", "kvstore", "library", "lr_scheduler",
           "LRScheduler", "ndarray", "np", "numpy", "numpy_extension", "npx",
           "obs", "ops", "optimizer", "parallel", "profiler", "random", "rnd",
           "resilience", "rtc", "serve", "telemetry", "trace", "MXNetError",
           "get_env"]

__getattr__ = _not_ported.module_getattr(__name__, "mx", _not_ported.MX,
                                         lazy=("test_utils",))
