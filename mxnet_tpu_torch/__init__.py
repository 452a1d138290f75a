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
  ``lr_scheduler`` and all 19 registry optimizers.

Entry points run on ``cuda:0`` unless the caller passes ``device="cpu"``.
"""
from . import (amp, autograd, context, gluon, library, lr_scheduler,
               ndarray, numpy_extension, ops, optimizer, parallel, random,
               rtc, serve)
from .base import MXNetError

npx = numpy_extension

__all__ = ["amp", "autograd", "context", "gluon", "library", "lr_scheduler",
           "ndarray", "numpy_extension", "npx", "ops", "optimizer",
           "parallel", "random", "rtc", "serve", "MXNetError"]
