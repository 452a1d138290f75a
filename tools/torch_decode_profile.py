"""Where a forward's (or a training step's) time goes in the PyTorch
port's serving and training paths, on one CUDA card.

    python3 tools/torch_decode_profile.py [--steps 20] [--cache-len 500]
        [--only decode,bert_batch,train_step,train_step_adamw,
                train_step_bf16,train_step_fp16,resnet_step,
                resnet_step_bf16,eager,decode_bf16,bert_batch_bf16]

Decode: builds ``transformer_lm`` at GPT-2-small widths (seeded random
weights, f32) on ``cuda:0`` and runs the decode tier's two forwards
directly: one 8-slot decode step at capacity 1024 with every row at
``--cache-len``, and one 256-token prefill into an empty 256-position
cache; ``decode_bf16`` the same with the model and its cache in bf16
(``transformer_lm(dtype=torch.bfloat16).cast(torch.bfloat16)``), and
``bert_batch_bf16`` the batch below on ``cast(torch.bfloat16)``; the
16-bit serving profiles split the device time into GEMMs, the port's
kernels and the rest.  Batch serving: builds ``bert_12_768_12`` (seeded random weights,
f32, TF32 off as in ``chip_smoke.py``) and runs one full batch as the
batch tier dispatches it: 16 rows padded to 512 tokens, lengths drawn
from 16-512 with a seed.  Training: builds
``BERTForPretrain(bert_12_768_12)`` (dropout 0.1, seeded weights, f32,
TF32 off) behind ``parallel.ShardedTrainer`` (adam, lr 1e-4, wd 0.01)
and runs steps on the bench's pretraining batch (32 rows of 128 tokens,
lengths 64-128, 20 masked positions), dispatched as a training loop
dispatches them (at most two in flight); then the same with the
per-parameter adamw, and in bf16 and f16 (dynamic loss scaling) at
``bench_bert_base``'s settings (``compute_dtype``, adamw); each step's
device time is split into GEMMs, the port's 16-bit attention kernels
and the rest.  ResNet training: builds
``resnet50_v1(layout="NHWC", fused_bn_relu=True)`` (seeded weights,
f32, TF32 off) behind ``parallel.ShardedTrainer`` (sgd, lr 0.05,
momentum 0.9, as ``bench.py``'s ``bench_resnet50``) on a B=128 batch of
224x224x3 images held on the card, and splits its device time into the
convolutions (cuDNN forward and both backward, with the classifier's
GEMMs), the layout transposes cuDNN runs around them, the two
``bn_act`` kernels, the rest (the plain-PyTorch BN forward and
backward, residual adds, relus, pooling, copies) and the arena; then
the same step in bf16 as ``bench_resnet50`` runs it
(``compute_dtype=torch.bfloat16``, the bench's f32 cross entropy), with
plain BatchNorm (the bench's default) and with ``fused_bn_relu=True``
(the 16-bit ``bn_act`` kernels).  Eager
Gluon: one ``autograd.record()`` -> loss -> ``autograd.backward`` ->
``gluon.Trainer.step`` of LeNet-5 (sgd, lr 0.05, momentum 0.9) and of
``chip_smoke.py``'s extension-op block (lr 0.01) at B=64 on images held
on the card.  For each forward or step it
reports the wall time (host clock around work that ends in a
synchronize), the device time summed over the kernels of a
``torch.profiler`` window, the device's busy share of that window, the
share of device time in the port's own kernels, the kernel launches a
call, and the kernels ranked by device time.  Prints one JSON line last.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GPT2_SMALL = dict(vocab_size=50257, units=768, hidden_size=3072,
                  num_layers=12, num_heads=12, max_length=1024)


def _device_us(evt, self_only):
    names = (("self_device_time_total", "self_cuda_time_total") if self_only
             else ("device_time_total", "cuda_time_total"))
    for n in names:
        if hasattr(evt, n):
            return float(getattr(evt, n))
    return 0.0


def profile(label, fn, n, groups=None):
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        dev = _device_us(evt, self_only=True)
        if dev > 0 and getattr(evt, "device_type", None) is not None \
                and "CUDA" in str(evt.device_type):
            rows.append((evt.key, dev / 1e3 / n, evt.count // n))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    own_ms = sum(r[1] for r in rows if any(k in r[0] for k in PORT_KERNELS))
    launches = sum(r[2] for r in rows)
    print(f"{label}: wall {wall_ms:.3f} ms per call (unprofiled), "
          f"device busy {busy_ms:.3f} ms per call = "
          f"{busy_ms * n / window_ms:.3f} of the profiled window; the "
          f"port's kernels {own_ms:.3f} ms = {own_ms / busy_ms:.3f} of busy; "
          f"{launches} kernel launches per call")
    for key, ms, cnt in rows[:15]:
        print(f"    {ms:9.4f} ms  x{cnt:<4d} {key[:90]}")
    out = dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
               busy_share=busy_ms * n / window_ms, port_kernels_ms=own_ms,
               launches=launches,
               port_kernels_share=own_ms / busy_ms,
               top=[dict(kernel=k[:120], ms=ms, count=c)
                    for k, ms, c in rows[:15]])
    if groups:
        split = {g: 0.0 for g in groups}
        for key, ms, _ in rows:
            name = next((g for g, match in groups.items() if match(key)),
                        "other")
            split[name] = split.get(name, 0.0) + ms
        for g, ms in split.items():
            print(f"  split {g}: {ms:.3f} ms = {ms / busy_ms:.3f} of busy")
        out["split_ms"] = split
    return out


# the port's hand-written kernels, by the name the profiler records
PORT_KERNELS = ("decode_split_kernel", "flash_fwd_kernel", "flash_fwd_wide_kernel",
                "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                "flash_bwd_dq_wide_kernel", "flash_bwd_dkv_wide_kernel",
                "opt_arena_kernel", "bn_stats_fold", "bn_apply_kernel",
                "ew_kernel", "flash_fwd16_kernel", "flash_fwd16_wide_kernel",
                "flash_bwd16_dq_kernel", "flash_bwd16_dkv_kernel")

# the training step's split, first match wins (else "other")
HALF_GROUPS = {
    "16-bit attention kernels": lambda k: any(w in k for w in (
        "flash_fwd16_kernel", "flash_bwd16_dq_kernel",
        "flash_bwd16_dkv_kernel")),
    "GEMMs": lambda k: any(w in k.lower() for w in (
        "gemm", "xmma", "cutlass", "nvjet", "cublas")),
}

_CONV_WORDS = ("conv", "fprop", "dgrad", "wgrad", "cudnn", "implicit",
               "winograd", "xmma", "gemm", "fft", "cutlass", "nvjet")

# the ResNet step's split, first match wins (anything else: "other")
RESNET_GROUPS = {
    "bn_act kernels": lambda k: any(w in k for w in (
        "bn_stats_fold", "bn_apply_kernel")),
    "arena": lambda k: "opt_arena_kernel" in k,
    "cuDNN layout transposes": lambda k: "nhwcToNchw" in k
    or "nchwToNhwc" in k,
    "convolutions and GEMMs": lambda k: any(w in k.lower()
                                            for w in _CONV_WORDS),
}


def resnet_step_profile(steps, compute_dtype=None, fused=True):
    """Profile ResNet-50 v1 training steps (module docstring): f32 with
    ``compute_dtype=None``, else under that policy with the bench's f32
    cross entropy."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import get_model
    from mxnet_tpu_torch.parallel import ShardedTrainer

    ce = SoftmaxCrossEntropyLoss()
    net = get_model("resnet50_v1", layout="NHWC", fused_bn_relu=fused,
                    device="cuda").initialize(seed=0)
    tr = ShardedTrainer(net, lambda p, y: ce(p.float(), y), optimizer="sgd",
                        learning_rate=0.05, momentum=0.9,
                        compute_dtype=compute_dtype)
    rs = np.random.RandomState(0)
    x = torch.as_tensor(rs.rand(128, 224, 224, 3).astype(np.float32),
                        device="cuda")
    y = torch.as_tensor(rs.randint(0, 1000, size=(128,)).astype(np.int32),
                        device="cuda")
    dt = "f32" if compute_dtype is None else str(compute_dtype).split(".")[-1]
    bn = "fused BN+relu" if fused else "BatchNorm + relu"
    return profile(f"ResNet-50 v1 training step (B=128, 224x224, NHWC, {bn},"
                   f" sgd momentum, {dt})", lambda: tr.step(x, y), steps,
                   groups=RESNET_GROUPS)


def eager_step_profiles(steps):
    """Profile eager ``gluon.Trainer`` steps of LeNet-5 and of the
    extension-op block (module docstring)."""
    from chip_smoke import ext_lenet
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model

    mx.library.load(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "example", "extensions",
        "torch_ops.py"))
    rs = np.random.RandomState(0)
    x = torch.as_tensor(rs.rand(64, 1, 28, 28).astype(np.float32),
                        device="cuda")
    y = torch.as_tensor(rs.randint(0, 10, size=64), device="cuda")
    loss_fn = SoftmaxCrossEntropyLoss()
    out = {}
    for key, net, lr in (
            ("lenet_step", get_model("lenet", device="cuda"), 0.05),
            ("ext_block_step", ext_lenet("cuda"), 0.01)):
        net.initialize(seed=0)
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": lr, "momentum": 0.9})

        def step():
            with autograd.record():
                loss = loss_fn(net(x), y)
            autograd.backward(loss)
            tr.step(64)

        out[key] = profile(f"{key} (B=64, 28x28x1, gluon.Trainer sgd "
                           "momentum)", step, steps)
    return out


def train_step_profile(steps, compute_dtype=None, opt=None):
    """Profile BERT-base pretraining steps (module docstring): f32 with
    adam (or ``opt``), or with ``compute_dtype`` at bench_bert_base's
    adamw."""
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon.model_zoo import BERTForPretrain, \
        bert_12_768_12
    from mxnet_tpu_torch.gluon.model_zoo.bert import pretrain_loss
    from mxnet_tpu_torch.parallel import ShardedTrainer

    mxrandom.seed(0)
    net = BERTForPretrain(bert_12_768_12(dropout=0.1, device="cuda")
                          ).initialize(seed=0)
    opt = opt or ("adam" if compute_dtype is None else "adamw")
    tr = ShardedTrainer(net, pretrain_loss, optimizer=opt,
                        learning_rate=1e-4, weight_decay=0.01,
                        compute_dtype=compute_dtype)
    rs = np.random.RandomState(21)
    b, t, n_pred = 32, 128, 20
    lens = rs.randint(64, t + 1, size=b).astype(np.int32)
    tokens = rs.randint(0, 30522, size=(b, t)).astype(np.int32)
    types = (np.arange(t)[None, :] >= lens[:, None] // 2).astype(np.int32)
    pos = np.stack([rs.choice(n, n_pred, replace=False)
                    for n in lens]).astype(np.int32)
    x = tuple(torch.as_tensor(a, device="cuda")
              for a in (tokens, types, lens, pos))
    y = (torch.as_tensor(rs.randint(0, 30522, size=(b, n_pred)),
                         device="cuda"),
         torch.as_tensor(np.arange(b) % 2, device="cuda"))
    dt = "f32" if compute_dtype is None else str(compute_dtype)[6:]
    return profile(f"BERT-base pretraining step ({dt}, B={b}, T={t}, "
                   f"{n_pred} masked, {opt})", lambda: tr.step(x, y), steps,
                   groups=HALF_GROUPS)


SERVE_GROUPS = {
    "the port's kernels": lambda k: any(w in k for w in PORT_KERNELS),
    "GEMMs": HALF_GROUPS["GEMMs"],
}


def decode_profiles(steps, cache_len, dtype=None):
    """The decode step and a prefill of GPT-2-small widths (module
    docstring); with ``dtype`` the model and its cache in that type."""
    from mxnet_tpu_torch.gluon.model_zoo import transformer_lm

    lm = transformer_lm(device="cuda", dtype=dtype or torch.float32,
                        **GPT2_SMALL).initialize(seed=0)
    if dtype is not None:
        lm.cast(dtype)
    tag = "" if dtype is None else f", {str(dtype)[6:]}"
    groups = None if dtype is None else SERVE_GROUPS
    slots = 8
    cache = lm.begin_cache(slots, 1024)
    lens = np.full(slots, cache_len, np.int64)
    toks = np.zeros((slots, 1), np.int64)

    def step():
        logits, _ = lm(toks, cache, lens, np.ones(slots, np.int64))
        return logits[:, 0].float().cpu()

    prompt = np.zeros((1, 256), np.int64)

    def prefill():
        logits, _ = lm(prompt, lm.begin_cache(1, 256), [0], [256])
        return logits[0, -1].float().cpu()

    return {"decode_step": profile(f"decode step (8 slots, C=1024, "
                                   f"cache_len={cache_len}{tag})", step,
                                   steps, groups),
            "prefill": profile(f"prefill (1 row, 256 tokens, C=256{tag})",
                               prefill, max(2, steps // 4), groups)}


def bert_batch_profile(steps, dtype=None):
    """One BERT-base batch as the batch tier dispatches it (module
    docstring); with ``dtype`` the model cast to it."""
    from mxnet_tpu_torch.gluon.model_zoo import bert_12_768_12

    bert = bert_12_768_12(dropout=0.0, device="cuda").initialize(seed=0)
    if dtype is not None:
        bert.cast(dtype)
    rs = np.random.RandomState(3)
    lens = rs.randint(16, 513, size=16).astype(np.int32)
    lens[0] = 512
    tokens = torch.as_tensor(rs.randint(0, 30522, size=(16, 512)),
                             device="cuda")
    types = torch.zeros_like(tokens)
    lens_dev = torch.as_tensor(lens, device="cuda")

    def bert_batch():
        seq, pooled = bert(tokens, types, lens_dev)
        return seq.cpu(), pooled.cpu()

    tag = "" if dtype is None else f", {str(dtype)[6:]}"
    with torch.inference_mode():
        return profile(f"BERT-base batch (16 rows x 512 tokens, "
                       f"{int(lens.sum())} valid{tag})", bert_batch, steps,
                       None if dtype is None else SERVE_GROUPS)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--cache-len", type=int, default=500)
    ap.add_argument("--only", default="decode,bert_batch,train_step,"
                    "train_step_adamw,train_step_bf16,train_step_fp16,"
                    "resnet_step,resnet_step_bf16,eager,decode_bf16,"
                    "bert_batch_bf16",
                    help="comma-separated profiles to run")
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not torch.cuda.is_available():
        print("torch_decode_profile: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    out = {"card": card}
    if "decode" in only:
        out.update(decode_profiles(args.steps, args.cache_len))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "bert_batch" in only:
        out["bert_batch"] = bert_batch_profile(max(2, args.steps // 4))
    for key, dt, opt in (("train_step", None, None),
                         ("train_step_adamw", None, "adamw"),
                         ("train_step_bf16", torch.bfloat16, None),
                         ("train_step_fp16", torch.float16, None)):
        if key in only:
            out[key] = train_step_profile(max(2, args.steps // 2), dt, opt)
            torch.cuda.empty_cache()
    if "resnet_step" in only:
        out["resnet_step"] = resnet_step_profile(max(2, args.steps // 2))
        torch.cuda.empty_cache()
    if "resnet_step_bf16" in only:
        out["resnet_step_bf16"] = {}
        for variant, fused in (("plain", False), ("fused", True)):
            out["resnet_step_bf16"][variant] = resnet_step_profile(
                max(2, args.steps // 2), torch.bfloat16, fused)
            torch.cuda.empty_cache()
    if "eager" in only:
        out.update(eager_step_profiles(args.steps))
    if "decode_bf16" in only:
        out["decode_bf16"] = decode_profiles(args.steps, args.cache_len,
                                             torch.bfloat16)
    if "bert_batch_bf16" in only:
        out["bert_batch_bf16"] = bert_batch_profile(max(2, args.steps // 4),
                                                    torch.bfloat16)
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
