"""The decode kernel's split plan and split-K threshold, timed on one
CUDA card.

    python3 tools/torch_decode_splits.py

At the decode tier's shape (B=8 slots, H=12 heads, d=64, capacity
C=1024, cache lengths 979-1000; f32 queries over an f32 and an int8
cache, and bf16 queries over a bf16 cache) it times the decode
kernel under several split lengths L (``ops.attention.split_plan``'s
choice among them) and under the tensor-core chunk path, then, at Tq in
{1, 2, 4, 8, 9, 16}, the split-K path (Tq <= 8 only) beside the chunk
path, so the threshold ``SPLIT_TQ`` can be read off; then the split
lengths 32-256 at the short capacities C = 100 and 256 (cache lengths
up to C - 11).  Every time is the
device time of one call, from ``torch.profiler`` kernel records summed
over 50 calls (at Tq = 1 also the kernels a call, one since the
splits merge inside the launch, and each one's time), with the inputs
cycled
through copies of at least 200 MB so the cache is read from HBM.  Each
plan is first checked against the plain version (atol = rtol = 1e-4;
bf16 within 2^-7 x max|ref|, ``test_utils.decode_bar``).
Prints one line per measurement and one JSON line last.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B, H, D, C = 8, 12, 64, 1024
TOL = 1e-4


def device_ms(fn, nbuf, calls=50, kernels=None):
    """Device time (ms) of one ``fn(i)`` call; with a dict ``kernels``,
    also each kernel's time a call and its launches a call by name."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        fn(i % nbuf)
    torch.cuda.synchronize()
    # CUPTI now and then loses kernel records: each kernel counts as its
    # mean recorded duration times its launches a call (a whole number
    # within 10% of its records over the calls); a profile further off is
    # taken again
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(calls):
                fn(i % nbuf)
            torch.cuda.synchronize()
        rows = {}
        for e in prof.key_averages():
            if e.device_time_total <= 0:
                continue
            k = round(e.count / calls)
            if k == 0 or abs(e.count - k * calls) > 0.1 * k * calls:
                rows = {}
                break
            rows[e.key[:60]] = (e.device_time_total / e.count * k / 1e3, k)
        if rows:
            break
    else:
        raise RuntimeError("five profiles lost kernel records")
    if kernels is not None:
        kernels.update(rows)
    return sum(t for t, _ in rows.values())


ELT = {"f32": 4, "int8": 1, "bf16": 2}


def inputs(tq, kind, dev, seed=7, c=C):
    from mxnet_tpu_torch.ops import attention as att

    g = torch.Generator().manual_seed(seed)
    one = B * H * c * D * ELT[kind] * 2
    nbuf = max(1, math.ceil(200e6 / one))
    bufs = []
    dt = torch.bfloat16 if kind == "bf16" else torch.float32
    for _ in range(nbuf):
        q = (torch.rand(B, H, tq, D, generator=g) - 0.5).to(dev, dt)
        k = (torch.rand(B, H, c, D, generator=g) - 0.5).to(dev, dt)
        v = (torch.rand(B, H, c, D, generator=g) - 0.5).to(dev, dt)
        kw = {}
        if kind == "int8":
            k, ks = att.quantize_kv(k)
            v, vs = att.quantize_kv(v)
            kw = dict(k_scale=ks, v_scale=vs)
        bufs.append((q, k, v, kw))
    top = min(c, 1000)
    lens = torch.tensor([top - 3 * i - tq for i in range(B)],
                        dtype=torch.int32, device=dev)
    return bufs, lens


def run(bufs, lens, plan, check=True, kernels=None):
    from mxnet_tpu_torch.ops import attention as att

    def call(i):
        q, k, v, kw = bufs[i]
        return att._launch_cuda(q, k, v, lens, 1.0 / math.sqrt(D), False,
                                kw.get("k_scale"), kw.get("v_scale"), plan)

    if check:
        from mxnet_tpu_torch.test_utils import decode_bar

        q, k, v, kw = bufs[0]
        got = call(0)
        want = att.flash_attention_decode_reference(q, k, v, lens, **kw)
        err = (got.float() - want.float()).abs()
        bar = decode_bar(q.dtype, k.dtype, want)
        if not bool((err <= (TOL + TOL * want.abs() if bar is None
                             else bar)).all()):
            raise RuntimeError(f"plan {plan}: max err {err.max().item():.3e}")
    return device_ms(call, len(bufs), kernels=kernels)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_decode_splits: no CUDA device", file=sys.stderr)
        return 1
    from mxnet_tpu_torch.ops import attention as att

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for kind in ("f32", "int8", "bf16"):
        bufs, lens = inputs(1, kind, dev)
        chosen = att.split_plan(B * H, 1, C, D, sms)
        for plan in ((128, 8), (256, 4), (384, 3), (512, 2), (1024, 1),
                     (0, 0)):
            split = {}
            ms = run(bufs, lens, plan, kernels=split)
            rows.append(dict(cache=kind, tq=1, L=plan[0], S=plan[1], ms=ms,
                             chosen=plan == chosen, kernels=split))
            each = ", ".join(f"{k.split('<')[0].split('(')[0].split()[-1]}"
                             f" {t:.4f} ms x{n:g}"
                             for k, (t, n) in split.items())
            print(f"  {kind} Tq=1 L={plan[0]} S={plan[1]}"
                  f"{' (plan)' if plan == chosen else ''}: {ms:.4f} ms, "
                  f"{sum(n for _, n in split.values()):g} kernel(s) a call "
                  f"({each})")
        for tq in (2, 4, 8, 9, 16):
            bufs, lens = inputs(tq, kind, dev, seed=tq)
            for plan in ([att.split_plan(B * H, min(tq, att.SPLIT_TQ), C, D,
                                         sms)] if tq <= 8 else []) + \
                    [(0, 0)]:
                ms = run(bufs, lens, plan)
                rows.append(dict(cache=kind, tq=tq, L=plan[0], S=plan[1],
                                 ms=ms, chosen=False))
                how = "chunk" if plan[1] == 0 else \
                    f"split L={plan[0]} S={plan[1]}"
                print(f"  {kind} Tq={tq} {how}: {ms:.4f} ms")
        for c in (100, 256):          # short caches: the first buckets
            bufs, lens = inputs(1, kind, dev, seed=c, c=c)
            chosen = att.split_plan(B * H, 1, c, D, sms)
            for length in (32, 64, 128, 256):
                plan = (length, -(-c // length))
                if length >= 2 * c:
                    continue
                ms = run(bufs, lens, plan)
                rows.append(dict(cache=kind, tq=1, c=c, L=plan[0], S=plan[1],
                                 ms=ms, chosen=plan == chosen))
                print(f"  {kind} Tq=1 C={c} L={plan[0]} S={plan[1]}"
                      f"{' (plan)' if plan == chosen else ''}: {ms:.4f} ms")
    print(card)
    print(json.dumps({"decode_splits": rows, "card": card, "sms": sms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
