"""The flash forward's tiles at d = 64, timed on one CUDA card.

    python3 tools/torch_flash_fwd_tiles.py

Builds ``csrc/flash_attention.cu`` once for each (warps along the rows,
streamed key rows) choice of the d <= 64 class (``MX_FWD64_WR``,
``MX_FWD64_BN`` in ``csrc/flash_fwd.cuh``), all builds started
together, and times each at the serving shape (B=16, H=12, T=512, d=64,
kv_len 24-512 from the seed ``chip_smoke.py`` phase 6b uses) and at the
training shape (B=32, T=128, lengths 64-128), by ``torch.profiler``
device time over 20 calls, inputs cycled through copies of at least 200
MB, in turns (each choice twice, first-last order reversed on the second
pass).  Each build is first checked against the plain version (atol =
rtol = 1e-4).  Prints one line per time and one JSON line last.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

H, D = 12, 64
CHOICES = ((4, 32), (8, 32), (4, 16), (2, 32), (8, 64))


def build(choices):
    from mxnet_tpu_torch.kernels import _build

    src = _build.CSRC / "flash_attention.cu"
    base = list(_build.NVCC_FLAGS)
    jobs, libs = [], {}
    try:
        for wr, bn in choices:
            _build.NVCC_FLAGS = base + [f"-DMX_FWD64_WR={wr}",
                                        f"-DMX_FWD64_BN={bn}"]
            libs[(wr, bn)] = _build._target(src)
            job = _build._start(src)
            if job is not None:
                jobs.append(job)
        for job in jobs:
            _build._finish(job)
    finally:
        _build.NVCC_FLAGS = base
    out = {}
    for key, path in libs.items():
        fn = ctypes.CDLL(str(path)).mx_flash_attention_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out[key] = fn
    return out


def device_ms(fn, nbuf, calls=20):
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        fn(i % nbuf)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(i % nbuf)
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()) / calls / 1e3


def shape(b, t, lo, seed, dev):
    rs = np.random.RandomState(seed)
    lens = rs.randint(lo, t + 1, size=b).tolist()
    lens[0] = t
    g = torch.Generator().manual_seed(11)
    nbuf = max(1, math.ceil(200e6 / (3 * b * H * t * D * 4)))
    bufs = [tuple((torch.rand(b, H, t, D, generator=g) - 0.5).to(dev)
                  for _ in range(3)) for _ in range(nbuf)]
    return bufs, torch.tensor(lens, dtype=torch.int32, device=dev)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_flash_fwd_tiles: no CUDA device", file=sys.stderr)
        return 1
    from mxnet_tpu_torch.ops import attention as att

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    fns = build(CHOICES)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for label, (b, t, lo, seed) in (("serve B=16 T=512", (16, 512, 16, 5)),
                                    ("train B=32 T=128", (32, 128, 64, 9))):
        bufs, lens = shape(b, t, lo, seed, dev)
        out = torch.empty_like(bufs[0][0])

        def call(fn, i):
            q, k, v = bufs[i]
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     lens.data_ptr(), out.data_ptr(), None, b, H, t, t, D, 0,
                     1.0 / math.sqrt(D), stream)
            if err != 0:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        want = att.flash_attention_reference(*bufs[0], kv_valid_length=lens)
        for key, fn in fns.items():
            call(fn, 0)
            diff = (out - want).abs()
            if not bool((diff <= 1e-4 + 1e-4 * want.abs()).all()):
                raise RuntimeError(f"{key}: max err {diff.max().item():.3e}")
        times = {key: [] for key in fns}
        for order in (list(fns), list(reversed(list(fns)))):
            for key in order:
                times[key].append(device_ms(
                    lambda i, f=fns[key]: call(f, i), len(bufs)))
        for key, ts in times.items():
            print(f"  {label} WR={key[0]} BN={key[1]}: "
                  f"{' / '.join(f'{x:.4f}' for x in ts)} ms")
            rows.append(dict(shape=label, wr=key[0], bn=key[1], ms=ts))
    print(card)
    print(json.dumps({"flash_fwd_tiles": rows, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
