"""Device time of the port's 16-bit flash-attention backward on one CUDA
card: this checkout's build beside other checkouts' builds, in turns.

    python3 tools/torch_flash_bwd16.py [--parent DIR] [--source NAME=DIR ...]
        [--scan]

``mxnet_tpu_torch/csrc/flash_attention_bwd.cu`` is built with ``nvcc``
(sm_90a, the port's flags) as ``default``, and once for each other
source, all builds started together; each build's registers and spills
(``-Xptxas -v``) are printed.  ``--parent DIR`` (an unpacked checkout of
an earlier commit) adds that checkout's source as ``parent``, run as dq
then dk/dv; ``--source NAME=DIR`` adds another checkout's (for example a
copy with one design choice changed), run like the default.  Correctness
is not checked here: ``chip_smoke.py`` phase 22 and
``tests/test_torch_cuda_kernels.py`` hold the kernels to their plain
version.

In turns (builds in order, then reversed), the device time
(``torch.profiler`` kernel records) of the whole backward at the
training shape (B=32, H=12, T=128, d=64, kv_len 64-128) and the serving
shape (B=16, T=512, kv_len 24-512), and at the training shape of the
default build run as two launches (dq, then dk/dv) beside its fused
launch; SDPA's backward in the same type and key lengths beside them.
With ``--scan``, the fused mode of each build at B in {11, 22, 33} (132,
264, 396 heads: one, two, three per SM of 132) and Tq in {64, 128, 256}
at Tk = 128, every key live, bf16: a block's fixed cost against its cost
a query tile.  Prints the card as ``nvidia-smi`` names it and one JSON
line last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SOURCE = "flash_attention_bwd.cu"
H = 12
SHAPES = dict(train=(32, 128, 64), serve=(16, 512, 24))   # B, T, lowest len
HALF = {torch.bfloat16: "bf16", torch.float16: "f16"}


def build(name, csrc):
    """Start nvcc on ``csrc``/SOURCE; returns the process and the library
    path (under the git-ignored build/)."""
    from mxnet_tpu_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"flash_attention_bwd16_{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
           str(out), str(csrc / SOURCE)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), out


def ptxas_lines(log):
    """``-Xptxas -v``'s registers, stack and spills of the 16-bit
    backward kernels, one line each, named by their mangled entry."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '(\S+)'", line)
        if m:
            cur = m.group(1)
        elif cur and "bwd16" in cur and ("registers" in line
                                         or "spill" in line):
            out.append(f"  {cur}: {line.split(':', 1)[-1].strip()}")
    return out


def device_ms(fn, nbuf, calls=20):
    """Device time of one ``fn(i)`` (ms): torch.profiler kernel records
    summed over ``calls`` calls, three tries; None if none recorded."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        fn(i % nbuf)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(calls):
                fn(i % nbuf)
            torch.cuda.synchronize()
        total = sum(e.device_time_total for e in prof.key_averages())
        if total > 0:
            return total / calls / 1e3
    return None


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=DIR: also build DIR's source (an unpacked "
                         "checkout) as NAME, run like the default")
    ap.add_argument("--scan", action="store_true",
                    help="also time the fused mode at B in {11, 22, 33} "
                         "and Tq in {64, 128, 256}, Tk = 128, bf16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.kernels import flash_bwd as fb
    from mxnet_tpu_torch.ops import attention as att

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    names = ["default"]
    srcs = {"default": _build.CSRC}
    if args.parent:
        names.append("parent")
        srcs["parent"] = Path(args.parent).resolve() / "mxnet_tpu_torch" / \
            "csrc"
    for spec in args.source:
        n, src = spec.split("=", 1)
        names.append(n)
        srcs[n] = Path(src).resolve() / "mxnet_tpu_torch" / "csrc"
    jobs = {n: build(n, srcs[n]) for n in names}
    libs = {}
    for n, (proc, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed ({n}):\n{log}")
        print(f"build {n}:\n" + "\n".join(ptxas_lines(log)), flush=True)
        libs[n] = ctypes.CDLL(str(out))

    def use(n):                     # the wrappers launch this build's kernels
        _build._LIBS[SOURCE] = libs[n]

    def two_launch(q, k, v, g, out, lse, lt, causal, scale=None):
        scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
        dq, delta = fb.launch_dq(q, k, v, g, out, lse, lt, causal, scale)
        dk, dv = fb.launch_dkv(q, k, v, g, lse, delta, lt, causal, scale)
        return dq, dk, dv

    def whole(n):
        return two_launch if n == "parent" else fb.flash_attention_bwd

    dev = torch.device("cuda", 0)
    times = {}
    order = names + names[::-1]
    for dt, sfx in HALF.items():
        for shape, (b, t, lo) in SHAPES.items():
            lens = np.random.RandomState(t + 1).randint(lo, t + 1,
                                                        size=b).tolist()
            lens[0] = t
            lt = torch.tensor(lens, dtype=torch.int32, device=dev)
            nbuf = max(1, math.ceil(200e6 / (5 * b * H * t * 64 * 2)))
            gen = torch.Generator().manual_seed(17)
            mask = (torch.arange(t, device=dev)[None, :] < lt[:, None])[
                :, None, None, :]
            bufs, graphs = [], []
            for _ in range(nbuf):
                q, k, v, g = (((torch.rand(b, H, t, 64, generator=gen) - 0.5)
                               * 2).to(dt).to(dev) for _ in range(4))
                out, lse = att.flash_attention(q, k, v, kv_valid_length=lt,
                                               return_lse=True)
                bufs.append((q, k, v, g, out, lse))
                leaves = [x.detach().clone().requires_grad_()
                          for x in (q, k, v)]
                graphs.append((leaves, F.scaled_dot_product_attention(
                    *leaves, attn_mask=mask), g))
            row = {n: [] for n in names}
            if shape == "train":
                row["default two-launch"] = []
            for n in order:
                use(n)
                fn = whole(n)
                row[n].append(device_ms(
                    lambda i: fn(*bufs[i], lt, False), nbuf))
                if n == "default" and shape == "train":
                    row["default two-launch"].append(device_ms(
                        lambda i: two_launch(*bufs[i], lt, False), nbuf))
            row["sdpa"] = [device_ms(lambda i: torch.autograd.grad(
                graphs[i][1], graphs[i][0], graphs[i][2],
                retain_graph=True), nbuf) for _ in range(2)]
            times[f"{sfx} {shape}"] = row
            print(f"time {sfx} {shape} (B={b} T={t} d=64 kv_len "
                  f"{min(lens)}..{max(lens)}), device ms: " + "; ".join(
                      f"{k_} {v_}" for k_, v_ in row.items()) +
                  f" [{card}]", flush=True)
    scan = {}
    if args.scan:
        for n in names:
            if n == "parent":
                continue
            use(n)
            for b in (11, 22, 33):
                for tq in (64, 128, 256):
                    gen = torch.Generator().manual_seed(b + tq)
                    x = [((torch.rand(b, H, t, 64, generator=gen) - 0.5) * 2)
                         .bfloat16().to(dev) for t in (tq, 128, 128, tq)]
                    lt = torch.full((b,), 128, dtype=torch.int32, device=dev)
                    out, lse = att.flash_attention(*x[:3], kv_valid_length=lt,
                                                   return_lse=True)
                    scan[f"{n} B={b} Tq={tq}"] = device_ms(
                        lambda i: fb.flash_attention_bwd(*x, out, lse, lt),
                        1)
            print(f"scan {n} (fused, bf16, Tk=128, device ms): " + "; ".join(
                f"{k_.split(' ', 1)[1]} {v_:.4f}" for k_, v_ in scan.items()
                if k_.startswith(n + " ")), flush=True)
    print(card)
    print(json.dumps(dict(card=card, times=times, scan=scan)))


if __name__ == "__main__":
    main()
