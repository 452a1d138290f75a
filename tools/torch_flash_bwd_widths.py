"""Constant width against runtime width in the port's flash-attention
backward kernels (``mxnet_tpu_torch/csrc/flash_attention_bwd.cu``), on
one CUDA card.

    python3 tools/torch_flash_bwd_widths.py [--d 32 64 128 256]

The source compiles the widths named by ``MX_FLASH_BWD_FIXED_D`` (one
bit each for d = 32, 64, 128, 256) as kernels with d a constant, and
every other width through the runtime-width kernels.  This script builds
the source twice with ``nvcc`` (sm_90a, the port's flags): with every
bit set (``0xF``, each d below a constant) and with none (``0x0``, each
d at runtime width), loads both, and at the training shape (B=32, H=12,
T=128, per-row key lengths 64-128 from a seed, dense) times the dq
kernel and the dk/dv kernel of each build with CUDA events, in turns
(constant, runtime, runtime, constant), inputs cycled through >= 200 MB
of copies.  Both builds' gradients are held against the plain version
(atol = rtol = 1e-4, TF32 off) and against each other.  Prints the card
as ``nvidia-smi`` names it and one JSON line last.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B, H, T = 32, 12, 128
VARIANTS = {"constant": "0xF", "runtime": "0x0"}
SOURCE = "flash_attention_bwd.cu"


def build(mask: str):
    """Compile the backward source with ``MX_FLASH_BWD_FIXED_D=mask``;
    returns the nvcc process and the library path (built under the
    git-ignored ``build/torch_kernels``)."""
    from mxnet_tpu_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"flash_attention_bwd_widths_{mask}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS,
           f"-DMX_FLASH_BWD_FIXED_D={mask}", "-I", str(_build.CSRC),
           "-o", str(out), str(_build.CSRC / SOURCE)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), out


def cuda_time_ms(fn, nbuf, iters=20, reps=5):
    for i in range(3):
        fn(i % nbuf)
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for i in range(iters):
            fn(i % nbuf)
        e.record()
        torch.cuda.synchronize()
        out.append(s.elapsed_time(e) / iters)
    return statistics.median(out)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--d", type=int, nargs="+", default=[32, 64, 128, 256])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import ctypes

    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.kernels import flash_bwd as fb
    from mxnet_tpu_torch.ops import attention as att

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    jobs = {name: build(mask) for name, mask in VARIANTS.items()}
    libs = {}
    for name, (proc, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed ({name}):\n{log}")
        libs[name] = ctypes.CDLL(str(out))

    def use(name):                  # the wrappers launch this build's kernels
        _build._LIBS[SOURCE] = libs[name]

    dev = torch.device("cuda", 0)
    rs = np.random.RandomState(9)
    lens = rs.randint(64, T + 1, size=B).tolist()
    lens[0] = T
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    rows = []
    for d in args.d:
        scale = 1.0 / math.sqrt(d)
        gen = torch.Generator().manual_seed(d)
        nbuf = max(1, math.ceil(200e6 / (5 * B * H * T * d * 4)))
        bufs = []
        for _ in range(nbuf):
            q, k, v, g = ((torch.rand(B, H, T, d, generator=gen) - 0.5)
                          .to(dev) for _ in range(4))
            out, lse = att.flash_attention(q, k, v, kv_valid_length=lens_t,
                                           return_lse=True)
            bufs.append([q, k, v, g, out, lse])
        ref = fb.flash_attention_bwd_reference(*bufs[0], lens_t, False,
                                               scale)
        grads = {}
        for name in VARIANTS:
            use(name)
            grads[name] = fb.flash_attention_bwd(*bufs[0], lens_t, False,
                                                 scale)
            torch.cuda.synchronize()
            for a, r in zip(grads[name], ref):
                torch.testing.assert_close(a, r, atol=1e-4, rtol=1e-4)
        for buf in bufs:
            buf.append(fb.launch_dq(*buf, lens_t, False, scale)[1])
        same = all(torch.equal(a, b) for a, b in
                   zip(grads["constant"], grads["runtime"]))
        times = {f"{n}_{k}": [] for n in VARIANTS for k in ("dq", "dkv")}
        for name in ("constant", "runtime", "runtime", "constant"):
            use(name)
            times[f"{name}_dq"].append(cuda_time_ms(
                lambda i: fb.launch_dq(*bufs[i][:6], lens_t, False, scale),
                nbuf))
            times[f"{name}_dkv"].append(cuda_time_ms(
                lambda i: fb.launch_dkv(*bufs[i][:4], bufs[i][5], bufs[i][6],
                                        lens_t, False, scale), nbuf))
        row = dict(d=d, B=B, H=H, T=T, kv_len=[min(lens), max(lens)],
                   input_copies=nbuf, same_bits=same, **times)
        rows.append(row)
        print(f"d={d:3d}: dq constant {times['constant_dq']} runtime "
              f"{times['runtime_dq']} ms; dk/dv constant "
              f"{times['constant_dkv']} runtime {times['runtime_dkv']} ms; "
              f"same bits {same} [{card}]", flush=True)
    print(card)
    print(json.dumps(dict(card=card, rows=rows)))


if __name__ == "__main__":
    main()
