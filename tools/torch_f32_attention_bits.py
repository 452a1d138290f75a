"""The port's f32 attention kernels against another checkout's, bit for
bit, on one CUDA card.

    python3 tools/torch_f32_attention_bits.py --parent DIR

Builds ``flash_attention.cu`` and ``flash_attention_bwd.cu`` from this
checkout and from DIR (an unpacked checkout of an earlier commit) with
``nvcc`` (sm_90a, the port's flags), loads both, and runs each build's
f32 flash forward (output and lse) and backward (dq, dk, dv) on the same
seeded inputs at B=32, H=12, T=128, d=64; B=4, T=512, d=320; B=3, T=70,
d=36 (per-row key lengths from a seed).  A change to the shared header's
16-bit section must leave these outputs the same bits.  The decode
kernel's C entries changed with its one-launch split-K, so an earlier
build cannot run behind this checkout's wrapper: its bits against an
earlier checkout are ``tools/torch_decode_turns.py``'s, each checkout in
a process of its own.  Prints one line a shape and output, the
card as ``nvidia-smi`` names it, and one JSON line last; exits 1 if any
output differs.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu")
SHAPES = ((32, 12, 128, 64), (4, 12, 512, 320), (3, 12, 70, 36))


def build(csrc: Path, tag: str):
    """Start one nvcc a source of ``csrc``; returns {source: (process,
    library path)} (libraries under the git-ignored build/)."""
    from mxnet_tpu_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for src in SOURCES:
        out = _build.BUILD_DIR / f"bits_{tag}_{Path(src).stem}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
               str(out), str(csrc / src)]
        jobs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True),
                     out)
    return jobs


def outputs(b, h, t, d, dev):
    """Every f32 output of the forward and backward on seeded inputs."""
    from mxnet_tpu_torch.kernels import flash_bwd as fb
    from mxnet_tpu_torch.ops import attention as att

    g = torch.Generator().manual_seed(b * t + d)
    q, k, v, go = (((torch.rand(b, h, t, d, generator=g) - 0.5) * 2).to(dev)
                   for _ in range(4))
    lens = np.random.RandomState(t).randint(1, t + 1, size=b).tolist()
    lens[0] = t
    lt = torch.tensor(lens, dtype=torch.int32, device=dev)
    out, lse = att.flash_attention(q, k, v, kv_valid_length=lt,
                                   return_lse=True)
    dq, dk, dv = fb.flash_attention_bwd(q, k, v, go, out, lse, lt)
    got = dict(out=out, lse=lse, dq=dq, dk=dk, dv=dv)
    torch.cuda.synchronize()
    return got


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from mxnet_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    jobs = {"change": build(_build.CSRC, "change"),
            "parent": build(Path(args.parent).resolve() / "mxnet_tpu_torch"
                            / "csrc", "parent")}
    libs = {}
    for tag, per in jobs.items():
        libs[tag] = {}
        for src, (proc, out) in per.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                sys.exit(f"nvcc failed ({tag} {src}):\n{log}")
            libs[tag][src] = ctypes.CDLL(str(out))
    dev = torch.device("cuda", 0)
    rows, differ = [], 0
    for b, h, t, d in SHAPES:
        got = {}
        for tag in ("parent", "change"):
            _build._LIBS.update(libs[tag])   # the wrappers launch these
            got[tag] = outputs(b, h, t, d, dev)
        for name in got["parent"]:
            a, c = got["parent"][name], got["change"][name]
            same = bool(torch.equal(a, c)) or bool(
                torch.equal(torch.nan_to_num(a), torch.nan_to_num(c)) and
                torch.equal(a.isnan(), c.isnan()))
            differ += not same
            rows.append(dict(B=b, H=h, T=t, d=d, output=name, same=same))
            print(f"B={b} H={h} T={t} d={d} {name}: "
                  f"{'same bits' if same else 'DIFFERS'} [{card}]",
                  flush=True)
    print(card)
    print(json.dumps(dict(card=card, rows=rows, differ=differ)))
    sys.exit(1 if differ else 0)


if __name__ == "__main__":
    main()
