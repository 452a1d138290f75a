"""Decode serving of one checkout, for comparing two checkouts in turns.

    python3 tools/torch_decode_ab.py --root DIR [--calls 2000]

Imports ``chip_smoke.py`` and ``mxnet_tpu_torch`` from the checkout at
``DIR`` (default: this one) and runs its phases 4 and 5 alone
(``phase_serve_f32``, ``phase_serve_int8``: GPT-2-small widths, 16 f32
and 8 int8-cache greedy requests), then the host time of the decode
wrapper: ``flash_attention_decode`` called ``--calls`` times at the
decode step's shape (B=8, H=12, Tq=1, C=1024, d=64, cache_len 500), the
host clock around the loop before any synchronize (the launches queue
up behind it), over the calls.  A run of two checkouts alternated (A B B
A ...) from one chip call compares them on one card.  Prints one JSON
line last.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from mxnet_tpu_torch.ops import attention as att

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    lm, f32 = chip_smoke.phase_serve_f32(dev, card)
    i8 = chip_smoke.phase_serve_int8(lm, card)
    del lm
    q = torch.rand(8, 12, 1, 64, device=dev)
    k = torch.rand(8, 12, 1024, 64, device=dev)
    lens = torch.full((8,), 500, dtype=torch.int32, device=dev)
    for _ in range(20):
        att.flash_attention_decode(q, k, k, lens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.calls):
        att.flash_attention_decode(q, k, k, lens)
    host_us = (time.perf_counter() - t0) / args.calls * 1e6
    torch.cuda.synchronize()
    print(f"decode wrapper host time: {host_us:.2f} us a call [{card}]")
    print(json.dumps({"root": root, "f32": f32, "int8": i8,
                      "wrapper_host_us": host_us, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
