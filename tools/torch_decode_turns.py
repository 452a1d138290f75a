"""The decode kernel of this checkout beside an earlier checkout's, in
turns, on one CUDA card.

    python3 tools/torch_decode_turns.py --parent DIR [--turns PCCP]

DIR is an unpacked checkout of an earlier commit (``git archive``).  Each
turn is a fresh process that imports ``mxnet_tpu_torch`` from its own
checkout (its own wrapper, C entries and build under its own
``build/``), so checkouts whose kernels take other arguments compare as
they are.  A turn times every (query type, cache type) pair of
``flash_attention_decode`` at the decode step's shape (B=8 slots, H=12,
d=64, Tq=1, C=1024, cache lengths 979-1000) and with 8 query rows (Tq=8,
the most a split-K block takes), inputs from ``test_utils.decode_case``,
cycled through copies of at least 200 MB so the cache is read from HBM:
device time a call from ``torch.profiler`` kernel records over 50 calls,
the kernels a call, and at the decode shape, where q and the cache share
a float type, ``scaled_dot_product_attention`` in that type with the
boolean decode mask (a yardstick the port never calls); and a 256-token
prefill chunk (B=1, C=256: the chunk path where q and the cache share a
float type or f32 queries meet int8, split-K in query groups of 8
otherwise).  It
also keeps the outputs and lse of every pair at the main path's shapes:
the decode shape, cache capacity 100 (``chip_smoke.py`` phase 3's
``decode_c100``), d = 36 and Tq in {4, 7} (phase 2b's splits), and a
64-token chunk.  The turns run in the order ``--turns`` gives (``P``
the parent, ``C`` this checkout); the last lines compare every output
of this checkout with the parent's, bit for bit, print the card as
``nvidia-smi`` names it and one JSON line.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, D, C = 8, 12, 64, 1024
TIMED = {  # name: (B, Tq, C, d, cache lengths)
    "decode": (B, 1, C, D, [1000 - 3 * i for i in range(B)]),
    "tq8": (B, 8, C, D, [992 - 3 * i for i in range(B)]),
    "chunk256": (1, 256, 256, D, [0]),
}
SHAPES = {  # name: (B, Tq, C, d, cache lengths)
    "decode": (B, 1, C, D, [1000 - 3 * i for i in range(B)]),
    "decode_c100": (B, 1, 100, D, [90 - i for i in range(B)]),
    "decode_d36": (B, 1, C, 36, [1000 - 3 * i for i in range(B)]),
    "split_tq4": (4, 4, 1024, 64, [0, 1, 384, 508]),
    "split_tq7": (4, 7, 100, 36, [0, 1, 50, 93]),
    "chunk_tq64": (2, 64, 256, 64, [0, 192]),
}


def turn(root: str, out_path: str) -> None:
    """One turn: every pair's times and outputs from the checkout at
    ``root``, saved to ``out_path``."""
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.test_utils import DECODE_PAIRS, decode_case

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    def device_ms(fn, nbuf, calls=50):
        for i in range(3):
            fn(i % nbuf)
        torch.cuda.synchronize()
        # CUPTI now and then loses kernel records: each kernel counts as
        # its mean recorded duration times its launches a call (a whole
        # number within 10% of its records over the calls); a profile
        # further off is taken again
        for _ in range(5):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for i in range(calls):
                    fn(i % nbuf)
                torch.cuda.synchronize()
            us = n = 0
            for e in prof.key_averages():
                if e.device_time_total <= 0:
                    continue
                k = round(e.count / calls)
                if k == 0 or abs(e.count - k * calls) > 0.1 * k * calls:
                    n = 0
                    break
                us += e.device_time_total / e.count * k
                n += k
            if n:
                return us / 1e3, n
        raise RuntimeError("five profiles lost kernel records")

    times, outputs = {}, {}
    for q_dt, kv_dt in DECODE_PAIRS:
        name = att.decode_kernel_name(q_dt, kv_dt)
        row = dict(sdpa_ms=None)
        for key, (b, tq, c, d, lens) in TIMED.items():
            ke = torch.tensor([], dtype=kv_dt).element_size()
            nbuf = max(1, math.ceil(200e6 / (2 * b * H * c * d * ke)))
            cases = [decode_case(q_dt, kv_dt, b, H, tq, c, d, lens,
                                 seed=50 + i, device=dev)
                     for i in range(nbuf)]
            ms, per_call = device_ms(
                lambda i: att.flash_attention_decode(**cases[i][0]), nbuf)
            if key == "decode":
                row.update(ms=ms, kernels_a_call=per_call)
                if q_dt == kv_dt:
                    mask = att.decode_mask(cases[0][0]["cache_len"], tq, c)
                    row["sdpa_ms"] = device_ms(
                        lambda i: F.scaled_dot_product_attention(
                            cases[i][1]["q"], cases[i][1]["k"],
                            cases[i][1]["v"], attn_mask=mask), nbuf)[0]
            else:
                row[f"{key}_ms"] = ms
            del cases
        times[name] = row
        for shape, (b, tq, c, d, lens) in SHAPES.items():
            kern, _ = decode_case(q_dt, kv_dt, b, H, tq, c, d, lens, seed=7,
                                  device=dev)
            o, lse = att.flash_attention_decode(**kern, return_lse=True)
            outputs[f"{name} {shape}"] = (o.cpu(), lse.cpu())
    torch.save(dict(times=times, outputs=outputs), out_path)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an unpacked earlier checkout")
    ap.add_argument("--turns", default="PCCP")
    ap.add_argument("--turn", nargs=2, metavar=("ROOT", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        turn(*args.turn)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_turns: no CUDA device", file=sys.stderr)
        return 1
    if not args.parent:
        ap.error("--parent DIR is required")
    roots = {"P": os.path.abspath(args.parent), "C": HERE}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    runs = []
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")
                                     if os.path.isdir(os.path.join(
                                         HERE, "build")) else None) as tmp:
        for i, who in enumerate(args.turns):
            out = os.path.join(tmp, f"turn{i}.pt")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--turn", roots[who], out], check=True,
                           cwd=roots[who])
            runs.append((who, torch.load(out)))
    names = list(runs[0][1]["times"])
    for name in names:
        cells = ", ".join(
            f"{who} {r['times'][name]['ms']:.4f} ms "
            f"x{r['times'][name]['kernels_a_call']:g}" for who, r in runs)
        for key, label in (("tq8", "Tq=8"), ("chunk256", "chunk 256")):
            cells += f"; {label}: " + ", ".join(
                f"{who} {r['times'][name][f'{key}_ms']:.4f}"
                for who, r in runs)
        sdpa = [r["times"][name]["sdpa_ms"] for _, r in runs
                if r["times"][name]["sdpa_ms"] is not None]
        print(f"{name}: {cells}"
              + (f"; SDPA {', '.join(f'{x:.4f}' for x in sdpa)} ms"
                 if sdpa else "") + f" [{card}]", flush=True)
    parent = next((r for who, r in runs if who == "P"), None)
    change = next((r for who, r in runs if who == "C"), None)
    same = {}
    if parent is not None and change is not None:
        for key, (o, lse) in change["outputs"].items():
            po, plse = parent["outputs"][key]
            same[key] = bool(torch.equal(o, po) and torch.equal(lse, plse))
        for name in names:
            rows = {k.split(" ", 1)[1]: v for k, v in same.items()
                    if k.split(" ", 1)[0] == name}
            print(f"{name} bits against the parent: "
                  + ", ".join(f"{k} {'same' if v else 'DIFFER'}"
                              for k, v in rows.items()))
    print(card)
    print(json.dumps(dict(card=card, turns=[
        dict(who=who, times=r["times"]) for who, r in runs], same=same)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
