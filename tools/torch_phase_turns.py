"""Chosen phases of ``chip_smoke.py`` from this checkout beside an earlier
checkout's, in turns, on one CUDA card.

    python3 tools/torch_phase_turns.py --parent DIR \
        [--phases lenet,ext_drive,lenet_drive] [--warmup lenet] [--turns PCCPPCCP]

DIR is an unpacked checkout of an earlier commit (``git archive``).  Each
turn is a fresh process that imports ``chip_smoke`` and
``mxnet_tpu_torch`` from its own checkout and builds its kernels under
that checkout's ``build/``.  A turn runs ``chip_smoke.phase_<name>(dev,
card)`` for each name of ``--warmup`` (its result dropped: a process's
first LeNet steps pay cuDNN's and cuBLAS's first calls, which the whole
script pays once, earlier), then for each name of ``--phases`` in order,
with TF32 off as ``chip_smoke.py`` sets it; every phase named must take
``(dev, card)`` in both checkouts, and a phase that registers operators
(``ext_drive``) runs once a process.  The turns run in the order
``--turns`` gives (``P`` the parent, ``C`` this checkout).  The last
lines list every rate and time a phase returns (each number under a key
ending in ``_per_s`` or ``_ms``) by turn, print the card as
``nvidia-smi`` names it and one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TURN = """
import json, sys, torch
sys.path.insert(0, {root!r})
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.phase_build()
card = cs.card_line()
dev = torch.device("cuda", 0)
for p in {warmup!r}:
    getattr(cs, "phase_" + p)(dev, card)
out = {{p: getattr(cs, "phase_" + p)(dev, card) for p in {phases!r}}}
print("TURN " + json.dumps(out))
"""


def readings(result, prefix=""):
    """Every number under a key ending in ``_per_s`` or ``_ms``, by
    dotted path."""
    out = {}
    for k, v in result.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(readings(v, path + "."))
        elif k.endswith(("_per_s", "_ms")) and isinstance(v, (int, float)) \
                and not isinstance(v, bool):
            out[path] = float(v)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--phases", default="lenet,ext_drive,lenet_drive")
    ap.add_argument("--turns", default="PCCPPCCP")
    ap.add_argument("--warmup", default="lenet")
    args = ap.parse_args()
    roots = {"P": os.path.abspath(args.parent), "C": HERE}
    phases = args.phases.split(",")
    warmup = [p for p in args.warmup.split(",") if p]
    table = []
    for i, who in enumerate(args.turns):
        code = TURN.format(root=roots[who], phases=phases, warmup=warmup)
        proc = subprocess.run([sys.executable, "-c", code], cwd=roots[who],
                              capture_output=True, text=True, timeout=1200)
        lines = proc.stdout.splitlines()
        for line in lines:
            if line.startswith("phase "):
                print(f"turn {i + 1} {who}: {line}")
        got = [ln for ln in lines if ln.startswith("TURN ")]
        if proc.returncode != 0 or not got:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            print(f"turn {i + 1} ({who}) failed: exit {proc.returncode}",
                  file=sys.stderr)
            return 1
        res = json.loads(got[0][5:])
        table.append(dict(turn=i + 1, checkout=who,
                          rates={p: readings(r) for p, r in res.items()}))
    for row in table:
        print(f"turn {row['turn']} {row['checkout']}: "
              + "; ".join(f"{p}.{k} {v:.3f}" for p, r in row["rates"].items()
                          for k, v in r.items()))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(card)
    print(json.dumps({"turns": table, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
