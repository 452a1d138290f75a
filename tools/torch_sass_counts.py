"""Count opcodes in the SASS of the port's kernels (needs nvcc, cuobjdump).

    python3 tools/torch_sass_counts.py [--match REGEX] [--ops HMMA,WARPSYNC,...]

Builds every ``mxnet_tpu_torch/csrc`` source (as the kernels build at
first use), disassembles each library with ``cuobjdump -sass`` and
prints, for each kernel whose (mangled) name matches ``--match``, how
many times each opcode of ``--ops`` occurs.  An ``mma.sync`` under a
condition the compiler cannot prove warp-uniform gets a ``WARPSYNC`` and
a branch of its own; a vector store split into scalar ones shows as
narrow ``STS``/``STG`` where wide ones were meant.  Prints one JSON line
last.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OPS = "HMMA,WARPSYNC,BSSY,BRA,LDSM,LDGSTS,STS,STS.128,STG,EXIT"


def _cuobjdump() -> str:
    for cand in (shutil.which("cuobjdump"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "cuobjdump")):
        if cand and os.path.exists(cand):
            return cand
    raise SystemExit("cuobjdump not found (PATH, $CUDA_HOME/bin)")


def counts(sass: str, ops):
    """``{function: Counter(opcode)}`` over the disassembly; an opcode is
    the instruction's first word, matched whole or up to its first dot
    (``HMMA.16816.F32.BF16`` counts as ``HMMA``; ``STS.128`` also as
    itself)."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if cur is None or not m:
            continue
        word = m.group(1)
        for op in ops:
            if word == op or word.split(".")[0] == op or \
                    word.startswith(op + "."):
                cur[op] += 1
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--match", default="16_")
    ap.add_argument("--ops", default=OPS)
    args = ap.parse_args()
    from mxnet_tpu_torch.kernels import _build

    _build.build_all()
    ops = args.ops.split(",")
    tool = _cuobjdump()
    result = {}
    for src in _build.sources():
        lib = _build._target(src)
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout
        for fn, c in counts(sass, ops).items():
            if re.search(args.match, fn):
                result[fn] = {op: c[op] for op in ops}
                print(f"{src.name}: {fn[:100]}")
                print("    " + "  ".join(f"{op} {c[op]}" for op in ops))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
