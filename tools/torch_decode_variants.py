"""Where the split-K decode kernel's time goes, by timing variants of it on
one CUDA card.

    python3 tools/torch_decode_variants.py

Copies ``mxnet_tpu_torch/csrc`` into ``build/decode_variants/<name>/``
with one change each (string patches of ``decode_attention.cuh``), builds
``decode_attention_bf16.cu`` and ``decode_attention.cu`` of every copy
with ``nvcc`` (sm_90a, the port's flags), and times bf16 queries over a
bf16 cache (the tensor-core path) and f32 over f32 (CUDA cores) at the
decode step's shape (B=8, H=12, d=64, Tq=1, C=1024, cache lengths
979-1000; 4 splits of 256), each build through the C entry of its own
library: device time a call from ``torch.profiler`` kernel records over
50 calls (each kernel's mean recorded duration times its launches a
call), the inputs cycled through copies of at least 200 MB, in three
rounds.  The variants:

- ``default placement``: the clusters launched without the
  load-balancing scheduling policy;
- ``early push``: rank 0's mailbox a region of its own after the
  mbarrier, so a split pushes its partial as soon as it has merged its
  warps, not once every ring of the cluster is read;
- a waterfall, each step removing one more piece (their outputs are
  wrong): ``W1`` no pushes to rank 0, ``W2`` no cluster barrier or
  mbarrier wait either, ``W3`` no cluster launch, ``W4`` no tile compute
  (S, softmax, P V), ``W5`` no K / V copies, ``W6`` no warp merge; the
  differences between neighbours read as the cost of each piece (W4 and
  W5 patch the tensor-core path only, so the f32 rows show W1-W3 and W6).

Prints one line a variant and round, the card as ``nvidia-smi`` names it
and one JSON line last.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B, H, D, C = 8, 12, 64, 1024
SOURCES = ("decode_attention_bf16.cu", "decode_attention.cu")
PUSH = ("    for (int i = tid; i < part; i += nt) slot[i] = g.pM[i];\n", "")
SYNC = [("  cluster_wait();   // every ring is read; rank 0's mbarrier "
         "initialized\n", ""),
        ("  if (S > 1) mbar_wait(bar, 0);\n", ""),
        ("    mbar_arrive_remote(bar, 0);\n", ""),
        ("  cluster_arrive();  // this block's ring is read\n", "")]
LAUNCH = ("  cfg.numAttrs = 2;", "  cfg.numAttrs = 0;")
COMPUTE = [("    // S = Q K^T: eight 8-key tiles",
            "    if (a.scale < 0.f) {\n    // S = Q K^T: eight 8-key tiles"),
           ("        mma16<T>(o[2 * mm + 1], pa, r[2], r[3]);\n      }\n    }\n",
            "        mma16<T>(o[2 * mm + 1], pa, r[2], r[3]);\n      }\n    }\n"
            "    }\n")]
COPIES = [("    if (tt < ntile) load_rows16<DK>(s, kb,",
           "    if (tt < 0) load_rows16<DK>(s, kb,"),
          ("    if (tt < ntile)\n      load_rows16<DK>(s + TILE16 * RB, vb,",
           "    if (tt < 0)\n      load_rows16<DK>(s + TILE16 * RB, vb,")]
WARPS = ("    merge_warps(g, nw, tq, wd, d);", "    (void)0;")
VARIANTS = {
    "this checkout": [],
    "default placement": [("  cfg.numAttrs = 2;", "  cfg.numAttrs = 1;")],
    "early push": [
        ("  if (p0 < p1) {\n    if constexpr (kKv16<KV>)\n",
         "  cluster_arrive();\n  if (p0 < p1) {\n    if constexpr (kKv16<KV>)\n"),
        ("  cluster_arrive();  // this block's ring is read\n", ""),
        ("  float* box = g.pA + tq * d;",
         "  float* box = reinterpret_cast<float*>(bar + 2);"),
        ("  const size_t merge = 4 * (merge_floats(nw, tq, wd, a.d) +\n"
         "                            (size_t)(a.S - 1) * tq * (a.d + 2));",
         "  const size_t merge = 4 * merge_floats(nw, tq, wd, a.d);"),
        ("  const size_t smem = bar + 16;",
         "  const size_t smem = bar + 16 + 4 * (size_t)(a.S - 1) * tq * "
         "(a.d + 2);")],
}
_STEPS = [("W1 no pushes", [PUSH]), ("W2 no cluster sync", SYNC),
          ("W3 no cluster launch", [LAUNCH]),
          ("W4 no tile compute", COMPUTE), ("W5 no K/V copies", COPIES),
          ("W6 no warp merge", [WARPS])]
_acc = []
for _name, _patches in _STEPS:
    _acc = _acc + _patches
    VARIANTS[_name] = list(_acc)


def variant_dir(csrc: Path, out: Path, patches) -> Path:
    out.mkdir(parents=True, exist_ok=True)
    for f in csrc.iterdir():
        if f.suffix not in (".cu", ".cuh"):
            continue
        txt = f.read_text()
        if f.name == "decode_attention.cuh":
            for old, new in patches:
                if old not in txt:
                    raise SystemExit(f"patch does not apply: {old!r}")
                txt = txt.replace(old, new)
        (out / f.name).write_text(txt)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_variants: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.kernels import _build
    from mxnet_tpu_torch.test_utils import decode_case

    root = _build.BUILD_DIR.parent / "decode_variants"
    jobs = {}
    for i, (name, patches) in enumerate(VARIANTS.items()):
        d = variant_dir(_build.CSRC, root / f"v{i}", patches)
        for src in SOURCES:
            lib = d / f"{Path(src).stem}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o",
                   str(lib), str(d / src)]
            jobs[(name, src)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), lib)
    libs = {}
    for (name, src), (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed ({name}, {src}):\n{log[-4000:]}")
        libs[(name, src)] = ctypes.CDLL(str(lib))
    dev = torch.device("cuda", 0)
    lens = [1000 - 3 * i for i in range(B)]
    pairs = {"bf16_bf16": (torch.bfloat16, "decode_attention_bf16.cu"),
             "f32_f32": (torch.float32, "decode_attention.cu")}
    stream = torch.cuda.current_stream(dev).cuda_stream

    def device_ms(fn, nbuf, calls=50):
        for i in range(3):
            fn(i % nbuf)
        torch.cuda.synchronize()
        for _ in range(5):       # a profile that lost records is taken again
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
                return us / 1e3
        raise RuntimeError("five profiles lost kernel records")

    rows = {}
    for pair, (dt, src) in pairs.items():
        nbuf = max(1, math.ceil(200e6 / (2 * B * H * C * D *
                                        torch.tensor([], dtype=dt)
                                        .element_size())))
        bufs = [decode_case(dt, dt, B, H, 1, C, D, lens, seed=50 + i,
                            device=dev)[0] for i in range(nbuf)]
        short = "f32" if dt == torch.float32 else "bf16"
        for rnd in range(3):
            for name in VARIANTS:
                fn = getattr(libs[(name, src)],
                             f"mx_decode_attention_{short}_{short}")
                fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + \
                    [ctypes.c_float, ctypes.c_void_p]
                fn.restype = ctypes.c_int

                def call(i, fn=fn):
                    kw = bufs[i]
                    out = torch.empty_like(kw["q"])
                    err = fn(kw["q"].data_ptr(), kw["k"].data_ptr(), None,
                             kw["v"].data_ptr(), None,
                             kw["cache_len"].data_ptr(), out.data_ptr(),
                             None, B, H, 1, C, D, 256, 4, 0.125, stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")

                ms = device_ms(call, nbuf)
                rows.setdefault(pair, {}).setdefault(name, []).append(ms)
                print(f"{pair} round {rnd} {name}: {ms:.4f} ms", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    for pair, per in rows.items():
        print(pair + ": " + ", ".join(
            f"{name} {statistics.median(v):.4f}" for name, v in per.items())
            + f" ms (medians) [{card}]")
    print(card)
    print(json.dumps(dict(card=card, ms=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
