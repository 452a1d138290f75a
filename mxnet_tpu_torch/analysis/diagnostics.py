"""The structured diagnostic of ``mx.analysis``, as the JAX package's
``mxnet_tpu/analysis/diagnostics.py`` shapes it, with the two rules the
retrace guard emits.  Stdlib only."""
from __future__ import annotations

from typing import Dict

__all__ = ["Diagnostic", "RULES", "rule_doc"]

# code -> (title, rationale, fix recipe)
RULES: Dict[str, tuple] = {
    "J001": (
        "retrace-storm",
        "one block accumulated an unbounded number of distinct captured "
        "signatures — each new signature pays a warm run and a CUDA graph "
        "capture, so steady-state throughput never materializes",
        "pad/bucket the offending argument to a fixed set of shapes "
        "(see the diagnostic for which input slot varies)"),
    "J002": (
        "shape-churn-storm",
        "a block keeps capturing a NEW signature every few calls with no "
        "ShapeBucketer attached — the shape distribution is churning "
        "(seq-len stream, partial batches) and the capture cost recurs "
        "forever instead of amortizing",
        "attach hybridize(bucketer=mx.jit.ShapeBucketer({axis: "
        "buckets})) so drifting shapes pad to a bounded bucket set (at "
        "most len(buckets) captures)"),
}


def rule_doc(code: str) -> str:
    """Human one-pager for a rule code."""
    if code not in RULES:
        return f"unknown rule code {code!r}"
    title, why, fix = RULES[code]
    return f"{code} ({title})\n  why: {why}\n  fix: {fix}\n"


class Diagnostic:
    """One finding: where, which rule, what to do about it."""

    __slots__ = ("path", "line", "col", "code", "message", "symbol",
                 "source")

    def __init__(self, path: str, line: int, code: str, message: str,
                 col: int = 0, symbol: str = "", source: str = "mxlint"):
        self.path = path
        self.line = int(line)
        self.col = int(col)
        self.code = code
        self.message = message
        self.symbol = symbol
        self.source = source

    def fingerprint(self) -> str:
        """Stable identity for baselining: (file, symbol, rule)."""
        return f"{self.path}::{self.symbol}::{self.code}"

    def to_dict(self) -> dict:
        return {"path": self.path, "line": self.line, "col": self.col,
                "code": self.code, "symbol": self.symbol,
                "message": self.message, "source": self.source}

    def format(self) -> str:
        where = f"{self.path}:{self.line}:{self.col}"
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{where}: {self.code} {self.message}{sym}"

    def __repr__(self):
        return f"Diagnostic({self.format()!r})"
