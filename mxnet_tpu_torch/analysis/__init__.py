"""The port's ``mx.analysis``: the retrace guard (J001, J002) over
``HybridBlock.hybridize()``'s captured signatures, and the
:class:`~.diagnostics.Diagnostic` it reports.

The part of ``mxnet_tpu/analysis/`` that the guard needs; the linters
(H, L, E, X rules) are not ported (ROADMAP A6).
"""
from . import retrace
from .diagnostics import RULES, Diagnostic, rule_doc

__all__ = ["retrace", "Diagnostic", "RULES", "rule_doc"]
