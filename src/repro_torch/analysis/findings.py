"""The one currency every analyzer family trades in.

A :class:`Finding` is a single violation: which rule, where (file + line
for AST lints; a symbolic location like ``registry:dgcwgmf`` for contract
checks and ``jaxpr:vmap_dgcwgmf`` for the round-fn auditors), and a
message precise enough to act on. Analyzers return ``list[Finding]`` —
never print, never exit — so the CLI (``python -m repro_torch.analysis``)
and the tests consume the same objects. The reference's
``repro.analysis.findings``, copied: equal findings give byte-equal JSON.
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str          # e.g. "REP001" / "CONTRACT-STATE" / "JAXPR-BASELINE"
    path: str          # file path, or "registry:<preset>" / "jaxpr:<config>"
    line: int          # 1-based line for lints; 0 when not file-anchored
    message: str
    severity: str = "error"   # "error" | "warning"

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: {self.rule} {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def to_json(findings: list[Finding], *, extra: dict | None = None) -> str:
    """Machine-readable report (``--json PATH`` writes it)."""
    doc = {
        "version": 1,
        "ok": not any(f.severity == "error" for f in findings),
        "num_findings": len(findings),
        "findings": [f.to_dict() for f in findings],
    }
    if extra:
        doc.update(extra)
    return json.dumps(doc, indent=2)


def print_findings(findings: list[Finding]) -> None:
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        print(f.format())
