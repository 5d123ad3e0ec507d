"""AST lint driver: the reference's ``repro.analysis.lints``, over the port.

Rules live in :mod:`repro_torch.analysis.lints.rules`; each is a callable
``rule(tree, path) -> list[Finding]`` registered via :func:`rule` with an
id (``REPxxx``, the reference's ids), a short name and the historical bug
it descends from.

The driver parses each file once, runs every rule over the shared tree,
then drops findings suppressed by a ``# repro-noqa: REPxxx`` (or bare
``# repro-noqa``) comment on the offending line: the same comment the
reference's driver honours, so one suppression serves both packages'
lints. A suppression carries its reason on the same line.

    from repro_torch.analysis import lints
    findings = lints.lint_paths(lints.default_paths())

``default_paths()`` are the port's own files: ``src/repro_torch/``,
``chip_smoke.py``, ``tests/test_torch_*.py`` and ``tests/torch_*.py``, and
the tools the port added (``tools/torch_*.py``,
``tools/k4_producer_variants.py``). ``tests/analysis_corpus/`` (the
seeded-violation corpus of both packages; the port's pairs are under
``torch/``) is excluded from tree walks.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Callable

from repro_torch.analysis.findings import Finding

__all__ = ["RULES", "Rule", "rule", "lint_source", "lint_file", "lint_paths", "default_paths"]

ROOT = Path(__file__).resolve().parents[4]


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    name: str
    doc: str          # one-line: what it catches
    history: str      # the shipped bug this rule descends from
    fn: Callable[[ast.AST, str], list[Finding]]


RULES: dict[str, Rule] = {}


def rule(id: str, name: str, *, doc: str, history: str):
    """Decorator registering a lint rule under ``id``."""

    def deco(fn):
        RULES[id] = Rule(id=id, name=name, doc=doc, history=history, fn=fn)
        return fn

    return deco


_NOQA = re.compile(r"#\s*repro-noqa(?::\s*(?P<ids>[A-Z0-9, ]+))?")

DEFAULT_EXCLUDE = ("analysis_corpus", "__pycache__", ".git")


def default_paths(root: str | Path = ROOT) -> list[Path]:
    """The port's files under ``root`` (the repo's root by default)."""
    root = Path(root)
    paths = [root / "src" / "repro_torch", root / "chip_smoke.py"]
    paths += sorted((root / "tests").glob("test_torch_*.py"))
    paths += sorted((root / "tests").glob("torch_*.py"))
    paths += sorted((root / "tools").glob("torch_*.py"))
    paths.append(root / "tools" / "k4_producer_variants.py")
    return [p for p in paths if p.exists()]


def _suppressed_lines(source: str) -> dict[int, set[str] | None]:
    """line -> set of suppressed rule ids (None = all rules)."""
    out: dict[int, set[str] | None] = {}
    for i, line in enumerate(source.splitlines(), 1):
        m = _NOQA.search(line)
        if not m:
            continue
        ids = m.group("ids")
        out[i] = None if ids is None else {s.strip() for s in ids.split(",")}
    return out


def lint_source(source: str, path: str = "<string>",
                rule_ids: tuple[str, ...] | None = None) -> list[Finding]:
    """Run (a subset of) the registered rules over one source string."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("REP000", path, e.lineno or 0, f"syntax error: {e.msg}")]
    findings: list[Finding] = []
    for rid, r in RULES.items():
        if rule_ids is not None and rid not in rule_ids:
            continue
        findings.extend(r.fn(tree, path))
    suppressed = _suppressed_lines(source)
    kept = []
    for f in findings:
        ids = suppressed.get(f.line, ())
        if ids is None or (ids and f.rule in ids):
            continue
        kept.append(f)
    return kept


def lint_file(path: str | Path, rule_ids: tuple[str, ...] | None = None) -> list[Finding]:
    p = Path(path)
    return lint_source(p.read_text(encoding="utf-8"), str(p), rule_ids)


def lint_paths(paths, *, exclude: tuple[str, ...] = DEFAULT_EXCLUDE,
               rule_ids: tuple[str, ...] | None = None) -> list[Finding]:
    """Lint every ``*.py`` under the given files/directories (a file named
    explicitly is always linted: the exclusions prune directory walks)."""
    findings: list[Finding] = []
    for root in paths:
        root = Path(root)
        if root.is_file():
            findings.extend(lint_file(root, rule_ids))
            continue
        for f in sorted(root.rglob("*.py")):
            if any(part in exclude for part in f.parts):
                continue
            findings.extend(lint_file(f, rule_ids))
    return findings


from repro_torch.analysis.lints import rules as _rules  # noqa: E402,F401  (registers RULES)
