"""File discovery and rule execution (a copy of
``repro.analysis.runner``, over the port's tree).

``analyze()`` walks the repo (or an explicit path list), parses each
python file once, runs every scoped rule over it, and partitions the
results into active findings vs inline-suppressed ones.  Files that do
not parse surface as findings of the pseudo-rule ``syntax-error`` so a
broken file fails the gate instead of silently dropping out of scope.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence, Set

from repro_torch.analysis.core import Finding, Rule, SourceFile, all_rules

#: directories walked when no explicit paths are given - the union of
#: every rule's scope roots.
DEFAULT_ROOTS = ("src/repro_torch",)

SYNTAX_RULE = "syntax-error"

_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "node_modules"}


def repo_root() -> str:
    """The repository root, inferred from this package's location
    (``<root>/src/repro_torch/analysis/runner.py``)."""
    here = os.path.abspath(os.path.dirname(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def discover_files(root: str, roots: Sequence[str] = DEFAULT_ROOTS) -> List[str]:
    """Repo-relative posix paths of every ``.py`` file under ``roots``."""
    out: List[str] = []
    for sub in roots:
        base = os.path.join(root, sub)
        if not os.path.isdir(base):
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(
                d for d in dirnames if d not in _SKIP_DIRS
            )
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    rel = os.path.relpath(os.path.join(dirpath, fn), root)
                    out.append(rel.replace(os.sep, "/"))
    return out


@dataclass
class AnalysisResult:
    root: str
    files_scanned: int = 0
    findings: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    #: rule ids referenced by suppression comments across the scan -
    #: validated against the registry so typos fail loudly
    suppression_ids: Set[str] = field(default_factory=set)

    def unknown_suppression_ids(self, known: Iterable[str]) -> Set[str]:
        return self.suppression_ids - set(known) - {SYNTAX_RULE}


def analyze(
    root: Optional[str] = None,
    paths: Optional[Sequence[str]] = None,
    rules: Optional[Sequence[Rule]] = None,
) -> AnalysisResult:
    root = os.path.abspath(root or repo_root())
    rules = list(rules) if rules is not None else all_rules()
    if paths is None:
        rel_paths = discover_files(root)
    else:
        rel_paths = []
        for p in paths:
            ap = os.path.abspath(p)
            if os.path.isdir(ap):
                sub = os.path.relpath(ap, root)
                rel_paths.extend(discover_files(root, (sub,)))
            else:
                rel_paths.append(
                    os.path.relpath(ap, root).replace(os.sep, "/")
                )
    result = AnalysisResult(root=root)
    for rel in rel_paths:
        scoped = [r for r in rules if r.applies(rel)]
        if not scoped:
            continue
        try:
            with open(os.path.join(root, rel), "r", encoding="utf-8") as f:
                source = f.read()
        except OSError as e:
            result.findings.append(
                Finding(rel, 0, SYNTAX_RULE, f"unreadable file: {e}")
            )
            continue
        try:
            sf = SourceFile.from_source(rel, source)
        except SyntaxError as e:
            result.findings.append(
                Finding(
                    rel, e.lineno or 0, SYNTAX_RULE, f"does not parse: {e.msg}"
                )
            )
            continue
        result.files_scanned += 1
        result.suppression_ids |= sf.suppressed_rule_ids()
        for rule in scoped:
            for finding in rule.check(sf):
                if sf.is_suppressed(finding.rule, finding.line):
                    result.suppressed.append(finding)
                else:
                    result.findings.append(finding)
    result.findings.sort()
    result.suppressed.sort()
    return result
