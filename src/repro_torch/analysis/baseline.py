"""Baseline files: grandfathered findings, checked in and burned down (a
copy of ``repro.analysis.baseline``).

A baseline lets the analyzer land as a zero-findings CI gate even on a
tree with pre-existing debt: known findings are recorded (by
``path:rule:line`` key) and filtered from the active set, while every
NEW finding still fails the gate.  ``--baseline-update`` rewrites the
file from the current scan - there is deliberately no ``--fix``.

The port's committed baseline (``src/repro_torch/analysis/baseline.json``)
is empty: every finding the five rules raise on the tree at merge time
was either fixed or carries an inline ``# repro: allow[...]`` suppression
with a reason.  Keep it that way.
"""

from __future__ import annotations

import json
import os
from typing import List, Set, Tuple

from repro_torch.analysis.core import Finding

BASELINE_SCHEMA = 1

#: repo-relative default location
DEFAULT_BASELINE = "src/repro_torch/analysis/baseline.json"


def load_baseline(path: str) -> Set[str]:
    """Finding keys recorded in a baseline file; empty set if absent."""
    if not os.path.exists(path):
        return set()
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    if data.get("schema") != BASELINE_SCHEMA:
        raise ValueError(
            f"baseline schema {data.get('schema')!r} != {BASELINE_SCHEMA} "
            f"in {path}"
        )
    return {Finding.from_dict(d).key() for d in data.get("findings", [])}


def write_baseline(path: str, findings: List[Finding]) -> None:
    data = {
        "schema": BASELINE_SCHEMA,
        "findings": [f.to_dict() for f in sorted(findings)],
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")


def split_baselined(
    findings: List[Finding], baseline_keys: Set[str]
) -> Tuple[List[Finding], List[Finding]]:
    """``(new, baselined)`` partition of findings against a baseline."""
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        (old if f.key() in baseline_keys else new).append(f)
    return new, old
