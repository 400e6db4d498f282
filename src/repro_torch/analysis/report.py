"""Text and JSON reporters (a copy of ``repro.analysis.report``).

The JSON schema is the reference's, versioned (``JSON_SCHEMA``) and
pinned by tests/test_torch_analysis.py: key removals or renames are
breaking changes and must bump the version.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence

from repro_torch.analysis.core import Finding, Rule

JSON_SCHEMA = 1


def render_json(
    result,
    new: List[Finding],
    baselined: List[Finding],
    rules: Sequence[Rule],
) -> Dict:
    counts: Dict[str, int] = {}
    for f in new:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return {
        "schema": JSON_SCHEMA,
        "root": result.root,
        "files_scanned": result.files_scanned,
        "rules": [
            {"id": r.id, "title": r.title, "scope": list(r.scope)}
            for r in rules
        ],
        "findings": [f.to_dict() for f in sorted(new)],
        "counts": counts,
        "suppressed": len(result.suppressed),
        "baselined": len(baselined),
        "exit_code": 1 if new else 0,
    }


def render_text(
    result,
    new: List[Finding],
    baselined: List[Finding],
    rules: Sequence[Rule],
) -> str:
    lines: List[str] = []
    for f in sorted(new):
        lines.append(f"{f.path}:{f.line}: {f.rule}: {f.message}")
    tally = (
        f"{result.files_scanned} files scanned, {len(new)} finding(s), "
        f"{len(result.suppressed)} suppressed, {len(baselined)} baselined"
    )
    if new:
        lines.append("")
        lines.append(f"FAIL: {tally}")
    else:
        lines.append(f"OK: {tally}")
    return "\n".join(lines)


def render_rule_list(rules: Sequence[Rule]) -> str:
    lines = []
    for r in rules:
        lines.append(f"{r.id}")
        lines.append(f"    {r.title}")
        lines.append(f"    scope: {', '.join(r.scope)}")
        lines.append(f"    why: {r.motivation}")
    return "\n".join(lines)


def dumps(payload: Dict) -> str:
    return json.dumps(payload, indent=2, sort_keys=True)
