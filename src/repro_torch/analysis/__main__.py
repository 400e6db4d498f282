"""CLI: ``python -m repro_torch.analysis`` (the reference's CLI, over the
port's tree and rule set).

Exit codes: 0 = clean (no non-baselined findings), 1 = findings, 2 =
usage error / unknown suppression id.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from repro_torch.analysis import (
    DEFAULT_BASELINE,
    all_rules,
    analyze,
    get_rule,
    load_baseline,
    render_json,
    render_text,
    repo_root,
    write_baseline,
)
from repro_torch.analysis.baseline import split_baselined
from repro_torch.analysis.report import dumps, render_rule_list


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description=(
            "Static bit-safety invariant analyzer of the PyTorch/CUDA "
            "port (src/repro_torch/README.md; --list-rules)."
        ),
    )
    p.add_argument(
        "paths",
        nargs="*",
        help="files/directories to scan (default: the whole repo)",
    )
    p.add_argument("--root", default=None, help="repository root")
    p.add_argument(
        "--json", action="store_true", help="emit the JSON report on stdout"
    )
    p.add_argument(
        "--rule",
        action="append",
        default=None,
        metavar="ID",
        help="run only this rule (repeatable)",
    )
    p.add_argument(
        "--baseline",
        default=None,
        metavar="FILE",
        help=f"baseline file (default: <root>/{DEFAULT_BASELINE})",
    )
    p.add_argument(
        "--baseline-update",
        action="store_true",
        help=(
            "rewrite the baseline from the current findings and exit 0 "
            "(grandfathers debt; there is deliberately no --fix)"
        ),
    )
    p.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog"
    )
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    rules = all_rules()
    if args.list_rules:
        print(render_rule_list(rules))
        return 0
    if args.rule:
        try:
            rules = [get_rule(r) for r in args.rule]
        except KeyError as e:
            print(f"error: {e.args[0]}", file=sys.stderr)
            return 2

    root = os.path.abspath(args.root or repo_root())
    result = analyze(
        root=root, paths=args.paths or None, rules=rules
    )

    unknown = result.unknown_suppression_ids(r.id for r in all_rules())
    if unknown:
        print(
            "error: suppression comment(s) name unknown rule id(s): "
            + ", ".join(sorted(unknown)),
            file=sys.stderr,
        )
        return 2

    baseline_path = args.baseline or os.path.join(root, DEFAULT_BASELINE)
    if args.baseline_update:
        write_baseline(baseline_path, result.findings)
        print(
            f"baseline updated: {len(result.findings)} finding(s) -> "
            f"{baseline_path}"
        )
        return 0

    baseline_keys = load_baseline(baseline_path)
    new, baselined = split_baselined(result.findings, baseline_keys)

    if args.json:
        print(dumps(render_json(result, new, baselined, rules)))
    else:
        print(render_text(result, new, baselined, rules))
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
