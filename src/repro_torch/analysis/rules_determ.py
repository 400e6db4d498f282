"""Rule ``hidden-nondeterminism``: scheduler plan paths replay exactly
(the reference's rule, ``repro.analysis.rules_determ``, over the port's
``runtime/scheduler.py``).

Every scheduling decision - admission order, prefill grants, preemption
victims, draft budgets - must be a pure function of the engine's
explicit state, because the bit-identity contracts (sync == async,
policy swap, preempt-resume) all assume a run can be replayed decision
for decision.  Three leaks of ambient nondeterminism into plan code:

  * wall-clock reads (``time.time`` and friends);
  * the stdlib ``random`` module (unseeded global state);
  * iterating a ``set`` (hash order depends on PYTHONHASHSEED and
    insertion history) where the order feeds a decision.
    ``sorted(set(...))`` is fine, and membership tests are order-free.
"""

from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.core import (Finding, Rule, SourceFile, dotted,
                                       imported_names, module_aliases,
                                       register)

CLOCK_FNS = (
    "time",
    "time_ns",
    "monotonic",
    "monotonic_ns",
    "perf_counter",
    "perf_counter_ns",
)


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in ("set", "frozenset")
    return False


class HiddenNondeterminismRule(Rule):
    id = "hidden-nondeterminism"
    title = "Wall-clock / stdlib-random / set-iteration in a plan path"
    scope = ("src/repro_torch/runtime/scheduler.py",)
    motivation = (
        "Plan decisions must be replayable bit-for-bit: wall-clock reads, "
        "stdlib random, and hash-ordered set iteration make a schedule "
        "depend on ambient state the bit-identity suites cannot pin."
    )

    def check(self, sf: SourceFile) -> List[Finding]:
        findings: List[Finding] = []
        time_aliases = module_aliases(sf.tree, "time")
        clock_targets = {
            f"{a}.{fn}" for a in time_aliases for fn in CLOCK_FNS
        }
        clock_direct = {
            local
            for local, orig in imported_names(sf.tree, "time").items()
            if orig in CLOCK_FNS
        }
        # plain ``import random`` only
        random_aliases = {
            a for a in module_aliases(sf.tree, "random") if a
        }
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call):
                name = dotted(node.func)
                if name in clock_targets or (
                    isinstance(node.func, ast.Name)
                    and node.func.id in clock_direct
                ):
                    findings.append(
                        self.finding(
                            sf,
                            node,
                            f"wall-clock read {name or '<call>'} in a plan "
                            "path: schedule decisions must depend only on "
                            "step counters and explicit state",
                        )
                    )
                elif name and "." in name:
                    root = name.split(".", 1)[0]
                    if root in random_aliases:
                        findings.append(
                            self.finding(
                                sf,
                                node,
                                f"stdlib random call {name} in a plan path: "
                                "use seeded, keyed randomness threaded "
                                "through explicit state",
                            )
                        )
            iters: List[ast.AST] = []
            if isinstance(node, ast.For):
                iters.append(node.iter)
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                iters.extend(gen.iter for gen in node.generators)
            for it in iters:
                if _is_set_expr(it):
                    findings.append(
                        self.finding(
                            sf,
                            it,
                            "iteration over a set in a plan path: hash "
                            "order depends on PYTHONHASHSEED/insertion "
                            "history; sort first (sorted(...)) or keep a "
                            "list/dict",
                        )
                    )
        return findings


RULE = register(HiddenNondeterminismRule())
