"""Rule ``generator-less-random``: every random draw names its generator
and its dtype.

The port's counterpart of the reference's ``dtype-less-random``.  A draw
without ``generator=`` reads the process's global RNG, whose state
depends on every draw made before it anywhere in the process (a test
run's order, a warm-up, a library), so two runs of the same seed can
draw different weights or inputs; a draw without ``dtype=`` draws at
``torch.get_default_dtype()``, ambient state again.  So in the port:

  * ``torch.randn`` / ``rand`` / ``randint`` / ``randperm`` carry
    ``generator=`` and ``dtype=``; ``torch.normal`` carries
    ``generator=`` (its tensor form takes no dtype);
  * the in-place ``.normal_()`` / ``.uniform_()`` / ``.bernoulli_()``
    carry ``generator=`` (they keep their tensor's dtype).

A ``**kwargs`` splat may carry either and is trusted.
"""

from __future__ import annotations

import ast
from typing import Dict, List

from repro_torch.analysis.core import (Finding, Rule, SourceFile, dotted,
                                       imported_names, module_aliases,
                                       register)

#: torch function -> needs dtype=
DRAWS: Dict[str, bool] = {"randn": True, "rand": True, "randint": True,
                          "randperm": True, "normal": False}
#: in-place tensor methods (keep their tensor's dtype)
IN_PLACE = ("normal_", "uniform_", "bernoulli_")


def _kwargs(call: ast.Call):
    names = {kw.arg for kw in call.keywords}
    return names, None in names


class GeneratorLessRandomRule(Rule):
    id = "generator-less-random"
    title = "Random draw without an explicit generator= (and dtype=)"
    scope = ("src/repro_torch/*.py", "src/repro_torch/**/*.py")
    motivation = (
        "A draw from the global RNG depends on every draw before it in the "
        "process, and a dtype-less one on the default dtype: the same seed "
        "no longer gives the same weights or inputs."
    )

    def check(self, sf: SourceFile) -> List[Finding]:
        aliases = module_aliases(sf.tree, "torch")
        targets = {f"{a}.{fn}": fn for a in aliases for fn in DRAWS}
        direct = {local: orig for local, orig in
                  imported_names(sf.tree, "torch").items() if orig in DRAWS}
        findings: List[Finding] = []
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = None
            if isinstance(node.func, ast.Attribute):
                name = dotted(node.func)
                if name in targets:
                    fn = targets[name]
                elif node.func.attr in IN_PLACE:
                    fn = node.func.attr
            elif isinstance(node.func, ast.Name) and node.func.id in direct:
                fn = direct[node.func.id]
            if fn is None:
                continue
            names, splat = _kwargs(node)
            if splat:
                continue
            missing = [k for k in ("generator", "dtype")
                       if k not in names and (k == "generator"
                                              or DRAWS.get(fn, False))]
            if missing:
                findings.append(self.finding(
                    sf, node, f"{fn} without {' and '.join(m + '=' for m in missing)}"
                    ": the draw depends on the process's global RNG state "
                    "or default dtype; pass them explicitly"))
        return findings


RULE = register(GeneratorLessRandomRule())
