"""Rule ``narrow-accumulation``: sums that feed kernel state accumulate
in fp32.

ROADMAP B's rule for the port: the sums that feed the PASA state - the
block key mean km, the row pseudo-average s-bar and the softmax sum l -
accumulate in fp32 (``core.precision.reduce_dtype``) and round once on
the store, so the state does not depend on the backend's summation order
or on the policy's (possibly fp16) storage dtype.  In ``kernels/`` and
``core/pasa.py`` this rule flags a ``sum`` / ``mean`` / ``cumsum`` /
``einsum`` / ``matmul`` (``torch.X(...)``, or the ``.sum()`` /
``.mean()`` / ``.cumsum()`` / ``.matmul()`` methods, or ``@``) that
satisfies neither of:

  * a wide ``dtype=`` (a float32 / float64 literal, or a named dtype
    variable such as ``wide`` or ``stat_dtype`` - an explicit choice,
    trusted), for the reducers that take one;
  * an operand widened first: ``.float()``, ``.double()``, or
    ``.to(<not narrow>)`` inside the reduced expression, or a local name
    whose last assignment above it, in source order, is such a widened
    expression (``kb = k.to(wide)`` and then ``kb.mean(-2)``).

A symbolic dtype is trusted: the rule cannot tell what ``wide`` or
``gemm_t`` holds.  So a product kept at the policy's input dtype on
purpose through a named dtype passes (the GEMM shift of
``core/pasa.py``, ``torch.matmul(q.to(gemm_t), ...)``), and so would
one at fp16 by mistake.
"""

from __future__ import annotations

import ast
import bisect
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from repro_torch.analysis.core import (Finding, Rule, SourceFile, dotted,
                                       register)

REDUCERS = ("sum", "mean", "cumsum", "einsum", "matmul")
TAKES_DTYPE = ("sum", "mean", "cumsum")
NARROW_TOKENS = ("float16", "bfloat16", "half", "fp16", "bf16", "e4m3",
                 "e5m2", "int8", "uint8")
WIDE_TOKENS = ("float32", "float64", "double", "f32", "f64")


def _dtype_is_narrow(node: ast.AST) -> Optional[bool]:
    """True / False for a dtype expression naming a narrow / wide dtype;
    None for a symbolic one (``wide``, ``policy.stat_dtype``)."""
    name = dotted(node)
    if name is None:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            name = node.value
        else:
            return None
    low = name.lower()
    if any(tok in low for tok in NARROW_TOKENS):
        return True
    if any(tok in low for tok in WIDE_TOKENS) or low.endswith(".float"):
        return False
    return None


def _widened(expr: ast.AST,
             is_wide: Callable[[ast.Name], bool] = lambda n: False) -> bool:
    """Does ``expr`` go through ``.float()`` / ``.double()``, a
    ``.to(<dtype>)`` that is not narrow (a named dtype variable is an
    explicit choice, trusted, as the reference trusts it; a device is no
    dtype), or a name that ``is_wide`` there?"""
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and is_wide(node):
            return True
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        if node.func.attr in ("float", "double") and not node.args:
            return True
        if node.func.attr == "to":
            dt = next((k.value for k in node.keywords if k.arg == "dtype"),
                      node.args[0] if node.args else None)
            if dt is None or "dev" in (dotted(dt) or "").rsplit(".", 1)[-1]:
                continue
            if _dtype_is_narrow(dt) is not True:
                return True
    return False


_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


def _own_nodes(scope: ast.AST) -> Iterator[ast.AST]:
    """The nodes of ``scope``'s body, not those of a def nested in it."""
    todo = list(ast.iter_child_nodes(scope))
    while todo:
        node = todo.pop()
        if isinstance(node, _DEFS):
            continue
        yield node
        todo.extend(ast.iter_child_nodes(node))


class _Bindings:
    """The bindings of each local name of a scope (a function, a class
    body or the module) in source order, each wide or not: an assignment
    of a widened expression is wide (``kb = k.to(wide)``, then ``kb = (kb
    - m) * s``); an argument, a loop or tuple target or an augmented
    assignment is not.  A use reads the name's last binding above it in
    source order, a reading that ignores branches and loops."""

    def __init__(self, scope: ast.AST):
        events = []                 # (position, name, value or None)
        if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
            events += [((0, 0), a.arg, None) for a in ast.walk(scope.args)
                       if isinstance(a, ast.arg)]
        plain = set()               # the Name targets of an assignment
        for node in _own_nodes(scope):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                end = (node.end_lineno, node.end_col_offset)
                for t in targets:
                    if isinstance(t, ast.Name):
                        plain.add(id(t))
                        events.append((end, t.id, node.value))
        for node in _own_nodes(scope):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store) \
                    and id(node) not in plain:
                events.append(((node.lineno, node.col_offset), node.id, None))
        self._at: Dict[str, list] = {}
        self._wide: Dict[str, list] = {}
        for pos, name, value in sorted(events, key=lambda e: e[0]):
            wide = value is not None and _widened(value, self.is_wide)
            self._at.setdefault(name, []).append(pos)
            self._wide.setdefault(name, []).append(wide)

    def is_wide(self, node: ast.Name) -> bool:
        at = self._at.get(node.id, [])
        i = bisect.bisect_left(at, (node.lineno, node.col_offset)) - 1
        return i >= 0 and self._wide[node.id][i]


def _scopes(tree: ast.AST) -> Iterator[Tuple[ast.AST, _Bindings]]:
    """Each function, class body and the module, with its bindings."""
    for scope in ast.walk(tree):
        if isinstance(scope, (ast.Module,) + _DEFS):
            yield scope, _Bindings(scope)


class NarrowAccumulationRule(Rule):
    id = "narrow-accumulation"
    title = "Kernel reduction or product with implicit (possibly fp16) accumulation"
    scope = ("src/repro_torch/kernels/*.py", "src/repro_torch/core/pasa.py")
    motivation = (
        "ROADMAP B: sums that feed km, s-bar and l accumulate in fp32; a "
        "reduction at the policy's fp16 storage dtype makes the kernel "
        "state depend on the backend's summation order."
    )

    def check(self, sf: SourceFile) -> List[Finding]:
        findings: List[Finding] = []
        for scope, names in _scopes(sf.tree):
            findings.extend(self._check_scope(sf, scope, names.is_wide))
        return sorted(findings, key=lambda f: f.line)

    def _check_scope(self, sf: SourceFile, scope: ast.AST,
                     wide: Callable[[ast.Name], bool]) -> List[Finding]:
        findings: List[Finding] = []
        for node in _own_nodes(scope):
            if isinstance(node, ast.BinOp) and isinstance(node.op,
                                                          ast.MatMult):
                if not (_widened(node.left, wide)
                        or _widened(node.right, wide)):
                    findings.append(self.finding(
                        sf, node, "@ product with operands at their storage "
                        "dtype: widen an operand first (.float())"))
                continue
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            name = dotted(func) or ""
            if name.startswith("torch.") and name[6:] in REDUCERS:
                reducer, operands = name[6:], list(node.args)
            elif isinstance(func, ast.Attribute) and func.attr in (
                    "sum", "mean", "cumsum", "matmul") \
                    and not name.startswith(("torch.", "np.", "math.")):
                reducer, operands = func.attr, [func.value] + list(node.args)
            else:
                continue
            dt = next((k.value for k in node.keywords if k.arg == "dtype"),
                      None)
            if dt is not None and reducer in TAKES_DTYPE:
                if _dtype_is_narrow(dt) is not True:
                    continue
                why = "an explicitly narrow dtype="
            elif any(_widened(op, wide) for op in operands):
                continue
            else:
                why = "no fp32 dtype= and no operand widened first"
            findings.append(self.finding(
                sf, node, f"{reducer} with {why}: sums feeding kernel state "
                "accumulate in fp32 (ROADMAP B)"))
        return findings


RULE = register(NarrowAccumulationRule())
