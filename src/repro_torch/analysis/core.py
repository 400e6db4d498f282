"""Analyzer core: findings, source-file model, rule registry, AST helpers
(a copy of ``repro.analysis.core``: the port imports nothing of the
reference).

Everything here is stdlib-only (``ast``, ``tokenize``, ``dataclasses``)
so the analyzer can run as a CI gate before any heavy import - it never
imports torch, never touches a device, and parses each file exactly once.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

# --------------------------------------------------------------- findings --


@dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at one source location.

    ``key()`` is the identity used by suppression and baseline matching:
    ``path:rule:line``.  Baselines therefore go stale when code moves -
    deliberately: a baseline is a burn-down list for grandfathered debt,
    not a living allowlist (inline suppressions are the living form,
    because they move with the code and carry a reason).
    """

    path: str  # repo-relative, posix separators
    line: int
    rule: str
    message: str

    def key(self) -> str:
        return f"{self.path}:{self.rule}:{self.line}"

    def to_dict(self) -> dict:
        return {
            "path": self.path,
            "line": self.line,
            "rule": self.rule,
            "message": self.message,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Finding":
        return cls(
            path=str(d["path"]),
            line=int(d["line"]),
            rule=str(d["rule"]),
            message=str(d.get("message", "")),
        )


# ---------------------------------------------------------- suppressions --

#: Suppression comment form: a ``repro: allow`` marker followed by one
#: or more bracketed rule ids and a free-text reason.  Rule ids are
#: validated against the registry at report time so a typo'd suppression
#: fails loudly instead of silently suppressing nothing.
_SUPPRESS_RE = re.compile(
    r"#\s*repro:\s*allow\[(?P<ids>[A-Za-z0-9_\-, ]+)\]\s*(?P<reason>.*)"
)


def _parse_suppressions(source: str) -> Dict[int, Set[str]]:
    """Map line number -> suppressed rule ids.

    A suppression comment applies to its own line; a *standalone* comment
    (nothing but the comment on its line) additionally applies to the
    next line, so multi-clause statements can carry the annotation just
    above the offending call.
    """
    out: Dict[int, Set[str]] = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        comments = [
            (tok.start[0], tok.start[1], tok.string)
            for tok in tokens
            if tok.type == tokenize.COMMENT
        ]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        # Fall back to a line scan; comments inside strings may false-
        # positive here, but this path only runs on files ast.parse will
        # reject anyway (reported as syntax-error findings).
        comments = [
            (i + 1, len(line) - len(line.lstrip()), line.strip())
            for i, line in enumerate(source.splitlines())
            if line.lstrip().startswith("#")
        ]
    lines = source.splitlines()
    for lineno, col, text in comments:
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        ids = {s.strip() for s in m.group("ids").split(",") if s.strip()}
        out.setdefault(lineno, set()).update(ids)
        src_line = lines[lineno - 1] if lineno - 1 < len(lines) else ""
        if src_line[:col].strip() == "":  # standalone comment line
            out.setdefault(lineno + 1, set()).update(ids)
    return out


# ---------------------------------------------------------- source files --


@dataclass
class SourceFile:
    """One parsed python file plus its suppression map."""

    path: str  # repo-relative posix path (used for rule scoping)
    source: str
    tree: ast.AST
    suppressions: Dict[int, Set[str]] = field(default_factory=dict)

    @classmethod
    def from_source(cls, path: str, source: str) -> "SourceFile":
        return cls(
            path=path,
            source=source,
            tree=ast.parse(source),
            suppressions=_parse_suppressions(source),
        )

    def is_suppressed(self, rule_id: str, line: int) -> bool:
        return rule_id in self.suppressions.get(line, ())

    def suppressed_rule_ids(self) -> Set[str]:
        ids: Set[str] = set()
        for s in self.suppressions.values():
            ids |= s
        return ids


# ------------------------------------------------------------------ rules --


class Rule:
    """One invariant, checked per file.

    Subclasses set ``id``/``title``/``scope``/``motivation`` and
    implement :meth:`check`.  ``scope`` is a tuple of ``fnmatch``
    patterns over repo-relative posix paths - a rule only sees files it
    scoped itself to, so adding a rule can never slow down or spuriously
    flag unrelated trees.
    """

    id: str = ""
    title: str = ""
    #: fnmatch patterns over repo-relative posix paths
    scope: Tuple[str, ...] = ()
    #: one-liner: the historical bug this rule makes unrepresentable
    motivation: str = ""

    def applies(self, relpath: str) -> bool:
        from fnmatch import fnmatch

        return any(fnmatch(relpath, pat) for pat in self.scope)

    def check(self, sf: SourceFile) -> List[Finding]:
        raise NotImplementedError

    def finding(self, sf: SourceFile, node: ast.AST, message: str) -> Finding:
        return Finding(
            path=sf.path,
            line=getattr(node, "lineno", 0),
            rule=self.id,
            message=message,
        )


_REGISTRY: Dict[str, Rule] = {}


def register(rule: Rule) -> Rule:
    if not rule.id:
        raise ValueError("rule must have an id")
    if rule.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {rule.id!r}")
    _REGISTRY[rule.id] = rule
    return rule


def all_rules() -> List[Rule]:
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def get_rule(rule_id: str) -> Rule:
    try:
        return _REGISTRY[rule_id]
    except KeyError:
        raise KeyError(
            f"unknown rule {rule_id!r}; have {sorted(_REGISTRY)}"
        ) from None


# ------------------------------------------------------------ AST helpers --


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def module_aliases(tree: ast.AST, module: str) -> Set[str]:
    """Every dotted prefix under which ``module`` is reachable in a file.

    ``module_aliases(tree, "torch.nn.functional")`` returns e.g.
    ``{"torch.nn.functional"}`` for ``import torch``, ``{"F"}`` for
    ``import torch.nn.functional as F``, ``{"functional"}`` for
    ``from torch.nn import functional``.
    """
    parent, _, last = module.rpartition(".")
    aliases: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == module:
                    aliases.add(a.asname or a.name)
                elif module.startswith(a.name + ".") and a.asname is None:
                    # ``import torch`` makes torch.nn reachable as-is
                    aliases.add(module)
                elif module.startswith(a.name + "."):
                    aliases.add(a.asname + module[len(a.name):])
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module == parent and parent:
                for a in node.names:
                    if a.name == last:
                        aliases.add(a.asname or a.name)
    return aliases


def imported_names(tree: ast.AST, module: str) -> Dict[str, str]:
    """Local name -> original name for ``from <module> import x [as y]``."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.ImportFrom)
            and node.level == 0
            and node.module == module
        ):
            for a in node.names:
                out[a.asname or a.name] = a.name
    return out


def iter_functions(
    tree: ast.AST,
) -> Iterator[Tuple[str, ast.AST]]:
    """Yield ``(owner, fn_node)`` for every module-level function and
    every direct class method.  Nested local functions are *not* yielded
    separately - they are part of their parent's body and inherit its
    drain/suppression status, exactly like the hand-rolled guard in
    tests/test_torch_async_guard.py."""
    if not isinstance(tree, ast.Module):
        return
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield "<module>", node
        elif isinstance(node, ast.ClassDef):
            for fn in node.body:
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield node.name, fn


def decorator_names(fn: ast.AST) -> Set[str]:
    """Last-component names of a function's decorators (``a.b`` -> ``b``;
    ``partial(a.b, ...)`` contributes ``partial`` AND ``b``)."""
    names: Set[str] = set()
    for deco in getattr(fn, "decorator_list", ()):
        for node in ast.walk(deco):
            if isinstance(node, ast.Attribute):
                names.add(node.attr)
            elif isinstance(node, ast.Name):
                names.add(node.id)
    return names


def has_decorator(fn: ast.AST, name: str) -> bool:
    return name in decorator_names(fn)
