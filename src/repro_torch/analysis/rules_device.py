"""Rule ``device-side-tenant-leak``: host labels never reach device code.

Tenancy, priority classes and request ids are host-side scheduling
labels: they shape WHEN a tenant's tokens arrive, never WHICH tokens.  If
one reached the device step, a serve could change padding or batch
shapes per tenant, or condition arithmetic on who is asking.

The reference finds the functions it hands to ``jax.jit`` /
``shard_map``.  The port's engine jits nothing: its device work is the
calls into the model and the kernels.  Their counterparts of the
reference's jitted functions are the bundle's step functions the engine
and the dense route call - ``serve_step``, ``paged_serve_step``,
``paged_prefill_step``, ``prefill``, ``init_cache``,
``init_paged_cache`` - and the engine's own ``paged_verify_step`` (the
reference's jitted verify), plus anything imported from
``repro_torch.models`` or ``repro_torch.kernels``.  In ``runtime/`` the
rule flags every identifier, attribute, keyword or string literal that
mentions ``tenant``, ``priority`` or ``req_id`` inside the arguments of
such a call (lambdas passed there included).
"""

from __future__ import annotations

import ast
from typing import List, Set

from repro_torch.analysis.core import (Finding, Rule, SourceFile, dotted,
                                       register)

BANNED_TOKENS = ("tenant", "priority", "req_id")
DEVICE_PACKAGES = ("repro_torch.models", "repro_torch.kernels")
#: the bundle's step functions and the engine's verify: called by name
DEVICE_CALLS = ("serve_step", "paged_serve_step", "paged_prefill_step",
                "prefill", "init_cache", "init_paged_cache",
                "paged_verify_step")


def _device_names(tree: ast.AST) -> Set[str]:
    """Local names bound to a module or function of the device packages."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 0 and \
                node.module and node.module.startswith(DEVICE_PACKAGES):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and \
                node.module == "repro_torch":
            names.update(a.asname or a.name for a in node.names
                         if a.name in ("models", "kernels"))
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.startswith(DEVICE_PACKAGES):
                    names.add(a.asname or a.name)
    return names


def _is_device_call(call: ast.Call, device_names: Set[str]) -> bool:
    func = call.func
    if isinstance(func, ast.Attribute) and func.attr in DEVICE_CALLS:
        return True
    if isinstance(func, ast.Name) and func.id in DEVICE_CALLS:
        return True
    name = dotted(func)
    if name is None:
        return False
    return any(name == n or name.startswith(n + ".") for n in device_names)


def _banned_mentions(expr: ast.AST):
    for node in ast.walk(expr):
        ident = None
        if isinstance(node, ast.Name):
            ident = node.id
        elif isinstance(node, ast.Attribute):
            ident = node.attr
        elif isinstance(node, ast.arg):
            ident = node.arg
        elif isinstance(node, ast.keyword) and node.arg:
            ident = node.arg
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            ident = node.value
        if ident is None:
            continue
        low = ident.lower()
        for tok in BANNED_TOKENS:
            if tok in low:
                yield node, ident, tok


class DeviceTenantLeakRule(Rule):
    id = "device-side-tenant-leak"
    title = "Host-only request label in the arguments of a device call"
    scope = ("src/repro_torch/runtime/*.py",)
    motivation = (
        "Tenancy, priority and request ids are host-side scheduling labels; "
        "on the device they could change shapes per tenant or condition "
        "arithmetic on who is asking - quotas must shape WHEN tokens "
        "arrive, never WHICH tokens."
    )

    def check(self, sf: SourceFile) -> List[Finding]:
        device_names = _device_names(sf.tree)
        findings: List[Finding] = []
        seen: Set[str] = set()
        for call in ast.walk(sf.tree):
            if not (isinstance(call, ast.Call)
                    and _is_device_call(call, device_names)):
                continue
            callee = dotted(call.func) or "<call>"
            args = list(call.args) + list(call.keywords)
            for arg in args:
                for node, ident, tok in _banned_mentions(arg):
                    line = getattr(node, "lineno", call.lineno)
                    key = f"{line}:{ident}"
                    if key in seen:
                        continue
                    seen.add(key)
                    findings.append(Finding(
                        path=sf.path, line=line, rule=self.id,
                        message=(f"device call {callee!r} is handed host-only "
                                 f"label {ident!r} (matches {tok!r}): tenant /"
                                 " priority / req_id state must stay "
                                 "host-side")))
        return findings


RULE = register(DeviceTenantLeakRule())
