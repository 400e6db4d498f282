"""Rule ``readback-outside-drain``: device readbacks only at drain points.

The async engine overlaps host planning with device execution; one
``.cpu()`` on a step output, or a host array moved to the card with a
blocking ``.to(device)``, serializes host and device again without
failing any functional test.  Across every module of the port's
``runtime/``, outside a function marked ``@_drain_point``
(``runtime/telemetry.py``; nested functions inherit the marker):

  * no readback: ``.cpu()``, ``.item()``, ``.tolist()``, ``.numpy()``;
  * no synchronize: ``torch.cuda.synchronize()``, an event's or a
    stream's ``.synchronize()``;
  * no blocking copy to a device: every ``.to(<device>)`` carries
    ``non_blocking=True``, and no ``torch.tensor`` / ``torch.as_tensor``
    builds a tensor on a device (``device=``) from host data.

The forms are the matcher's of tests/test_torch_async_guard.py.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.analysis.core import Finding, Rule, SourceFile, register

READBACKS = ("cpu", "tolist", "item", "numpy", "synchronize")
HOST_TO_DEVICE = ("tensor", "as_tensor")
DRAIN_MARKER = "_drain_point"


def _names(node) -> str:
    """The dotted text of a Name / Attribute chain ('' for others)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return f"{_names(node.value)}.{node.attr}"
    return ""


def _device_like(node) -> bool:
    """A ``.to()`` argument that names a device: a string, a
    ``torch.device(...)`` call, or a name whose last part says "dev"."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return True
    if isinstance(node, ast.Call) and _names(node.func).endswith("device"):
        return True
    return "dev" in _names(node).split(".")[-1]


def _kw(call, name):
    return next((k.value for k in call.keywords if k.arg == name), None)


def violation(call: ast.Call) -> Optional[str]:
    """The message for a synchronizing call, or None."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return None
    if func.attr in READBACKS:
        return f".{func.attr}() synchronizes with the device"
    if func.attr == "to":
        dev = _kw(call, "device")
        if dev is None and call.args and _device_like(call.args[0]):
            dev = call.args[0]
        if dev is None:
            return None
        nb = _kw(call, "non_blocking")
        if not (isinstance(nb, ast.Constant) and nb.value is True):
            return ".to(<device>) without non_blocking=True blocks"
    if (func.attr in HOST_TO_DEVICE and _names(func.value) == "torch"
            and _kw(call, "device") is not None):
        return (f"torch.{func.attr}(..., device=) copies host data to the "
                "device and blocks")
    return None


def _is_drain_marked(fn) -> bool:
    for dec in fn.decorator_list:
        name = dec.id if isinstance(dec, ast.Name) else getattr(
            dec, "attr", None)
        if name == DRAIN_MARKER:
            return True
    return False


class ReadbackOutsideDrainRule(Rule):
    id = "readback-outside-drain"
    title = "Synchronizing call outside an @_drain_point function"
    scope = ("src/repro_torch/runtime/*.py",)
    motivation = (
        "The async engine's point: plan and dispatch never wait for the "
        "device; one .cpu() or blocking .to(device) on the hot path "
        "re-serializes host and device without failing a functional test."
    )

    def check(self, sf: SourceFile) -> List[Finding]:
        findings: List[Finding] = []

        def visit(node, drained):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                drained = drained or _is_drain_marked(node)
            if isinstance(node, ast.Call) and not drained:
                msg = violation(node)
                if msg:
                    findings.append(self.finding(
                        sf, node, f"{msg} outside @_drain_point (wrap the "
                        "readback in a drain point or keep values on the "
                        "device)"))
            for child in ast.iter_child_nodes(node):
                visit(child, drained)

        visit(sf.tree, False)
        return findings


RULE = register(ReadbackOutsideDrainRule())
