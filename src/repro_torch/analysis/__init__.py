"""Static bit-safety analysis of the PyTorch/CUDA port: the reference's
analyzer (``repro.analysis``), its infrastructure copied, with five rules
rewritten for torch and scoped to ``src/repro_torch/``.

The port's bit-contracts (batched == one at a time, sync == async, every
schedule, policy and telemetry toggle bit-neutral) rest on conventions
that are easy to break and that no functional test notices at once:

  * device readbacks, synchronizes and blocking copies only at
    ``@_drain_point`` functions of ``runtime/``
    (``readback-outside-drain``);
  * every random draw with an explicit ``generator=`` and ``dtype=``
    (``generator-less-random``);
  * sums that feed the kernels' state in fp32 (``narrow-accumulation``);
  * host-only tenant labels never in a device call's arguments
    (``device-side-tenant-leak``);
  * no wall-clock / stdlib-random / set-iteration nondeterminism in the
    scheduler's plan paths (``hidden-nondeterminism``).

Each rule is an AST check (stdlib ``ast`` only) with inline suppressions
(``# repro: allow[rule-id] reason``), a committed baseline (empty:
``baseline.json`` in this package) and text / JSON reporters, the
reference's schema and exit codes.

Run it::

    python -m repro_torch.analysis            # text report, exit 1 on findings
    python -m repro_torch.analysis --json     # machine-readable report
    python -m repro_torch.analysis --list-rules
"""

from repro_torch.analysis.core import (  # noqa: F401
    Finding,
    Rule,
    SourceFile,
    all_rules,
    get_rule,
    register,
)

# Importing the rule modules populates the registry.
from repro_torch.analysis import rules_readback  # noqa: F401
from repro_torch.analysis import rules_random  # noqa: F401
from repro_torch.analysis import rules_accum  # noqa: F401
from repro_torch.analysis import rules_device  # noqa: F401
from repro_torch.analysis import rules_determ  # noqa: F401

from repro_torch.analysis.runner import (  # noqa: F401
    AnalysisResult,
    analyze,
    repo_root,
)
from repro_torch.analysis.baseline import (  # noqa: F401
    DEFAULT_BASELINE,
    load_baseline,
    write_baseline,
)
from repro_torch.analysis.report import (  # noqa: F401
    JSON_SCHEMA,
    render_json,
    render_text,
)

__all__ = [
    "Finding",
    "Rule",
    "SourceFile",
    "all_rules",
    "get_rule",
    "register",
    "AnalysisResult",
    "analyze",
    "repo_root",
    "DEFAULT_BASELINE",
    "load_baseline",
    "write_baseline",
    "JSON_SCHEMA",
    "render_json",
    "render_text",
]
