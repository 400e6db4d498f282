"""The port's static analyzer (``python -m repro_torch.analysis``).

  * each of the five torch rules flags its seeded violation and passes
    its negatives;
  * the port's tree is clean under all five with the committed, empty
    baseline (the CLI exits 0, its JSON report has the reference's
    schema);
  * the suppression syntax, the unknown-id exit code and the baseline
    behave as the reference's;
  * ``hidden-nondeterminism`` gives the reference rule's findings on the
    same seeded source, and ``readback-outside-drain`` those of
    tests/test_torch_async_guard.py's matcher.
"""

import json
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import (SourceFile, all_rules, analyze, get_rule,
                                  load_baseline)
from repro_torch.analysis.__main__ import main

ROOT = Path(__file__).resolve().parents[1]
RUNTIME = "src/repro_torch/runtime/x.py"
KERNELS = "src/repro_torch/kernels/x.py"
SCHED = "src/repro_torch/runtime/scheduler.py"


def _lines(rule_id, path, src):
    sf = SourceFile.from_source(path, textwrap.dedent(src))
    rule = get_rule(rule_id)
    assert rule.applies(path)
    return sorted(f.line for f in rule.check(sf))


def test_five_rules_scoped_to_the_port():
    ids = {r.id for r in all_rules()}
    assert ids == {"readback-outside-drain", "generator-less-random",
                   "narrow-accumulation", "device-side-tenant-leak",
                   "hidden-nondeterminism"}
    for r in all_rules():
        assert all(p.startswith("src/repro_torch/") for p in r.scope), r.id
        assert not r.applies("src/repro/runtime/engine.py"), r.id


SEEDS = {
    "readback-outside-drain": (RUNTIME, """\
        import torch

        class ServeEngine:
            def step(self):
                vals = self._tok.cpu()
                torch.cuda.synchronize()
                t = torch.from_numpy(self.table).to(self.device)
                u = torch.tensor(self.rows, device=self.device)
                return vals, t, u

            def peek(self, x, ev):
                ev.synchronize()
                return x.item(), x.tolist(), x.numpy(), x.to("cuda")

        def helper(x):
            return x.cpu()
        """, [5, 6, 7, 8, 12, 13, 13, 13, 13, 16], """\
        import numpy as np
        import torch

        class ServeEngine:
            @_drain_point
            def _retire_one(self):
                self.event.synchronize()
                return self.host.tolist()

            @_drain_point
            def sample(self, pool):
                def read(name):
                    return pool[name].cpu().numpy()
                return read("k")

            def _dispatch(self, table, dev):
                host = np.array(table)
                t = torch.from_numpy(host).pin_memory()
                return t.to(dev, non_blocking=True), t.to(torch.int32)
        """),
    "generator-less-random": ("src/repro_torch/models/x.py", """\
        import torch
        from torch import randint as ri

        def draw(g, shape, dev):
            a = torch.randn(shape, generator=g)
            b = torch.rand(shape, dtype=torch.float32)
            c = ri(0, 9, shape, dtype=torch.int64)
            d = torch.normal(torch.zeros(3), 1.0)
            e = torch.empty(shape).normal_()
            f = torch.randperm(9, generator=g)
            return a, b, c, d, e, f
        """, [5, 6, 7, 8, 9, 10], """\
        import torch

        def draw(g, shape, kw):
            a = torch.randn(shape, generator=g, dtype=torch.float32)
            b = torch.randint(0, 9, shape, generator=g, dtype=torch.int64)
            c = torch.normal(torch.zeros(3), 1.0, generator=g)
            d = torch.empty(shape).uniform_(generator=g)
            e = torch.rand(shape, **kw)
            return a, b, c, d, e
        """),
    "narrow-accumulation": (KERNELS, """\
        import torch

        def stats(s, p, v, wide):
            sbar = s.sum(-1)
            l = torch.sum(p, dim=-1, dtype=torch.float16)
            km = torch.mean(s, -2)
            pv = p @ v
            acc = torch.matmul(p, v)
            e = torch.einsum("bij,bjd->bid", p, v)
            kb = s.to(wide)
            kb = p.reshape(-1)
            return sbar, l, km, pv, acc, e, kb.sum()
        """, [4, 5, 6, 7, 8, 9, 12], """\
        import torch

        def stats(s, p, v, wide):
            sbar = s.float().sum(-1)
            l = torch.sum(p, dim=-1, dtype=torch.float32)
            km = torch.mean(s.to(wide), -2)
            n = s.sum(-1, dtype=wide)
            pv = p.float() @ v.float()
            acc = torch.matmul(p.to(torch.float32), v)
            e = torch.einsum("bij,bjd->bid", p.double(), v)
            kb = s.reshape(-1, 8).to(wide)
            kb = (kb - 1.0) * 2.0
            m = kb.mean(-2)
            return sbar, l, km, n, pv, acc, e, m
        """),
    "device-side-tenant-leak": (RUNTIME, """\
        from repro_torch.kernels import ops
        from repro_torch.models import transformer as T

        class ServeEngine:
            def step(self, req):
                a = self.bundle.paged_serve_step(self.params, req.tenant,
                                                 self.pool)
                b = T.serve_step(self.params, priority=req.priority)
                c = ops.pasa_decode(req.req_id_tensor, self.k, self.v)
                d = paged_verify_step(self.step, lambda r: r.tenant)
                return a, b, c, d
        """, [6, 8, 9, 10], """\
        from repro_torch.models import transformer as T

        class ServeEngine:
            def step(self, req):
                quota = self.quotas[req.tenant]
                out = self.bundle.paged_serve_step(self.params, self.feed,
                                                   self.pool)
                self.log(req.tenant, req.priority)
                return T.serve_step(self.params, self.feed), quota, out
        """),
    "hidden-nondeterminism": (SCHED, """\
        import random
        import time

        class Policy:
            def order(self, reqs):
                now = time.monotonic()
                random.shuffle(reqs)
                for r in set(reqs):
                    pass
                return [r for r in {1, 2}], now
        """, [6, 7, 8, 10], """\
        class Policy:
            def order(self, reqs, step):
                for r in sorted(set(reqs)):
                    pass
                return [r for r in reqs if r in {1, 2}], step
        """),
}


@pytest.mark.parametrize("rule_id", sorted(SEEDS))
def test_rule_flags_its_seeded_violation(rule_id):
    path, bad, lines, _ = SEEDS[rule_id]
    assert _lines(rule_id, path, bad) == lines


@pytest.mark.parametrize("rule_id", sorted(SEEDS))
def test_rule_passes_its_negatives(rule_id):
    path, _, _, good = SEEDS[rule_id]
    assert _lines(rule_id, path, good) == []


def test_hidden_nondeterminism_matches_the_reference_rule():
    from repro.analysis import SourceFile as RefSourceFile
    from repro.analysis import get_rule as ref_get_rule

    src = textwrap.dedent(SEEDS["hidden-nondeterminism"][1]) + textwrap.dedent(
        """\
        from time import perf_counter as pc
        import random as rnd

        def plan(xs):
            t = pc()
            rnd.random()
            return {x for x in frozenset(xs)}, t
        """)
    ref = ref_get_rule("hidden-nondeterminism").check(
        RefSourceFile.from_source("src/repro/runtime/scheduler.py", src))
    port = get_rule("hidden-nondeterminism").check(
        SourceFile.from_source(SCHED, src))
    assert [(f.line, f.message) for f in port] == [
        (f.line, f.message) for f in ref]
    assert len(port) == 7


def test_readback_rule_agrees_with_the_async_guard():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_async_guard", ROOT / "tests" / "test_torch_async_guard.py")
    guard = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(guard)
    rule = get_rule("readback-outside-drain")
    for src in (guard._BAD, guard._GOOD):
        sf = SourceFile.from_source(RUNTIME, src)
        assert sorted(f.line for f in rule.check(sf)) == sorted(
            n for _, n, _ in guard.findings(src))


def test_suppression_applies_and_unknown_ids_fail(tmp_path):
    src = textwrap.dedent("""\
        def f(x):
            # repro: allow[readback-outside-drain] the host owns x here
            a = x.cpu()
            b = x.item()  # repro: allow[readback-outside-drain] ditto
            return a, b, x.tolist()
        """)
    sf = SourceFile.from_source(RUNTIME, src)
    rule = get_rule("readback-outside-drain")
    live = [f for f in rule.check(sf) if not sf.is_suppressed(f.rule, f.line)]
    assert [f.line for f in live] == [5]
    root = tmp_path
    path = root / "src" / "repro_torch" / "runtime"
    path.mkdir(parents=True)
    (path / "x.py").write_text(
        "def f(x):\n    return x  # repro: allow[no-such-rule] why\n")
    assert main(["--root", str(root)]) == 2
    (path / "x.py").write_text("def f(x):\n    return x.cpu()\n")
    assert main(["--root", str(root)]) == 1
    base = root / "base.json"
    assert main(["--root", str(root), "--baseline", str(base),
                 "--baseline-update"]) == 0
    assert main(["--root", str(root), "--baseline", str(base)]) == 0


def test_the_port_is_clean_with_the_empty_baseline(capsys):
    baseline = ROOT / "src" / "repro_torch" / "analysis" / "baseline.json"
    assert json.loads(baseline.read_text()) == {"findings": [], "schema": 1}
    assert load_baseline(str(baseline)) == set()
    result = analyze(root=str(ROOT))
    assert result.findings == [], [f.key() for f in result.findings]
    assert result.files_scanned > 60
    assert main(["--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert set(report) == {"schema", "root", "files_scanned", "rules",
                           "findings", "counts", "suppressed", "baselined",
                           "exit_code"}
    assert report["schema"] == 1 and report["exit_code"] == 0
    assert len(report["rules"]) == 5
