"""Serving-stack observability: step tracing, metrics, numerics telemetry.

The port's own copy of ``repro.runtime.telemetry``: stdlib and numpy,
torch only at the probe's one device read.  Three layers, all
**bit-neutral** - enabling them changes what the engine records, never
what it computes:

  * :class:`StepTracer` - a bounded ring buffer of typed trace events:
    per-step ``plan`` / ``dispatch`` / ``retire`` spans (wall-clock
    begin/end and engine step number) and per-request lifecycle instants
    (``submit`` / ``admit`` / ``resume`` / ``first_token`` / ``preempt``
    / ``cancel`` / ``finish``).  Exportable as JSON lines
    (:meth:`StepTracer.write_jsonl`) or as a Chrome ``trace_event`` file
    (:meth:`StepTracer.write_chrome_trace`) for Perfetto /
    ``chrome://tracing``; under async pipelining step N's ``retire`` span
    sits after step N+1's ``dispatch``.
  * :class:`MetricsRegistry` - counters, gauges and bucketed histograms
    with percentile estimates (:class:`Histogram`), and cross-replica
    aggregation (:func:`aggregate_snapshots`).  The engine threads one
    registry through itself, its
    :class:`~repro_torch.runtime.paged_cache.PageAllocator` and its
    :class:`~repro_torch.runtime.prefix_cache.RadixPrefixCache`;
    :meth:`ServeEngine.metrics_snapshot` is the scrape surface.
  * :class:`NumericsProbe` - the paper's overflow and resonance
    instrumentation as a sampled monitor: every ``every``-th engine step
    it reads a bounded sample of live K pages (its own drain, the only
    device readback of this module, marked ``@_drain_point``) and
    publishes the paper's overflow causes as gauges: the worst-case
    score amplitude against the fp16 ceiling, the per-page PASA shift
    magnitude and a Q/K resonance indicator.

Why telemetry is bit-neutral: every hook reads host state the engine
already keeps (queue lengths, cursors, allocator counters, wall clocks),
and none of it feeds back into a device call, a scheduling decision or a
sampling key.  The probe only reads the pool, at a retirement boundary
where the pipeline may wait for the device anyway: it costs time, never
bits.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

FP16_MAX = 65504.0


def _drain_point(fn):
    """Mark a function as a LEGAL synchronizing site of the async serving
    pipeline: a device readback (``.cpu()``, ``.tolist()``, ``.item()``,
    ``.numpy()``), an event or device synchronize, or a blocking copy to
    the device.  tests/test_torch_async_guard.py parses every module of
    the port's runtime and fails on any such call outside a function
    carrying this marker - the static guard that keeps host/device
    overlap from silently regressing."""
    fn.__drain_point__ = True
    return fn


# ------------------------------------------------------------- tracing --

#: Span names of one engine step, in order.  ``plan`` = host-only
#: scheduling (trim, admission, policy decisions); ``dispatch`` = page
#: -table assembly + enqueueing the device calls (no sync); ``retire`` =
#: materializing tokens of steps beyond ``pipeline_depth`` (the only
#: per-token device wait).
STEP_SPANS = ("plan", "dispatch", "retire")

#: Request lifecycle instants the engine emits.  ``resume`` is the
#: re-admission of a previously preempted request; ``first_token`` fires
#: at RETIREMENT (when the token value exists on host), stamped with the
#: step that dispatched it.
LIFECYCLE_EVENTS = (
    "submit", "admit", "resume", "first_token", "preempt", "cancel",
    "finish",
)


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One ring-buffer entry.

    ``kind``: "span" (has ``dur``), "instant", or "counter" (per-step
    gauge samples in ``args``).  ``ts``/``dur`` are seconds relative to
    the tracer's epoch; ``engine`` is the replica index (0 for a single
    engine); ``args`` carries event payload (req_id, token counts, probe
    readings, ...)."""

    kind: str
    name: str
    step: int
    ts: float
    dur: float = 0.0
    engine: int = 0
    args: Optional[dict] = None


class StepTracer:
    """Bounded ring buffer of :class:`TraceEvent`.

    Appends are O(1); when full, the OLDEST events are dropped (a serving
    process must never grow without bound because someone left tracing
    on) and :attr:`dropped` counts exactly how many - an exporter can
    report truncation honestly instead of silently presenting a window
    as the whole history."""

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._events: deque = deque(maxlen=self.capacity)
        self.emitted = 0          # total appends ever
        self._epoch = time.perf_counter()

    def clock(self) -> float:
        """Seconds since the tracer's epoch (the trace time base)."""
        return time.perf_counter() - self._epoch

    @property
    def dropped(self) -> int:
        return self.emitted - len(self._events)

    def events(self) -> List[TraceEvent]:
        return list(self._events)

    def _append(self, ev: TraceEvent) -> None:
        self._events.append(ev)
        self.emitted += 1

    def span(self, name: str, step: int, t0: float, t1: float, *,
             engine: int = 0, args: Optional[dict] = None) -> None:
        self._append(TraceEvent(
            "span", name, step, t0, max(t1 - t0, 0.0), engine, args
        ))

    def instant(self, name: str, step: int, *, engine: int = 0,
                args: Optional[dict] = None) -> None:
        self._append(TraceEvent(
            "instant", name, step, self.clock(), 0.0, engine, args
        ))

    def counter(self, name: str, step: int, values: dict, *,
                engine: int = 0) -> None:
        """Per-step numeric samples; rendered as Chrome counter tracks
        (queue depth, free pages, ... as area charts under the spans)."""
        self._append(TraceEvent(
            "counter", name, step, self.clock(), 0.0, engine, dict(values)
        ))

    # ------------------------------------------------------- exporters --

    def write_jsonl(self, path: str) -> int:
        """One JSON object per line (ingestion-friendly); returns the
        number of events written.  A leading meta line records capacity
        and how many events the ring dropped."""
        evs = self.events()
        with open(path, "w") as f:
            f.write(json.dumps({
                "meta": "repro_torch.runtime.telemetry",
                "capacity": self.capacity,
                "emitted": self.emitted,
                "dropped": self.dropped,
            }) + "\n")
            for ev in evs:
                f.write(json.dumps(dataclasses.asdict(ev)) + "\n")
        return len(evs)

    def write_chrome_trace(self, path: str) -> int:
        """Chrome ``trace_event`` JSON (the ``traceEvents`` array form),
        loadable in Perfetto / ``chrome://tracing``; returns the number
        of trace events written.

        Layout: one *process* per engine replica (pid = engine index);
        step spans go on tid 0 ("step"), request lifecycle instants on
        tid 1 ("requests"), counters become "C" events (rendered as
        per-process area tracks).  Timestamps are microseconds from the
        tracer epoch, durations likewise - Perfetto's wall-clock axis
        then directly shows retire-of-step-N landing after
        dispatch-of-step-N+1 under async pipelining."""
        out = []
        pids = set()
        for ev in self._events:
            pids.add(ev.engine)
            base = {
                "pid": ev.engine,
                "ts": ev.ts * 1e6,
                "cat": ev.kind,
                "name": ev.name,
                "args": dict(ev.args or {}, step=ev.step),
            }
            if ev.kind == "span":
                out.append(dict(base, ph="X", tid=0, dur=ev.dur * 1e6))
            elif ev.kind == "counter":
                out.append(dict(base, ph="C", tid=0))
            else:
                out.append(dict(base, ph="i", tid=1, s="t"))
        meta = []
        for pid in sorted(pids):
            meta.append({
                "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                "args": {"name": f"engine {pid}"},
            })
            meta.append({
                "ph": "M", "pid": pid, "tid": 0, "name": "thread_name",
                "args": {"name": "step"},
            })
            meta.append({
                "ph": "M", "pid": pid, "tid": 1, "name": "thread_name",
                "args": {"name": "requests"},
            })
        payload = {
            "traceEvents": meta + out,
            "displayTimeUnit": "ms",
            "otherData": {
                "source": "repro_torch.runtime.telemetry",
                "dropped_events": self.dropped,
            },
        }
        with open(path, "w") as f:
            json.dump(payload, f)
        return len(out)


# ------------------------------------------------------------- metrics --

class Counter:
    """Monotone counter."""

    kind = "counter"

    def __init__(self, name: str, unit: str = "", help: str = ""):
        self.name, self.unit, self.help = name, unit, help
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: inc({n})")
        self.value += n

    def snapshot(self) -> dict:
        return {"value": self.value, "unit": self.unit}


class Gauge:
    """Last-write-wins instantaneous value (None until first set)."""

    kind = "gauge"

    def __init__(self, name: str, unit: str = "", help: str = ""):
        self.name, self.unit, self.help = name, unit, help
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> dict:
        return {"value": self.value, "unit": self.unit}


#: Default histogram buckets: exponential decades 1e-4 .. 1e2 with 1-2-5
#: subdivision - spans sub-ms host phases to multi-second TTFTs.
DEFAULT_BUCKETS = tuple(
    m * 10.0 ** e for e in range(-4, 3) for m in (1.0, 2.0, 5.0)
)


class Histogram:
    """Fixed-bucket histogram with exact count/sum/min/max and
    interpolated percentiles.

    ``bounds`` are the INCLUSIVE upper edges of the finite buckets; an
    implicit overflow bucket catches everything beyond the last edge.
    :meth:`percentile` finds the bucket containing the requested rank
    and interpolates linearly inside it (the overflow bucket reports its
    lower edge, clamped by the exact observed max - a conservative,
    deterministic estimate rather than a fabricated interior point)."""

    kind = "histogram"

    def __init__(self, name: str, unit: str = "", help: str = "",
                 bounds: Sequence[float] = DEFAULT_BUCKETS):
        self.name, self.unit, self.help = name, unit, help
        self.bounds = tuple(float(b) for b in bounds)
        if not self.bounds or any(
            b <= a for a, b in zip(self.bounds, self.bounds[1:])
        ):
            raise ValueError(
                f"histogram {name}: bounds must be non-empty and strictly "
                f"increasing, got {bounds}"
            )
        self.counts = [0] * (len(self.bounds) + 1)   # +1: overflow
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def percentile(self, p: float) -> Optional[float]:
        """Estimate the ``p``-th percentile (0 <= p <= 100) from the
        bucket counts; None when empty."""
        if not 0.0 <= p <= 100.0:
            raise ValueError(f"percentile {p} outside [0, 100]")
        if self.count == 0:
            return None
        rank = p / 100.0 * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                lo = 0.0 if i == 0 else self.bounds[i - 1]
                if i == len(self.bounds):      # overflow bucket
                    return min(self.max, max(lo, self.min))
                hi = self.bounds[i]
                frac = (rank - seen) / c
                est = lo + frac * (hi - lo)
                # exact extremes beat bucket interpolation at the edges
                return min(max(est, self.min), self.max)
            seen += c
        return self.max

    def snapshot(self) -> dict:
        return {
            "count": self.count, "sum": self.sum,
            "min": self.min, "max": self.max,
            "buckets": [
                [b, c] for b, c in zip(
                    list(self.bounds) + ["inf"], self.counts
                )
            ],
            "p50": self.percentile(50), "p90": self.percentile(90),
            "p99": self.percentile(99),
            "unit": self.unit,
        }


class MetricsRegistry:
    """Get-or-create instrument registry.

    Instrument names are ``component.metric`` (the catalog is
    :meth:`Telemetry._install_instruments`).  Creation is idempotent per
    (name, kind); re-registering a name as a different kind raises -
    typos fail fast instead of splitting a metric across instruments."""

    def __init__(self):
        self._instruments: Dict[str, object] = {}

    def _get(self, cls, name: str, **kw):
        inst = self._instruments.get(name)
        if inst is None:
            inst = cls(name, **kw)
            self._instruments[name] = inst
        elif not isinstance(inst, cls):
            raise ValueError(
                f"metric {name!r} already registered as {inst.kind}"
            )
        return inst

    def counter(self, name: str, **kw) -> Counter:
        return self._get(Counter, name, **kw)

    def gauge(self, name: str, **kw) -> Gauge:
        return self._get(Gauge, name, **kw)

    def histogram(self, name: str, **kw) -> Histogram:
        return self._get(Histogram, name, **kw)

    def snapshot(self) -> dict:
        """{"counters": {...}, "gauges": {...}, "histograms": {...}} -
        plain JSON-serializable dicts (the scrape payload)."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, inst in sorted(self._instruments.items()):
            out[inst.kind + "s"][name] = inst.snapshot()
        return out


def aggregate_snapshots(snaps: Sequence[dict]) -> dict:
    """Merge registry snapshots from several engine replicas into one
    group view: counters and histogram counts/sums SUM (they are
    additive event tallies), gauges SUM over replicas where set (queue
    depth / free pages across a group are totals) except ``*_max``
    -suffixed gauges which take the max, histogram min/max combine, and
    merged percentiles are recomputed from the merged buckets."""
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    for snap in snaps:
        for name, c in snap.get("counters", {}).items():
            cur = out["counters"].setdefault(
                name, {"value": 0, "unit": c.get("unit", "")}
            )
            cur["value"] += c["value"]
        for name, g in snap.get("gauges", {}).items():
            cur = out["gauges"].setdefault(
                name, {"value": None, "unit": g.get("unit", "")}
            )
            if g["value"] is None:
                continue
            if cur["value"] is None:
                cur["value"] = g["value"]
            elif name.endswith("_max"):
                cur["value"] = max(cur["value"], g["value"])
            else:
                cur["value"] += g["value"]
        for name, h in snap.get("histograms", {}).items():
            cur = out["histograms"].get(name)
            if cur is None:
                out["histograms"][name] = {
                    k: (list(v) if isinstance(v, list) else v)
                    for k, v in h.items()
                }
                out["histograms"][name]["buckets"] = [
                    list(b) for b in h["buckets"]
                ]
                continue
            if [b for b, _ in cur["buckets"]] != [b for b, _ in h["buckets"]]:
                raise ValueError(f"histogram {name}: bucket bounds differ")
            cur["count"] += h["count"]
            cur["sum"] += h["sum"]
            for side, pick in (("min", min), ("max", max)):
                if h[side] is not None:
                    cur[side] = (
                        h[side] if cur[side] is None
                        else pick(cur[side], h[side])
                    )
            for i, (_, c) in enumerate(h["buckets"]):
                cur["buckets"][i][1] += c
    for h in out["histograms"].values():
        _recompute_percentiles(h)
    return out


def _recompute_percentiles(h: dict) -> None:
    """Percentiles of a merged histogram snapshot (same interpolation as
    :meth:`Histogram.percentile`, over the merged buckets)."""
    for key, p in (("p50", 50.0), ("p90", 90.0), ("p99", 99.0)):
        if h["count"] == 0:
            h[key] = None
            continue
        rank = p / 100.0 * h["count"]
        seen = 0
        est = h["max"]
        for i, (edge, c) in enumerate(h["buckets"]):
            if c == 0:
                continue
            if seen + c >= rank:
                lo = 0.0 if i == 0 else h["buckets"][i - 1][0]
                if edge == "inf":
                    est = min(h["max"], max(lo, h["min"]))
                else:
                    est = lo + (rank - seen) / c * (edge - lo)
                    est = min(max(est, h["min"]), h["max"])
                break
            seen += c
        h[key] = est


# ------------------------------------------------------ numerics probe --

class NumericsProbe:
    """Sampled online monitor of the paper's overflow causes.

    Every ``every``-th engine step - at a retirement drain boundary,
    never inside a device call - :meth:`sample` reads up to
    ``max_pages`` live K pages of layer ``layer`` (valid rows only; a
    recycled page's stale tail is garbage by design) and reduces them to
    gauges:

      * ``numerics.kv_max_abs``          - max |K| over sampled valid rows;
      * ``numerics.score_amp_max``       - max |K K^T| over per-head page
        grams: the Q-free worst-case score-amplitude proxy.  Under the
        paper's resonance mechanism Q shares the K waveform (exactly or
        180 degrees shifted), so |Q K^T| ~= |K K^T|, and K pages are
        what is resident in a serving process;
      * ``numerics.fp16_margin``         - ``FP16_MAX - score_amp_max``:
        negative means live traffic would already overflow a raw fp16
        score store (the paper's central failure);
      * ``numerics.shift_mag_max``       - max |per-page PASA shift| (the
        valid-row mean each kernel subtracts); on quantized pools read
        straight from the page's ``k_shift`` sidecar;
      * ``numerics.resonance_max``       - max per-page K self-resonance
        (mean |cos(k_row, k_mean)|, ``core.numerics.resonance_index``
        with q := K): 1.0 = perfectly phase-coincident rows.

    Sampling is deterministic (the first ``max_pages`` live pages in
    page-id order), so two identical serves probe identical pages.  The
    read is one ``index_select`` of each leaf on the pool's device and
    one copy to the host - the probe's own drain (``@_drain_point``); it
    only reads the pool, which is the bit-neutrality argument.  The
    arithmetic is numpy float32, as the reference's is.
    """

    def __init__(self, every: int = 64, max_pages: int = 8,
                 layer: int = 0):
        if every < 1:
            raise ValueError(f"probe interval must be >= 1, got {every}")
        if max_pages < 1:
            raise ValueError(f"max_pages must be >= 1, got {max_pages}")
        self.every = int(every)
        self.max_pages = int(max_pages)
        self.layer = int(layer)
        self.samples = 0
        self.last: Optional[dict] = None

    def due(self, step: int) -> bool:
        return step % self.every == 0

    @_drain_point
    def sample(self, pool: dict, pages_valid: Sequence[Tuple[int, int]],
               *, n_kv_heads: int) -> Optional[dict]:
        """Probe ``pages_valid`` = [(physical page id, valid rows), ...]
        against ``pool`` (raw or quantized leaves of (layers, pages, ...)
        tensors); returns the gauge dict, or None when nothing is live.
        The only device readback of this module (see class doc)."""
        pages = [(p, v) for p, v in pages_valid if v > 0][: self.max_pages]
        if not pages:
            return None
        dev = pool["k"].device
        idx = torch.tensor([p for p, _ in pages], dtype=torch.long)
        if dev.type == "cuda":
            idx = idx.pin_memory()
        idx = idx.to(dev, non_blocking=True)

        def read(name):
            leaf = pool[name][self.layer].index_select(0, idx)
            return leaf.cpu().float().numpy()

        k = read("k")                               # (n, page, kv_dim)
        n, page, kv_dim = k.shape
        d = kv_dim // n_kv_heads
        sidecar_shift = None
        if "k_scale" in pool:                        # quantized pool
            scale = read("k_scale")                 # (n, KVH)
            sidecar_shift = read("k_shift")         # (n, kv_dim)
            codes = k.reshape(n, page, n_kv_heads, d)
            k = (
                codes * scale[:, None, :, None]
                + sidecar_shift.reshape(n, 1, n_kv_heads, d)
            ).reshape(n, page, kv_dim)

        # one vectorized pass over all sampled pages (this runs every
        # sample on the serving hot path - no per-page python loop).
        # Rows past a page's valid length are recycled-page debris (can
        # be Inf/NaN): np.where them to exact zeros BEFORE any
        # arithmetic, so they contribute nothing to any statistic.
        valid = np.asarray([v for _, v in pages], np.float32)   # (n,)
        mask = (
            np.arange(page, dtype=np.float32)[None, :] < valid[:, None]
        )                                           # (n, page)
        per_head = np.where(
            mask[:, None, :, None],
            k.reshape(n, page, n_kv_heads, d).transpose(0, 2, 1, 3),
            np.float32(0.0),
        )                                           # (n, KVH, page, D)
        kv_max = float(np.abs(per_head).max())
        # per-head page grams: the Q-free score-amplitude proxy (zeroed
        # rows only produce zero gram entries - they cannot set the max)
        gram = np.einsum("nhsd,nhtd->nhst", per_head, per_head)
        amp_max = float(np.abs(gram).max())
        if sidecar_shift is not None:
            shift = sidecar_shift.reshape(n, n_kv_heads, d)
        else:                       # valid-row mean == sum / valid count
            shift = per_head.sum(axis=2) / valid[:, None, None]
        shift_max = float(np.abs(shift).max())
        # K self-resonance: per page-head, mean |cos| between valid rows
        # and the valid-row mean (zeroed rows have zero norm -> zero cos)
        kbar = per_head.sum(axis=2) / valid[:, None, None]  # (n, KVH, D)
        kn = kbar / (np.linalg.norm(kbar, axis=-1, keepdims=True) + 1e-30)
        rows_n = per_head / (
            np.linalg.norm(per_head, axis=-1, keepdims=True) + 1e-30
        )
        cos = np.abs(np.einsum("nhsd,nhd->nhs", rows_n, kn))
        res_max = float((cos.sum(axis=-1) / valid[:, None]).max())
        self.samples += 1
        self.last = {
            "kv_max_abs": kv_max,
            "score_amp_max": amp_max,
            "fp16_margin": FP16_MAX - amp_max,
            "shift_mag_max": shift_max,
            "resonance_max": res_max,
            "pages_sampled": len(pages),
        }
        return self.last


# ------------------------------------------------------------- facade --

class Telemetry:
    """The engine-facing facade bundling the three layers.

    Construct once and pass as ``ServeEngine(telemetry=...)``; any layer
    can be off (``tracing=False`` / ``metrics=False`` /
    ``numerics_every=0``), so each layer's cost is opt-in.  For replicas
    (:class:`~repro_torch.runtime.engine.EngineReplicaGroup`),
    :meth:`for_replica` derives per-engine children that SHARE the
    parent's tracer (events carry the replica index, exported as separate
    Chrome processes) while keeping their own metrics registries; the
    parent's :meth:`metrics_snapshot` aggregates them
    (:func:`aggregate_snapshots`).  The per-tenant series
    (``serve.tenant.<t>.*``) take the request's tenant from the engine
    and appear only for tenants other than ``"default"``.

    Every ``on_*`` hook and :meth:`end_step` is host-only (wall clocks +
    integers the engine already tracks).  The numerics probe is invoked
    from :meth:`end_step` at the engine's retirement boundary and owns
    the single sanctioned readback (class docs above).
    """

    def __init__(self, *, tracing: bool = True, metrics: bool = True,
                 numerics_every: int = 0, trace_capacity: int = 65536,
                 numerics_pages: int = 8, numerics_layer: int = 0,
                 _tracer: Optional[StepTracer] = None,
                 _engine_id: int = 0):
        self.tracer = _tracer if _tracer is not None else (
            StepTracer(trace_capacity) if tracing else None
        )
        self.metrics = MetricsRegistry() if metrics else None
        self.probe = (
            NumericsProbe(
                numerics_every, max_pages=numerics_pages,
                layer=numerics_layer,
            )
            if numerics_every > 0 else None
        )
        self.engine_id = int(_engine_id)
        self._children: List["Telemetry"] = []
        self._submit_t: Dict[int, float] = {}
        self._clock_epoch = time.perf_counter()
        if self.metrics is not None:
            self._install_instruments()

    def _install_instruments(self) -> None:
        m = self.metrics
        c, g, h = m.counter, m.gauge, m.histogram
        c("serve.requests_submitted", help="submit() calls accepted")
        c("serve.requests_finished", help="requests run to completion")
        c("serve.requests_cancelled", help="cancel() on a live request")
        c("serve.preemptions", help="preempt-to-page-out events")
        c("serve.resumes", help="re-admissions of preempted requests")
        c("serve.tokens_emitted", unit="tokens",
          help="generated tokens materialized at retirement")
        c("serve.admission_blocked_pages",
          help="admission attempts failed on pages (policy decisions)")
        c("pages.allocated", unit="pages", help="PageAllocator grants")
        c("pages.freed", unit="pages", help="PageAllocator returns")
        c("prefix.hits", unit="pages", help="prefix-cache pages served")
        c("prefix.misses", unit="pages", help="pages a match lacked")
        c("prefix.evictions", unit="pages", help="cache pages evicted")
        c("prefix.donations", unit="pages", help="pages adopted on donate")
        c("numerics.samples", help="numerics-probe invocations")
        c("numerics.fp16_overflow_risk",
          help="probe samples whose score-amplitude proxy exceeded "
               "FP16_MAX (fp16_margin < 0)")
        g("serve.waiting", unit="requests", help="queue depth")
        g("serve.running", unit="requests", help="occupied batch slots")
        g("serve.inflight", unit="steps",
          help="dispatched steps not yet retired (pipeline depth in use)")
        g("serve.step_tokens", unit="tokens",
          help="token spend of the last step (decode rows + prefill)")
        g("serve.budget_utilization",
          help="last step tokens / step_token_budget (unset: no budget)")
        g("pages.free", unit="pages", help="allocator free list size")
        g("pages.live", unit="pages", help="allocated pages")
        g("pages.occupancy", help="live / allocatable fraction")
        g("prefix.cached_pages", unit="pages", help="resident trie pages")
        g("numerics.kv_max_abs")
        g("numerics.score_amp_max",
          help="max |K K^T| page gram (Q-free score-amplitude proxy)")
        g("numerics.fp16_margin",
          help="FP16_MAX - score_amp_max; negative = overflow regime")
        g("numerics.shift_mag_max", help="max |per-page PASA shift|")
        g("numerics.resonance_max",
          help="max per-page K self-resonance (mean |cos|, 0..1)")
        h("serve.ttft_seconds", unit="s",
          help="submit -> first token MATERIALIZED (wall clock)")
        h("serve.ttft_steps", unit="steps",
          bounds=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128),
          help="submit -> first-token dispatch, in engine steps "
               "(inclusive, the benchmarks' convention)")
        h("serve.step_seconds", unit="s",
          help="wall-clock duration of step() calls")

    # --------------------------------------------------------- replicas --

    def for_replica(self, engine_id: int) -> "Telemetry":
        """A per-replica child: shared tracer, OWN metrics registry and
        probe cadence; registered so the parent's
        :meth:`metrics_snapshot` aggregates it."""
        child = Telemetry(
            tracing=False, metrics=self.metrics is not None,
            numerics_every=self.probe.every if self.probe else 0,
            numerics_pages=self.probe.max_pages if self.probe else 8,
            numerics_layer=self.probe.layer if self.probe else 0,
            _tracer=self.tracer, _engine_id=engine_id,
        )
        self._children.append(child)
        return child

    def metrics_snapshot(self) -> Optional[dict]:
        """This telemetry's registry snapshot; with replica children,
        the cross-replica aggregation (counters/histograms summed,
        gauges summed except ``*_max``)."""
        if self.metrics is None:
            return None
        if self._children:
            return aggregate_snapshots(
                [c.metrics.snapshot() for c in self._children
                 if c.metrics is not None] + [self.metrics.snapshot()]
            )
        return self.metrics.snapshot()

    # ------------------------------------------------------- engine API --

    def clock(self) -> float:
        return (
            self.tracer.clock() if self.tracer is not None
            else time.perf_counter() - self._clock_epoch
        )

    def _instant(self, name: str, step: int, **args) -> None:
        if self.tracer is not None:
            self.tracer.instant(
                name, step, engine=self.engine_id, args=args
            )

    def _inc(self, name: str, n: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.counter(name).inc(n)

    # Per-tenant attribution.  Series are created LAZILY and only for
    # explicitly-named tenants (tenant != "default"): single-tenant serves
    # keep the exact metric catalog of the reference's tests,
    # and a fleet pays only for the tenants it actually sees.  The
    # aggregate serve.* counters always include every tenant's traffic -
    # the per-tenant series are a breakdown, not a replacement.

    def _inc_tenant(self, tenant: Optional[str], leaf: str,
                    n: int = 1) -> None:
        if (self.metrics is not None and tenant is not None
                and tenant != "default"):
            self.metrics.counter(
                f"serve.tenant.{tenant}.{leaf}",
                help=f"per-tenant breakdown of serve.* ({leaf})",
            ).inc(n)

    def on_submit(self, req_id: int, step: int, *,
                  tenant: Optional[str] = None,
                  priority: Optional[str] = None) -> None:
        self._submit_t[req_id] = self.clock()
        args = {"req_id": req_id}
        if tenant is not None and tenant != "default":
            args["tenant"] = tenant
        if priority is not None:
            args["priority"] = priority
        self._instant("submit", step, **args)
        self._inc("serve.requests_submitted")
        self._inc_tenant(tenant, "submitted")

    def on_admit(self, req_id: int, step: int, *, resumed: bool) -> None:
        self._instant(
            "resume" if resumed else "admit", step, req_id=req_id
        )
        if resumed:
            self._inc("serve.resumes")

    def on_first_token(self, req_id: int, submit_step: int,
                       dispatch_step: int, *,
                       tenant: Optional[str] = None) -> None:
        """Fired at RETIREMENT (the value exists), stamped with the step
        that dispatched the token - so TTFT-in-steps is pipeline-mode
        -invariant while TTFT-in-seconds honestly includes the async
        emission lag."""
        self._instant("first_token", dispatch_step, req_id=req_id)
        if self.metrics is not None:
            ttft = dispatch_step - submit_step + 1
            self.metrics.histogram("serve.ttft_steps").observe(ttft)
            if tenant is not None and tenant != "default":
                self.metrics.histogram(
                    f"serve.tenant.{tenant}.ttft_steps", unit="steps",
                    help="per-tenant TTFT breakdown (dispatch clock)",
                ).observe(ttft)
            t0 = self._submit_t.get(req_id)
            if t0 is not None:
                self.metrics.histogram("serve.ttft_seconds").observe(
                    self.clock() - t0
                )

    def on_finish(self, req_id: int, step: int, *,
                  tenant: Optional[str] = None) -> None:
        self._submit_t.pop(req_id, None)
        self._instant("finish", step, req_id=req_id)
        self._inc("serve.requests_finished")
        self._inc_tenant(tenant, "finished")

    # Speculative decoding.  Like the per-tenant series, the serve.spec.*
    # instruments are registered LAZILY on first use: a speculation-off
    # serve never touches them, so the pinned default catalog
    # (:meth:`_install_instruments`) stays
    # intact.  Both hooks read host tallies the engine already computed -
    # nothing here feeds back into a device call, so speculation
    # telemetry is bit-neutral like everything else in this module.

    def on_spec_dispatch(self, n_rows: int, n_drafts: int) -> None:
        """One step dispatched ``n_rows`` K-draft verifies carrying
        ``n_drafts`` draft tokens total (dispatch-side tallies; the
        accepted counts arrive at retirement)."""
        if self.metrics is None:
            return
        self.metrics.counter(
            "serve.spec.proposed", unit="tokens",
            help="draft tokens dispatched into speculative verifies",
        ).inc(n_drafts)
        self.metrics.counter(
            "serve.spec.verify_steps",
            help="per-row K-draft verify dispatches",
        ).inc(n_rows)

    def on_spec_retire(self, proposed: int, accepted: int,
                       rollback_pages: int) -> None:
        """One verify retired: ``accepted`` of ``proposed`` drafts kept
        (they matched the model's own choice); ``rollback_pages`` pages
        had rejected-draft bytes restored on device."""
        if self.metrics is None:
            return
        self.metrics.counter(
            "serve.spec.accepted", unit="tokens",
            help="draft tokens accepted (matched the model's own choice)",
        ).inc(accepted)
        self.metrics.counter(
            "serve.spec.rollback_pages", unit="pages",
            help="pages whose rejected-draft bytes were restored",
        ).inc(rollback_pages)
        self.metrics.histogram(
            "serve.spec.accepted_per_verify", unit="tokens",
            bounds=(0, 1, 2, 3, 4, 6, 8, 12, 16),
            help="accepted draft tokens per retired verify",
        ).observe(accepted)

    def on_preempt(self, req_id: int, step: int, *,
                   tenant: Optional[str] = None) -> None:
        self._instant("preempt", step, req_id=req_id)
        self._inc("serve.preemptions")
        self._inc_tenant(tenant, "preempted")

    def on_cancel(self, req_id: int, step: int) -> None:
        self._submit_t.pop(req_id, None)
        self._instant("cancel", step, req_id=req_id)
        self._inc("serve.requests_cancelled")

    def on_admission_blocked(self, step: int) -> None:
        self._inc("serve.admission_blocked_pages")

    def on_tokens_emitted(
        self, n: int,
        by_tenant: Optional[Dict[str, int]] = None,
    ) -> None:
        self._inc("serve.tokens_emitted", n)
        if by_tenant:
            for tenant, cnt in by_tenant.items():
                self._inc_tenant(tenant, "tokens_emitted", cnt)

    def end_step(self, eng, t0: float, t_plan: float,
                 t_dispatch: float, n_live: int) -> None:
        """Close out one engine step: emit the plan/dispatch/retire
        spans and per-step gauges, then run the numerics probe when due.
        Called by ``ServeEngine.step()`` with the wall stamps it took at
        its phase boundaries; everything here is host-only except the
        probe's sanctioned drain."""
        t_end = self.clock()
        step = eng.steps
        if self.tracer is not None:
            tr, eid = self.tracer, self.engine_id
            tr.span("plan", step, t0, t_plan, engine=eid,
                    args={"live": n_live})
            if t_dispatch > t_plan:
                tr.span("dispatch", step, t_plan, t_dispatch, engine=eid,
                        args={"tokens": eng.last_step_tokens})
            tr.span("retire", step, t_dispatch, t_end, engine=eid,
                    args={"inflight": len(eng._inflight)})
            tr.counter("engine", step, {
                "waiting": len(eng.waiting),
                "running": eng.num_running,
                "free_pages": eng.allocator.free_pages,
                "inflight": len(eng._inflight),
            }, engine=eid)
        if self.metrics is not None:
            m = self.metrics
            allocatable = eng.num_pages - 1
            m.gauge("serve.waiting").set(len(eng.waiting))
            m.gauge("serve.running").set(eng.num_running)
            m.gauge("serve.inflight").set(len(eng._inflight))
            m.gauge("serve.step_tokens").set(eng.last_step_tokens)
            if eng.step_token_budget:
                m.gauge("serve.budget_utilization").set(
                    eng.last_step_tokens / eng.step_token_budget
                )
            m.gauge("pages.free").set(eng.allocator.free_pages)
            m.gauge("pages.live").set(eng.allocator.live_pages)
            m.gauge("pages.occupancy").set(
                eng.allocator.live_pages / max(allocatable, 1)
            )
            if eng.prefix_cache is not None:
                m.gauge("prefix.cached_pages").set(
                    eng.prefix_cache.cached_pages
                )
            m.histogram("serve.step_seconds").observe(t_end - t0)
        if self.probe is not None and self.probe.due(step):
            self.sample_numerics(eng)

    def sample_numerics(self, eng) -> Optional[dict]:
        """Run the probe against the engine's LIVE pages (running
        requests' written positions, shared prefix pages included).
        The (page, valid-rows) list is assembled from host cursors -
        the readback itself happens inside :meth:`NumericsProbe.sample`
        at this retirement boundary."""
        if self.probe is None:
            return None
        pages_valid: List[Tuple[int, int]] = []
        page = eng.page_size
        for r in eng._slots:
            if r is None:
                continue
            valid = (
                r.cursor if r.prefill_pos >= len(r.prompt)
                else r.prefill_pos
            )
            row = eng.page_table[r.slot]
            for i in range((valid + page - 1) // page):
                pid = int(row[i])
                if pid != 0:
                    pages_valid.append(
                        (pid, min(page, valid - i * page))
                    )
        pages_valid.sort()
        reading = self.probe.sample(
            eng.pool, pages_valid, n_kv_heads=eng.pool_kv_heads
        )
        if reading is None:
            return None
        if self.metrics is not None:
            m = self.metrics
            for key in ("kv_max_abs", "score_amp_max", "fp16_margin",
                        "shift_mag_max", "resonance_max"):
                m.gauge(f"numerics.{key}").set(reading[key])
            m.counter("numerics.samples").inc()
            if reading["fp16_margin"] < 0:
                m.counter("numerics.fp16_overflow_risk").inc()
        self._instant("numerics_probe", eng.steps, **reading)
        return reading
