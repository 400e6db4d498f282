"""Scheduling policies of the paged serving engine (counterpart of
``repro.runtime.scheduler``).

The engine owns the mechanism - slots, pages, the two device calls,
preemption - and asks a :class:`SchedulerPolicy` for every decision: the
order in which waiting requests are tried for admission (and whether a
request that does not fit blocks those behind it), which still-prefilling
requests' chunks ride this step's batched prefill call with how many
tokens each under the per-step token budget, how many draft tokens each
decode row may verify under what the budget leaves, and which running
request is paged out when an admission has been page-starved past the
engine's patience.  Policies are pure host functions over immutable
:class:`RequestView` snapshots.  Scheduling changes latency, never output
bits: the chunk-exact prefill makes every request's output invariant to
its chunk schedule, and a decode step reads only its own page-table row.

  * :class:`FCFSPolicy` (``"fcfs"``, default): arrival order with
    head-of-line blocking; chunks go to the oldest-admitted requests.
  * :class:`SJFPolicy` (``"sjf"``): short prompts first, no head-of-line
    blocking, an aging guard that promotes a request waiting ``patience``
    steps to strict FIFO; the preemption victim is the straggler.
  * :class:`MixedPolicy` (``"mixed"``): FCFS admission; the step's
    prefill budget is dealt round-robin in page-size quanta across every
    prefilling request.
  * :class:`TenantQuotaPolicy` (``"tenant"``): per-tenant page and token
    quotas and two priority classes (``"latency"`` admitted and prefilled
    first; ``"throughput"`` kept from starving by the aging guard), with
    a class-aware preemption victim.  Quotas shape when a tenant's tokens
    arrive, never which tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

#: Priority classes a request may declare at submit time: ``"latency"``
#: goes ahead of ``"throughput"`` (the default, and the preferred
#: preemption victim class).
PRIORITY_CLASSES = ("latency", "throughput")
DEFAULT_TENANT = "default"


@dataclasses.dataclass(frozen=True)
class RequestView:
    """Immutable scheduling snapshot of one request.

    ``remaining_prefill``: prompt tokens whose K/V is not written yet (0
    in the decode phase); ``remaining_decode``: tokens still to generate;
    ``slot``/``admit_step`` are -1 while waiting.  Under async pipelining
    the counts advance at dispatch, so a policy sees the same counts at
    every pipeline depth; ``pending_tokens`` counts the generated tokens
    whose values are still on the device (0 in synchronous mode)."""

    req_id: int
    prompt_len: int
    remaining_prefill: int
    remaining_decode: int
    submit_step: int
    admit_step: int = -1
    slot: int = -1
    pages_needed: int = 0
    preempt_count: int = 0
    #: engine step of the most recent page-out (-1 = never preempted).
    preempt_step: int = -1
    pending_tokens: int = 0
    #: tenant attribution (quota accounting and priority ordering).
    tenant: str = DEFAULT_TENANT
    priority: str = "throughput"

    @property
    def wait_anchor(self) -> int:
        """The step this request's current wait began: submission, or the
        most recent page-out if later (a paged-out request re-queues at
        the back and forfeits its seniority)."""
        return max(self.submit_step, self.preempt_step)


# (req_id, token allowance this step).  Allowances are page multiples
# unless they cover the request's prompt tail, so chunk starts stay
# page-aligned.
PrefillGrant = Tuple[int, int]


def _aligned(allow: int, remaining: int, page_size: int) -> int:
    """Clip an allowance to the page-alignment rule."""
    if allow >= remaining:
        return remaining          # the tail may be ragged; it ends the prompt
    return allow - allow % page_size


class SchedulerPolicy:
    """Decision interface; subclasses override the ordering hooks."""

    name = "base"
    #: True: the first waiting request that fails admission blocks every
    #: request behind it this step.
    hol_blocking = True

    def admission_order(self, waiting: Sequence[RequestView],
                        now: int = 0) -> List[RequestView]:
        """Waiting requests in try order.  The default keeps queue order,
        not submit order, so a preempted request re-queued at the back
        stays at the back."""
        del now
        return list(waiting)

    def plan_admission(self, waiting: Sequence[RequestView],
                       running: Sequence[RequestView],
                       now: int = 0) -> List[RequestView]:
        """Admission candidates for this step, in try order (default:
        :meth:`admission_order`, the running set ignored)."""
        del running
        return self.admission_order(waiting, now=now)

    def prefill_order(self, prefilling: Sequence[RequestView]
                      ) -> List[RequestView]:
        """Still-prefilling requests in chunk-grant priority order."""
        return sorted(prefilling, key=lambda v: (v.admit_step, v.req_id))

    def choose_victim(self, running: Sequence[RequestView],
                      now: int = 0) -> Optional[RequestView]:
        """Preemption victim among RUNNING requests admitted before
        ``now`` (None = do not preempt).  Default: the youngest-admitted.
        Requests never paged out are preferred, so a just-resumed request
        is not the first pick again (victim-side anti-thrash); it stays
        eligible when it is the only candidate."""
        cands = [v for v in running if v.admit_step < now]
        if not cands:
            return None
        fresh = [v for v in cands if v.preempt_count == 0]
        return max(fresh or cands, key=lambda v: (v.admit_step, v.req_id))

    def plan_prefill(self, prefilling: Sequence[RequestView], *,
                     n_decode: int, budget: Optional[int], chunk: int,
                     page_size: int, max_rows: int) -> List[PrefillGrant]:
        """Greedy grants: walk :meth:`prefill_order`, give each request
        ``min(chunk, remaining)`` tokens until the budget (minus one token
        per decode row) or the row cap runs out; ``budget`` None =
        unlimited."""
        left = None if budget is None else max(budget - n_decode, 0)
        plan: List[PrefillGrant] = []
        for v in self.prefill_order(prefilling):
            if len(plan) >= max_rows or (left is not None and left <= 0):
                break
            allow = min(chunk, v.remaining_prefill)
            if left is not None and allow > left:
                allow = _aligned(left, v.remaining_prefill, page_size)
            if allow <= 0:
                continue
            plan.append((v.req_id, allow))
            if left is not None:
                left -= allow
        return plan

    def plan_speculation(self, decoding: Sequence[RequestView], *, k: int,
                         budget_left: Optional[int] = None
                         ) -> List[Tuple[int, int]]:
        """Draft-token grants for this step's speculative verify.

        ``decoding`` holds the decode rows the engine found eligible and
        draftable (the proposer had a guess); each gets at most ``k``
        drafts under the leftover step budget (``budget_left``: the budget
        minus decode and prefill spend; None = unlimited), so drafts never
        displace a decode row or a prefill chunk.  A row omitted or granted
        0 decodes one token.  Grants move latency only: rejected drafts are
        restored byte for byte and accepted ones matched the model's own
        choice.  Default: ``min(k, remaining_decode - 1)`` greedily in the
        given order until the budget runs out."""
        left = budget_left
        plan: List[Tuple[int, int]] = []
        for v in decoding:
            if left is not None and left <= 0:
                break
            allow = min(k, max(v.remaining_decode - 1, 0))
            if left is not None:
                allow = min(allow, left)
            if allow <= 0:
                continue
            plan.append((v.req_id, allow))
            if left is not None:
                left -= allow
        return plan


class FCFSPolicy(SchedulerPolicy):
    """First-come-first-served with head-of-line blocking."""

    name = "fcfs"
    hol_blocking = True


class SJFPolicy(SchedulerPolicy):
    """Shortest-job-first with an anti-starvation aging guard.

    Admission prefers short prompts and skips candidates that do not fit;
    a request whose wait (from :attr:`RequestView.wait_anchor`) reaches
    ``patience`` steps goes ahead of every other in FIFO order, so a long
    prompt is delayed, never starved.  Chunks go to the requests closest
    to finishing their prompt."""

    name = "sjf"
    hol_blocking = False

    def __init__(self, patience: int = 64):
        if patience < 1:
            raise ValueError(f"patience must be >= 1, got {patience}")
        self.patience = int(patience)

    def admission_order(self, waiting, now: int = 0):
        starved = [v for v in waiting if now - v.wait_anchor >= self.patience]
        fresh = [v for v in waiting if now - v.wait_anchor < self.patience]
        starved.sort(key=lambda v: (v.wait_anchor, v.req_id))
        fresh.sort(key=lambda v: (v.prompt_len, v.req_id))
        return starved + fresh

    def prefill_order(self, prefilling):
        return sorted(
            prefilling, key=lambda v: (v.remaining_prefill, v.req_id)
        )

    def choose_victim(self, running, now: int = 0):
        """The straggler: most work remaining, never-preempted requests
        first (the base policy's anti-thrash rule)."""
        cands = [v for v in running if v.admit_step < now]
        if not cands:
            return None
        fresh = [v for v in cands if v.preempt_count == 0]
        return max(
            fresh or cands,
            key=lambda v: (v.remaining_prefill + v.remaining_decode, v.req_id),
        )


class MixedPolicy(SchedulerPolicy):
    """Sarathi-style token-budget mixing: FCFS admission; the step's
    prefill budget (the global budget minus one token per decode row) is
    dealt round-robin in ``page_size`` quanta across the prefilling
    requests, so concurrent long prompts advance together in one batched
    prefill call."""

    name = "mixed"
    hol_blocking = True

    def plan_prefill(self, prefilling, *, n_decode, budget, chunk,
                     page_size, max_rows):
        order = self.prefill_order(prefilling)[:max_rows]
        if not order:
            return []
        left = None if budget is None else max(budget - n_decode, 0)
        alloc = {v.req_id: 0 for v in order}
        remaining = {v.req_id: v.remaining_prefill for v in order}
        progress = True
        while progress and (left is None or left > 0):
            progress = False
            for v in order:
                rid = v.req_id
                cap = min(remaining[rid], chunk - alloc[rid])
                if cap <= 0:
                    continue
                quantum = min(page_size, cap)
                # a sub-page grant is legal only as the prompt tail
                if quantum < page_size and quantum < remaining[rid]:
                    continue
                if left is not None and quantum > left:
                    continue
                alloc[rid] += quantum
                remaining[rid] -= quantum
                if left is not None:
                    left -= quantum
                progress = True
        return [(v.req_id, alloc[v.req_id]) for v in order
                if alloc[v.req_id] > 0]


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Resource ceilings of one tenant (None = unlimited).

    ``max_pages`` caps the KV pages the tenant's running requests hold at
    once, counted at the ``pages_needed`` the engine charges on
    admission; ``max_step_tokens`` caps the prefill (and draft) tokens
    granted to the tenant in one engine step."""

    max_pages: Optional[int] = None
    max_step_tokens: Optional[int] = None

    def __post_init__(self):
        if self.max_pages is not None and self.max_pages < 1:
            raise ValueError(f"max_pages must be >= 1, got {self.max_pages}")
        if self.max_step_tokens is not None and self.max_step_tokens < 1:
            raise ValueError(
                f"max_step_tokens must be >= 1, got {self.max_step_tokens}"
            )


class TenantQuotaPolicy(SchedulerPolicy):
    """Multi-tenant scheduling: quotas and priority classes.

    Admission (:meth:`plan_admission`): candidates whose wait reaches
    ``patience`` steps go first in FIFO order (from ``wait_anchor``),
    whatever their class; then the ``"latency"`` class, then
    ``"throughput"``, FIFO within each.  A candidate that would lift its
    tenant's running page footprint above ``max_pages`` is withheld (not
    returned); the pass charges each returned candidate in turn, so one
    step cannot overshoot a quota.  A withheld request is not
    page-starved: quota waits never trigger preemption.

    Prefill: latency class first, then fewest remaining tokens, each
    tenant's grants in a step capped at ``max_step_tokens`` (page-aligned
    as the base plan's).  Speculation: latency class first, each tenant's
    drafts capped the same way.  Preemption victim: never-preempted first
    (the base policy's anti-thrash rule), then throughput over latency,
    then the largest page footprint, then the youngest-admitted."""

    name = "tenant"
    hol_blocking = False

    def __init__(self, quotas: Optional[Mapping[str, TenantQuota]] = None,
                 patience: int = 64):
        if patience < 1:
            raise ValueError(f"patience must be >= 1, got {patience}")
        self.patience = int(patience)
        self.quotas: Dict[str, TenantQuota] = {}
        for tenant, q in (quotas or {}).items():
            if not isinstance(q, TenantQuota):
                q = TenantQuota(**dict(q))
            self.quotas[str(tenant)] = q

    def _class_rank(self, v: RequestView) -> int:
        return 0 if v.priority == "latency" else 1

    def _cap(self, tenant: str, field: str) -> Optional[int]:
        quota = self.quotas.get(tenant)
        return None if quota is None else getattr(quota, field)

    def admission_order(self, waiting, now: int = 0):
        starved = [v for v in waiting if now - v.wait_anchor >= self.patience]
        fresh = [v for v in waiting if now - v.wait_anchor < self.patience]
        starved.sort(key=lambda v: (v.wait_anchor, v.req_id))
        fresh.sort(
            key=lambda v: (self._class_rank(v), v.wait_anchor, v.req_id)
        )
        return starved + fresh

    def plan_admission(self, waiting, running, now: int = 0):
        used: Dict[str, int] = {}
        for v in running:
            used[v.tenant] = used.get(v.tenant, 0) + v.pages_needed
        plan: List[RequestView] = []
        for v in self.admission_order(waiting, now=now):
            cap = self._cap(v.tenant, "max_pages")
            if cap is not None and used.get(v.tenant, 0) + v.pages_needed > cap:
                continue
            # charged as if admitted: later candidates of the same tenant
            # in this pass see its footprint
            used[v.tenant] = used.get(v.tenant, 0) + v.pages_needed
            plan.append(v)
        return plan

    def prefill_order(self, prefilling):
        return sorted(
            prefilling,
            key=lambda v: (self._class_rank(v), v.remaining_prefill, v.req_id),
        )

    def plan_prefill(self, prefilling, *, n_decode, budget, chunk,
                     page_size, max_rows):
        left = None if budget is None else max(budget - n_decode, 0)
        spent: Dict[str, int] = {}
        plan: List[PrefillGrant] = []
        for v in self.prefill_order(prefilling):
            if len(plan) >= max_rows or (left is not None and left <= 0):
                break
            allow = min(chunk, v.remaining_prefill)
            if left is not None and allow > left:
                allow = left
            cap = self._cap(v.tenant, "max_step_tokens")
            if cap is not None:
                allow = min(allow, cap - spent.get(v.tenant, 0))
            allow = _aligned(allow, v.remaining_prefill, page_size)
            if allow <= 0:
                continue
            plan.append((v.req_id, allow))
            spent[v.tenant] = spent.get(v.tenant, 0) + allow
            if left is not None:
                left -= allow
        return plan

    def plan_speculation(self, decoding, *, k, budget_left=None):
        """Latency-class rows draft first, and each tenant's drafts in a
        step are capped at its ``max_step_tokens``, as its prefill
        grants are."""
        order = sorted(
            decoding,
            key=lambda v: (self._class_rank(v), v.wait_anchor, v.req_id),
        )
        left = budget_left
        spent: Dict[str, int] = {}
        plan: List[Tuple[int, int]] = []
        for v in order:
            if left is not None and left <= 0:
                break
            allow = min(k, max(v.remaining_decode - 1, 0))
            if left is not None:
                allow = min(allow, left)
            cap = self._cap(v.tenant, "max_step_tokens")
            if cap is not None:
                allow = min(allow, max(cap - spent.get(v.tenant, 0), 0))
            if allow <= 0:
                continue
            plan.append((v.req_id, allow))
            spent[v.tenant] = spent.get(v.tenant, 0) + allow
            if left is not None:
                left -= allow
        return plan

    def choose_victim(self, running, now: int = 0):
        cands = [v for v in running if v.admit_step < now]
        if not cands:
            return None
        fresh = [v for v in cands if v.preempt_count == 0]
        return max(
            fresh or cands,
            key=lambda v: (self._class_rank(v), v.pages_needed,
                           v.admit_step, v.req_id),
        )


POLICIES = {"fcfs": FCFSPolicy, "sjf": SJFPolicy, "mixed": MixedPolicy,
            "tenant": TenantQuotaPolicy}


def get_scheduler(policy) -> SchedulerPolicy:
    """Accept a policy name, class, or instance; return an instance."""
    if isinstance(policy, SchedulerPolicy):
        return policy
    if isinstance(policy, type) and issubclass(policy, SchedulerPolicy):
        return policy()
    if isinstance(policy, str):
        try:
            return POLICIES[policy]()
        except KeyError as e:
            raise ValueError(
                f"unknown scheduler {policy!r}; have {sorted(POLICIES)}"
            ) from e
    raise TypeError(f"scheduler must be a name or SchedulerPolicy: {policy!r}")
