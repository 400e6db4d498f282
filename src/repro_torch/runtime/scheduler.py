"""Scheduling policies of the paged serving engine (counterpart of
``repro.runtime.scheduler``; the FCFS policy of this slice).

The engine owns the mechanism - slots, pages, the two device calls - and
asks a :class:`SchedulerPolicy` for every decision: the order in which
waiting requests are tried for admission (and whether a request that does
not fit blocks those behind it), and which still-prefilling requests'
chunks ride this step's batched prefill call with how many tokens each.
Policies are pure host functions over immutable :class:`RequestView`
snapshots.  Scheduling changes latency, never output bits: the chunk-exact
prefill makes every request's output invariant to its chunk schedule.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class RequestView:
    """Immutable scheduling snapshot of one request.

    ``remaining_prefill``: prompt tokens whose K/V is not written yet (0
    in the decode phase); ``remaining_decode``: tokens still to generate;
    ``slot``/``admit_step`` are -1 while waiting."""

    req_id: int
    prompt_len: int
    remaining_prefill: int
    remaining_decode: int
    submit_step: int
    admit_step: int = -1
    slot: int = -1
    pages_needed: int = 0


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

    def plan_admission(self, waiting: Sequence[RequestView],
                       running: Sequence[RequestView],
                       now: int = 0) -> List[RequestView]:
        """Admission candidates for this step, in try order (default: queue
        order)."""
        del running, now
        return list(waiting)

    def prefill_order(self, prefilling: Sequence[RequestView]
                      ) -> List[RequestView]:
        """Still-prefilling requests in chunk-grant priority order."""
        return sorted(prefilling, key=lambda v: (v.admit_step, v.req_id))

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


class FCFSPolicy(SchedulerPolicy):
    """First-come-first-served with head-of-line blocking."""

    name = "fcfs"
    hol_blocking = True


POLICIES = {"fcfs": FCFSPolicy}


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
