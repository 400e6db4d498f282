"""Continuous-batching serving engine over the paged KV cache.

Counterpart of ``repro.runtime.engine.ServeEngine`` in its synchronous
mode (``pipeline_depth=0``) with greedy decoding.  The engine owns the
host-side mechanism - request queue, batch slots, page accounting,
per-request cursors - around at most two device calls per step: one
BATCHED chunked-prefill call (``bundle.paged_prefill_step``) and one
batched decode call (``bundle.paged_serve_step``), both at static shapes
``(prefill_batch, prefill_chunk)`` and ``(max_batch,)``.  Scheduling
decisions come from a :class:`~repro_torch.runtime.scheduler
.SchedulerPolicy` (FCFS with head-of-line blocking).

  * **Admission** at the top of every :meth:`step`, in policy order: a
    free slot plus the request's worst-case page count, granted
    all-or-nothing (conservative).
  * **Chunked prefill**: each step runs prompt chunks of up to
    ``prefill_batch`` still-prefilling requests through one call; each row
    carries its own start, valid length and page-table row; ragged tails
    and missing rows are padded and write to the null page.  A row whose
    chunk ends its prompt yields the request's first token, fed to the
    same step's decode on the device.
  * **Decode**: every request past its prompt decodes one token; slots
    not decoding this step get a null page-table row, so their writes land
    in the null page.
  * **Finish** is decided by count (no EOS): the request's pages are
    freed (recycled without scrubbing) and its slot is reusable next step.

The device keeps the next-token feed between the two calls of a step; the
host reads the step's sampled tokens back once, at the end of the step -
the synchronous mode's contract.  The prefix cache, preemption, sampling,
speculation, async pipelining, telemetry and mesh branches of the
reference are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.runtime.paged_cache import (
    NULL_PAGE,
    PageAllocator,
    paged_bytes,
    pool_dtype_name,
    resolve_pool_dtype,
)
from repro_torch.runtime.scheduler import RequestView, get_scheduler

WAITING = "waiting"
RUNNING = "running"
FINISHED = "finished"


def chunked_cold_reference(bundle, params, prompt, max_new_tokens: int, *,
                           page_size: int = 16,
                           prefill_chunk: Optional[int] = None,
                           cache_dtype=torch.bfloat16, **engine_kwargs):
    """Serve one request alone on a fresh engine; returns its tokens.

    The oracle of batched serving: a request's stream in any batch, under
    any chunk schedule, must equal this token for token."""
    total = len(prompt) + max_new_tokens
    eng = ServeEngine(
        bundle, params, max_batch=1,
        num_pages=1 + math.ceil(max(total - 1, 1) / page_size),
        page_size=page_size, max_seq_len=total,
        prefill_chunk=prefill_chunk, cache_dtype=cache_dtype,
        **engine_kwargs,
    )
    r = eng.submit(prompt, max_new_tokens)
    eng.run_to_completion()
    return r.generated


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle bookkeeping."""

    req_id: int
    prompt: List[int]
    max_new_tokens: int
    state: str = WAITING
    generated: List[Optional[int]] = dataclasses.field(default_factory=list)
    # engine-step timestamps
    submit_step: int = -1
    admit_step: int = -1
    first_token_step: int = -1
    finish_step: int = -1
    # placement while RUNNING
    slot: int = -1
    pages: List[int] = dataclasses.field(default_factory=list)
    cursor: int = 0        # next cache position written by decode
    prefill_pos: int = 0   # next prompt position whose K/V is not written

    @property
    def total_len(self) -> int:
        return len(self.prompt) + self.max_new_tokens

    def pages_needed(self, page_size: int) -> int:
        # positions 0..total_len-2 are written (the final token is
        # returned, never fed back)
        return math.ceil(max(self.total_len - 1, 1) / page_size)


# (request, index into its ``generated``, row of the step's token tensor)
_Emit = Tuple[Request, int, int]


class ServeEngine:
    """Paged-KV continuous-batching engine over a ModelBundle.

    Args (as in the reference): ``max_batch`` decode slots; ``num_pages``
    physical pages including the null page 0; ``page_size`` tokens per
    page (default: the model's PASA block length, one page = one shift
    block); ``max_seq_len`` longest prompt + generation (sets the page-table
    width; default: the pool's capacity); ``prefill_chunk`` per-row chunk
    width, a multiple of ``page_size`` (default ``8 * page_size``);
    ``cache_dtype`` pool dtype, a torch dtype or one of ``"bf16"``,
    ``"fp8_e4m3"``, ``"int8"`` (the last two store quantized pages with
    sidecars; chunk starts stay page-aligned, as their page-granular
    writes require); ``scheduler`` a policy name or instance;
    ``prefill_batch`` rows of the prefill call (default ``max_batch``).

    The engine runs on the device its parameters live on.
    """

    def __init__(self, bundle, params, *, max_batch: int = 4,
                 num_pages: int = 64, page_size: Optional[int] = None,
                 max_seq_len: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 cache_dtype=torch.bfloat16, scheduler="fcfs",
                 prefill_batch: Optional[int] = None):
        self.bundle = bundle
        self.params = params
        self.device = params["embed"].device
        if page_size is None:
            page_size = bundle.cfg.attention.block_kv
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.page_size = int(page_size)
        self.max_batch = int(max_batch)
        self.num_pages = int(num_pages)
        if max_seq_len is None:
            self.max_pages_per_seq = self.num_pages - 1
            self.max_seq_len = self.max_pages_per_seq * self.page_size
        else:
            if max_seq_len < 1:
                raise ValueError(f"max_seq_len must be >= 1, got {max_seq_len}")
            self.max_pages_per_seq = min(
                math.ceil(max_seq_len / self.page_size), self.num_pages - 1
            )
            self.max_seq_len = int(max_seq_len)
        if prefill_chunk is None:
            prefill_chunk = 8 * self.page_size
        if prefill_chunk < 1 or prefill_chunk % self.page_size:
            raise ValueError(
                f"prefill_chunk ({prefill_chunk}) must be a positive "
                f"multiple of page_size ({self.page_size}); page-aligned "
                "chunk boundaries are what make chunked prefill bit-exact"
            )
        self.prefill_chunk = int(prefill_chunk)
        self._policy = get_scheduler(scheduler)
        if prefill_batch is None:
            prefill_batch = self.max_batch
        if prefill_batch < 1:
            raise ValueError(f"prefill_batch must be >= 1, got {prefill_batch}")
        self.prefill_batch = min(int(prefill_batch), self.max_batch)

        self.cache_dtype = resolve_pool_dtype(cache_dtype)
        self.pool = bundle.init_paged_cache(
            self.num_pages, self.page_size, self.cache_dtype,
            device=self.device,
        )
        self.allocator = PageAllocator(self.num_pages)
        self.page_table = np.full(
            (self.max_batch, self.max_pages_per_seq), NULL_PAGE, np.int32
        )
        self._slots: List[Optional[Request]] = [None] * self.max_batch
        self.waiting: deque = deque()
        self.finished: Dict[int, Request] = {}
        self.steps = 0
        self.prefill_calls = 0
        self.decode_calls = 0
        self._req_counter = 0
        # decode feed: the host knows no token values between steps except
        # through the readback; the previous step's sampled tokens stay on
        # the device (``_next_dev``) and feed the next decode call.
        self._next_dev = torch.zeros(
            (self.max_batch,), dtype=torch.int32, device=self.device
        )

    # ------------------------------------------------------------- queue --

    def submit(self, prompt, max_new_tokens: int,
               req_id: Optional[int] = None) -> Request:
        """Enqueue a request; admission happens inside :meth:`step`.
        Raises ValueError for a request that could never be served."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if req_id is None:
            req_id = self._req_counter
        self._req_counter = max(self._req_counter + 1, req_id + 1)
        r = Request(req_id=req_id, prompt=prompt, max_new_tokens=max_new_tokens)
        if r.total_len > self.max_seq_len:
            raise ValueError(
                f"request needs {len(prompt)} prompt + {max_new_tokens} new "
                f"= {r.total_len} positions > max_seq_len {self.max_seq_len}"
            )
        need = r.pages_needed(self.page_size)
        if need > self.max_pages_per_seq:
            raise ValueError(
                f"request needs {need} pages > pool capacity "
                f"{self.max_pages_per_seq}"
            )
        r.submit_step = self.steps
        self.waiting.append(r)
        return r

    def _view(self, r: Request) -> RequestView:
        rem_prefill = (
            max(len(r.prompt) - r.prefill_pos, 0) if r.state == RUNNING
            else len(r.prompt)
        )
        return RequestView(
            req_id=r.req_id,
            prompt_len=len(r.prompt),
            remaining_prefill=rem_prefill,
            remaining_decode=max(r.max_new_tokens - len(r.generated), 0),
            submit_step=r.submit_step,
            admit_step=r.admit_step if r.state == RUNNING else -1,
            slot=r.slot,
            pages_needed=r.pages_needed(self.page_size),
        )

    # --------------------------------------------------------- admission --

    def _admit_one(self, r: Request) -> str:
        """Place one waiting request: "admitted", "no_slot" or "no_pages"."""
        slot = next(
            (i for i, s in enumerate(self._slots) if s is None), None
        )
        if slot is None:
            return "no_slot"
        pages = self.allocator.alloc(r.pages_needed(self.page_size))
        if pages is None:
            return "no_pages"
        self.waiting.remove(r)
        r.state = RUNNING
        r.slot = slot
        r.pages = pages
        r.admit_step = self.steps
        r.prefill_pos = 0
        r.cursor = len(r.prompt)   # decode starts after the prompt
        self._slots[slot] = r
        row = self.page_table[slot]
        row[:] = NULL_PAGE
        row[: len(pages)] = pages
        return "admitted"

    def _try_admit(self) -> None:
        """Admit everything the policy can place this step."""
        while self.waiting:
            order = self._policy.plan_admission(
                [self._view(r) for r in self.waiting],
                [self._view(r) for r in self._slots if r is not None],
                now=self.steps,
            )
            by_id = {r.req_id: r for r in self.waiting}
            admitted = False
            for v in order:
                status = self._admit_one(by_id[v.req_id])
                if status == "admitted":
                    admitted = True
                    break
                if status == "no_slot" or self._policy.hol_blocking:
                    return
            if not admitted:
                return

    def _finish(self, r: Request) -> None:
        self.allocator.free(r.pages)
        self.page_table[r.slot, :] = NULL_PAGE
        self._slots[r.slot] = None
        r.pages = []
        r.slot = -1
        r.state = FINISHED
        r.finish_step = self.steps
        self.finished[r.req_id] = r

    # -------------------------------------------------------------- step --

    @property
    def num_running(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def idle(self) -> bool:
        return not self.waiting and self.num_running == 0

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _run_prefill(self, plan, emits: List[Tuple[torch.Tensor, List[_Emit]]]):
        """One batched prefill call over the planned chunk rows."""
        by_id = {
            r.req_id: r for r in self._slots
            if r is not None and r.prefill_pos < len(r.prompt)
        }
        rows = []
        for rid, grant in plan:
            r = by_id.get(rid)
            if r is None or grant < 1 or len(rows) >= self.prefill_batch:
                continue
            rows.append((r, min(grant, len(r.prompt) - r.prefill_pos)))
        if not rows:
            return
        pb, cs = self.prefill_batch, self.prefill_chunk
        tokens = np.zeros((pb, cs), np.int32)
        start = np.zeros((pb,), np.int32)
        kv_len = np.zeros((pb,), np.int32)
        last = np.zeros((pb,), np.int32)
        table = np.full((pb, self.max_pages_per_seq), NULL_PAGE, np.int32)
        for i, (r, real) in enumerate(rows):
            c0 = r.prefill_pos
            tokens[i, :real] = r.prompt[c0: c0 + real]
            start[i] = c0
            kv_len[i] = c0 + real
            last[i] = real - 1
            table[i] = self.page_table[r.slot]
        logits, self.pool = self.bundle.paged_prefill_step(
            self.params, self._tensor(tokens), self._tensor(start),
            self._tensor(kv_len), self._tensor(last), self.pool,
            self._tensor(table),
        )
        self.prefill_calls += 1
        first = torch.argmax(logits, dim=-1).to(torch.int32)
        out: List[_Emit] = []
        slots, srcs = [], []
        for i, (r, real) in enumerate(rows):
            r.prefill_pos += real
            if r.prefill_pos < len(r.prompt):
                continue
            # this chunk held the last prompt token: its logits row is the
            # first generated token, which the same step's decode consumes
            out.append((r, len(r.generated), i))
            r.generated.append(None)           # value filled at readback
            slots.append(r.slot)
            srcs.append(i)
            if len(r.generated) >= r.max_new_tokens:
                self._finish(r)
        if slots:
            self._next_dev[self._tensor(np.asarray(slots, np.int64))] = first[
                self._tensor(np.asarray(srcs, np.int64))
            ]
        emits.append((first, out))

    def _run_decode(self, dec: List[Request],
                    emits: List[Tuple[torch.Tensor, List[_Emit]]]) -> None:
        """One batched decode call over the decoding slots."""
        dec_slots = {r.slot for r in dec}
        table = np.array(self.page_table)
        pos = np.zeros((self.max_batch,), np.int32)
        for i in range(self.max_batch):
            if i not in dec_slots:
                table[i, :] = NULL_PAGE   # writes of idle slots -> null page
        for r in dec:
            pos[r.slot] = r.cursor
        feed = self._next_dev.clone()
        logits, self.pool = self.bundle.paged_serve_step(
            self.params, feed, self._tensor(pos), self.pool, self._tensor(table)
        )
        self.decode_calls += 1
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        mask = np.zeros((self.max_batch,), bool)
        mask[list(dec_slots)] = True
        self._next_dev = torch.where(self._tensor(mask), nxt, feed)
        out: List[_Emit] = []
        for r in dec:
            r.cursor += 1
            out.append((r, len(r.generated), r.slot))
            r.generated.append(None)
            if len(r.generated) >= r.max_new_tokens:
                self._finish(r)
        emits.append((nxt, out))

    def _read_back(self, step_no: int,
                   emits: List[Tuple[torch.Tensor, List[_Emit]]]) -> None:
        """The step's one device readback: fill the generated tokens."""
        if not emits:
            return
        vals = torch.cat([t for t, _ in emits]).cpu().tolist()
        base = 0
        for t, out in emits:
            for r, gen_idx, row in out:
                r.generated[gen_idx] = int(vals[base + row])
                if gen_idx == 0 and r.first_token_step < 0:
                    r.first_token_step = step_no
            base += t.shape[0]

    def step(self) -> int:
        """One engine step: admission, the batched prefill call, one
        batched decode call, then the readback.  Returns the number of
        requests live this step; ``steps`` advances on every call."""
        self._try_admit()
        live = [r for r in self._slots if r is not None]
        if not live:
            self.steps += 1
            return 0
        emits: List[Tuple[torch.Tensor, List[_Emit]]] = []
        prefilling = [r for r in live if r.prefill_pos < len(r.prompt)]
        if prefilling:
            plan = self._policy.plan_prefill(
                [self._view(r) for r in prefilling],
                n_decode=len(live) - len(prefilling), budget=None,
                chunk=self.prefill_chunk, page_size=self.page_size,
                max_rows=self.prefill_batch,
            )
            if plan:
                self._run_prefill(plan, emits)
        dec = [
            r for r in self._slots
            if r is not None and r.prefill_pos >= len(r.prompt)
        ]
        if dec:
            self._run_decode(dec, emits)
        self._read_back(self.steps, emits)
        self.steps += 1
        return len(live)

    def run_to_completion(self, max_steps: int = 100_000) -> Dict[int, Request]:
        """Drive :meth:`step` until queue and slots drain."""
        start = self.steps
        while not self.idle:
            if self.steps - start >= max_steps:
                raise RuntimeError(f"engine did not drain in {max_steps} steps")
            self.step()
        return self.finished

    def stats(self) -> dict:
        """A subset of the reference's ``stats()`` schema, plus the device
        call counts."""
        return {
            "steps": self.steps,
            "running": self.num_running,
            "waiting": len(self.waiting),
            "finished": len(self.finished),
            "free_pages": self.allocator.free_pages,
            "live_pages": self.allocator.live_pages,
            "cache_bytes": paged_bytes(self.pool),
            "page_size": self.page_size,
            "pool_dtype": pool_dtype_name(self.cache_dtype),
            "scheduler": self._policy.name,
            "prefill_batch": self.prefill_batch,
            "prefill_calls": self.prefill_calls,
            "decode_calls": self.decode_calls,
        }
