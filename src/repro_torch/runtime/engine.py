"""Continuous-batching serving engine over the paged KV cache.

Counterpart of ``repro.runtime.engine.ServeEngine`` in its synchronous
mode (``pipeline_depth=0``).  The engine owns the host-side mechanism -
request queue, batch slots, page accounting, prefix-cache references,
per-request cursors, preemption - around at most two device calls per
step: one BATCHED chunked-prefill call
(``bundle.paged_prefill_step``) and one batched decode call
(``bundle.paged_serve_step``), both at static shapes ``(prefill_batch,
prefill_chunk)`` and ``(max_batch,)``.  Every scheduling decision comes
from a :class:`~repro_torch.runtime.scheduler.SchedulerPolicy`
(``scheduler=`` "fcfs" | "sjf" | "mixed").

Request lifecycle::

    submit() -> WAITING --admission--> RUNNING(prefill) -> RUNNING(decode)
                 ^  |          (slot + pages granted,            |
                 |  |           shared prefix pages referenced)  v
                 |  +<---- insufficient slot/pages     FINISHED (owned pages
                 |                                     freed or donated to the
                 +--- preempt-to-page-out              prefix cache, slot
                      (pages donated/freed,            reusable next step)
                       request re-queued)

  * **Admission** at the top of every :meth:`step`, in policy order: a
    free slot plus the request's worst-case page count, all-or-nothing.
    With the prefix cache (``prefix_cache=True``) the longest cached
    page-prefix of the prompt, capped at ``len(prompt) - 1`` tokens, is
    referenced instead of recomputed, only the non-shared pages are
    charged, and refcount-0 cache pages are evicted when that covers the
    shortfall.  FCFS and mixed block at the head of the line; SJF skips.
  * **Chunked prefill** (default): each step runs prompt chunks of up to
    ``prefill_batch`` still-prefilling requests through one call, starting
    after any cached prefix; each row carries its own start, valid length
    and page-table row; ragged tails and missing rows are padded and write
    to the null page.  The policy splits ``step_token_budget`` (decode rows
    charge one token each) across the rows.  A row whose chunk ends its
    prompt yields the request's first token.
  * **Token-by-token mode** (``chunked_prefill=False``): prompts are
    consumed one token per step through the decode call, the prompt's
    tokens teacher-forced; its oracle is :func:`dense_greedy_reference`.
  * **Decode**: every request past its prompt decodes one token; slots
    not decoding this step get a null page-table row, so their writes land
    in the null page.
  * **Preemption** (``preemption=True``): when the head admission
    candidate has been page-starved for ``preempt_patience`` steps, the
    policy picks a running victim; its full prompt pages are donated to the
    prefix cache (their bytes are a function of the token prefix), the
    rest freed, and it re-queues at the back with its generated tokens
    recorded.  Resume is a prefix hit, a re-prefill of the private prompt
    tail, and a decode replay of the recorded tokens: the resumed stream
    equals the uninterrupted one bit for bit.
  * **Finish** is decided by count (no EOS): the slot is reusable next
    step; full prompt pages are donated to the prefix cache when it is on,
    the rest recycled without scrubbing.  ``trim_high`` / ``trim_low``
    watermarks evict refcount-0 cache pages at the top of a step.

The decode feed is split: slots whose next input the host knows (a prompt
start or a teacher-forced prompt token in token-by-token mode, a replayed
token after a resume) read ``_next_token`` where ``_next_known`` is set;
the others read ``_next_dev``, the previous call's sampled token, which
stays on the device.  One ``torch.where`` composes them
(:meth:`_compose_feed`), so the feed needs no readback.  The host reads
each step's sampled tokens back once, at the end of the step - the
synchronous mode's contract; preemption records a victim's tokens from
that readback.

**Sampling** (``temperature > 0``): the logits are divided by the
temperature in fp32, truncated to the ``top_k`` largest (ties at the k-th
value stay in) and sampled as ``argmax(logits + Gumbel noise)``, what
``jax.random.categorical`` computes.  The noise is a pure function of
(``sample_seed``, request id, token index, vocabulary index): an integer
counter hash computed on the device from two int32 rows
(:func:`sample_uniforms`), so a request's stream does not depend on its
batch, its chunk schedule, the policy or a preemption.  The reference
keys ``jax.random`` the same way (``fold_in`` of the request id and the
token index); its bits cannot be reproduced in torch, so sampled streams
are held to the reference's invariances, not to its streams.
``temperature == 0`` is the argmax path.

**Speculation** (``speculate = K > 0``): a host-side drafter
(``runtime/spec_decode.py``) proposes up to K tokens per decode row from
the request's own history, the policy grants them under the step budget,
and the step's decode becomes ONE verify (:func:`paged_verify_step`):
K + 1 chained calls of the unmodified ``paged_serve_step`` (feed, then
the drafts), each sub-step's touched page captured first.  The accepted
count ``m`` (1 + the longest draft prefix equal to the model's own
choices) is computed on the device and every sub-step at or past ``m`` is
restored, in reverse order, codes and sidecars alike: token streams and
non-null page bytes equal the non-speculative serve's bit for bit.  A
verify row's cursor advance, its ``generated`` growth and its finish wait
for the step's readback, which reads ``m`` with the tokens.  Async
pipelining, telemetry, the tenant policy and the mesh branches of the
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
    capture_pages,
    paged_bytes,
    pool_dtype_name,
    resolve_pool_dtype,
    restore_pages,
    touched_pages,
)
from repro_torch.runtime.prefix_cache import RadixPrefixCache
from repro_torch.runtime.scheduler import RequestView, get_scheduler
from repro_torch.runtime.spec_decode import get_drafter

WAITING = "waiting"
RUNNING = "running"
FINISHED = "finished"


def dense_greedy_reference(bundle, params, prompt, max_new_tokens: int):
    """Token-by-token greedy decode of one request on a fresh DENSE (B=1)
    cache; returns its tokens.

    The oracle of the token-by-token engine mode (``chunked_prefill=
    False``): it runs only ``bundle.serve_step`` on the dense cache, none
    of the paged machinery, and must give the same greedy tokens as the
    request served through :class:`ServeEngine` in that mode.  Chunked
    prefill rounds interior rows differently; its oracle is
    :func:`chunked_cold_reference`.  The prompt's tokens are fed from the
    device and the tokens read back once, at the end."""
    dev = params["embed"].device
    total = len(prompt) + max_new_tokens
    cache = bundle.init_cache(1, total, device=dev)
    feed = torch.tensor(prompt, dtype=torch.int32, device=dev)
    tok = feed[:1]
    out = []
    for i in range(total - 1):
        pos = torch.full((1,), i, dtype=torch.int32, device=dev)
        logits, cache = bundle.serve_step(params, tok, pos, cache)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        if i + 1 < len(prompt):
            tok = feed[i + 1:i + 2]
        else:
            tok = nxt
            out.append(nxt)
    return torch.cat(out).cpu().tolist()


def chunked_cold_reference(bundle, params, prompt, max_new_tokens: int, *,
                           page_size: int = 16,
                           prefill_chunk: Optional[int] = None,
                           cache_dtype=torch.bfloat16,
                           req_id: Optional[int] = None, **engine_kwargs):
    """Serve one request alone on a fresh engine with an empty prefix
    cache; returns its tokens.

    The oracle of batched, prefix-hit and preempted serving: a request's
    stream in any batch, under any chunk schedule, policy or preemption,
    must equal this token for token.  A sampled stream is keyed by its
    request id: pass the id the request had (``req_id``)."""
    total = len(prompt) + max_new_tokens
    eng = ServeEngine(
        bundle, params, max_batch=1,
        num_pages=1 + math.ceil(max(total - 1, 1) / page_size),
        page_size=page_size, max_seq_len=total,
        prefill_chunk=prefill_chunk, cache_dtype=cache_dtype,
        **engine_kwargs,
    )
    r = eng.submit(prompt, max_new_tokens, req_id=req_id)
    eng.run_to_completion()
    return r.generated


_M32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit integer mix (xor-shift / multiply rounds) on values in
    [0, 2**32): int64 tensors, or a Python int.  Each product is a 32-bit
    value times a constant below 2**31, so it stays below 2**63: no step
    relies on signed overflow, and every device computes the same bits."""
    x = x ^ (x >> 16)
    x = (x * 0x045D9F3B) & _M32
    x = x ^ (x >> 16)
    x = (x * 0x045D9F3B) & _M32
    return x ^ (x >> 16)


def sample_uniforms(seed: int, req_ids: torch.Tensor, token_idx: torch.Tensor,
                    vocab: int) -> torch.Tensor:
    """(B,) request ids x (B,) token indices -> (B, vocab) fp32 uniforms
    in (0, 1), a pure function of (seed, request id, token index,
    vocabulary index), computed on the ids' device.

    The row key folds the request id, then the token index, into the
    mixed seed (as the reference's ``fold_in`` chain does); each
    vocabulary index is hashed against it in two more rounds.  The top 23
    bits of the hash map to ``(h + 0.5) * 2**-23``, exact in fp32 and
    never 0 or 1 (24 bits would round ``2**24 - 0.5`` up to 1)."""
    dev = req_ids.device
    base = _mix32(int(seed) & _M32)           # a Python int: no host copy
    rid = req_ids.to(torch.int64) & _M32
    idx = token_idx.to(torch.int64) & _M32
    key = _mix32(_mix32(base ^ rid) ^ idx)[:, None]             # (B, 1)
    key2 = _mix32(key ^ 0x6A09E667)
    v = torch.arange(vocab, dtype=torch.int64, device=dev)[None, :]
    h = _mix32((v * 0x27D4EB2F + key) & _M32)
    h = _mix32(h ^ key2)
    return ((h >> 9).to(torch.float32) + 0.5) * 2.0 ** -23


def make_sampler(temperature: float, top_k: int, seed: int):
    """``(logits (B, V), req_ids (B,), token_idx (B,)) -> tokens (B,)
    int32``: the logits over the temperature in fp32, then the ``top_k``
    largest kept (``top_k`` 0: all; ties at the k-th value stay in), then
    ``argmax(logits + g)`` with Gumbel noise ``g = -log(-log(u))`` from
    :func:`sample_uniforms` - the reference's ``_make_sampler`` with a
    counter hash in place of jax's keys."""
    temp = float(temperature)
    # the temperature as a device tensor, made once per device: a Python
    # scalar divisor may be turned into a product with its reciprocal on
    # the card (one ulp from the CPU's quotient), and a fresh host copy per
    # call would wait for the device
    temps = {}

    def sample(logits, req_ids, token_idx):
        dev = logits.device
        if dev not in temps:
            temps[dev] = torch.tensor(temp, dtype=torch.float32, device=dev)
        lg = logits.float() / temps[dev]
        if top_k > 0:
            kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
            lg = lg.masked_fill(lg < kth, -math.inf)
        u = sample_uniforms(seed, req_ids, token_idx, lg.shape[-1])
        return torch.argmax(lg - torch.log(-torch.log(u)), dim=-1).to(
            torch.int32)

    return sample


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def paged_verify_step(step, params, tokens, pos0, active, pool, table, *,
                      page_size: int, choose):
    """The speculative verify: K + 1 chained decode sub-steps on the page
    pool, then the accepted count and the rollback, all on the device.

    tokens (B, K+1): each row's feed token, then its drafts; pos0 (B,):
    the feed's position; active (B, K+1) bool: row b runs sub-step i
    (``active[:, 0]`` = the row decodes this step; a row with k drafts is
    active at 0..k); ``table`` the decode view of the page table.
    Sub-step i runs the unmodified ``step`` (``paged_serve_step``) with
    inactive rows at a nulled table row and position 0, as the plain
    decode runs its idle slots, after capturing the page each row's
    append touches; ``choose(logits, i)`` picks its tokens ``g[:, i]``.
    Then ``m = 1 + cumprod(active[:, 1:] & (tokens[:, 1:] ==
    g[:, :-1])).sum(1)`` (0 for rows not decoding), and sub-steps
    ``i >= m`` are restored in reverse order (two sub-steps of a row may
    touch one page).  Returns ``(nxt, g, m, pool)``: ``nxt = g[b, m - 1]``
    is the next feed."""
    n = tokens.shape[1]
    gs, pre_images = [], []
    for i in range(n):
        act = active[:, i]
        tbl = torch.where(act[:, None], table, NULL_PAGE)
        pos = torch.where(act, pos0 + i, 0).to(torch.int32)
        phys = touched_pages(tbl, pos, page_size)
        pre_images.append((phys, capture_pages(pool, phys)))
        logits, pool = step(params, tokens[:, i].contiguous(), pos, pool, tbl)
        gs.append(choose(logits, i))
    g = torch.stack(gs, dim=1)                                 # (B, K+1)
    match = active[:, 1:] & (tokens[:, 1:] == g[:, :-1])
    m = 1 + torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
    m = torch.where(active[:, 0], m, 0).to(torch.int32)
    for i in reversed(range(n)):
        phys, pre = pre_images[i]
        pool = restore_pages(pool, phys, pre, i >= m)
    last = torch.clamp(m.long() - 1, 0, n - 1)[:, None]
    nxt = torch.gather(g, 1, last)[:, 0]
    return nxt, g, m, pool


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
    pages: List[int] = dataclasses.field(default_factory=list)  # owned only
    cursor: int = 0        # next cache position written by decode
    prefill_pos: int = 0   # next prompt position whose K/V is not written
    cached_len: int = 0    # prompt tokens served from the prefix cache
    prefix_nodes: list = dataclasses.field(default_factory=list)
    # preemption bookkeeping
    replay: List[int] = dataclasses.field(default_factory=list)
    blocked_steps: int = 0   # consecutive page-starved admission attempts
    preempt_count: int = 0
    preempt_step: int = -1

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
    width; default: the pool's capacity); ``chunked_prefill`` prefill in
    chunks (default) or token by token through the decode call;
    ``prefill_chunk`` per-row chunk width, a multiple of ``page_size``
    (default ``8 * page_size``); ``prefix_cache`` share full prompt pages
    through a :class:`RadixPrefixCache` (needs ``chunked_prefill``);
    ``cache_dtype`` pool dtype, a torch dtype or one of ``"bf16"``,
    ``"fp8_e4m3"``, ``"int8"`` (the last two store quantized pages with
    sidecars; chunk starts stay page-aligned, as their page-granular
    writes require); ``scheduler`` a policy name or instance;
    ``prefill_batch`` rows of the prefill call (default ``max_batch``);
    ``step_token_budget`` tokens per step the policy splits between decode
    rows (one each) and prefill chunks (None = unlimited; at least
    ``page_size``); ``preemption`` / ``preempt_patience`` page out a
    running request when the head admission candidate has been
    page-starved that many steps; ``trim_high`` / ``trim_low`` prefix-cache
    trimming watermarks as fractions of the allocatable pool (both or
    neither; need ``prefix_cache``); ``temperature`` / ``top_k`` /
    ``sample_seed`` sampling (0 = greedy argmax; ``top_k`` 0 = no
    truncation, beyond the vocabulary = no truncation); ``speculate`` draft
    tokens per decode row per step (0 = off; needs ``chunked_prefill``) and
    ``draft`` the proposer (a ``spec_decode.DRAFTERS`` name, a
    :class:`~repro_torch.runtime.spec_decode.DraftProposer` class or an
    instance).  Draft quality moves latency only, never output bits.

    The engine runs on the device its parameters live on.
    """

    def __init__(self, bundle, params, *, max_batch: int = 4,
                 num_pages: int = 64, page_size: Optional[int] = None,
                 max_seq_len: Optional[int] = None,
                 chunked_prefill: bool = True,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = False,
                 cache_dtype=torch.bfloat16, scheduler="fcfs",
                 prefill_batch: Optional[int] = None,
                 step_token_budget: Optional[int] = None,
                 preemption: bool = False, preempt_patience: int = 4,
                 trim_high: Optional[float] = None,
                 trim_low: Optional[float] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 sample_seed: int = 0, speculate: int = 0, draft="ngram"):
        if not bundle.supports_paged:
            raise ValueError(
                f"family {bundle.cfg.family!r} has no paged serving path; "
                "use the dense cache (launch/serve.py default)"
            )
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
        self.chunked_prefill = bool(chunked_prefill)
        if prefill_chunk is None:
            prefill_chunk = 8 * self.page_size
        if prefill_chunk < 1 or prefill_chunk % self.page_size:
            raise ValueError(
                f"prefill_chunk ({prefill_chunk}) must be a positive "
                f"multiple of page_size ({self.page_size}); page-aligned "
                "chunk boundaries are what make chunked prefill bit-exact"
            )
        self.prefill_chunk = int(prefill_chunk)
        if prefix_cache and not self.chunked_prefill:
            raise ValueError(
                "prefix_cache requires chunked_prefill: cached page contents "
                "are defined by the chunk-exact convention, which the "
                "token-by-token decode path does not produce"
            )
        self._policy = get_scheduler(scheduler)
        if prefill_batch is None:
            prefill_batch = self.max_batch
        if prefill_batch < 1:
            raise ValueError(f"prefill_batch must be >= 1, got {prefill_batch}")
        self.prefill_batch = min(int(prefill_batch), self.max_batch)
        if step_token_budget is not None and step_token_budget < self.page_size:
            raise ValueError(
                f"step_token_budget ({step_token_budget}) below page_size "
                f"({self.page_size}) could never grant a page-aligned chunk"
            )
        self.step_token_budget = (
            None if step_token_budget is None else int(step_token_budget)
        )
        self.preemption = bool(preemption)
        if preempt_patience < 1:
            raise ValueError(
                f"preempt_patience must be >= 1, got {preempt_patience}"
            )
        self.preempt_patience = int(preempt_patience)
        if (trim_high is None) != (trim_low is None):
            raise ValueError("trim_high and trim_low must be set together")
        self._trim_high_pages = self._trim_low_pages = None
        if trim_high is not None:
            if not prefix_cache:
                raise ValueError("cache trimming requires prefix_cache=True")
            if not 0.0 <= trim_low <= trim_high <= 1.0:
                raise ValueError(
                    f"need 0 <= trim_low <= trim_high <= 1, got "
                    f"{trim_low}/{trim_high}"
                )
            allocatable = self.num_pages - 1
            self._trim_high_pages = int(trim_high * allocatable)
            self._trim_low_pages = int(trim_low * allocatable)
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        self.temperature = float(temperature)
        # top_k beyond the vocabulary is "no truncation"
        self.top_k = min(int(top_k), bundle.cfg.vocab_size)
        self._sampler = (
            make_sampler(self.temperature, self.top_k, int(sample_seed))
            if self.temperature > 0.0 else None
        )
        if speculate < 0:
            raise ValueError(f"speculate must be >= 0, got {speculate}")
        if speculate > 0 and not self.chunked_prefill:
            raise ValueError(
                "speculate requires chunked_prefill: the verify rides the "
                "decode-phase cursor convention, which the token-by-token "
                "mode does not keep"
            )
        self.speculate = int(speculate)
        self._drafter = get_drafter(draft) if self.speculate > 0 else None
        # the reference's speculation tallies (stats()["spec"])
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_rollbacks = 0
        self.spec_verify_steps = 0

        self.cache_dtype = resolve_pool_dtype(cache_dtype)
        self.pool = bundle.init_paged_cache(
            self.num_pages, self.page_size, self.cache_dtype,
            device=self.device,
        )
        self.allocator = PageAllocator(self.num_pages)
        self.prefix_cache = (
            RadixPrefixCache(self.allocator, self.page_size)
            if prefix_cache else None
        )
        self.page_table = np.full(
            (self.max_batch, self.max_pages_per_seq), NULL_PAGE, np.int32
        )
        self._slots: List[Optional[Request]] = [None] * self.max_batch
        self.waiting: deque = deque()
        self.finished: Dict[int, Request] = {}
        self.steps = 0
        self.prefill_calls = 0
        self.decode_calls = 0
        self.verify_calls = 0
        self.preemptions = 0
        self.trimmed_pages = 0
        # per-step token spend (decode rows + real prefill tokens): the
        # observable the step_token_budget contract is held to
        self.last_step_tokens = 0
        self.max_step_tokens = 0
        self._req_counter = 0
        # the decode feed (module doc): host-known tokens where
        # _next_known is set, else the previous call's sampled token kept
        # on the device
        self._next_token = np.zeros((self.max_batch,), np.int32)
        self._next_known = np.ones((self.max_batch,), bool)
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
        if r.state == RUNNING and self.chunked_prefill:
            rem_prefill = max(len(r.prompt) - r.prefill_pos, 0)
        elif r.state == RUNNING:
            rem_prefill = max(len(r.prompt) - 1 - r.cursor, 0)
        else:
            rem_prefill = len(r.prompt)
        return RequestView(
            req_id=r.req_id,
            prompt_len=len(r.prompt),
            remaining_prefill=rem_prefill,
            remaining_decode=max(r.max_new_tokens - len(r.generated), 0),
            submit_step=r.submit_step,
            admit_step=r.admit_step if r.state == RUNNING else -1,
            slot=r.slot,
            pages_needed=r.pages_needed(self.page_size),
            preempt_count=r.preempt_count,
            preempt_step=r.preempt_step,
        )

    # --------------------------------------------------------- admission --

    def _admit_one(self, r: Request) -> str:
        """Place one waiting request: "admitted", "no_slot" or "no_pages".
        With the prefix cache, matched prefix pages are referenced and only
        the non-shared pages are charged."""
        slot = next(
            (i for i, s in enumerate(self._slots) if s is None), None
        )
        if slot is None:
            return "no_slot"
        nodes = []
        if self.prefix_cache is not None:
            # cap at len(prompt) - 1: the last prompt position is always
            # computed (its logits are the first token) and the partial
            # page stays private
            nodes = self.prefix_cache.match(
                r.prompt, max_tokens=len(r.prompt) - 1
            )
        need_new = r.pages_needed(self.page_size) - len(nodes)
        if self.prefix_cache is not None:
            short = need_new - self.allocator.free_pages
            # evict only when that covers the shortfall: otherwise
            # admission fails anyway and the cache would lose resident
            # prefixes for nothing
            if 0 < short <= self.prefix_cache.evictable_pages:
                self.prefix_cache.evict(short)
        pages = self.allocator.alloc(need_new)
        if pages is None:
            if nodes:
                self.prefix_cache.release(nodes)
            return "no_pages"
        self.waiting.remove(r)
        if self.prefix_cache is not None:
            self.prefix_cache.record_match(
                r.prompt, nodes, max_tokens=len(r.prompt) - 1
            )
        r.state = RUNNING
        r.slot = slot
        r.pages = pages
        r.prefix_nodes = nodes
        r.cached_len = len(nodes) * self.page_size
        r.admit_step = self.steps
        r.blocked_steps = 0
        self._slots[slot] = r
        row = self.page_table[slot]
        row[:] = NULL_PAGE
        shared = [n.page for n in nodes]
        row[: len(shared)] = shared
        row[len(shared): len(shared) + len(pages)] = pages
        if self.chunked_prefill:
            r.prefill_pos = r.cached_len
            r.cursor = len(r.prompt)     # decode starts after the prompt
        else:
            r.prefill_pos = len(r.prompt)  # unused in this mode
            r.cursor = 0
            self._next_token[slot] = r.prompt[0]
            self._next_known[slot] = True
        return "admitted"

    def _admit_pass(self) -> Optional[Request]:
        """Admit everything the policy can place this step; returns the
        first page-blocked candidate (the preemption trigger) or None.
        Free pages never grow within a pass, so a candidate that failed on
        pages is not tried again in it."""
        blocked: Optional[Request] = None
        page_failed: set = set()
        while self.waiting:
            order = self._policy.plan_admission(
                [self._view(r) for r in self.waiting],
                [self._view(r) for r in self._slots if r is not None],
                now=self.steps,
            )
            by_id = {r.req_id: r for r in self.waiting}
            admitted = False
            for v in order:
                if v.req_id in page_failed:
                    continue
                r = by_id[v.req_id]
                status = self._admit_one(r)
                if status == "admitted":
                    admitted = True
                    break
                if status == "no_slot":
                    return blocked
                page_failed.add(r.req_id)
                if blocked is None:
                    blocked = r
                if self._policy.hol_blocking:
                    return blocked
            if not admitted:
                return blocked
        return blocked

    def _try_admit(self) -> None:
        """Admission, then preemption when the blocked head has run out of
        patience."""
        blocked = self._admit_pass()
        if blocked is None:
            return
        blocked.blocked_steps += 1
        if (not self.preemption
                or blocked.blocked_steps < self.preempt_patience):
            return
        if blocked.preempt_count > 0:
            # anti-thrash: a request that was paged out itself never
            # triggers another preemption; it waits for running work
            return
        victim_view = self._policy.choose_victim(
            [self._view(r) for r in self._slots if r is not None],
            now=self.steps,
        )
        if victim_view is None:
            return
        victim = next(
            (s for s in self._slots
             if s is not None and s.req_id == victim_view.req_id), None
        )
        if victim is None:
            return
        # preempt only when paging the victim out can unblock the
        # candidate: its owned pages are freed or become refcount-0 cache
        # pages, both reclaimable by admission
        avail = self.allocator.free_pages + len(victim.pages)
        if self.prefix_cache is not None:
            avail += self.prefix_cache.evictable_pages
        if avail < blocked.pages_needed(self.page_size):
            return
        self._preempt(victim)
        blocked.blocked_steps = 0
        self._admit_pass()

    # -------------------------------------------------- page-out / finish --

    def _release_slot(self, r: Request) -> None:
        """Free the request's slot and pages.  With the prefix cache its
        prefill-written FULL prompt pages are donated (their contents are a
        function of the token prefix; decode-written pages never qualify
        and are freed)."""
        row = self.page_table[r.slot]
        if self.prefix_cache is not None:
            n_share = min(r.prefill_pos, len(r.prompt)) // self.page_size
            adopted = set(self.prefix_cache.insert(
                r.prompt[: n_share * self.page_size], list(row[:n_share])
            ))
            if r.prefix_nodes:
                self.prefix_cache.release(r.prefix_nodes)
            self.allocator.free([p for p in r.pages if p not in adopted])
        else:
            self.allocator.free(r.pages)
        row[:] = NULL_PAGE
        self._slots[r.slot] = None
        r.pages = []
        r.prefix_nodes = []
        r.slot = -1

    def _preempt(self, r: Request) -> None:
        """Page a running request out: donate / free its pages, record its
        generated tokens for replay (already on the host: the engine reads
        every step back before the next one plans), and re-queue it at the
        BACK of the queue (a paged-out request yields its seniority)."""
        self._release_slot(r)
        # a request preempted again mid-replay keeps the recorded suffix it
        # has not replayed yet (generated[i] == replay[i] while replaying)
        r.replay = r.generated + r.replay[len(r.generated):]
        r.generated = []
        r.state = WAITING
        r.preempt_count += 1
        r.preempt_step = self.steps
        r.prefill_pos = 0
        r.cursor = 0
        r.cached_len = 0
        r.blocked_steps = 0
        self.preemptions += 1
        self.waiting.append(r)

    def _finish(self, r: Request) -> None:
        self._release_slot(r)
        r.state = FINISHED
        r.finish_step = self.steps
        self.finished[r.req_id] = r

    def _account_step_tokens(self, n: int) -> None:
        self.last_step_tokens = int(n)
        self.max_step_tokens = max(self.max_step_tokens, int(n))

    def _maybe_trim(self) -> None:
        """Watermark trim: when live pages exceed the high watermark,
        evict refcount-0 cache pages down toward the low one (an O(1)
        probe every step)."""
        if self._trim_high_pages is None:
            return
        if self.allocator.live_pages <= self._trim_high_pages:
            return
        excess = self.allocator.live_pages - self._trim_low_pages
        n = min(excess, self.prefix_cache.evictable_pages)
        if n > 0:
            self.trimmed_pages += self.prefix_cache.evict(n)

    # -------------------------------------------------------------- step --

    @property
    def num_running(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def idle(self) -> bool:
        return not self.waiting and self.num_running == 0

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _sample_rows(self, pairs):
        """(request id, token index) int32 rows of the sampler, or None
        when the engine is greedy; a row whose pair is None (a dead or pad
        row) gets zeros - its sample is never read.  Made before the
        device call: a host copy after it would wait for the device."""
        if self._sampler is None:
            return None
        rids = np.zeros((len(pairs),), np.int32)
        idxs = np.zeros((len(pairs),), np.int32)
        for i, pair in enumerate(pairs):
            if pair is not None:
                rids[i], idxs[i] = pair
        return self._tensor(rids), self._tensor(idxs)

    def _pick(self, logits: torch.Tensor, rows, offset: int = 0):
        """The tokens of one call's logits: argmax, or the sampler keyed by
        ``rows`` (:meth:`_sample_rows`), token indices plus ``offset``."""
        if rows is None:
            return _argmax(logits)
        return self._sampler(logits, rows[0], rows[1] + offset)

    def _run_prefill(self, plan, emits: List[Tuple[torch.Tensor, List[_Emit]]]):
        """One batched prefill call over the planned chunk rows.  Returns
        ``(tokens_spent, completed)``: the real prompt tokens advanced and
        the requests whose prompt ended in this call."""
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
            return 0, []
        pb, cs = self.prefill_batch, self.prefill_chunk
        tokens = np.zeros((pb, cs), np.int32)
        start = np.zeros((pb,), np.int32)
        kv_len = np.zeros((pb,), np.int32)
        last = np.zeros((pb,), np.int32)
        table = np.full((pb, self.max_pages_per_seq), NULL_PAGE, np.int32)
        pairs = [None] * pb
        for i, (r, real) in enumerate(rows):
            c0 = r.prefill_pos
            tokens[i, :real] = r.prompt[c0: c0 + real]
            start[i] = c0
            kv_len[i] = c0 + real
            last[i] = real - 1
            table[i] = self.page_table[r.slot]
            # the first token's key: (request, its index), as every row's
            pairs[i] = (r.req_id, len(r.generated))
        rows_key = self._sample_rows(pairs)
        logits, self.pool = self.bundle.paged_prefill_step(
            self.params, self._tensor(tokens), self._tensor(start),
            self._tensor(kv_len), self._tensor(last), self.pool,
            self._tensor(table),
        )
        self.prefill_calls += 1
        first = self._pick(logits, rows_key)
        out: List[_Emit] = []
        completed = []
        slots, srcs = [], []
        for i, (r, real) in enumerate(rows):
            r.prefill_pos += real
            if r.prefill_pos < len(r.prompt):
                continue
            # this chunk held the last prompt token: its logits row is the
            # first generated token
            out.append((r, len(r.generated), i))
            r.generated.append(None)           # value filled at readback
            completed.append(r)
            if r.replay:
                # a resumed request feeds its recorded token (bit-equal to
                # the one just recomputed): a host-known value
                self._next_token[r.slot] = r.replay[0]
                self._next_known[r.slot] = True
            else:
                # the same step's decode consumes it on the device
                self._next_known[r.slot] = False
                slots.append(r.slot)
                srcs.append(i)
            if len(r.generated) >= r.max_new_tokens:
                self._finish(r)
        if slots:
            self._next_dev[self._tensor(np.asarray(slots, np.int64))] = first[
                self._tensor(np.asarray(srcs, np.int64))
            ]
        emits.append((first, out))
        return sum(real for _, real in rows), completed

    def _compose_feed(self) -> torch.Tensor:
        """This step's decode inputs: host-known tokens over the on-device
        sampled ones, in one ``torch.where`` (exact; no readback)."""
        host = self._tensor(self._next_token)
        if self._next_known.all():
            return host
        return torch.where(self._tensor(self._next_known), host,
                           self._next_dev)

    def _plan_speculation(self, dec: List[Request], prefill_spent: int):
        """Drafts and the policy's grants for this step's decode rows:
        ``[(request, k, drafts)]`` for the rows that verify k drafts (the
        others decode one token).  Eligible: at least 2 tokens left (k <=
        remaining - 1 keeps every verify write inside the pages admission
        reserved, so speculation never allocates) and not replaying.  The
        drafter reads the materialized history; the first token of a prompt
        that ended in this step's prefill call is still on the device (a
        None placeholder), and the draft starts past it (``skip``), as the
        reference's does."""
        cands, drafts = [], {}
        for r in dec:
            remaining = r.max_new_tokens - len(r.generated)
            if remaining < 2 or len(r.generated) < len(r.replay):
                continue
            pending = sum(t is None for t in r.generated)
            hist = r.prompt + r.generated[:len(r.generated) - pending]
            d = self._drafter.propose(
                hist, min(self.speculate, remaining - 1), skip=pending
            )
            if d:
                cands.append(r)
                drafts[r.req_id] = [int(t) for t in d]
        if not cands:
            return []
        left = None
        if self.step_token_budget is not None:
            left = max(self.step_token_budget - len(dec) - prefill_spent, 0)
        grants = self._policy.plan_speculation(
            [self._view(r) for r in cands], k=self.speculate, budget_left=left,
        )
        by_id = {r.req_id: r for r in cands}
        out = []
        for rid, g in grants:
            r = by_id.get(rid)
            if r is None or g < 1:
                continue
            d = drafts[rid][:g]
            if d:
                out.append((r, len(d), d))
        return out

    def _run_decode(self, dec: List[Request],
                    emits: List[Tuple[torch.Tensor, List[_Emit]]],
                    spec_plan=()):
        """One batched decode call over the decoding slots, or, when a row
        has drafts (``spec_plan``), one verify call of K + 1 sub-steps in
        which every other decoding row is active at sub-step 0 only (that
        sub-step is its plain decode).  Returns the verify's ``(g, m,
        rows)`` for the readback, or None."""
        dec_slots = {r.slot for r in dec}
        table = np.array(self.page_table)
        pos = np.zeros((self.max_batch,), np.int32)
        pairs = [None] * self.max_batch
        for i in range(self.max_batch):
            if i not in dec_slots:
                table[i, :] = NULL_PAGE   # writes of idle slots -> null page
        for r in dec:
            pos[r.slot] = r.cursor
            pairs[r.slot] = (r.req_id, len(r.generated))
        feed = self._compose_feed()
        rows = self._sample_rows(pairs)
        mask = np.zeros((self.max_batch,), bool)
        mask[list(dec_slots)] = True
        mask = self._tensor(mask)
        verify = None
        if spec_plan:
            k = self.speculate
            drafts = np.zeros((self.max_batch, k), np.int32)
            active = np.zeros((self.max_batch, k + 1), bool)
            for r in dec:
                active[r.slot, 0] = True
            for r, n, d in spec_plan:
                drafts[r.slot, :n] = d
                active[r.slot, 1:1 + n] = True
            tokens = torch.cat([feed[:, None], self._tensor(drafts)], dim=1)
            nxt, g, m, self.pool = paged_verify_step(
                self.bundle.paged_serve_step, self.params, tokens,
                self._tensor(pos), self._tensor(active), self.pool,
                self._tensor(table), page_size=self.page_size,
                choose=lambda logits, i: self._pick(logits, rows, i),
            )
            self.verify_calls += 1
            self.spec_proposed += sum(n for _, n, _ in spec_plan)
            self.spec_verify_steps += len(spec_plan)
            first = g[:, 0]
            verify = (g, m, [(r, r.slot, n) for r, n, _ in spec_plan])
        else:
            logits, self.pool = self.bundle.paged_serve_step(
                self.params, feed, self._tensor(pos), self.pool,
                self._tensor(table)
            )
            self.decode_calls += 1
            nxt = first = self._pick(logits, rows)
        # decoding slots keep their sampled token (a verify row: its last
        # accepted one) on the device for the next step's feed; the others
        # keep their value
        self._next_dev = torch.where(mask, nxt, feed)
        spec_ids = {r.req_id for r, _, _ in spec_plan}
        out: List[_Emit] = []
        for r in dec:
            if r.req_id in spec_ids:
                # cursor, tokens and finish wait for the accepted count
                self._next_known[r.slot] = False
                continue
            p = r.cursor
            r.cursor += 1
            if not self.chunked_prefill and p + 1 < len(r.prompt):
                self._next_token[r.slot] = r.prompt[p + 1]  # teacher forcing
                self._next_known[r.slot] = True
                continue
            gen_idx = len(r.generated)
            out.append((r, gen_idx, r.slot))
            r.generated.append(None)
            if gen_idx < len(r.replay):
                self._next_token[r.slot] = r.replay[gen_idx]
                self._next_known[r.slot] = True
            else:
                self._next_known[r.slot] = False   # the value is on the device
            if len(r.generated) >= r.max_new_tokens:
                self._finish(r)
        emits.append((first, out))
        return verify

    def _read_back(self, step_no: int,
                   emits: List[Tuple[torch.Tensor, List[_Emit]]],
                   verify=None) -> None:
        """The step's one device readback: fill the generated tokens, then
        a verify's accepted tokens, with the cursor advance, the tallies and
        the finish they decide.  A request keeps the first-token step of its
        first emission across a preemption."""
        if not emits:
            return
        parts = [t for t, _ in emits]
        if verify is not None:
            g, m, _ = verify
            parts += [g.reshape(-1), m]
        vals = torch.cat(parts).cpu().tolist()
        base = 0
        for t, out in emits:
            for r, gen_idx, row in out:
                r.generated[gen_idx] = int(vals[base + row])
                if gen_idx == 0 and r.first_token_step < 0:
                    r.first_token_step = step_no
            base += t.shape[0]
        if verify is None:
            return
        g, m, rows = verify
        width = g.shape[1]
        g_vals = vals[base:base + g.numel()]
        m_vals = vals[base + g.numel():]
        for r, slot, k in rows:
            n = int(m_vals[slot])
            r.generated.extend(g_vals[slot * width: slot * width + n])
            r.cursor += n
            self.spec_accepted += n - 1
            if n <= k:
                self.spec_rollbacks += 1   # a draft was rejected and restored
            if len(r.generated) >= r.max_new_tokens:
                self._finish(r)

    def step(self) -> int:
        """One engine step: trim, admission (and preemption), the batched
        prefill call, one batched decode (or verify) call, then the
        readback.  Returns the number of requests live this step; ``steps``
        advances on every call."""
        self._maybe_trim()
        self._try_admit()
        live = [r for r in self._slots if r is not None]
        if not live:
            self._account_step_tokens(0)
            self.steps += 1
            return 0
        emits: List[Tuple[torch.Tensor, List[_Emit]]] = []
        spec_plan = []
        if self.chunked_prefill:
            prefilling = [r for r in live if r.prefill_pos < len(r.prompt)]
            prefill_spent, completed = 0, []
            if prefilling:
                plan = self._policy.plan_prefill(
                    [self._view(r) for r in prefilling],
                    n_decode=len(live) - len(prefilling),
                    budget=self.step_token_budget,
                    chunk=self.prefill_chunk, page_size=self.page_size,
                    max_rows=self.prefill_batch,
                )
                if plan:
                    prefill_spent, completed = self._run_prefill(plan, emits)
            dec = [
                r for r in self._slots
                if r is not None and r.prefill_pos >= len(r.prompt)
            ]
            if self.step_token_budget is not None:
                # a row whose prompt ended in this step's prefill call
                # joined ``dec`` after the policy counted the decode rows:
                # defer the first decode of just enough of them (latest
                # grants first) to keep the step within budget
                over = len(dec) + prefill_spent - self.step_token_budget
                if over > 0:
                    in_dec = {r.req_id for r in dec}
                    deferrable = [
                        r.req_id for r in completed if r.req_id in in_dec
                    ]
                    defer = set(deferrable[max(len(deferrable) - over, 0):])
                    dec = [r for r in dec if r.req_id not in defer]
            # drafts only spend what decode and prefill leave of the budget
            if self.speculate > 0 and dec:
                spec_plan = self._plan_speculation(dec, prefill_spent)
            n_draft = sum(n for _, n, _ in spec_plan)
            self._account_step_tokens(len(dec) + prefill_spent + n_draft)
        else:
            dec = live
            self._account_step_tokens(len(dec))
        verify = self._run_decode(dec, emits, spec_plan) if dec else None
        self._read_back(self.steps, emits, verify)
        self.steps += 1
        return len(live)

    def run_to_completion(self, max_steps: int = 100_000) -> Dict[int, Request]:
        """Drive :meth:`step` until queue and slots drain (``max_steps``
        bounds this call)."""
        start = self.steps
        while not self.idle:
            if self.steps - start >= max_steps:
                raise RuntimeError(f"engine did not drain in {max_steps} steps")
            self.step()
        return self.finished

    def stats(self) -> dict:
        """The reference's ``stats()`` keys of the ported features (the
        prefix cache's sub-dict is None when it is off; ``spec`` is zeros
        when speculation is off), plus the device call counts: a verify
        call (K + 1 decode sub-steps) counts in ``verify_calls``, not in
        ``decode_calls``."""
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
            "chunked_prefill": self.chunked_prefill,
            "scheduler": self._policy.name,
            "prefill_batch": self.prefill_batch,
            "step_token_budget": self.step_token_budget,
            "preemptions": self.preemptions,
            "trimmed_pages": self.trimmed_pages,
            "last_step_tokens": self.last_step_tokens,
            "max_step_tokens": self.max_step_tokens,
            "prefix_cache": (
                None if self.prefix_cache is None
                else self.prefix_cache.stats()
            ),
            "temperature": self.temperature,
            "speculate": self.speculate,
            "spec": {
                "proposed": self.spec_proposed,
                "accepted": self.spec_accepted,
                "rollbacks": self.spec_rollbacks,
                "verify_steps": self.spec_verify_steps,
            },
            "prefill_calls": self.prefill_calls,
            "decode_calls": self.decode_calls,
            "verify_calls": self.verify_calls,
        }
