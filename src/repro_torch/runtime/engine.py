"""Continuous-batching serving engine over the paged KV cache.

Counterpart of ``repro.runtime.engine.ServeEngine`` on one device.  The
engine owns the host-side mechanism - request queue, batch slots, page
accounting, prefix-cache references, per-request cursors, preemption,
cancellation - around at most two device calls per step: one BATCHED
chunked-prefill call (``bundle.paged_prefill_step``) and one batched
decode call (``bundle.paged_serve_step``), both at static shapes
``(prefill_batch, prefill_chunk)`` and ``(max_batch,)``.  Every
scheduling decision comes from a
:class:`~repro_torch.runtime.scheduler.SchedulerPolicy` (``scheduler=``
"fcfs" | "sjf" | "mixed").

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
  * **Cancellation** (:meth:`cancel`, a client disconnect): a waiting
    request leaves the queue; a running one is released as on finish
    (full prompt pages donated, the rest freed) after the pipeline is
    drained.  Its state becomes CANCELLED.

The decode feed is split: slots whose next input the host knows (a prompt
start or a teacher-forced prompt token in token-by-token mode, a replayed
token after a resume) read ``_next_token`` where ``_next_known`` is set;
the others read ``_next_dev``, the previous call's sampled token, which
stays on the device.  One ``torch.where`` composes them
(:meth:`_compose_feed`), so the feed needs no readback.

**Async pipelining** (``pipeline_depth``): every step is a host PLAN
(trim, admission, policy decisions, page-table assembly), a DISPATCH of
the device calls, and a RETIRE of the steps beyond ``pipeline_depth``
still in flight (:meth:`_retire_backlog`).  Nothing on the plan and
dispatch path waits for the device: host inputs reach the card through
pinned memory with ``non_blocking=True`` (the caching host allocator
holds each pinned block until its copy has run), and a step's outputs -
the prefill's first tokens, the decode tokens, a verify's ``g`` and
``m`` - are copied back into pinned memory at dispatch, followed by a
CUDA event.  Finish decisions are counts (every decode row emits one
token), so ``len(generated)`` advances at dispatch with ``None``
placeholders (``Request.pending``); :meth:`_retire_one` waits on the
oldest step's event and fills them in dispatch order, firing
``on_token``.  Depth 0 retires every step before :meth:`step` returns
(the synchronous engine); depth 1 retires step N after step N+1 was
dispatched, so the host's planning overlaps the device.  The only legal
synchronizing sites are marked ``@_drain_point``
(``runtime/telemetry.py``; held by tests/test_torch_async_guard.py):
retirement, :meth:`drain`, and the numerics probe.  :meth:`drain` runs
before a decision that needs token VALUES (preemption records the
victim's tokens for replay; :meth:`cancel`), on an idle tick, when only
verifying rows are live, and at the end of :meth:`run_to_completion`.
Both modes run the same device calls on the same inputs (every host
array is copied when it crosses to the device, so a later plan cannot
change a step in flight, and the pool is written in stream order), so
their token streams and page bytes are equal bit for bit.

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
verify row freezes until its retirement (``Request.verifying``): its
cursor advance, its ``generated`` growth and its finish wait for the
accepted count.

**Telemetry** (``telemetry=``, :class:`~repro_torch.runtime.telemetry
.Telemetry`): step spans, lifecycle instants, the metrics registry
(threaded through the allocator and the prefix cache) and the numerics
probe, at the reference's sites.  Bit-neutral: every hook reads host
state the engine keeps anyway, and the probe reads the pool at a drain
point.

**The model axis** (``mesh=``, a :class:`~repro_torch.launch.mesh.Mesh`
whose ``model`` axis is a ``torch.distributed`` group of M processes, one
per rank, every rank running this same engine): the pool stays
kv-head-sharded at rest, each rank holding its kv heads' columns of every
leaf (``paged_cache.pool_shardings``).  Around each device call the pool
boundary (:class:`_PoolIO`) all-gathers every sharded leaf along its split
dim in rank order, the interior is the unchanged one-device step -
prefill, decode or verify, sampled or greedy - on the whole pool, and
this rank's part is sliced back, as the reference's ``shard_map`` body
does.  Every rank computes the same full step, so the host state, the
tokens and the decisions stay identical across ranks with no broadcast,
and the tokens and page bytes are the one-device serve's bit for bit.
gloo takes host tensors, so on a card the boundary stages the sharded
leaves through pinned host memory (``core.collectives``) and counts the
time it takes (``pool_io.stage_s`` over ``pool_io.calls``); that copy
waits for the device, so the model axis cannot pipeline.  The split at
rest saves no peak memory and no compute: every rank holds the gathered
whole pool beside its part during a call, and runs the whole step.  A
pool whose kv heads the model axis does not divide stays whole on every
rank, and then no call communicates.  :class:`EngineReplicaGroup` adds the data
axis: replicas of this engine fed from one queue.

**Tenants** (``submit(tenant=, priority=)``): host-only labels read by
the tenant policy (``scheduler="tenant"``, :class:`~repro_torch.runtime
.scheduler.TenantQuotaPolicy`) and by the per-tenant telemetry series.
Nothing tenant-shaped reaches the device, so a tenant's tokens are the
same under any quota; a quota-withheld request is never tried for
admission, so it is never page-starved and never triggers preemption.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.collectives import WIRE, all_gather
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.sharding import manual_region
from repro_torch.runtime.paged_cache import (
    NULL_PAGE,
    PageAllocator,
    capture_pages,
    model_axis_size,
    paged_bytes,
    paged_bytes_per_device,
    pool_dtype_name,
    pool_shardings,
    resolve_pool_dtype,
    restore_pages,
    shard_pool,
    touched_pages,
)
from repro_torch.runtime.prefix_cache import RadixPrefixCache
from repro_torch.runtime.scheduler import (
    DEFAULT_TENANT,
    PRIORITY_CLASSES,
    RequestView,
    get_scheduler,
)
from repro_torch.runtime.spec_decode import get_drafter
from repro_torch.runtime.telemetry import Telemetry, _drain_point

WAITING = "waiting"
RUNNING = "running"
FINISHED = "finished"
CANCELLED = "cancelled"

#: Version of the ``stats()`` schema, the reference's (``repro.runtime
#: .engine.STATS_SCHEMA``): v2 has ``speculate`` and the ``spec`` tallies.
#: The port adds three keys of its own, the device call counts
#: ``prefill_calls``, ``decode_calls`` and ``verify_calls``.
STATS_SCHEMA = 2

#: How :meth:`EngineReplicaGroup.stats` aggregates each shared key of
#: :meth:`ServeEngine.stats` (the reference's tuples): tallies and
#: capacity totals sum, clocks and per-device peaks take the max, the
#: uniform engine configuration passes through from replica 0.
_STATS_SUM = (
    "running", "waiting", "finished", "free_pages", "live_pages",
    "cache_bytes", "preemptions", "trimmed_pages", "last_step_tokens",
    "inflight", "cancellations",
)
_STATS_MAX = ("steps", "cache_bytes_per_device", "max_step_tokens")
_STATS_CONFIG = (
    "page_size", "pool_dtype", "chunked_prefill", "scheduler",
    "prefill_batch", "step_token_budget", "temperature", "pipeline_depth",
    "speculate",
)

#: Replica-routing modes of :class:`EngineReplicaGroup`.
ROUTING_MODES = ("affinity", "least", "rr")


@_drain_point
def dense_greedy_reference(bundle, params, prompt, max_new_tokens: int):
    """Token-by-token greedy decode of one request on a fresh DENSE (B=1)
    cache; returns its tokens.

    The oracle of the token-by-token engine mode (``chunked_prefill=
    False``): it runs only ``bundle.serve_step`` on the dense cache, none
    of the paged machinery, and must give the same greedy tokens as the
    request served through :class:`ServeEngine` in that mode.  Chunked
    prefill rounds interior rows differently; its oracle is
    :func:`chunked_cold_reference`.  The prompt's tokens are fed from the
    device and the tokens read back once, at the end (a drain point: the
    oracle is a whole serve, its readback the stream's boundary)."""
    dev = params["embed"].device
    total = len(prompt) + max_new_tokens
    cache = bundle.init_cache(1, total, device=dev)
    feed = torch.tensor(prompt, dtype=torch.int32).to(dev)
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
    # the temperature as a device tensor, filled once per device: a Python
    # scalar divisor may be turned into a product with its reciprocal on
    # the card (one ulp from the CPU's quotient), and a copy from the host
    # would wait for the device
    temps = {}

    def sample(logits, req_ids, token_idx):
        dev = logits.device
        if dev not in temps:
            temps[dev] = torch.full((), temp, dtype=torch.float32,
                                    device=dev)
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
    # async pipelining: entries of ``generated`` whose value is still on
    # the device (None placeholders, filled in dispatch order at
    # retirement).  The count len(generated) advances at dispatch, so
    # finish, budget and policy decisions never wait for a readback.
    pending: int = 0
    # speculation: True from dispatching this request's verify to its
    # retirement; the accepted count is on the device, so the request sits
    # the plans out meanwhile (its cursor and ``generated`` frozen)
    verifying: bool = False
    # tenant attribution: quota accounting, priority class, telemetry
    tenant: str = DEFAULT_TENANT
    priority: str = "throughput"

    @property
    def total_len(self) -> int:
        return len(self.prompt) + self.max_new_tokens

    def pages_needed(self, page_size: int) -> int:
        # positions 0..total_len-2 are written (the final token is
        # returned, never fed back)
        return math.ceil(max(self.total_len - 1, 1) / page_size)


# (request, index into its ``generated``, index into the step's outputs)
_Emit = Tuple[Request, int, int]


@dataclasses.dataclass
class _InflightStep:
    """One dispatched engine step whose outputs are not read back yet.

    ``parts`` are the step's int32 device outputs in order (the prefill's
    first tokens, then the decode tokens or a verify's ``g`` flattened and
    its ``m``); :meth:`ServeEngine._ship` concatenates them and copies them
    to the host at dispatch (``host``; pinned memory and an ``event`` on a
    card).  ``emits`` and ``spec_rows`` say where each value goes, fixed at
    dispatch, so retirement is a fill-in."""

    step_no: int
    parts: List[torch.Tensor] = dataclasses.field(default_factory=list)
    size: int = 0
    emits: List[_Emit] = dataclasses.field(default_factory=list)
    # a verify: (request, drafts k, index of g[slot, 0], index of m[slot])
    spec_rows: List[Tuple[Request, int, int, int]] = dataclasses.field(
        default_factory=list)
    host: Optional[torch.Tensor] = None
    event: Optional["torch.cuda.Event"] = None

    def add(self, t: torch.Tensor) -> int:
        """Append a 1-D output; returns its offset in the step's outputs."""
        base = self.size
        self.parts.append(t)
        self.size += t.numel()
        return base


def params_to(params: dict, device) -> dict:
    """The parameter tree on ``device``; the same tree where it already
    lies there (no copy)."""
    if params["embed"].device == device:
        return params

    def move(tree):
        return {k: move(v) if isinstance(v, dict)
                else v.to(device, non_blocking=True)
                for k, v in tree.items()}
    return move(params)


class _PoolIO:
    """The model axis's pool boundary around one device call (the
    reference's ``_make_pool_io``): :meth:`expand` all-gathers every
    sharded leaf of a :class:`~repro_torch.runtime.paged_cache.ShardedPool`
    along its split dim, in rank order; the engine slices this rank's part
    of the updated pool back (``shard_pool``).  Pure data movement: the
    step between them is the one-device step on the whole pool.  On a card
    gloo takes host tensors, so :meth:`expand` stages the leaves through
    pinned host memory, and the copy to the host waits for the device:
    every device call of a sharded engine synchronizes here, so the model
    axis cannot pipeline (``pipeline_depth`` overlaps nothing on it).
    ``stage_s`` sums over ``calls`` the seconds spent staging and in
    gloo, as ``collectives.WIRE`` times them on the host (the wait for
    the device's earlier work is not in it)."""

    def __init__(self, group, device: torch.device):
        self.group = group
        self.device = device
        self.calls = 0
        self.stage_s = 0.0

    @_drain_point
    def expand(self, pool) -> dict:
        before = WIRE.stage_s + WIRE.wire_s
        full = {name: all_gather(x, pool.shardings[name].dim, self.group)
                for name, x in pool.items()}
        self.stage_s += WIRE.stage_s + WIRE.wire_s - before
        self.calls += 1
        return full


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
    instance).  Draft quality moves latency only, never output bits;
    ``pipeline_depth`` steps kept in flight ahead of their readback (0 =
    synchronous, 1 = async pipelining; module doc); ``on_token(request,
    index, token)`` called as each token is read back, in dispatch order
    (one step behind dispatch at depth 1; :meth:`drain` flushes);
    ``telemetry`` a :class:`~repro_torch.runtime.telemetry.Telemetry`
    (bit-neutral); ``mesh`` a :class:`~repro_torch.launch.mesh.Mesh` whose
    axes other than ``model`` have size 1: the pool is kv-head-sharded over
    its model axis (module doc).

    Without a mesh the engine runs on the device its parameters live on;
    with one, on this rank's cell of the mesh, the parameters copied there
    if they lie elsewhere.
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
                 sample_seed: int = 0, speculate: int = 0, draft="ngram",
                 pipeline_depth: int = 0,
                 on_token: Optional[Callable[[Request, int, int], None]] = None,
                 telemetry: Optional[Telemetry] = None,
                 mesh: Optional[Mesh] = None):
        if not bundle.supports_paged:
            raise ValueError(
                f"family {bundle.cfg.family!r} has no paged serving path; "
                "use the dense cache (launch/serve.py default)"
            )
        self.bundle = bundle
        self.mesh = mesh
        if mesh is None:
            self.device = params["embed"].device
        else:
            if any(n > 1 for a, n in mesh.shape.items() if a != "model"):
                raise ValueError(
                    f"a ServeEngine shards over the model axis only, got "
                    f"{mesh.shape}; EngineReplicaGroup serves the data axis")
            self.device = mesh.devices.reshape(-1)[mesh.axis_rank("model")]
        self.params = params_to(params, self.device)
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
        # the model axis: this rank keeps its kv heads' part of the pool,
        # and every device call goes through the pool boundary
        self.pool_io = None
        self.pool_kv_heads = bundle.cfg.n_kv_heads
        if model_axis_size(mesh) > 1:
            shardings = pool_shardings(mesh, self.pool, bundle.cfg.n_kv_heads)
            if not next(iter(shardings.values())).is_fully_replicated:
                self.pool = shard_pool(self.pool, shardings)
                self.pool_io = _PoolIO(mesh.axis_group("model"),
                                      self.device)
                self.pool_kv_heads //= model_axis_size(mesh)
        self.telemetry = telemetry
        metrics = telemetry.metrics if telemetry is not None else None
        self.allocator = PageAllocator(self.num_pages, metrics=metrics)
        self.prefix_cache = (
            RadixPrefixCache(self.allocator, self.page_size, metrics=metrics)
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
        if pipeline_depth < 0:
            raise ValueError(
                f"pipeline_depth must be >= 0, got {pipeline_depth}"
            )
        self.pipeline_depth = int(pipeline_depth)
        self.on_token = on_token
        self.cancellations = 0
        # dispatched steps not retired yet, oldest first; at most
        # pipeline_depth of them at the end of every step()
        self._inflight: deque = deque()

    # ------------------------------------------------------------- queue --

    def submit(self, prompt, max_new_tokens: int,
               req_id: Optional[int] = None, *,
               tenant: str = DEFAULT_TENANT,
               priority: str = "throughput") -> Request:
        """Enqueue a request; admission happens inside :meth:`step`.
        ``tenant`` and ``priority`` (one of ``PRIORITY_CLASSES``) are read
        by the tenant policy and the per-tenant telemetry only.  Raises
        ValueError for a bad label or a request that could never be
        served."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if not tenant or not isinstance(tenant, str):
            raise ValueError(f"tenant must be a non-empty string: {tenant!r}")
        if priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"priority must be one of {PRIORITY_CLASSES}, got {priority!r}"
            )
        if req_id is None:
            req_id = self._req_counter
        self._req_counter = max(self._req_counter + 1, req_id + 1)
        r = Request(req_id=req_id, prompt=prompt, max_new_tokens=max_new_tokens,
                    tenant=tenant, priority=priority)
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
        if self.telemetry is not None:
            self.telemetry.on_submit(r.req_id, self.steps, tenant=r.tenant,
                                     priority=r.priority)
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
            pending_tokens=r.pending,
            tenant=r.tenant,
            priority=r.priority,
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
        if self.telemetry is not None:
            self.telemetry.on_admit(r.req_id, self.steps,
                                    resumed=r.preempt_count > 0)
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
        if self.telemetry is not None:
            self.telemetry.on_admission_blocked(self.steps)
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
        # preemption records the victim's token VALUES for replay: the one
        # plan decision that needs them, so the pipeline drains first (the
        # trigger above is count-based)
        self.drain()
        # the drain may have finished the victim (a retiring verify's
        # accepted count reached max_new_tokens): its pages are free already
        if victim.state == RUNNING:
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
        generated tokens for replay (on the host: the caller drained the
        pipeline), and re-queue it at the BACK of the queue (a paged-out
        request yields its seniority)."""
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
        if self.telemetry is not None:
            self.telemetry.on_preempt(r.req_id, self.steps, tenant=r.tenant)

    def _finish(self, r: Request, step: Optional[int] = None) -> None:
        """Finish a request; ``step`` stamps a finish decided at retirement
        (a verify's accepted count) with the step that dispatched it, as
        the synchronous engine records it."""
        self._release_slot(r)
        r.state = FINISHED
        r.finish_step = self.steps if step is None else step
        self.finished[r.req_id] = r
        if self.telemetry is not None:
            self.telemetry.on_finish(r.req_id, r.finish_step,
                                     tenant=r.tenant)

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

    # ------------------------------------------------- retire / cancel --

    @_drain_point
    def _retire_one(self) -> None:
        """Read the OLDEST in-flight step back: wait for its event, fill
        the placeholders it dispatched and fire ``on_token`` in dispatch
        order (prefill completions, then decode rows), then a verify's
        accepted tokens with the cursor advance, the tallies and the finish
        they decide.  The engine's one per-token readback; at depth 1 it
        runs after the next step was dispatched.

        The one site that stamps ``first_token_step``: the step that
        DISPATCHED a request's first token, so the stamp is the same at
        every depth, and a resumed request keeps its original stamp."""
        st = self._inflight.popleft()
        if st.event is not None:
            st.event.synchronize()
        vals = st.host.tolist() if st.host is not None else []
        tel = self.telemetry
        emitted = 0
        by_tenant: Dict[str, int] = {}
        for r, gen_idx, at in st.emits:
            tok = int(vals[at])
            r.generated[gen_idx] = tok
            r.pending -= 1
            emitted += 1
            by_tenant[r.tenant] = by_tenant.get(r.tenant, 0) + 1
            if gen_idx == 0 and r.first_token_step < 0:
                r.first_token_step = st.step_no
                if tel is not None:
                    tel.on_first_token(r.req_id, r.submit_step, st.step_no,
                                       tenant=r.tenant)
            if self.on_token is not None:
                self.on_token(r, gen_idx, tok)
        for r, k, g_at, m_at in st.spec_rows:
            m = int(vals[m_at])
            gen_idx0 = len(r.generated)
            for j in range(m):
                tok = int(vals[g_at + j])
                r.generated.append(tok)
                emitted += 1
                by_tenant[r.tenant] = by_tenant.get(r.tenant, 0) + 1
                if self.on_token is not None:
                    self.on_token(r, gen_idx0 + j, tok)
            r.cursor += m
            r.verifying = False
            self.spec_accepted += m - 1
            rb_pages = 0
            if m <= k:
                # a draft was rejected: its pages were restored on the device
                self.spec_rollbacks += 1
                c0 = r.cursor - m
                rb_pages = len({(c0 + j) // self.page_size
                                for j in range(m, k + 1)})
            if tel is not None:
                tel.on_spec_retire(k, m - 1, rb_pages)
            if len(r.generated) >= r.max_new_tokens:
                self._finish(r, step=st.step_no)
        if emitted and tel is not None:
            tel.on_tokens_emitted(emitted, by_tenant=by_tenant)

    def _retire_backlog(self) -> None:
        """Retire down to ``pipeline_depth`` steps in flight (the tail of
        every :meth:`step`; depth 0 = synchronous)."""
        while len(self._inflight) > self.pipeline_depth:
            self._retire_one()

    @_drain_point
    def drain(self) -> None:
        """Retire every in-flight step: the pipeline barrier (stream
        boundaries, preemption's replay record, :meth:`cancel`)."""
        while self._inflight:
            self._retire_one()

    def cancel(self, req_id: int) -> bool:
        """Cancel a request mid-stream (a client disconnect).  A waiting
        request leaves the queue; a running one is released through
        :meth:`_release_slot` after the pipeline is drained (so no
        retirement touches it later): its full prompt pages are donated to
        the prefix cache, the rest freed.  Returns True if the request was
        live, False otherwise - also when the drain's verify finished it."""
        for r in self.waiting:
            if r.req_id == req_id:
                self.waiting.remove(r)
                self._cancelled(r)
                return True
        r = next((s for s in self._slots
                  if s is not None and s.req_id == req_id), None)
        if r is None:
            return False
        self.drain()
        if r.state != RUNNING:
            return False
        self._release_slot(r)
        self._cancelled(r)
        return True

    def _cancelled(self, r: Request) -> None:
        r.state = CANCELLED
        r.finish_step = self.steps
        self.cancellations += 1
        if self.telemetry is not None:
            self.telemetry.on_cancel(r.req_id, self.steps)

    # -------------------------------------------------------------- step --

    @property
    def num_running(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def idle(self) -> bool:
        """No queued work, no live request and no step in flight: a
        ``while not eng.idle: eng.step()`` loop ends with every
        placeholder read back, at every depth."""
        return (not self.waiting and self.num_running == 0
                and not self._inflight)

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        """A copy of a host array on the engine's device, never waiting for
        the device: on a card through pinned memory with ``non_blocking``
        (the caching host allocator keeps the pinned block until the copy
        has run); on the CPU a copy, so a later plan's writes to ``arr``
        cannot reach a step in flight."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        t = t.pin_memory() if self.device.type == "cuda" else t.clone()
        return t.to(self.device, non_blocking=True)

    def _ship(self, st: _InflightStep) -> None:
        """Queue the step for retirement with its outputs copied to the
        host: one int32 vector, into pinned memory with ``non_blocking``
        and a CUDA event on a card."""
        if st.parts:
            out = torch.cat(st.parts) if len(st.parts) > 1 else st.parts[0]
            if out.device.type == "cuda":
                st.host = torch.empty(out.shape, dtype=out.dtype,
                                      pin_memory=True)
                st.host.copy_(out, non_blocking=True)
                st.event = torch.cuda.Event()
                st.event.record()
            else:
                st.host = out
        st.parts = []
        self._inflight.append(st)

    def _sample_rows(self, pairs):
        """(request id, token index) int32 rows of the sampler, or None
        when the engine is greedy; a row whose pair is None (a dead or pad
        row) gets zeros - its sample is never read."""
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

    def _on_pool(self, call):
        """Run one device call ``call(pool) -> (out, pool)`` on the whole
        pool (through the pool boundary on a sharded pool); returns
        ``out``.  The call is a manual region (``launch.sharding``): every
        rank runs the one-device step, whatever mesh is active."""
        with manual_region():
            if self.pool_io is None:
                out, self.pool = call(self.pool)
                return out
            sharded = self.pool
            out, full = call(self.pool_io.expand(sharded))
        self.pool = shard_pool(full, sharded.shardings)
        return out

    def _run_prefill(self, plan, st: _InflightStep):
        """Dispatch one batched prefill call over the planned chunk rows;
        every index tensor is made before the call.  A row whose chunk
        ends its prompt gets its first token as a placeholder emission, and
        (unless it replays a recorded token) that token moves into
        ``_next_dev`` on the device for this step's decode.  Returns
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
        # slots whose first token feeds this step's decode on the device:
        # the prefill row each one takes it from
        take = np.zeros((self.max_batch,), bool)
        src = np.zeros((self.max_batch,), np.int64)
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
            if c0 + real >= len(r.prompt) and not r.replay:
                take[r.slot] = True
                src[r.slot] = i
        rows_key = self._sample_rows(pairs)
        args = [self._tensor(x) for x in (tokens, start, kv_len, last)]
        table_t = self._tensor(table)
        take_t = self._tensor(take) if take.any() else None
        src_t = self._tensor(src) if take_t is not None else None
        logits = self._on_pool(lambda pool: self.bundle.paged_prefill_step(
            self.params, *args, pool, table_t))
        self.prefill_calls += 1
        first = self._pick(logits, rows_key)
        base = st.add(first)
        if take_t is not None:
            self._next_dev = torch.where(
                take_t, first.index_select(0, src_t), self._next_dev)
        completed = []
        for i, (r, real) in enumerate(rows):
            r.prefill_pos += real
            if r.prefill_pos < len(r.prompt):
                continue
            # this chunk held the last prompt token: its logits row is the
            # first generated token
            st.emits.append((r, len(r.generated), base + i))
            r.generated.append(None)           # filled at retirement
            r.pending += 1
            completed.append(r)
            if r.replay:
                # a resumed request feeds its recorded token (bit-equal to
                # the one just recomputed): a host-known value
                self._next_token[r.slot] = r.replay[0]
                self._next_known[r.slot] = True
            else:
                # the same step's decode consumes it on the device
                self._next_known[r.slot] = False
            if len(r.generated) >= r.max_new_tokens:
                self._finish(r)
        return sum(real for _, real in rows), completed

    def _compose_feed(self) -> torch.Tensor:
        """This step's decode inputs: host-known tokens over the on-device
        sampled ones, in one ``torch.where`` (exact; no readback).  The
        host rows are copied (:meth:`_tensor`), so the arrays may change
        while the step is in flight."""
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
        drafter reads the materialized history; tokens still on the device
        (``pending``: a step in flight, or the first token of a prompt that
        ended in this step's prefill call) are skipped over (``skip``), as
        the reference's drafter does."""
        cands, drafts = [], {}
        for r in dec:
            remaining = r.max_new_tokens - len(r.generated)
            if remaining < 2 or len(r.generated) < len(r.replay):
                continue
            hist = r.prompt + r.generated[:len(r.generated) - r.pending]
            d = self._drafter.propose(
                hist, min(self.speculate, remaining - 1), skip=r.pending
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

    def _run_decode(self, dec: List[Request], st: _InflightStep,
                    spec_plan=()):
        """Dispatch one batched decode call over the decoding slots, or,
        when a row has drafts (``spec_plan``), one verify call of K + 1
        sub-steps in which every other decoding row is active at sub-step
        0 only (that sub-step is its plain decode).  Then the optimistic
        host advance: cursors, placeholder tokens and finishes by count;
        a verifying row freezes until its retirement."""
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
        mask = np.zeros((self.max_batch,), bool)
        mask[list(dec_slots)] = True
        feed = self._compose_feed()
        rows = self._sample_rows(pairs)
        mask_t, pos_t, table_t = (self._tensor(x) for x in (mask, pos, table))
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
            active_t = self._tensor(active)

            def verify(pool):
                *out, pool = paged_verify_step(
                    self.bundle.paged_serve_step, self.params, tokens, pos_t,
                    active_t, pool, table_t, page_size=self.page_size,
                    choose=lambda logits, i: self._pick(logits, rows, i),
                )
                return out, pool

            nxt, g, m = self._on_pool(verify)
            self.verify_calls += 1
            n_draft = sum(n for _, n, _ in spec_plan)
            self.spec_proposed += n_draft
            self.spec_verify_steps += len(spec_plan)
            if self.telemetry is not None:
                self.telemetry.on_spec_dispatch(len(spec_plan), n_draft)
            g_base = st.add(g.reshape(-1))
            m_base = st.add(m)
            at = lambda slot: g_base + slot * (k + 1)    # g[slot, 0]
            for r, n, _ in spec_plan:
                st.spec_rows.append((r, n, at(r.slot), m_base + r.slot))
        else:
            logits = self._on_pool(lambda pool: self.bundle.paged_serve_step(
                self.params, feed, pos_t, pool, table_t))
            self.decode_calls += 1
            nxt = self._pick(logits, rows)
            base = st.add(nxt)
            at = lambda slot: base + slot
        # decoding slots keep their sampled token (a verify row: its last
        # accepted one) on the device for the next step's feed; the others
        # keep their value
        self._next_dev = torch.where(mask_t, nxt, feed)
        spec_ids = {r.req_id for r, _, _ in spec_plan}
        for r in dec:
            if r.req_id in spec_ids:
                # cursor, tokens and finish wait for the accepted count
                r.verifying = True
                self._next_known[r.slot] = False
                continue
            p = r.cursor
            r.cursor += 1
            if not self.chunked_prefill and p + 1 < len(r.prompt):
                self._next_token[r.slot] = r.prompt[p + 1]  # teacher forcing
                self._next_known[r.slot] = True
                continue
            gen_idx = len(r.generated)
            st.emits.append((r, gen_idx, at(r.slot)))
            r.generated.append(None)           # filled at retirement
            r.pending += 1
            if gen_idx < len(r.replay):
                self._next_token[r.slot] = r.replay[gen_idx]
                self._next_known[r.slot] = True
            else:
                self._next_known[r.slot] = False   # the value is on the device
            if len(r.generated) >= r.max_new_tokens:
                self._finish(r)

    def step(self) -> int:
        """One engine step: the host PLAN (trim, admission and preemption,
        the policy's grants, page-table assembly), the DISPATCH of the
        batched prefill call and one batched decode (or verify) call with
        the host's optimistic advance, then the retirement of any step
        beyond ``pipeline_depth`` (depth 0: this very step).  Returns the
        number of requests live this step; ``steps`` advances on every
        call."""
        tel = self.telemetry
        t0 = tel.clock() if tel is not None else 0.0
        self._maybe_trim()
        self._try_admit()
        t_plan = tel.clock() if tel is not None else 0.0
        live = [r for r in self._slots if r is not None]
        if not live:
            self._account_step_tokens(0)
            # nothing to dispatch, nothing to overlap: drain, so a
            # ``while not eng.idle`` loop ends with every token read back
            self.drain()
            if tel is not None:
                tel.end_step(self, t0, t_plan, t_plan, 0)
            self.steps += 1
            return 0
        st = _InflightStep(step_no=self.steps)
        spec_plan = []
        prefill_spent = 0
        if self.chunked_prefill:
            prefilling = [r for r in live if r.prefill_pos < len(r.prompt)]
            # a row whose verify is in flight sits this plan out and spends
            # no budget
            n_verifying = sum(r.verifying for r in live)
            completed = []
            if prefilling:
                plan = self._policy.plan_prefill(
                    [self._view(r) for r in prefilling],
                    n_decode=len(live) - len(prefilling) - n_verifying,
                    budget=self.step_token_budget,
                    chunk=self.prefill_chunk, page_size=self.page_size,
                    max_rows=self.prefill_batch,
                )
                if plan:
                    prefill_spent, completed = self._run_prefill(plan, st)
            dec = [
                r for r in self._slots
                if r is not None and r.prefill_pos >= len(r.prompt)
                and not r.verifying
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
        if dec:
            self._run_decode(dec, st, spec_plan)
            self._ship(st)
        elif st.emits:
            # a prefill-only step (its completions' decodes were deferred)
            # still owes their first tokens
            self._ship(st)
        elif prefill_spent == 0:
            # only verifying rows are live and nothing was dispatched: at
            # depth >= 1 the backlog alone would never retire them
            self.drain()
        t_disp = tel.clock() if tel is not None else 0.0
        self._retire_backlog()
        if tel is not None:
            tel.end_step(self, t0, t_plan, t_disp, len(live))
        self.steps += 1
        return len(live)

    def run_to_completion(self, max_steps: int = 100_000) -> Dict[int, Request]:
        """Drive :meth:`step` until queue, slots and pipeline drain
        (``max_steps`` bounds this call)."""
        start = self.steps
        while not self.idle:
            if self.steps - start >= max_steps:
                raise RuntimeError(f"engine did not drain in {max_steps} steps")
            self.step()
        self.drain()   # the stream's boundary: read back the last tokens
        return self.finished

    def metrics_snapshot(self) -> Optional[dict]:
        """The metrics registry's scrape payload (plain JSON-serializable
        dicts), or None without telemetry or its metrics layer."""
        if self.telemetry is None:
            return None
        return self.telemetry.metrics_snapshot()

    def stats(self) -> dict:
        """The reference's ``stats()`` at schema :data:`STATS_SCHEMA`,
        every key always present (the prefix cache's sub-dict is None when
        it is off; ``spec`` is zeros when speculation is off;
        ``cache_bytes`` is the whole pool, ``cache_bytes_per_device`` this
        rank's part), plus
        the port's device call counts: a verify call (K + 1 decode
        sub-steps) counts in ``verify_calls``, not in ``decode_calls``."""
        return {
            "schema": STATS_SCHEMA,
            "steps": self.steps,
            "running": self.num_running,
            "waiting": len(self.waiting),
            "finished": len(self.finished),
            "free_pages": self.allocator.free_pages,
            "live_pages": self.allocator.live_pages,
            "cache_bytes": paged_bytes(self.pool),
            "cache_bytes_per_device": paged_bytes_per_device(self.pool),
            "page_size": self.page_size,
            "pool_dtype": pool_dtype_name(self.cache_dtype),
            "chunked_prefill": self.chunked_prefill,
            "scheduler": self._policy.name,
            "prefill_batch": self.prefill_batch,
            "step_token_budget": self.step_token_budget,
            "preemptions": self.preemptions,
            "trimmed_pages": self.trimmed_pages,
            "temperature": self.temperature,
            "last_step_tokens": self.last_step_tokens,
            "max_step_tokens": self.max_step_tokens,
            "pipeline_depth": self.pipeline_depth,
            "inflight": len(self._inflight),
            "cancellations": self.cancellations,
            "speculate": self.speculate,
            "spec": {
                "proposed": self.spec_proposed,
                "accepted": self.spec_accepted,
                "rollbacks": self.spec_rollbacks,
                "verify_steps": self.spec_verify_steps,
            },
            "prefix_cache": (
                None if self.prefix_cache is None
                else self.prefix_cache.stats()
            ),
            "prefill_calls": self.prefill_calls,
            "decode_calls": self.decode_calls,
            "verify_calls": self.verify_calls,
        }


class EngineReplicaGroup:
    """Data-parallel paged serving over a ``(data, model)`` mesh (the
    reference's group of the same name).

    One :class:`ServeEngine` replica per ``data`` row, each serving from
    its own page pool, kv-head-sharded over that row's ``model`` ranks
    (``ServeEngine(mesh=...)``); requests from one logical queue are
    routed across replicas.  Replicas share nothing on the device but the
    weights: each device's cells take one copy of the parameters, made
    only where they do not lie yet, so D replicas on one card share it.
    A request's stream is the one-engine serve's bit for bit: routing
    changes only which pool holds its pages, and a decode reads only its
    own page-table row.  Every rank of the model axis runs the same
    routing on the same host state, so the ranks agree with no message.

    ``routing``:

      * ``"affinity"`` (default): probe every replica's prefix trie
        (:meth:`RadixPrefixCache.probe_len`, a pure read) and send the
        request to a replica holding the longest cached prefix of its
        prompt, least-loaded among those; with no cached prefix anywhere
        (or the prefix cache off), least-loaded.  A burst that shares a
        system prompt lands on the replica that holds its pages.
      * ``"least"``: fewest waiting + running requests, ties broken by a
        rotating cursor: a burst onto idle replicas deals ``i::n``
        exactly, and after a :meth:`cancel` or an early finish the next
        requests fill the gap.
      * ``"rr"``: strict rotation whatever the load.

    Request ids are group-global (the ids one engine serving the same
    submission order would assign), so a sampled stream does not depend
    on where its request lands, and :meth:`cancel` finds the owner.
    """

    def __init__(self, bundle, params, mesh: Mesh, *, telemetry=None,
                 routing: str = "affinity", **engine_kwargs):
        names = mesh.axis_names
        if not set(names) <= {"data", "model"}:
            raise ValueError(
                f"EngineReplicaGroup needs a (data, model) mesh; got axes "
                f"{names}")
        if routing not in ROUTING_MODES:
            raise ValueError(
                f"routing must be one of {ROUTING_MODES}, got {routing!r}")
        n_data = mesh.shape.get("data", 1)
        n_model = mesh.shape.get("model", 1)
        # the row-major (data, model) grid whatever the axis order
        devs = np.array(mesh.devices, dtype=object)
        if names and names[0] == "model" and "data" in names:
            devs = devs.T
        devs = devs.reshape(n_data, n_model)
        self.meshes = [Mesh({"model": n_model}, devs[i], groups=mesh.groups,
                            coords=mesh.coords)
                       for i in range(n_data)]
        # one copy of the weights per device
        copies = {}
        for m in self.meshes:
            dev = m.devices[m.axis_rank("model")]
            if dev not in copies:
                copies[dev] = params_to(params, dev)
        # per-replica telemetry children share the group's tracer (events
        # carry the replica index) and keep their own registries;
        # metrics_snapshot() aggregates them
        self.telemetry = telemetry
        self.engines = [
            ServeEngine(
                bundle, copies[m.devices[m.axis_rank("model")]], mesh=m,
                telemetry=(None if telemetry is None
                           else telemetry.for_replica(i)),
                **engine_kwargs)
            for i, m in enumerate(self.meshes)
        ]
        self.routing = routing
        self._rr = 0
        self._req_counter = 0
        self._owner: Dict[int, ServeEngine] = {}

    @property
    def n_replicas(self) -> int:
        return len(self.engines)

    # ----------------------------------------------------------- routing --

    def _load(self, eng: ServeEngine) -> int:
        """A replica's outstanding work in requests: queued + holding a
        slot."""
        return len(eng.waiting) + eng.num_running

    def _pick_least_loaded(self, cands: List[int]) -> int:
        """The least-loaded candidate; ties go to the first at or after
        the rotating cursor, so equal loads deal round-robin."""
        lo = min(self._load(self.engines[i]) for i in cands)
        tied = [i for i in cands if self._load(self.engines[i]) == lo]
        pick = min(tied, key=lambda i: (i - self._rr) % len(self.engines))
        self._rr = pick + 1
        return pick

    def _route(self, prompt) -> ServeEngine:
        n = len(self.engines)
        if self.routing == "rr":
            pick = self._rr % n
            self._rr += 1
            return self.engines[pick]
        cands = list(range(n))
        if self.routing == "affinity":
            probes = [0 if e.prefix_cache is None
                      else e.prefix_cache.probe_len(prompt)
                      for e in self.engines]
            best = max(probes)
            if best > 0:
                cands = [i for i in cands if probes[i] == best]
        return self.engines[self._pick_least_loaded(cands)]

    def submit(self, prompt, max_new_tokens: int, *,
               tenant: str = DEFAULT_TENANT,
               priority: str = "throughput") -> Request:
        """Route one request from the logical queue; its id is
        group-global."""
        prompt = [int(t) for t in prompt]
        eng = self._route(prompt)
        rid = self._req_counter
        self._req_counter += 1
        r = eng.submit(prompt, max_new_tokens, req_id=rid, tenant=tenant,
                       priority=priority)
        self._owner[r.req_id] = eng
        return r

    def cancel(self, req_id: int) -> bool:
        """Cancel a request on whichever replica owns it
        (:meth:`ServeEngine.cancel`)."""
        eng = self._owner.get(req_id)
        return False if eng is None else eng.cancel(req_id)

    def drain(self) -> None:
        """The pipeline barrier of every replica."""
        for e in self.engines:
            e.drain()

    @property
    def idle(self) -> bool:
        return all(e.idle for e in self.engines)

    def step(self) -> int:
        """Advance every replica one engine step, idle ones included, so
        each replica's ``steps`` clock advances on every call.  At
        ``pipeline_depth`` 1 no replica waits for another's readback: each
        retires its own backlog."""
        return sum(e.step() for e in self.engines)

    def run_to_completion(self, max_steps: int = 100_000):
        """Drive every replica, interleaved, until all drain
        (``max_steps`` bounds this call on each replica's clock); returns
        ``{(replica, req_id): Request}`` of the finished requests."""
        start = max(e.steps for e in self.engines)
        while not self.idle:
            if max(e.steps for e in self.engines) - start >= max_steps:
                raise RuntimeError(
                    f"replica group did not drain in {max_steps} steps")
            self.step()
        self.drain()
        return {(i, rid): r for i, e in enumerate(self.engines)
                for rid, r in e.finished.items()}

    def metrics_snapshot(self) -> Optional[dict]:
        """The replicas' metrics aggregated (counters and histograms
        summed, gauges summed but ``*_max``); None without telemetry."""
        if self.telemetry is None:
            return None
        return self.telemetry.metrics_snapshot()

    def stats(self) -> dict:
        """:meth:`ServeEngine.stats` aggregated over the replicas by
        ``_STATS_SUM`` / ``_STATS_MAX`` / ``_STATS_CONFIG`` (the port's
        call counts summed too), plus ``replicas`` and the per-replica
        dicts under ``engines``."""
        per = [e.stats() for e in self.engines]
        out = {"schema": STATS_SCHEMA, "replicas": len(per)}
        for key in _STATS_SUM + ("prefill_calls", "decode_calls",
                                 "verify_calls"):
            out[key] = sum(s[key] for s in per)
        for key in _STATS_MAX:
            out[key] = max(s[key] for s in per)
        for key in _STATS_CONFIG:
            out[key] = per[0][key]
        out["spec"] = {k: sum(s["spec"][k] for s in per)
                       for k in per[0]["spec"]}
        out["prefix_cache"] = (
            None if per[0]["prefix_cache"] is None
            else {k: sum(s["prefix_cache"][k] for s in per)
                  for k in per[0]["prefix_cache"]})
        out["engines"] = per
        return out
