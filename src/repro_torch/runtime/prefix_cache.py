"""Radix prefix cache: shared prompt-prefix K/V pages over the page pool.

Counterpart of ``repro.runtime.prefix_cache``.

A trie over token ids at **page granularity**: each edge is the tuple of
``page_size`` token ids that fills one KV page, and each node owns one
physical page of the :class:`~repro_torch.runtime.paged_cache
.PageAllocator` pool holding the **raw** (unshifted) K/V - or, on an
8-bit pool, the codes and the per-page sidecars - of those positions.
PASA's pseudo-average shift happens inside the attention kernels at read
time, and the chunk-exact prefill computes every full page's K/V as a
function of the token prefix alone, whatever chunk schedule produced it:
so a cache-hit prefill is bit-identical to a cold one.

Only FULL pages are shared: the rows of a partial tail page are computed
over the column set ``col < prompt_len``, which depends on the requesting
prompt's length.  The engine matches at most ``len(prompt) - 1`` tokens,
so the last prompt position is always computed (its logits are the first
generated token) and the partial page stays private (copy-on-write).

Ownership and refcounts (the engine side is runtime/engine.py):

  * pages enter the cache via :meth:`insert` when a request finishes or
    is paged out - the request DONATES its full prompt pages; pages whose
    prefix the cache already holds are not adopted and the caller frees
    them;
  * :meth:`match` takes a reference on every matched node and
    :meth:`release` drops it: a running request holds references to
    exactly the cached pages in its page table, so eviction never frees a
    page a sequence still reads;
  * :meth:`evict` frees LRU refcount-0 leaves back to the allocator; an
    interior node goes only after its children.

The allocator counts cached pages as live; ``evictable_pages`` is the
slack admission may reclaim on demand.  Donation moves page ids only:
the bytes (and sidecars) stay where the prefill wrote them.  Under async
pipelining (engine ``pipeline_depth >= 1``) donation and recycling need
no deferral: every write to the pool is enqueued on one stream, so a
page's earlier writes land before any later step reads or rewrites it.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

from repro_torch.runtime.paged_cache import PageAllocator


@dataclasses.dataclass
class _Node:
    """One cached page: edge = the page's token tuple, payload = page id."""

    tokens: Tuple[int, ...]
    page: int
    parent: Optional["_Node"]
    children: Dict[Tuple[int, ...], "_Node"] = dataclasses.field(
        default_factory=dict
    )
    refcount: int = 0
    last_use: int = 0
    # Sum of refcounts over this node's subtree (self included); the node
    # is reclaimable by evict() exactly when it is 0.
    subtree_refs: int = 0


class RadixPrefixCache:
    """Page-granular radix tree of prompt prefixes over ``allocator``."""

    def __init__(self, allocator: PageAllocator, page_size: int,
                 metrics=None):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.allocator = allocator
        self.page_size = int(page_size)
        self._root = _Node(tokens=(), page=-1, parent=None)
        self._clock = 0
        self._nodes = 0
        self._evictable = 0    # cached count, kept exact incrementally
        self.traversals = 0    # full-trie walks
        # monotone counters (stats)
        self.hits = 0          # pages served from cache across all matches
        self.misses = 0        # pages a match could not serve
        self.evictions = 0
        self.donations = 0     # pages adopted from finish / page-out / cancel
        # optional runtime.telemetry.MetricsRegistry mirror of the
        # counters above (prefix.* names)
        self.metrics = metrics

    # ------------------------------------------------------------- sizing --

    @property
    def cached_pages(self) -> int:
        return self._nodes

    @property
    def evictable_pages(self) -> int:
        """Pages evict() could free now (refcount-0 subtrees).  O(1): a
        counter kept on every ref/deref, insert and evict, since admission
        probes it on every page-short attempt;
        :meth:`_evictable_pages_dfs` is the reference the tests hold it
        to."""
        return self._evictable

    def _evictable_pages_dfs(self) -> int:
        """Slow reference for :attr:`evictable_pages` (tests only)."""
        self.traversals += 1

        def walk(node: _Node):
            # (subtree node count, reclaimable nodes in subtree)
            kids_size = kids_free = 0
            for c in node.children.values():
                s, f = walk(c)
                kids_size += s
                kids_free += f
            mine = 1 if node.refcount == 0 and kids_free == kids_size else 0
            return 1 + kids_size, kids_free + mine

        return sum(walk(c)[1] for c in self._root.children.values())

    def _bump_subtree(self, n: _Node, delta: int) -> None:
        """subtree_refs += delta on one node, tracking 0 <-> nonzero
        transitions in the evictable counter."""
        if delta == 0:
            return
        old = n.subtree_refs
        n.subtree_refs = old + delta
        if old == 0:
            self._evictable -= 1
        elif n.subtree_refs == 0:
            self._evictable += 1

    def _deref(self, node: _Node) -> None:
        node.refcount -= 1
        n = node
        while n is not None and n is not self._root:
            self._bump_subtree(n, -1)
            n = n.parent

    def _bump_chain(self, nodes: List[_Node], sign: int) -> None:
        """refcount +-1 on every node of a parent->child chain in one
        root-path walk: the node at chain index i gains ``sign * (len -
        i)`` subtree references, every strict ancestor of the head
        ``sign * len``."""
        length = len(nodes)
        for i, n in enumerate(nodes):
            n.refcount += sign
            self._bump_subtree(n, sign * (length - i))
        a = nodes[0].parent
        while a is not None and a is not self._root:
            self._bump_subtree(a, sign * length)
            a = a.parent

    @staticmethod
    def _is_chain(nodes: List[_Node]) -> bool:
        return all(
            nodes[i + 1].parent is nodes[i] for i in range(len(nodes) - 1)
        )

    # ------------------------------------------------------------ matching --

    def _walk(self, tokens) -> List[_Node]:
        out = []
        node = self._root
        for start in range(0, len(tokens) - self.page_size + 1,
                           self.page_size):
            edge = tuple(int(t) for t in tokens[start:start + self.page_size])
            nxt = node.children.get(edge)
            if nxt is None:
                break
            out.append(nxt)
            node = nxt
        return out

    def probe_len(self, tokens) -> int:
        """Length in tokens of the longest cached page prefix of
        ``tokens``: a pure read for the replica group's prefix-affinity
        routing (:class:`~repro_torch.runtime.engine.EngineReplicaGroup`).
        Unlike :meth:`match` it takes no reference, does not move the
        eviction clock and counts no hit or miss: a router probes every
        replica's trie per submission, and only the chosen replica's
        admission counts and pins anything."""
        return len(self._walk(tokens)) * self.page_size

    def match(self, tokens, max_tokens: Optional[int] = None) -> List[_Node]:
        """Longest cached page-prefix of ``tokens`` (at most ``max_tokens``
        tokens); takes a reference on every returned node, which the
        caller must :meth:`release`.  Leaves the hit/miss counters alone:
        a page-starved admission retries every step, so the engine counts
        an admitted request once, with :meth:`record_match`."""
        nodes = self._walk(tokens)
        if max_tokens is not None:
            nodes = nodes[: max(0, int(max_tokens)) // self.page_size]
        self._clock += 1
        if nodes:
            self._bump_chain(nodes, 1)   # _walk returns a root-path chain
            for n in nodes:
                n.last_use = self._clock
        return nodes

    def record_match(self, tokens, nodes: List[_Node],
                     max_tokens: Optional[int] = None) -> None:
        """Count one request's served and missed pages (the arguments of
        the :meth:`match` call it mirrors)."""
        self.hits += len(nodes)
        want = (len(tokens) if max_tokens is None
                else min(len(tokens), int(max_tokens))) // self.page_size
        missed = max(0, want - len(nodes))
        self.misses += missed
        if self.metrics is not None:
            if nodes:
                self.metrics.counter("prefix.hits").inc(len(nodes))
            if missed:
                self.metrics.counter("prefix.misses").inc(missed)

    def release(self, nodes: List[_Node]) -> None:
        for n in nodes:
            if n.refcount <= 0:
                raise ValueError(
                    f"release of unreferenced cache node (page {n.page})"
                )
        if nodes and self._is_chain(nodes):
            self._bump_chain(nodes, -1)   # exactly what match() returned
        else:
            for n in nodes:
                self._deref(n)

    # ----------------------------------------------------------- insertion --

    def insert(self, tokens, pages: List[int]) -> List[int]:
        """Donate the pages backing ``tokens`` (full pages only).

        ``pages[i]`` holds the K/V of ``tokens[i*page : (i+1)*page]`` at
        the chunk-exact convention.  Returns the page ids the cache
        ADOPTED; pages of prefixes it already held stay with the caller,
        who frees them."""
        n_full = len(tokens) // self.page_size
        if len(pages) < n_full:
            raise ValueError(
                f"{n_full} full pages of tokens but only {len(pages)} pages"
            )
        adopted: List[int] = []
        node = self._root
        self._clock += 1
        for i in range(n_full):
            edge = tuple(int(t) for t in
                         tokens[i * self.page_size:(i + 1) * self.page_size])
            nxt = node.children.get(edge)
            if nxt is None:
                nxt = _Node(tokens=edge, page=int(pages[i]), parent=node,
                            last_use=self._clock)
                node.children[edge] = nxt
                self._nodes += 1
                self._evictable += 1   # fresh node: subtree_refs == 0
                adopted.append(int(pages[i]))
            else:
                nxt.last_use = self._clock
            node = nxt
        self.donations += len(adopted)
        if self.metrics is not None and adopted:
            self.metrics.counter("prefix.donations").inc(len(adopted))
        return adopted

    # ------------------------------------------------------------ eviction --

    def evict(self, n_pages: int) -> int:
        """Free up to ``n_pages`` refcount-0 LRU leaves to the allocator;
        returns how many were freed.  Evicting a leaf may expose its
        parent as the next candidate.  One trie traversal plus a heap."""
        freed = 0
        self.traversals += 1
        heap = [
            (node.last_use, id(node), node)
            for node in _iter_subtree(self._root)
            if node is not self._root
            and not node.children and node.refcount == 0
        ]
        heapq.heapify(heap)
        while freed < n_pages and heap:
            _, _, victim = heapq.heappop(heap)
            parent = victim.parent
            del parent.children[victim.tokens]
            self.allocator.free([victim.page])
            self._nodes -= 1
            self._evictable -= 1   # a leaf in the heap has subtree_refs == 0
            self.evictions += 1
            freed += 1
            if (parent is not self._root and not parent.children
                    and parent.refcount == 0):
                heapq.heappush(heap, (parent.last_use, id(parent), parent))
        if self.metrics is not None and freed:
            self.metrics.counter("prefix.evictions").inc(freed)
        return freed

    def stats(self) -> dict:
        return {
            "cached_pages": self.cached_pages,
            "evictable_pages": self.evictable_pages,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "donations": self.donations,
        }


def _iter_subtree(node: _Node):
    yield node
    for c in list(node.children.values()):
        yield from _iter_subtree(c)
