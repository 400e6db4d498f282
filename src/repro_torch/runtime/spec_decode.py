"""Host-side draft proposers for self-speculative decoding (the port's
own copy of ``repro.runtime.spec_decode``).

The engine's verify path (``ServeEngine`` with ``speculate=K``) accepts
the longest draft prefix that matches the model's own greedy argmax
(or the seeded sampler at temperature > 0), and restores the KV bytes
of every rejected position on device.  Accepted tokens therefore always
equal the non-speculative trajectory bit-for-bit — **draft quality only
affects latency, never output**.  That freedom is what lets the
proposers here stay trivially cheap: pure-Python suffix matching over
the request's own prompt + generated history, no second model, no
device work.

``propose(history, k, skip=0)`` returns at most ``k`` draft tokens
predicted to FOLLOW ``history``.  ``skip`` is for tokens of the true
history that are not host-visible yet: the engine passes the
materialized prefix and asks the proposer to start ``skip`` positions
further into its continuation (a guess-on-a-guess; still bit-safe, see
above).  The port's synchronous engine has one such token: the first
token of a request whose prompt ended in the same step's prefill call,
still on the device when that step drafts.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Type


class DraftProposer:
    """Interface for host-side draft token proposers."""

    name = "base"

    def propose(self, history: Sequence[int], k: int,
                skip: int = 0) -> List[int]:
        raise NotImplementedError


class NgramProposer(DraftProposer):
    """Prompt-lookup / n-gram drafting (arXiv:2304.04487 flavour).

    Match the longest recent suffix of ``history`` (length
    ``max_ngram`` down to ``min_ngram``) against earlier occurrences in
    ``history`` itself; the tokens that followed the MOST RECENT match
    become the draft.  Repetitive and templated workloads (code, JSON,
    chat boilerplate) hit constantly; random text simply proposes
    nothing and the engine falls back to plain decode for that row.
    """

    name = "ngram"

    def __init__(self, min_ngram: int = 1, max_ngram: int = 4):
        if not (1 <= min_ngram <= max_ngram):
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"({min_ngram}, {max_ngram})"
            )
        self.min_ngram = int(min_ngram)
        self.max_ngram = int(max_ngram)

    def propose(self, history: Sequence[int], k: int,
                skip: int = 0) -> List[int]:
        hist = list(history)
        n = len(hist)
        want = k + skip
        if want <= 0 or n < self.min_ngram + 1:
            return []
        for size in range(min(self.max_ngram, n - 1), self.min_ngram - 1,
                          -1):
            suffix = hist[n - size:]
            # most recent earlier occurrence wins
            for start in range(n - size - 1, -1, -1):
                if hist[start:start + size] == suffix:
                    cont = hist[start + size:start + size + want]
                    if len(cont) > skip:
                        return cont[skip:skip + k]
                    break  # shorter n-gram may match somewhere useful
        return []


DRAFTERS: Dict[str, Type[DraftProposer]] = {
    "ngram": NgramProposer,
}


def get_drafter(draft) -> DraftProposer:
    """Resolve a proposer from a name, class, or ready instance."""
    if isinstance(draft, DraftProposer):
        return draft
    if isinstance(draft, type) and issubclass(draft, DraftProposer):
        return draft()
    try:
        return DRAFTERS[draft]()
    except KeyError:
        raise ValueError(
            f"unknown draft proposer {draft!r}; "
            f"known: {sorted(DRAFTERS)}"
        ) from None
