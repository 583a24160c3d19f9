"""Reference-counted shared-prefix cache over paged KV block runs.

RAG traffic repeats its expensive part: the retrieved-context prefix of
the prompt ("context : ... <sep>") recurs across every question asked
against the same top-k documents, while the question suffix is short
and unique.  With the paged KV cache a prefilled prefix is just a run
of pool blocks plus a one-row snapshot of the non-pooled state at the
prefix end — so a repeat request can *fork* those blocks (refcount
bump, copy-on-write on a mid-block tail) instead of re-prefilling.

Entries are keyed by the prefix token tuple (hash-based dict lookup)
and prefilled at canonical positions: left-padded to a multiple of the
engine's prefill chunk, so every fork sees identical relative positions
and the forked row's numerics match a solo run exactly.

The cache only does host-side bookkeeping (LRU order, stats, eviction
callbacks that return block refcounts to the ``BlockAllocator``); block
*contents* live in the session's device pool, which is why a cache is
scoped to one ``ContinuousSession``.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence


@dataclass
class PrefixEntry:
    """One prefilled prefix: its pool block run and resume state."""
    block_ids: List[int]      # pool blocks holding positions [0, length)
    length: int               # L0 = pad + prefix tokens (chunk multiple)
    pad: int                  # left-pad inside the run (= row "first")
    row_state: dict = field(repr=False)   # 1-row non-pooled snapshot


class PrefixCache:
    """LRU map: prefix token tuple -> ``PrefixEntry``.

    ``on_evict(entry)`` fires when an entry leaves the cache (capacity
    or explicit eviction) and should free the entry's block refcounts;
    blocks still forked into live rows stay alive through their own
    refcounts.
    """

    def __init__(self, capacity: int = 8,
                 on_evict: Optional[Callable[[PrefixEntry], None]] = None):
        if capacity < 1:
            raise ValueError(f"capacity={capacity} must be >= 1")
        self.capacity = int(capacity)
        self.on_evict = on_evict
        self._entries: "OrderedDict[tuple, PrefixEntry]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key_tokens: Sequence[int]) -> Optional[PrefixEntry]:
        """Stats-counting lookup (refreshes LRU position on hit)."""
        e = self._entries.get(tuple(key_tokens))
        if e is None:
            self.misses += 1
            return None
        self._entries.move_to_end(tuple(key_tokens))
        self.hits += 1
        return e

    def peek(self, key_tokens: Sequence[int]) -> Optional[PrefixEntry]:
        """Planning lookup: no hit/miss accounting, but still refreshes
        LRU position so admission planning can't evict the entry it is
        about to fork."""
        k = tuple(key_tokens)
        e = self._entries.get(k)
        if e is not None:
            self._entries.move_to_end(k)
        return e

    def put(self, key_tokens: Sequence[int], entry: PrefixEntry) -> None:
        k = tuple(key_tokens)
        if k in self._entries:          # racing double-prefill: keep old
            if self.on_evict:
                self.on_evict(entry)
            return
        self._entries[k] = entry
        while len(self._entries) > self.capacity:
            self.evict_lru()

    def evict_lru(self) -> bool:
        """Drop the least-recently-used entry (freeing its blocks via
        ``on_evict``); False when the cache is already empty."""
        if not self._entries:
            return False
        _, e = self._entries.popitem(last=False)
        self.evictions += 1
        if self.on_evict:
            self.on_evict(e)
        return True

    def clear(self) -> None:
        while self.evict_lru():
            pass

    def held_blocks(self) -> int:
        """Pool blocks currently pinned by cached entries."""
        return sum(len(e.block_ids) for e in self._entries.values())

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0
