"""Hot-row LRU cache (a copy of ``repro.serve.cache``).

Word frequencies are Zipfian, so a small set of rows absorbs most
lookups (the same skew the frequency-tiered engine exploits on the
write path). The cache sits *in front of* the coalescing batcher: a hit
never enqueues, a miss rides the next coalesced batch and is inserted
on completion.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Hashable


class LRUCache:
    """A plain ordered-dict LRU with hit/miss counters.

    Args:
        capacity: max entries; 0 disables caching (every ``get`` is a
            recorded miss, ``put`` is a no-op).

    Not thread-safe — it is only touched from the server's event loop.
    """

    def __init__(self, capacity: int):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.capacity = capacity
        self._d: OrderedDict[Hashable, object] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._d

    def get(self, key: Hashable):
        """The cached value (refreshing its recency) or ``None``."""
        if key in self._d:
            self._d.move_to_end(key)
            self.hits += 1
            return self._d[key]
        self.misses += 1
        return None

    def put(self, key: Hashable, value) -> None:
        """Insert/refresh ``key``, evicting the least-recently-used
        entry past capacity."""
        if self.capacity == 0:
            return
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def clear(self) -> None:
        """Drop all entries (counters survive — they describe the
        process lifetime, not one table version)."""
        self._d.clear()

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
