"""Generic LRU+TTL cache with hit statistics.

CacheService (`common/cacheService.ts`, 300 LoC): bounded LRU with per-entry
TTL and hit/miss counters. Used by the system-message cache (45 s,
convertToLLMMessageService.ts), directory-string cache (60 s), and file
content cache (30 s / 20 entries) — same TTLs recorded in
context/token_config.py DIRECTORY_OPTIMIZATION.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Generic, Optional, Tuple, TypeVar

V = TypeVar("V")


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    expirations: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class LRUTTLCache(Generic[V]):
    def __init__(self, max_size: int = 100,
                 default_ttl_s: Optional[float] = 60.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.max_size = max_size
        self.default_ttl_s = default_ttl_s
        self._clock = clock
        self._data: OrderedDict[Any, Tuple[V, Optional[float]]] = \
            OrderedDict()
        self.stats = CacheStats()

    def get(self, key: Any) -> Optional[V]:
        item = self._data.get(key)
        if item is None:
            self.stats.misses += 1
            return None
        value, expires = item
        if expires is not None and self._clock() >= expires:
            del self._data[key]
            self.stats.expirations += 1
            self.stats.misses += 1
            return None
        self._data.move_to_end(key)
        self.stats.hits += 1
        return value

    def put(self, key: Any, value: V,
            ttl_s: Optional[float] = None) -> None:
        ttl = self.default_ttl_s if ttl_s is None else ttl_s
        expires = self._clock() + ttl if ttl is not None else None
        if key in self._data:
            self._data.move_to_end(key)
        self._data[key] = (value, expires)
        while len(self._data) > self.max_size:
            self._data.popitem(last=False)
            self.stats.evictions += 1

    def get_or_compute(self, key: Any, fn: Callable[[], V],
                       ttl_s: Optional[float] = None) -> V:
        v = self.get(key)
        if v is None:
            v = fn()
            self.put(key, v, ttl_s)
        return v

    def invalidate(self, key: Any) -> None:
        self._data.pop(key, None)

    def clear(self) -> None:
        self._data.clear()

    def __len__(self) -> int:
        return len(self._data)
