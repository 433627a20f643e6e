# Bounded LRU cache (capability parity with reference
# src/aiko_services/main/utilities/lru_cache.py:22-47), used for audio
# sliding windows and the recorder's per-topic ring buffers.

from __future__ import annotations

from collections import OrderedDict

__all__ = ["LRUCache"]


class LRUCache:
    def __init__(self, size: int):
        self.size = size
        self._cache = OrderedDict()

    def get(self, key, default=None):
        if key in self._cache:
            self._cache.move_to_end(key)
            return self._cache[key]
        return default

    def put(self, key, value) -> None:
        if key in self._cache:
            self._cache.move_to_end(key)
        self._cache[key] = value
        while len(self._cache) > self.size:
            self._cache.popitem(last=False)

    def delete(self, key) -> None:
        self._cache.pop(key, None)

    def keys(self):
        return list(self._cache.keys())

    def values(self):
        return list(self._cache.values())

    def items(self):
        return list(self._cache.items())

    def __len__(self):
        return len(self._cache)

    def __contains__(self, key):
        return key in self._cache
