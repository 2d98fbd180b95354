"""Disk cache and weighted LRU of the port's serving registry.

A copy of ``repro.serve.cache``.  One flat directory of pickle files keyed
by a caller-supplied string.  The location defaults to ``<repo>/.cache``
(ignored by git — artifacts are regenerated deterministically on first
use) and can be redirected with the ``REPRO_CACHE`` environment variable,
as the reference's.  The port's registry keeps its own files in the
``repro_torch`` subdirectory of it (:data:`NAMESPACE`): both packages name
a graph ``gcngraph_<hash>``, and a reference pickle would import ``jax``
when unpickled.
"""

from __future__ import annotations

import os
import pickle
from collections import OrderedDict
from typing import Any, Callable, Iterator, Optional, Tuple

#: The port's subdirectory of a cache directory shared with the reference.
NAMESPACE = "repro_torch"


class LruDict:
    """Weighted LRU map: the in-memory half of every artifact cache here.

    ``capacity`` bounds the *total weight* of resident entries (weights
    default to 1.0, so an unweighted LruDict is a plain max-entries LRU).
    Reads and writes touch recency; inserting past capacity evicts
    least-recently-used entries — but never the entry just inserted, so a
    single over-budget value still loads.  ``on_evict(key, value)`` fires
    for each capacity eviction (not for explicit ``pop``), which is where
    dependent caches drop their rows.
    """

    def __init__(
        self,
        capacity: float,
        *,
        on_evict: Optional[Callable[[Any, Any], None]] = None,
    ):
        if capacity <= 0:
            raise ValueError(f"capacity must be > 0, got {capacity}")
        self.capacity = float(capacity)
        self.on_evict = on_evict
        self._data: "OrderedDict[Any, Any]" = OrderedDict()
        self._weights: dict = {}
        self.total_weight = 0.0
        self.evictions = 0

    def __contains__(self, key: Any) -> bool:
        return key in self._data

    def __len__(self) -> int:
        return len(self._data)

    def __iter__(self) -> Iterator:
        return iter(self._data)

    def get(self, key: Any, default: Any = None) -> Any:
        if key not in self._data:
            return default
        self._data.move_to_end(key)
        return self._data[key]

    def __getitem__(self, key: Any) -> Any:
        self._data.move_to_end(key)
        return self._data[key]

    def put(self, key: Any, value: Any, weight: float = 1.0) -> None:
        if key in self._data:
            self.total_weight -= self._weights[key]
        self._data[key] = value
        self._data.move_to_end(key)
        self._weights[key] = float(weight)
        self.total_weight += float(weight)
        while self.total_weight > self.capacity and len(self._data) > 1:
            old_key, old_val = self._data.popitem(last=False)
            self.total_weight -= self._weights.pop(old_key)
            self.evictions += 1
            if self.on_evict is not None:
                self.on_evict(old_key, old_val)

    def pop(self, key: Any, default: Any = None) -> Any:
        if key not in self._data:
            return default
        self.total_weight -= self._weights.pop(key)
        return self._data.pop(key)

    def keys(self):
        return self._data.keys()

    def values(self):
        return self._data.values()

    def items(self):
        return self._data.items()


_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
)


def default_cache_dir() -> str:
    env = os.environ.get("REPRO_CACHE")
    if env:
        return env
    # Four levels up is the repo root only for an src-layout checkout or
    # editable install; from site-packages fall back to a user cache dir.
    if os.path.isdir(os.path.join(_REPO_ROOT, "src", "repro_torch")):
        return os.path.join(_REPO_ROOT, ".cache")
    return os.path.join(os.path.expanduser("~"), ".cache", "repro")


def cache_path(key: str, cache_dir: Optional[str] = None) -> str:
    return os.path.join(cache_dir or default_cache_dir(), f"{key}.pkl")


def load_pickle(key: str, cache_dir: Optional[str] = None) -> Tuple[Any, bool]:
    """Return ``(obj, True)`` on a hit, ``(None, False)`` on a miss."""
    path = cache_path(key, cache_dir)
    if not os.path.exists(path):
        return None, False
    with open(path, "rb") as f:
        return pickle.load(f), True


def store_pickle(key: str, obj: Any, cache_dir: Optional[str] = None) -> str:
    path = cache_path(key, cache_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f, protocol=4)
    os.replace(tmp, path)  # atomic: concurrent readers never see a torn file
    return path


def disk_memo(
    key: str, builder: Callable[[], Any], cache_dir: Optional[str] = None
) -> Tuple[Any, bool]:
    """Load ``key`` from disk, or build + persist it.  Returns (obj, hit)."""
    obj, hit = load_pickle(key, cache_dir)
    if hit:
        return obj, True
    obj = builder()
    store_pickle(key, obj, cache_dir)
    return obj, False
