"""Block-paged KV memory for continuous batching: a fixed page pool plus
per-sequence page tables over the existing cache layout.

The device side is dead simple on purpose — ``mdl.init_paged_cache``
allocates each attention sublayer ONE flat pool of
``num_pages * page_size`` token rows (no batch dimension), and the jitted
paged decode step (``serve.engine.build_paged_serve_step``) reads/writes
it through a ``row_idx`` table.  ALL ownership bookkeeping lives here, on
the host, in plain numpy:

* :class:`KVPagePool` — the allocator.  Page 0 is the reserved TRASH
  page: idle scheduler slots park their page tables (and their write
  position) on it, so the fixed-shape decode step can always run the full
  slot batch — writes from idle slots collide harmlessly at row 0, which
  no live sequence ever owns.  ``alloc`` returns ``None`` instead of
  raising when the pool is exhausted: overload is a RESULT at this layer
  (the scheduler turns it into preemption), never an exception.
* :class:`PageTable` — one sequence's pages plus the flattened per-token
  ``row_idx`` row the decode step consumes (``row_idx[t]`` = pool row of
  token ``t``; unallocated tail rows point at the trash page).

Admission watermarks are the pool's job too: ``free_frac`` /
``used_frac`` are what the scheduler's admission gate and the
``EngineHealth.kv_used_frac`` load signal read.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class PageTable:
    """One sequence's view of the pool: its pages, in token order."""
    page_size: int
    max_kv: int                         # static row_idx width (tokens)
    pages: List[int] = dataclasses.field(default_factory=list)

    @property
    def capacity(self) -> int:
        return len(self.pages) * self.page_size

    def row_idx(self) -> np.ndarray:
        """(max_kv,) int32 pool row per token; trash-page rows past the
        allocated capacity (row 0 — never owned by a live sequence)."""
        out = np.zeros(self.max_kv, np.int32)
        n = min(self.capacity, self.max_kv)
        if n:
            pages = np.asarray(self.pages, np.int32)
            t = np.arange(n)
            out[:n] = pages[t // self.page_size] * self.page_size \
                + t % self.page_size
        return out


class KVPagePool:
    """Fixed-size page allocator for the flat paged KV cache.

    ``num_pages`` includes the reserved trash page 0, so ``usable_pages ==
    num_pages - 1``.  Free pages are handed out lowest-index first
    (deterministic — chaos tests replay allocation exactly)."""

    def __init__(self, num_pages: int, page_size: int):
        assert num_pages >= 2, "need at least one usable page plus trash"
        assert page_size >= 1
        self.num_pages = num_pages
        self.page_size = page_size
        self._free = list(range(num_pages - 1, 0, -1))  # pop() -> lowest

    @property
    def num_rows(self) -> int:
        return self.num_pages * self.page_size

    @property
    def usable_pages(self) -> int:
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_frac(self) -> float:
        return 1.0 - self.free_pages / max(self.usable_pages, 1)

    @property
    def free_frac(self) -> float:
        return self.free_pages / max(self.usable_pages, 1)

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` token rows."""
        return -(-max(n_tokens, 0) // self.page_size)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages, or return None (caller decides: queue,
        preempt, or reject — exhaustion is never an exception here)."""
        if n < 0 or n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: List[int]) -> None:
        for p in pages:
            assert 0 < p < self.num_pages, f"bad page {p}"
            assert p not in self._free, f"double free of page {p}"
            self._free.append(p)
        # keep hand-out order deterministic after frees interleave
        self._free.sort(reverse=True)
