"""Paged KV-cache bookkeeping: page pool allocator + per-request tables.

A copy of ``repro.serving.paging``'s allocator (numpy only; the port does
not import the reference).  Position ``t`` of a request lives at
``(table[t // page_size], t % page_size)``.  Page 0 is the trash page:
never allocated, the target of every padded table lane.  Tables handed to
the device are padded to a power-of-two width.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["TRASH_PAGE", "PageAllocator", "PageTable", "pages_needed",
           "pad_pow2"]

TRASH_PAGE = 0


def pages_needed(length: int, page_size: int) -> int:
    """Pages required to hold ``length`` tokens (ceil division)."""
    return max(0, (length + page_size - 1) // page_size)


def _pow2_up(n: int) -> int:
    return 1 << (max(n, 1) - 1).bit_length()


def pad_pow2(n: int, lo: int = 1, hi: int | None = None) -> int:
    """Round ``n`` up to a power-of-two bucket in ``[lo, hi]``.  Always a
    power of two >= n: ``hi`` is a soft cap that never under-allocates."""
    b = max(_pow2_up(lo), _pow2_up(n))
    if hi is not None:
        hi_pow = 1 << max(hi, 1).bit_length() - 1       # pow2 floor of hi
        b = min(b, max(hi_pow, _pow2_up(n)))
    return b


class PageAllocator:
    """Free-list allocator over ``num_pages`` physical pages; page 0 is
    reserved.  ``alloc`` is all-or-nothing."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        # LIFO: recently freed pages are reused first
        self._free = list(range(num_pages - 1, 0, -1))
        self._allocated: set[int] = set()

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        if n < 0:
            raise ValueError(n)
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._allocated.update(pages)
        return pages

    def free(self, pages: list[int]) -> None:
        for p in pages:
            if p not in self._allocated:
                raise ValueError(f"double free / foreign page {p}")
            self._allocated.discard(p)
            self._free.append(p)


@dataclass
class PageTable:
    """One request's logical -> physical page mapping."""
    page_size: int
    pages: list[int] = field(default_factory=list)

    def ensure(self, length: int, allocator: PageAllocator) -> bool:
        """Grow to hold ``length`` tokens; False (unchanged) when the pool
        cannot supply the missing pages."""
        need = pages_needed(length, self.page_size) - len(self.pages)
        if need <= 0:
            return True
        got = allocator.alloc(need)
        if got is None:
            return False
        self.pages.extend(got)
        return True

    def release(self, allocator: PageAllocator) -> None:
        allocator.free(self.pages)
        self.pages = []

    def padded(self, width: int) -> np.ndarray:
        """Physical ids padded with the trash page to ``width`` entries."""
        if len(self.pages) > width:
            raise ValueError(f"table has {len(self.pages)} pages > "
                             f"bucket width {width}")
        out = np.full((width,), TRASH_PAGE, np.int32)
        out[:len(self.pages)] = self.pages
        return out
