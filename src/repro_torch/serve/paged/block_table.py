"""Per-slot block table: logical page index → physical page id.

One `BlockTable` per engine slot. Logical token position `pos` lives in
logical page `pos // page_size`; the table maps that to a physical page of
the pool (-1 = unmapped). The table is the ONLY place the logical→physical
translation exists — the model's Top-K/feedback state stays logical, and
the jitted step receives the stacked tables as the `page_table` array.
"""

from __future__ import annotations

from typing import List

import numpy as np


class BlockTable:
    """Logical→physical page map for one slot (host side)."""

    def __init__(self, num_logical_pages: int):
        self.num_logical_pages = int(num_logical_pages)
        self._pages = np.full((self.num_logical_pages,), -1, np.int32)

    def get(self, logical_page: int) -> int:
        """Physical page id, or -1 when unmapped."""
        return int(self._pages[logical_page])

    def map(self, logical_page: int, phys_page: int) -> None:
        self._pages[logical_page] = phys_page

    def unmap(self, logical_page: int) -> int:
        """Drop one mapping; returns the physical id that was mapped (the
        caller decrefs it), or -1 when it was already unmapped. Used by the
        speculative-decode rollback (`rewind_slot`) to return pages mapped
        ahead of a rejected draft."""
        phys = int(self._pages[logical_page])
        self._pages[logical_page] = -1
        return phys

    def mapped(self) -> List[int]:
        """Physical ids of all mapped logical pages, in logical order."""
        return [int(p) for p in self._pages[self._pages >= 0]]

    def clear(self) -> List[int]:
        """Unmap everything; returns the physical ids that were mapped (the
        caller decrefs them against the pool)."""
        released = self.mapped()
        self._pages[:] = -1
        return released

    @property
    def row(self) -> np.ndarray:
        """The (num_logical_pages,) int32 row for the stacked device table."""
        return self._pages
