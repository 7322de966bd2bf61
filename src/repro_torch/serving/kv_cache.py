"""Paged KV cache bookkeeping (host side). The port's own copy of
``repro.serving.kv_cache``, unchanged in logic.

The device side is the per-layer page pools built by
``repro_torch.models.transformer.init_serving_state``: [P, page_size, Hkv,
Dh] tensors whose first axis is indexed by *physical page id* (this
module's domain). This module owns
everything about which pages belong to whom:

- ``PageAllocator``  : reference-counted free-list over physical ids 1..P-1
                       (page 0 is the null page — a write sink for inactive
                       slots, never owned by a sequence). A full page whose
                       K/V is shared by N sequences (prefix caching) is stored
                       once and carries N holds; it returns to the free list
                       only when the last hold drops.
- ``PagedCacheState``: per-slot page table + sequence length, mirrored as
                       numpy on the host (mutated cheaply every step) and
                       shipped to the device as two small int32 arrays.

Live KV memory is ``pages_in_use * page_size`` tokens instead of the dense
cache's ``num_slots * max_len`` — the memory math behind continuous batching —
and with prefix sharing the physical page count drops below the logical
``sum(seq_lens) / page_size`` (see README §Serving).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

NULL_PAGE = 0


def pages_needed(num_tokens: int, page_size: int) -> int:
    return -(-num_tokens // page_size)


class PageAllocator:
    """All-or-nothing, reference-counted free-list allocator over page ids.

    Page 0 is reserved (null page). ``alloc`` either returns exactly ``n``
    distinct pages (each with one hold) or None — admission control refuses
    rather than partially allocating. ``incref`` adds a hold to a live page
    (copy-on-write sharing); ``free`` drops one hold per page and recycles a
    page only when its last hold is gone.
    """

    def __init__(self, num_pages: int):
        assert num_pages >= 2, "need at least one real page beyond the null page"
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, NULL_PAGE, -1))
        self._refs: Dict[int, int] = {}

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        """Distinct live pages (shared pages count once — the dedup metric)."""
        return len(self._refs)

    def ref_count(self, page: int) -> int:
        return self._refs.get(page, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n < 0:
            raise ValueError(n)
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for pg in pages:
            self._refs[pg] = 1
        return pages

    def incref(self, page: int) -> None:
        if page == NULL_PAGE or page not in self._refs:
            raise ValueError(f"incref on unallocated page {page}")
        self._refs[page] += 1

    def free(self, pages: List[int]) -> None:
        """Drop one hold per page; recycle pages whose last hold dropped."""
        for pg in pages:
            if pg == NULL_PAGE or pg not in self._refs:
                raise ValueError(f"freeing unallocated page {pg}")
            self._refs[pg] -= 1
            if self._refs[pg] == 0:
                del self._refs[pg]
                self._free.append(pg)


@dataclasses.dataclass
class PagedCacheState:
    """Per-slot page-table/length state for a fixed decode batch."""

    num_slots: int
    max_pages_per_seq: int
    page_size: int

    def __post_init__(self):
        self.page_table = np.zeros((self.num_slots, self.max_pages_per_seq),
                                   np.int32)
        self.seq_lens = np.zeros((self.num_slots,), np.int32)

    # -- slot lifecycle ----------------------------------------------------------
    def assign(self, slot: int, pages: List[int], seq_len: int) -> None:
        assert self.seq_lens[slot] == 0 and not self.page_table[slot].any(), \
            f"slot {slot} not recycled"
        assert len(pages) <= self.max_pages_per_seq, (len(pages), slot)
        assert len(pages) >= pages_needed(seq_len, self.page_size)
        self.page_table[slot, :len(pages)] = pages
        self.seq_lens[slot] = seq_len

    def append_page(self, slot: int, page: int) -> None:
        row = self.page_table[slot]
        n = int((row != NULL_PAGE).sum())
        assert n < self.max_pages_per_seq, f"slot {slot} page table full"
        row[n] = page

    def release(self, slot: int) -> List[int]:
        """Clear a slot; returns its pages for the caller to free."""
        row = self.page_table[slot]
        pages = [int(p) for p in row[row != NULL_PAGE]]
        row[:] = NULL_PAGE
        self.seq_lens[slot] = 0
        return pages

    # -- queries -----------------------------------------------------------------
    def allocated_pages(self, slot: int) -> int:
        return int((self.page_table[slot] != NULL_PAGE).sum())

    def needs_page(self, slot: int) -> bool:
        """True if the *next* token's position falls past the allocated pages."""
        pos = int(self.seq_lens[slot])
        return pos // self.page_size >= self.allocated_pages(slot)

    @property
    def live_tokens(self) -> int:
        return int(self.seq_lens.sum())
