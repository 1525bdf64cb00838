"""Paged KV cache, host side: the ref-counted page allocator and the block
tables with their copy-on-write discipline, a copy of the JAX package's
`kernels/paged_cache.py` (pure numpy). The device side, the block-table
gather and writes, is in `models/attention.py`; the paged decode kernel
is `kernels.ops.flash_decode_paged`.

  - `PageAllocator`: ref-counted free-list allocator. Page 0 is the
    reserved TRASH page: every decode step writes the K/V of *inactive*
    slots too, at a stale position; their table rows point every block at
    page 0, which absorbs those writes and is never read unmasked. Frees
    are LIFO and the free list is seeded in ascending order, so the page
    sequence depends only on the call sequence.
  - `BlockTables`: the (H, n_blocks) int32 table plus the copy-on-write
    discipline. `fork_row` shares a prefix by bumping refcounts (GRPO
    prefix sharing: prefill once, fork G rollouts); `ensure_writable`
    enforces the invariant that a page with refcount > 1 is never
    written: the writer first gets a fresh page and the device copies the
    old page's contents.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

TRASH_PAGE = 0


class OutOfPages(RuntimeError):
    """The pool has no free page. The engine reacts by deferring
    admission or preempting a sequence — never by corrupting a page."""


class PageAllocator:
    """Ref-counted page pool. Page 0 (TRASH_PAGE) is reserved forever.

    Deterministic: the free list is seeded ascending and reused LIFO, so
    the page sequence depends only on the alloc/free call order.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError(f"need >= 2 pages (1 is the trash page), "
                             f"got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.refcount = np.zeros(n_pages, np.int32)
        # pop() yields 1, 2, 3, ... on a fresh pool
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        # counters (page-costed admission + telemetry)
        self.total_allocs = 0
        self.cow_copies = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        """Pages currently referenced by at least one block-table entry."""
        return self.n_pages - 1 - len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise OutOfPages(f"all {self.n_pages - 1} pages live")
        p = self._free.pop()
        assert self.refcount[p] == 0, f"free-list page {p} has refs"
        self.refcount[p] = 1
        self.total_allocs += 1
        return p

    def share(self, p: int) -> None:
        """One more block-table entry references page p (COW fork)."""
        if p == TRASH_PAGE:
            raise ValueError("cannot share the trash page")
        if self.refcount[p] <= 0:
            raise ValueError(f"share of dead page {p}")
        self.refcount[p] += 1

    def release(self, p: int) -> None:
        """Drop one reference; the page returns to the pool at zero."""
        if p == TRASH_PAGE:
            raise ValueError("cannot release the trash page")
        if self.refcount[p] <= 0:
            raise ValueError(f"double free of page {p}")
        self.refcount[p] -= 1
        if self.refcount[p] == 0:
            self._free.append(p)

    def check(self) -> None:
        """Conservation invariants (exercised by the property suite)."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate page in free list"
        assert TRASH_PAGE not in free, "trash page leaked into free list"
        assert self.refcount[TRASH_PAGE] == 0
        for p in range(1, self.n_pages):
            if p in free:
                assert self.refcount[p] == 0, f"free page {p} has refs"
            else:
                assert self.refcount[p] > 0, f"page {p} leaked (0 refs, " \
                    f"not free)"
        assert self.free_pages + self.live_pages == self.n_pages - 1


class BlockTables:
    """(H, n_blocks) block table + the copy-on-write write discipline.

    Entry 0 means "unallocated": reads of such blocks are always masked
    by per-slot lengths, and writes from inactive slots land on the
    trash page by construction.
    """

    def __init__(self, n_slots: int, n_blocks: int, alloc: PageAllocator):
        self.alloc = alloc
        self.n_blocks = int(n_blocks)
        self.table = np.zeros((n_slots, n_blocks), np.int32)

    # ---- queries -------------------------------------------------------
    def blocks_for(self, n_positions: int) -> int:
        """Blocks needed to cover ring positions [0, n_positions)."""
        if n_positions <= 0:
            return 0
        ps = self.alloc.page_size
        return -(-min(n_positions, self.n_blocks * ps) // ps)

    def owned_pages(self, s: int) -> List[int]:
        return [int(p) for p in self.table[s] if p != TRASH_PAGE]

    # ---- mutation (all invariant-preserving) ---------------------------
    def alloc_prefix(self, s: int, n_blocks: int) -> int:
        """Allocate fresh pages for blocks [0, n_blocks) of row s (prompt
        admission). Rolls back on pool exhaustion. Returns pages taken."""
        taken: List[Tuple[int, int]] = []
        try:
            for j in range(n_blocks):
                assert self.table[s, j] == TRASH_PAGE, (s, j)
                p = self.alloc.alloc()
                self.table[s, j] = p
                taken.append((j, p))
        except OutOfPages:
            for j, p in taken:
                self.alloc.release(p)
                self.table[s, j] = TRASH_PAGE
            raise
        return len(taken)

    def fork_row(self, dst: int, src: int) -> int:
        """dst shares every allocated block of src (refcount bump, no
        copy) — GRPO prefix sharing. Returns #blocks shared."""
        n = 0
        for j in range(self.n_blocks):
            p = int(self.table[src, j])
            if p == TRASH_PAGE:
                continue
            self.alloc.share(p)
            self.table[dst, j] = p
            n += 1
        return n

    def ensure_writable(self, s: int, j: int) -> Optional[Tuple[int, int]]:
        """Make block j of row s safe to write: allocate if unallocated,
        COW if shared. Returns (src_page, dst_page) when the caller must
        copy page contents on device (COW), else None. The invariant this
        enforces: no write ever lands on a page with refcount > 1."""
        p = int(self.table[s, j])
        if p == TRASH_PAGE:
            self.table[s, j] = self.alloc.alloc()
            return None
        if self.alloc.refcount[p] > 1:
            q = self.alloc.alloc()       # may raise OutOfPages: no state
            #                              was mutated yet, caller retries
            self.alloc.refcount[p] -= 1  # >1 before, so never hits 0
            self.table[s, j] = q
            self.alloc.cow_copies += 1
            return (p, q)
        return None

    def release_row(self, s: int) -> int:
        """Free every allocated block of row s (rollout finished, slot
        preempted, or engine killed). Returns #refs dropped."""
        n = 0
        for j in range(self.n_blocks):
            p = int(self.table[s, j])
            if p == TRASH_PAGE:
                continue
            self.alloc.release(p)
            self.table[s, j] = TRASH_PAGE
            n += 1
        return n

    def check(self) -> None:
        """Cross-check table refcounts against the allocator (property
        suite): every page's refcount equals the number of table entries
        referencing it."""
        refs = np.zeros(self.alloc.n_pages, np.int64)
        vals, counts = np.unique(self.table, return_counts=True)
        refs[vals] = counts
        refs[TRASH_PAGE] = 0
        np.testing.assert_array_equal(refs, self.alloc.refcount)
        self.alloc.check()
