"""Paged KV-cache pool: the pure-numpy allocator half.

The serving cache used to be a pool of whole-sequence slot rows: admitting
a request cost ``max_len`` tokens of cache no matter how short it was, and
the pool's concurrency ceiling was exactly ``slots`` rows.  This module
breaks that pool into fixed-size PAGES of ``page_size`` token positions
with an indirection table per request:

  * ``PagePool`` is the per-replica allocator - alloc/free lists, per-page
    refcounts, and per-uid page tables (the logical->physical indirection
    the device programs consume).  It is pure numpy/python bookkeeping: the
    scheduler core (serve/core.py) drives it at plan time and ships the
    resulting tables/maps INSIDE the existing PrefillPlan/ChunkedPlan/
    DecodePlan arrays, so the device side never adds a host round-trip and
    the multi-host coordinator broadcasts them like any other plan payload.
  * ``PrefixStore`` implements copy-on-write prefix sharing: full pages of
    a landed prompt are registered under their token-prefix key, and a
    later request whose prompt starts with the same tokens attaches those
    pages read-only (refcount + 1) instead of landing duplicates.  Only
    FULL pages strictly below every participant's write frontier are ever
    shared, so shared pages are immutable by construction; the allocator's
    ``ensure_writable`` (the COW arm) enforces that invariant before every
    decode write and copies a page out if a sharing policy ever aliases a
    frontier page.
  * ``SpillRecord`` carries a preempted request's page contents (plus its
    flat per-slot leaves) in host memory, so re-admission restores the
    cache instead of regenerating - the warm-resume path.

Page 0 of every pool is the DUMP page: it is never allocated and never
read (unallocated page-table entries are -1, which the device gather maps
turn into zero rows - bit-exactly the never-written region of a slot-row
cache).  Free slots still run the batched decode step on garbage rows
(a scheduler invariant); their write-back lands on page 0, which
nothing ever reads.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

DUMP_PAGE = 0


class PageError(RuntimeError):
    """Page allocation failed: the pool is out of free pages.  The
    scheduler catches this and either defers admission or preempts the
    youngest live request (serve/core.py)."""


def pages_for(tokens: int, page: int) -> int:
    """Pages needed to hold token positions [0, tokens)."""
    return -(-int(tokens) // page)


class PagePool:
    """Refcounted fixed-size-page allocator for ONE replica's cache pool.

    Physical page ids index the leading page axis of every paged cache
    leaf on the owning replica (replica-LOCAL ids, the same convention the
    scheduler's ``src_map`` scratch rows use).  A uid's table is its pages
    in logical order: entry j backs token positions [j*page, (j+1)*page).
    """

    def __init__(self, n_pages: int, pages_per_seq: int, page: int):
        assert n_pages >= pages_per_seq + 1, (
            f"pool of {n_pages} pages cannot hold one full sequence of "
            f"{pages_per_seq} pages plus the dump page")
        self.n_pages = int(n_pages)
        self.n_pp = int(pages_per_seq)
        self.page = int(page)
        self.refs = np.zeros((n_pages,), np.int32)
        self.refs[DUMP_PAGE] = 1                 # never allocated, never freed
        # LIFO free list: hot pages recycle first (better locality, and the
        # hypothesis suite exercises reuse-after-free aggressively)
        self._free: list[int] = list(range(n_pages - 1, 0, -1))
        self._tables: dict[int, list[int]] = {}
        # freed-page callback (the PrefixStore drops its entries there)
        self.on_free = None
        # COW callback: fired with (uid, src, dst) whenever ensure_writable
        # breaks a shared frontier page (the engine wires a telemetry
        # counter + structured event here; None = uninstrumented)
        self.on_cow = None
        self.stats = {"page_allocs": 0, "page_frees": 0, "cow_copies": 0}

    # ------------------------------------------------------------- accounting
    def free_pages(self) -> int:
        return len(self._free)

    def used_pages(self) -> int:
        return self.n_pages - 1 - len(self._free)

    def holds(self, uid: int) -> bool:
        return uid in self._tables

    def pages(self, uid: int) -> list[int]:
        return list(self._tables[uid])

    def n_owned(self, uid: int) -> int:
        return len(self._tables.get(uid, ()))

    # ------------------------------------------------------------- allocation
    def attach(self, uid: int) -> None:
        """Open an (empty) page table for a request being placed."""
        assert uid not in self._tables, f"uid {uid} already holds pages"
        self._tables[uid] = []

    def share(self, uid: int, page_ids: list[int]) -> None:
        """Attach already-populated pages read-only (prefix sharing): each
        gains a reference and extends the uid's table in logical order.
        Caller guarantees the pages sit strictly below the uid's write
        frontier (full pages of a common prompt prefix)."""
        tab = self._tables[uid]
        assert not tab, "shared prefix pages must come first in the table"
        for p in page_ids:
            assert 0 < p < self.n_pages and self.refs[p] > 0, p
            self.refs[p] += 1
            tab.append(int(p))

    def alloc(self, uid: int, k: int) -> list[int]:
        """Append k fresh (refcount-1) pages to the uid's table; raises
        ``PageError`` without side effects if the pool cannot supply k."""
        if k > len(self._free):
            raise PageError(
                f"uid {uid} needs {k} pages, pool has {len(self._free)} free "
                f"({self.used_pages()}/{self.n_pages - 1} in use)")
        tab = self._tables[uid]
        got = [self._free.pop() for _ in range(k)]
        for p in got:
            assert self.refs[p] == 0, (p, self.refs[p])
            self.refs[p] = 1
        tab.extend(got)
        self.stats["page_allocs"] += k
        return got

    def ensure_writable(self, uid: int, j: int) -> tuple[int, int] | None:
        """Copy-on-write arm: page j of the uid's table is about to be
        WRITTEN (the decode frontier).  If it is shared (refcount > 1),
        allocate a fresh page, swap it into the table, drop the old
        reference, and return ``(src, dst)`` so the engine can issue the
        device page copy.  Returns None when the page is already exclusive
        - the common case: full-prefix sharing never aliases a frontier
        page, so this arm is the invariant keeper a future fork/parallel-
        sampling policy would lean on."""
        tab = self._tables[uid]
        src = tab[j]
        if self.refs[src] == 1:
            return None
        dst = self.alloc_one_detached()
        self.refs[src] -= 1
        tab[j] = dst
        self.stats["cow_copies"] += 1
        if self.on_cow is not None:
            self.on_cow(uid, src, dst)
        return src, dst

    def alloc_one_detached(self) -> int:
        """One fresh refcount-1 page NOT appended to any table (COW swap)."""
        if not self._free:
            raise PageError("pool exhausted during copy-on-write")
        p = self._free.pop()
        assert self.refs[p] == 0
        self.refs[p] = 1
        self.stats["page_allocs"] += 1
        return p

    def release(self, uid: int) -> list[int]:
        """Drop the uid's table; pages reaching refcount 0 return to the
        free list (and fire ``on_free`` so the prefix store forgets them).
        Unknown uids are a no-op - every slot-release path funnels here."""
        tab = self._tables.pop(uid, None)
        if tab is None:
            return []
        freed: list[int] = []
        for p in tab:
            self.refs[p] -= 1
            assert self.refs[p] >= 0, p
            if self.refs[p] == 0:
                self._free.append(p)
                freed.append(p)
                if self.on_free is not None:
                    self.on_free(p)
        self.stats["page_frees"] += len(freed)
        return freed

    # ------------------------------------------------------------ device maps
    def table_row(self, uid: int | None) -> np.ndarray:
        """(n_pp,) int32 page-table row: allocated pages in logical order,
        -1 beyond (the device gather turns -1 into zero rows, matching the
        never-written region of a slot-row cache bit-exactly)."""
        row = np.full((self.n_pp,), -1, np.int32)
        if uid is not None and uid in self._tables:
            tab = self._tables[uid]
            row[:len(tab)] = tab
        return row

    def check(self) -> None:
        """Allocator invariants (the hypothesis suite calls this after
        every operation): refcounts equal table membership counts, free
        pages are unreferenced, nothing leaks, no double-free, and no two
        uids alias a writable (refcount-1) page."""
        counts = np.zeros_like(self.refs)
        counts[DUMP_PAGE] = 1
        for tab in self._tables.values():
            for p in tab:
                counts[p] += 1
        assert (counts == self.refs).all(), (counts, self.refs)
        free = set(self._free)
        assert len(free) == len(self._free), "double-free: duplicate free page"
        assert DUMP_PAGE not in free
        for p in free:
            assert self.refs[p] == 0, f"free page {p} still referenced"
        used = {p for tab in self._tables.values() for p in tab}
        assert not (used & free), "page both allocated and free"
        assert len(used) + len(free) + 1 == self.n_pages or \
            len(used | free) + 1 == self.n_pages


class PrefixStore:
    """Token-prefix -> page-ids index for copy-on-write prefix sharing.

    ``register`` records every FULL-page prefix of a landed prompt; a later
    ``lookup`` returns the longest registered prefix of its prompt.  Pages
    leave the store the moment the allocator frees them (``PagePool.on_free``
    wiring), so a hit can always be attached with ``PagePool.share``.
    Entries alias live pages only - the store never owns a reference.
    """

    def __init__(self, page: int):
        self.page = int(page)
        self._by_key: dict[bytes, tuple[int, ...]] = {}
        self._by_page: dict[int, set[bytes]] = {}
        self.stats = {"prefix_hits": 0, "prefix_shared_pages": 0,
                      "prefix_entries": 0}

    @staticmethod
    def _key(prompt: np.ndarray, tokens: int) -> bytes:
        return np.ascontiguousarray(prompt[:tokens], np.int32).tobytes()

    def lookup(self, prompt: np.ndarray) -> tuple[int, list[int]]:
        """Longest shareable prefix of ``prompt``: returns (k, pages) where
        the k returned pages hold prompt tokens [0, k*page).  Only full
        pages strictly inside the prompt are candidates, so the caller's
        own landing (its partial last page, its decode frontier) never
        touches a shared page."""
        P = self.page
        prompt = np.asarray(prompt)
        for k in range(len(prompt) // P, 0, -1):
            ids = self._by_key.get(self._key(prompt, k * P))
            if ids is not None:
                self.stats["prefix_hits"] += 1
                self.stats["prefix_shared_pages"] += k
                return k, list(ids)
        return 0, []

    def register(self, prompt: np.ndarray, page_ids: list[int]) -> None:
        """Record the prompt's full pages (page_ids[:len(prompt)//page])
        under every full-page prefix key.  First writer wins: identical
        prefixes re-registered later keep the original pages (maximal
        sharing against the oldest copy)."""
        P = self.page
        prompt = np.asarray(prompt)
        n_full = min(len(prompt) // P, len(page_ids))
        for k in range(1, n_full + 1):
            key = self._key(prompt, k * P)
            if key in self._by_key:
                continue
            ids = tuple(int(p) for p in page_ids[:k])
            self._by_key[key] = ids
            for p in ids:
                self._by_page.setdefault(p, set()).add(key)
            self.stats["prefix_entries"] += 1

    def drop_page(self, page: int) -> None:
        """A physical page was freed: forget every prefix that used it
        (wired as ``PagePool.on_free``)."""
        for key in self._by_page.pop(page, ()):
            ids = self._by_key.pop(key, None)
            if ids is None:
                continue
            self.stats["prefix_entries"] -= 1
            for p in ids:
                if p != page and p in self._by_page:
                    self._by_page[p].discard(key)
                    if not self._by_page[p]:
                        del self._by_page[p]


@dataclasses.dataclass
class SpillRecord:
    """Host-memory copy of a preempted request's cache state: one
    cache-shaped numpy tree holding the paged leaves' page contents
    (padded to n_pp pages so the restore program compiles once) AND the
    flat per-slot leaves (one row each), plus the scheduler state needed
    to reactivate without re-prefilling (warm resume)."""
    uid: int
    n_pages: int                     # pages actually held (rest is padding)
    length: int                      # self.lengths[slot] at preemption
    last_token: int
    data: Any                        # PagedCacheOps.capture() tree
