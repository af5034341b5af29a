"""Paged KV cache: host-side page allocator, per-slot block tables and
copy-on-write prefix sharing (the port's own copy of the JAX package's
``serving/paged_kv.py``, numpy only, the same behaviour line for line).

The contiguous engine sizes every slot to the worst case — ``max_batch x
cache_len`` tokens of KV live in device memory whether or not anyone is
using them. This module replaces the per-slot rings with a fixed pool of
fixed-size pages plus a per-slot *block table* mapping logical KV blocks
to pool pages, so

* device memory scales with **live tokens** (pages are allocated as
  positions are written and released when a stream finishes), and
* a shared-prefix hit can be a **page alias**: the new slot's block
  table points at the donor's pages with a refcount bump — zero KV
  copies (``serving/prefix_cache.py``; the engine's paged path).

Split of responsibilities
-------------------------
Device side (``models/layers.py``): every attention sub-cache carries
``kp``/``vp`` page pools of shape ``(num_pages + 1, page_size, Hkv, hd)``,
a per-slot block table ``bt (B, n_blocks)``, and the same dense
``pos (B, S)`` / ``step (B,)`` metadata as the contiguous layout
(``S = n_blocks * page_size``). Reads go through the table (the paged
decode-attention kernel, or a gather of ``kp[bt]`` into the contiguous
logical view); writes scatter through the table. Pool index
``num_pages`` is a **trash page**: unallocated block entries point at
it, so reads stay in-bounds (junk is masked by ``pos == -1``) and
masked-off writes land there harmlessly.

Host side (this module): ``PageAllocator`` owns the free list and
refcounts; ``PagedKVState`` owns the block tables and the slot
lifecycle — provisioning pages ahead of each dispatched step
(``prepare_write``, which also performs the copy-on-write split when a
to-be-written page is shared), aliasing prefix pages on a hit
(``alias_prefix``), pinning them when an entry is published
(``snapshot_prefix``), and releasing on finish/shrink. The host state is
authoritative; the device block table is just its pushed copy.

Invariants (asserted by ``check_invariants``; the port's tests replay
seeded op sequences against the JAX package's copy):

* **Conservation**: live pages + free pages == pool size after every op.
* **No double free**: releasing a page with refcount 0 raises.
* **CoW isolation**: a page reachable from two owners is never handed
  out for writing — ``prepare_write`` splits it first, so writes through
  one alias are never visible through the other.
* **Determinism**: the free list is a LIFO stack and every op is
  host-ordered, so identical op sequences yield identical block tables
  (prefill/decode replays hit identical pages — bit-equal caches).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "PagePoolExhausted",
    "PageAllocator",
    "PagedKVState",
    "walk_attn",
    "walk_attn2",
    "POOL_KEYS",
    "num_blocks",
]

# Cache-dict keys whose leading (post-scan) axis is the page pool rather
# than the batch. Everything else in an attention sub-cache (bt / pos /
# step) is per-slot and is sliced on the batch axis by the engine.
POOL_KEYS = ("kp", "vp", "kp_scale", "vp_scale")


def num_blocks(kv_len: int, page_size: int) -> int:
    return -(-int(kv_len) // int(page_size))


class PagePoolExhausted(RuntimeError):
    """Raised by ``PageAllocator.alloc`` when the free list is empty.

    The engine catches this at admission (backpressure: the request
    stays queued) and turns it into a hard error mid-decode (a live
    slot must never be corrupted by a failed write)."""


# --------------------------------------------------------------------- #
# tree walkers (shared with the engine)
# --------------------------------------------------------------------- #
def walk_attn(node, fn):
    """Apply ``fn`` to every attention sub-cache (dict containing "pos")
    in a nested dict tree, rebuilding the tree."""
    if isinstance(node, dict):
        if "pos" in node:
            return fn(node)
        return {k: walk_attn(v, fn) for k, v in node.items()}
    return node


def walk_attn2(a, b, fn):
    """Lockstep variant: ``fn(node_a, node_b)`` on paired sub-caches."""
    if isinstance(a, dict):
        if "pos" in a:
            return fn(a, b)
        return {k: walk_attn2(v, b[k], fn) for k, v in a.items()}
    return a


# --------------------------------------------------------------------- #
# allocator
# --------------------------------------------------------------------- #
class PageAllocator:
    """Refcounted free-list page allocator.

    The free list is a LIFO stack initialised so the first allocations
    hand out pages 0, 1, 2, ... — deterministic given the op sequence.
    """

    def __init__(self, num_pages: int):
        assert num_pages > 0
        self.num_pages = int(num_pages)
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))
        self.refcount = np.zeros(self.num_pages, dtype=np.int32)

    # ------------------------------------------------------------ #
    def alloc(self) -> int:
        if not self._free:
            raise PagePoolExhausted(
                f"KV page pool exhausted ({self.num_pages} pages, 0 free)")
        page = self._free.pop()
        self.refcount[page] = 1
        return page

    def retain(self, page: int) -> None:
        if self.refcount[page] <= 0:
            raise AssertionError(f"retain of unallocated page {page}")
        self.refcount[page] += 1

    def release(self, page: int) -> None:
        if self.refcount[page] <= 0:
            raise AssertionError(f"double free of page {page}")
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            self._free.append(page)

    # ------------------------------------------------------------ #
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        return self.num_pages - len(self._free)

    def check(self) -> None:
        """Conservation + free-list consistency. O(pool); called by the
        property tests after every op and by the engine under
        ``__debug__`` at poll boundaries."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate page in free list"
        assert len(free) + int(np.sum(self.refcount > 0)) == self.num_pages, \
            "page conservation violated (live + free != pool)"
        assert np.all(self.refcount >= 0), "negative refcount"
        for p in free:
            assert self.refcount[p] == 0, f"free page {p} has refcount"


# --------------------------------------------------------------------- #
# per-slot block tables + lifecycle
# --------------------------------------------------------------------- #
class PagedKVState:
    """Host-authoritative block tables and page lifecycle for one engine.

    One instance serves *all* layers: the engine keeps every layer's
    block table identical (all layers of one stream occupy the same
    logical positions), so a single host table is broadcast to each
    attention sub-cache's ``bt`` leaf on push. Page indices refer to each
    layer's own pool — "page 7" is page 7 of every layer's ``kp``/``vp``.
    """

    def __init__(self, max_batch: int, kv_len: int, page_size: int,
                 num_pages: int):
        assert page_size > 0
        self.page_size = int(page_size)
        self.n_blocks = num_blocks(kv_len, page_size)
        self.logical_len = self.n_blocks * self.page_size
        self.num_pages = int(num_pages)
        self.sentinel = self.num_pages          # the trash page's pool index
        self.alloc = PageAllocator(num_pages)
        self.block_tables = np.full((max_batch, self.n_blocks),
                                    self.sentinel, dtype=np.int32)
        self.dirty = True       # device bt out of date (force initial push)
        # counters surfaced via Engine.latency_stats
        self.alias_pages = 0    # prefix-hit pages aliased (zero-copy reuse)
        self.cow_splits = 0     # shared pages split before a write
        self.pages_released = 0

    # ------------------------------------------------------------ #
    def _blocks_for(self, start: int, n: int) -> List[int]:
        """Logical block ids touched by writes at positions
        [start, start + n), ring-mapped mod the logical length."""
        if n <= 0:
            return []
        blocks = []
        seen = set()
        for p in range(start, start + n):
            b = (p % self.logical_len) // self.page_size
            if b not in seen:
                seen.add(b)
                blocks.append(b)
        return blocks

    def prepare_write(self, slot: int, start: int, n: int
                      ) -> List[Tuple[int, int]]:
        """Make every page touched by positions [start, start+n) of
        ``slot`` privately writable: allocate missing pages and
        CoW-split shared ones. Returns ``(src, dst)`` page pairs the
        caller must copy on device **before** dispatching the write.
        Raises :class:`PagePoolExhausted` without mutating state if the
        pool cannot cover the request (the caller may reclaim + retry).
        """
        bt = self.block_tables[slot]
        blocks = self._blocks_for(start, n)
        need = sum(1 for b in blocks
                   if bt[b] == self.sentinel
                   or self.alloc.refcount[bt[b]] > 1)
        if need > self.alloc.free_pages:
            raise PagePoolExhausted(
                f"need {need} pages for slot {slot}, "
                f"only {self.alloc.free_pages} free")
        copies: List[Tuple[int, int]] = []
        for b in blocks:
            cur = int(bt[b])
            if cur == self.sentinel:
                bt[b] = self.alloc.alloc()
                self.dirty = True
            elif self.alloc.refcount[cur] > 1:
                new = self.alloc.alloc()
                copies.append((cur, new))
                self.alloc.release(cur)
                bt[b] = new
                self.cow_splits += 1
                self.dirty = True
        return copies

    # ------------------------------------------------------------ #
    def alias_prefix(self, slot: int, pages: Sequence[int]) -> None:
        """Point ``slot``'s leading blocks at ``pages`` (a prefix-cache
        hit): refcount bumps only, no KV movement. The slot must be
        empty (freshly reset)."""
        bt = self.block_tables[slot]
        assert all(int(p) == self.sentinel for p in bt), \
            "alias_prefix into a non-empty slot"
        assert len(pages) <= self.n_blocks
        for i, p in enumerate(pages):
            self.alloc.retain(int(p))
            bt[i] = int(p)
        self.alias_pages += len(pages)
        if pages:
            self.dirty = True

    def snapshot_prefix(self, slot: int, n_tokens: int) -> List[int]:
        """Pin the pages holding ``slot``'s first ``n_tokens`` positions
        for publication as a prefix-cache entry (refcount bump; the
        entry owns one reference per page until evicted)."""
        assert n_tokens % self.page_size == 0, \
            "prefix entries must be page-aligned"
        k = n_tokens // self.page_size
        pages = [int(p) for p in self.block_tables[slot, :k]]
        assert all(p != self.sentinel for p in pages), \
            "snapshot of unallocated blocks"
        for p in pages:
            self.alloc.retain(p)
        return pages

    def release_pages(self, pages: Sequence[int]) -> None:
        """Drop one reference per page (prefix-entry eviction)."""
        for p in pages:
            self.alloc.release(int(p))
        self.pages_released += len(pages)

    # ------------------------------------------------------------ #
    def release_slot(self, slot: int) -> None:
        """Stream finished/evicted: release every page the slot holds."""
        bt = self.block_tables[slot]
        n = 0
        for b in range(self.n_blocks):
            if bt[b] != self.sentinel:
                self.alloc.release(int(bt[b]))
                bt[b] = self.sentinel
                n += 1
        if n:
            self.pages_released += n
            self.dirty = True

    def shrink(self, slot: int, depth: int) -> None:
        """Release pages past the slot's true depth (the engine
        provisions an upper bound ahead of dispatch and corrects here
        once the harvested trace reveals where the stream actually
        stopped). No-op once the ring has wrapped."""
        if depth >= self.logical_len:
            return
        bt = self.block_tables[slot]
        first_unused = num_blocks(max(depth, 0), self.page_size)
        n = 0
        for b in range(first_unused, self.n_blocks):
            if bt[b] != self.sentinel:
                self.alloc.release(int(bt[b]))
                bt[b] = self.sentinel
                n += 1
        if n:
            self.pages_released += n
            self.dirty = True

    # ------------------------------------------------------------ #
    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` positions from 0."""
        return num_blocks(min(n_tokens, self.logical_len), self.page_size)

    def can_admit(self, n_tokens: int, aliased: int = 0) -> bool:
        """Conservative admission check: room for the prompt plus the
        first decode write, minus blocks served by a prefix alias."""
        need = self.pages_for(n_tokens + 1) - int(aliased)
        return need <= self.alloc.free_pages

    # ------------------------------------------------------------ #
    @property
    def free_pages(self) -> int:
        return self.alloc.free_pages

    @property
    def live_pages(self) -> int:
        return self.alloc.live_pages

    def check_invariants(
            self, entry_pages: Optional[Sequence[Sequence[int]]] = None
    ) -> None:
        """Allocator conservation plus table/refcount agreement: every
        page's refcount equals the number of block-table cells plus
        prefix-entry references (``entry_pages``) pointing at it."""
        self.alloc.check()
        refs = np.zeros(self.num_pages, dtype=np.int64)
        for row in self.block_tables:
            for p in row:
                if p != self.sentinel:
                    refs[p] += 1
        for pages in (entry_pages or ()):
            for p in pages:
                refs[int(p)] += 1
        assert np.array_equal(refs, self.alloc.refcount.astype(np.int64)), \
            "refcounts disagree with block-table + entry references"

    def stats(self) -> Dict[str, float]:
        return {
            "kv_pages_total": self.num_pages,
            "kv_page_size": self.page_size,
            "kv_pages_live": self.live_pages,
            "kv_pages_free": self.free_pages,
            "kv_alias_pages": self.alias_pages,
            "kv_cow_splits": self.cow_splits,
            "kv_pages_released": self.pages_released,
        }
