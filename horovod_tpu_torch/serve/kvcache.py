"""Block/paged KV cache: fixed-size pages over the static cache layout.

The port of ``horovod_tpu.serve.kvcache``. The engine's step sees
fixed-shape page tensors (``[num_pages, page_size, H, D]`` per layer per
K/V) plus per-request page-table index vectors, so paging is pure index
data. A request's logical cache positions ``0..Lmax-1`` map through its
page table to physical pages; the gather of a full table reconstructs
exactly the ``[Lmax, H, D]`` cache :func:`models.parallel_lm.lm_decode`
uses.

Host side, this module is bookkeeping: a refcounted free-list
:class:`PageAllocator` (verbatim from the JAX package) and
:class:`PagedKVCache`, which ties the allocator to the page tensors on
the engine's device and holds the admission-control page math. Export
and import of pages for disaggregated serving come with that slice.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch


class OutOfPages(Exception):
    """Raised by :meth:`PageAllocator.alloc` when the free list cannot
    satisfy the request (all-or-nothing; nothing was allocated)."""


#: Physical pages never handed out: page 0, the reserved null sink.
RESERVED_NULL_PAGES = 1


def allocatable_pages(num_pages: int) -> int:
    """Pages the allocator can actually grant."""
    return num_pages - RESERVED_NULL_PAGES


def pages_needed(prompt_len: int, max_new_tokens: int,
                 page_size: int) -> int:
    """Worst-case pages for a request: cache positions
    ``0..prompt_len + max_new_tokens - 2`` are written (the final
    sampled token is never fed back)."""
    positions = prompt_len + max_new_tokens - 1
    return max(1, math.ceil(positions / page_size))


def append_rows(table, start: int, n: int, *, page_size: int,
                num_pages: int, valid=None):
    """The multi-row page-write math of the chunked-prefill lane
    (``n`` rows at ``start..start+n-1``), on host arrays.

    ``table`` is one request's page-table index vector [pps];
    ``valid`` an optional [n] bool mask (``None`` = all rows valid).
    Returns numpy ``(write_page [n], write_off [n], safe_pos [n])``:

    * ``write_page`` — the physical page per row, or the sentinel
      ``num_pages`` for an invalid row (masked or past the table). A
      sentinel row must never be written; the engine selects the rows
      with ``write_page < num_pages`` (the JAX engine drops them with
      ``mode="drop"``, which torch indexing has no counterpart of);
    * ``write_off`` — the in-page offset per row;
    * ``safe_pos`` — the row's absolute position clipped into
      ``0..Lmax-1``.
    """
    table = np.asarray(table)
    positions = int(start) + np.arange(n)
    lmax = table.shape[0] * page_size
    safe_pos = np.clip(positions, 0, lmax - 1)
    ok = positions < lmax
    if valid is not None:
        ok = np.logical_and(np.asarray(valid), ok)
    write_page = np.where(ok, table[safe_pos // page_size], num_pages)
    return write_page, safe_pos % page_size, safe_pos


def fits_geometry(prompt_len: int, max_new_tokens: int, *, max_len: int,
                  page_size: int, capacity: int) -> bool:
    """Whether a request can EVER run on this cache geometry: position
    bound (``prompt + steps <= Lmax``) and total-capacity bound."""
    return (prompt_len >= 1 and max_new_tokens >= 1
            and prompt_len + max_new_tokens <= max_len
            and pages_needed(prompt_len, max_new_tokens, page_size)
            <= capacity)


class PageAllocator:
    """Free-list allocator over physical page ids.

    Page ids ``reserved..num_pages-1`` are allocatable; ids below
    ``reserved`` (the null sink page 0, by default) are never handed
    out. Frees push onto the list tail and allocations pop from it
    (LIFO — recently-freed pages are re-used first). ``alloc`` is
    all-or-nothing: either the full grant or :class:`OutOfPages` with no
    state change.

    Every held page carries a REFCOUNT (1 at grant): ``retain`` adds a
    holder, ``release`` drops one and frees only at zero. ``free`` is
    the strict single-holder teardown — it refuses shared pages.
    """

    def __init__(self, num_pages: int, reserved: int = 1):
        if num_pages <= reserved:
            raise ValueError(
                f"num_pages ({num_pages}) must exceed reserved "
                f"({reserved})")
        self.num_pages = num_pages
        self.reserved = reserved
        self._free: List[int] = list(range(num_pages - 1, reserved - 1, -1))
        self._held: set = set()
        self._refs: Dict[int, int] = {}

    @property
    def capacity(self) -> int:
        return self.num_pages - self.reserved

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return len(self._held)

    @property
    def shared(self) -> int:
        """Pages currently held by MORE than one holder."""
        return sum(1 for c in self._refs.values() if c > 1)

    def refcount(self, page: int) -> int:
        """Holders of ``page`` (0 if not allocated)."""
        return self._refs.get(page, 0)

    def is_shared(self, page: int) -> bool:
        """Whether a write to ``page`` must copy-on-write first."""
        return self._refs.get(page, 0) > 1

    def alloc(self, n: int) -> List[int]:
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise OutOfPages(
                f"need {n} pages, {len(self._free)} free "
                f"(capacity {self.capacity})")
        grant = [self._free.pop() for _ in range(n)]
        self._held.update(grant)
        for p in grant:
            self._refs[p] = 1
        return grant

    def retain(self, pages: Sequence[int]) -> None:
        """Add one holder to each (already-allocated) page.
        All-or-nothing: an unallocated page raises with no state
        change."""
        for p in pages:
            if p not in self._held:
                raise ValueError(
                    f"retain of page {p} which is not allocated "
                    "(a prefix hit can only share live pages)")
        for p in pages:
            self._refs[p] += 1

    def release(self, pages: Sequence[int]) -> None:
        """Drop one holder from each page; a page returns to the free
        list only when its LAST holder releases."""
        for p in pages:
            if p not in self._held:
                raise ValueError(
                    f"release of page {p} which is not allocated "
                    "(double release, or a reserved/null page id)")
            self._refs[p] -= 1
            if self._refs[p] <= 0:
                del self._refs[p]
                self._held.discard(p)
                self._free.append(p)

    def free(self, pages: Sequence[int]) -> None:
        """Strict single-holder teardown: refuses shared pages."""
        for p in pages:
            if p not in self._held:
                raise ValueError(
                    f"free of page {p} which is not allocated (double "
                    "free, or a reserved/null page id)")
            if self._refs.get(p, 0) > 1:
                raise ValueError(
                    f"free of page {p} with refcount "
                    f"{self._refs[p]} — shared pages must go through "
                    "release() so remaining holders keep the page")
        for p in pages:
            del self._refs[p]
            self._held.discard(p)
            self._free.append(p)


class PagedKVCache:
    """The page tensors on the engine's device + the allocator + the
    page math.

    Layer count, heads, head_dim, Lmax, dtype and device are read off
    the :func:`models.parallel_lm.init_lm_params` dict. The model's
    position-table length must divide into whole pages, so the gathered
    per-request cache is EXACTLY ``[Lmax, H, D]``.
    """

    def __init__(self, params: Dict, config):
        self.config = config
        self.max_len = int(params["pos"].shape[0])
        if self.max_len % config.page_size:
            raise ValueError(
                f"position table length {self.max_len} must be a "
                f"multiple of page_size {config.page_size} (whole-page "
                "logical caches keep the gathered layout identical to "
                "the decode lane's)")
        self.pages_per_seq = self.max_len // config.page_size
        wqkv = params["layers"][0]["wqkv"]
        self.num_heads = int(wqkv.shape[2])
        self.head_dim = int(wqkv.shape[3])
        self.dtype = wqkv.dtype
        self.device = wqkv.device
        self.num_layers = len(params["layers"])
        shape = (config.num_pages, config.page_size, self.num_heads,
                 self.head_dim)
        #: Per-layer ``{"k", "v"}`` page tensors. The engine's step
        #: writes them in place (see serve/engine.py); page 0 stays
        #: zero, the null sink unmapped table entries gather.
        self.pages = [{"k": torch.zeros(shape, dtype=self.dtype,
                                        device=self.device),
                       "v": torch.zeros(shape, dtype=self.dtype,
                                        device=self.device)}
                      for _ in range(self.num_layers)]
        self.allocator = PageAllocator(config.num_pages,
                                       reserved=RESERVED_NULL_PAGES)

    @property
    def dtype_bytes(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    # -------------------------------------------------- copy-on-write

    def cow_page(self, page: int) -> int:
        """Copy-on-write: allocate a fresh page, copy ``page``'s K/V
        contents into it across every layer, drop one holder from the
        original, and return the new (exclusively-held) page id. Raises
        :class:`OutOfPages` (no state change) when no page is free."""
        (new,) = self.allocator.alloc(1)
        for layer in self.pages:
            for kv in ("k", "v"):
                layer[kv][new] = layer[kv][page]
        self.allocator.release([page])
        return new

    # ------------------------------------------------------- page math

    def pages_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        """Worst-case pages for a request over this cache's page size."""
        return pages_needed(prompt_len, max_new_tokens,
                            self.config.page_size)

    def fits(self, prompt_len: int, max_new_tokens: int) -> bool:
        """Whether the request can EVER run on this geometry. Failing
        this is a hard reject, not a queue."""
        return fits_geometry(prompt_len, max_new_tokens,
                             max_len=self.max_len,
                             page_size=self.config.page_size,
                             capacity=self.allocator.capacity)

    # ---------------------------------------------------------- stats

    def occupancy(self) -> float:
        """Fraction of allocatable pages currently held (0..1)."""
        return self.allocator.in_use / max(1, self.allocator.capacity)
