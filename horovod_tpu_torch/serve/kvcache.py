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
the engine's device and holds the admission-control page math.

For disaggregated serving, :meth:`PagedKVCache.export_pages` writes a
request's finished pages into one deterministic ``HVKV`` blob and
:meth:`PagedKVCache.import_pages` scatters such a blob into another
cache. The page tensors have the reference's ``[num_pages, page_size,
H, D]`` layout, so the blob is byte-identical to the reference's for the
same page contents (its header names numpy's dtype, ``float32`` or
``bfloat16``), and each package imports the other's. Import writes into
the existing page tensors in place: a captured decode lane keeps
reading the storage it captured.

Under tensor parallelism (``ServeConfig.mesh``) every rank's cache holds
its own head shard: page tensors ``[num_pages, page_size, H/tp, D]``,
each a contiguous tensor of its own (the paged-attention kernel reads a
page row at stride ``H/tp * D`` from the tensor's base, so a head-slice
view of a full-width tensor would read the wrong heads). The blob stays
in the full-head layout whatever the tp: rank ``r`` holds heads
``r*H/tp .. (r+1)*H/tp - 1`` (the cut of
:func:`~horovod_tpu_torch.models.parallel_lm.shard_lm_params`), so an
export concatenates the ranks' tiles in rank order and an import keeps
each rank's slice, and exporter and importer need not agree on tp. The
cache stays single-process: :meth:`PagedKVCache.export_pages` takes the
group's gather and :meth:`PagedKVCache.import_pages` its fan-out from
the engine (:class:`~horovod_tpu_torch.serve.engine.ServeEngine`),
which owns the tensor group.
"""

from __future__ import annotations

import json
import math
import struct
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from horovod_tpu_torch.common.exceptions import InvalidArgumentError
from horovod_tpu_torch.serve.transport import FrameError


class OutOfPages(Exception):
    """Raised by :meth:`PageAllocator.alloc` when the free list cannot
    satisfy the request (all-or-nothing; nothing was allocated)."""


#: KV-page blob container magic ("HoroVod KV pages"), the payload the
#: disaggregated prefill-to-decode handoff chunk-streams
#: (serve/kv_wire.py).
KV_BLOB_MAGIC = b"HVKV"
_KV_BLOB_HEADER = struct.Struct(">4sI")   # magic, header-JSON length


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
    per-request cache is EXACTLY ``[Lmax, H, D]``. ``params`` is the
    rank's shard under tensor parallelism (``tp`` > 1), so ``num_heads``
    is the shard's head count ``H/tp``.
    """

    def __init__(self, params: Dict, config, tp: int = 1,
                 tp_rank: int = 0):
        self.config = config
        #: The tensor-parallel degree the heads are sharded over, and
        #: this rank's place on the axis (its heads in the blob's
        #: layout: ``tp_rank * num_heads`` onward).
        self.tp = tp
        self.tp_rank = tp_rank
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

    @property
    def dtype_name(self) -> str:
        """numpy's name of the page dtype (``float32``, ``bfloat16``):
        the blob header's, as the reference writes it."""
        return str(self.dtype).rpartition(".")[2]

    # -------------------------------------------------- copy-on-write

    def cow_page(self, page: int) -> int:
        """Copy-on-write: allocate a fresh page, copy ``page``'s K/V
        contents into it across every layer, drop one holder from the
        original, and return the new (exclusively-held) page id. Raises
        :class:`OutOfPages` (no state change) when no page is free."""
        (new,) = self.allocator.alloc(1)
        self.copy_page(page, new)
        self.allocator.release([page])
        return new

    def copy_page(self, src: int, dst: int) -> None:
        """The data half of :meth:`cow_page`: ``src``'s K/V rows into
        ``dst`` across every layer, with no allocator change (a tensor-
        parallel follower runs it on its head shard when the controller
        copies)."""
        for layer in self.pages:
            for kv in ("k", "v"):
                layer[kv][dst] = layer[kv][src]

    # --------------------------------------------- export / import (kv)

    @property
    def blob_heads(self) -> int:
        """The head count of the blob's layout: the model's, whatever
        this cache's shard of it."""
        return self.num_heads * self.tp

    def read_tiles(self, ids: torch.Tensor) -> torch.Tensor:
        """This rank's K/V tiles of the pages ``ids`` (int tensor on the
        cache's device), as one ``[layers, 2, n, page_size, H/tp, D]``
        tensor: per layer, K then V, in the order of ``ids``."""
        ids = ids.long()
        return torch.stack([torch.stack([layer[kv].index_select(0, ids)
                                         for kv in ("k", "v")])
                            for layer in self.pages])

    def write_tiles(self, ids: torch.Tensor, tiles: torch.Tensor) -> None:
        """Write the full-head tiles ``[layers, 2, n, page_size, H, D]``
        of :meth:`read_tiles`' layout into the pages ``ids``, this rank's
        heads only, into the existing page tensors in place
        (``index_copy_``: a captured lane's storage stays the one it
        reads)."""
        h = self.num_heads
        mine = tiles[..., self.tp_rank * h:(self.tp_rank + 1) * h, :]
        mine = mine.to(self.device)
        ids = ids.long().to(self.device)
        for layer, lt in zip(self.pages, mine):
            for kv, t in zip(("k", "v"), lt):
                layer[kv].index_copy_(0, ids, t)

    def _sharded(self, what: str, hook) -> None:
        if self.tp > 1 and hook is None:
            raise InvalidArgumentError(
                f"PagedKVCache.{what} of a head-sharded cache (tp="
                f"{self.tp}): this rank holds {self.num_heads} of the "
                f"blob's {self.blob_heads} heads, so the tensor group "
                "takes part; go through the engine (ServeEngine."
                "export_handoff / admit_prefilled)")

    def export_pages(self, pages: Sequence[int], num_positions: int, *,
                     gather: Optional[Callable] = None) -> bytes:
        """Serialize the finished K/V pages covering logical positions
        ``0..num_positions-1`` into ONE deterministic byte blob, the
        payload of the disaggregated handoff (``serve/kv_wire.py``).
        ``pages`` is the request's physical page list in logical order;
        the tiles ship per layer, K then V, as ``[n, page_size, H, D]``
        in logical page order and the model's full head layout. The
        tiles are read on the device and copied to the host once.
        READ-ONLY: refcounts are untouched, so pages shared under COW or
        the prefix cache export safely.

        A head-sharded cache (``tp`` > 1) needs ``gather(ids)``: the
        full-head tiles of :meth:`read_tiles`' layout, the ranks' shards
        concatenated in rank order (the engine's tensor group). It runs
        only once the page math has been checked."""
        self._sharded("export_pages", gather)
        ps = self.config.page_size
        need = pages_needed(num_positions, 1, ps) \
            if num_positions >= 1 else 0
        if num_positions < 1 or len(pages) != need:
            raise FrameError(
                f"export of {len(pages)} pages for {num_positions} "
                f"positions — geometry says {need} pages of "
                f"{ps} positions each")
        header = json.dumps({
            "layers": self.num_layers,
            "page_size": ps,
            "heads": self.blob_heads,
            "head_dim": self.head_dim,
            "dtype": self.dtype_name,
            "pages": len(pages),
            "positions": int(num_positions),
        }).encode("utf-8")
        ids = torch.tensor(list(pages), dtype=torch.int32,
                           device=self.device)
        tiles = (gather or self.read_tiles)(ids).contiguous().cpu()
        if tiles.dtype == torch.bfloat16:
            # numpy has no bfloat16: the same bytes as int16.
            tiles = tiles.view(torch.int16)
        return b"".join([_KV_BLOB_HEADER.pack(KV_BLOB_MAGIC, len(header)),
                         header, tiles.numpy().tobytes()])

    def import_pages(self, blob: bytes, *,
                     write: Optional[Callable] = None
                     ) -> Tuple[List[int], int]:
        """Inverse of :meth:`export_pages` against THIS cache: checks the
        geometry (a blob of another model or page shape is a typed
        :class:`~horovod_tpu_torch.serve.transport.FrameError`), the page
        math and the length before allocating, allocates the pages
        all-or-nothing (:class:`OutOfPages` with no state change), and
        writes the tiles into the existing page tensors in place
        (:meth:`write_tiles`). Returns ``(granted_pages,
        num_positions)``, the granted ids in logical order; any failure
        after the grant frees it.

        A head-sharded cache needs ``write(ids, tiles)``, which hands the
        granted ids and the full-head tiles to every rank of the group
        and writes this rank's heads (the engine's fan-out); it runs
        only once the blob has been checked and the pages granted."""
        self._sharded("import_pages", write)
        if len(blob) < _KV_BLOB_HEADER.size:
            raise FrameError(
                f"kv blob of {len(blob)} bytes is shorter than its "
                "header — torn payload")
        magic, hlen = _KV_BLOB_HEADER.unpack_from(blob)
        if magic != KV_BLOB_MAGIC:
            raise FrameError(
                f"bad kv-blob magic {magic!r} — not a HVKV payload")
        end = _KV_BLOB_HEADER.size + hlen
        if len(blob) < end:
            raise FrameError("kv blob torn inside its header")
        try:
            h = json.loads(blob[_KV_BLOB_HEADER.size:end].decode("utf-8"))
            n, positions = int(h["pages"]), int(h["positions"])
        except (ValueError, KeyError, UnicodeDecodeError) as e:
            raise FrameError(f"undecodable kv-blob header: {e!r}"
                             ) from None
        ps = self.config.page_size
        want = {"layers": self.num_layers, "page_size": ps,
                "heads": self.blob_heads, "head_dim": self.head_dim,
                "dtype": self.dtype_name}
        got = {k: h.get(k) for k in want}
        if got != want:
            raise FrameError(
                f"kv blob geometry {got} does not match this cache "
                f"{want} — cross-model/cross-geometry import refused")
        if positions < 1 or n != pages_needed(positions, 1, ps):
            raise FrameError(
                f"kv blob claims {n} pages for {positions} positions — "
                "inconsistent page math")
        shape = (self.num_layers, 2, n, ps, self.blob_heads, self.head_dim)
        total = end + math.prod(shape) * self.dtype_bytes
        if len(blob) != total:
            raise FrameError(
                f"kv blob is {len(blob)} bytes, geometry says {total} "
                "— torn or padded payload")
        grant = self.allocator.alloc(n)     # all-or-nothing; OutOfPages
        try:
            ids = torch.tensor(grant, dtype=torch.int32, device=self.device)
            # One writable copy of the payload for torch.frombuffer.
            tiles = torch.frombuffer(bytearray(memoryview(blob)[end:]),
                                     dtype=self.dtype).reshape(shape)
            (write or self.write_tiles)(ids, tiles)
        except BaseException:
            self.allocator.free(grant)
            raise
        return grant, positions

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

    def can_admit(self, prompt_len: int, max_new_tokens: int) -> bool:
        """Admission control (reserve discipline): admit only when the
        worst case is allocatable RIGHT NOW, so an admitted request can
        always run to completion without eviction."""
        return (self.pages_needed(prompt_len, max_new_tokens)
                <= self.allocator.available)

    # ---------------------------------------------------------- stats

    def occupancy(self) -> float:
        """Fraction of allocatable pages currently held (0..1)."""
        return self.allocator.in_use / max(1, self.allocator.capacity)

    def stats(self) -> Dict[str, float]:
        return {
            "pages_total": self.allocator.capacity,
            "pages_in_use": self.allocator.in_use,
            "pages_free": self.allocator.available,
            "pages_shared": self.allocator.shared,
            "occupancy": self.occupancy(),
        }
