"""Radix-tree prefix index over page-aligned token chunks (SGLang's
RadixAttention on the paged KV cache): a copy of the framework-neutral
``horovod_tpu.serve.prefix``, over the port's refcounted
:class:`~horovod_tpu_torch.serve.kvcache.PageAllocator`.

A request's prompt is keyed as a chain of ``page_size``-token chunks;
each radix node owns the PHYSICAL page that chunk's K/V rows were
prefilled into. :meth:`PrefixIndex.match` maps a new prompt to the
longest chain of already-filled pages, admission maps those pages into
the new request's page table read-only (``allocator.retain``), and
prefill starts at the first miss. One cold prefill per unique prefix;
every later request pays only its tail.

Correctness ground rules (each one load-bearing):

* **Only FULL prompt pages are indexable or matchable** — a partial
  last page will still be written by its owner (and a matched page by
  nobody: new holders write from their first missed position onward),
  so indexed pages are write-free by construction; the engine's COW
  guard (``cow_page``) stays a backstop, not the hot path.
* **A match never covers the whole prompt**: the last prompt token is
  always prefilled (``matched_tokens < prompt_len``), so the first
  generated token's logits come off the same prefill path as a cold
  request — the cache-hit stream is bit-identical to the cold one.
* **The index holds its own +1 refcount** on every entry's page, so a
  prefix outlives the request that prefilled it; under allocator
  pressure :meth:`reclaim` drops least-recently-touched leaves whose
  pages ONLY the index still holds (never a page any request maps),
  and entries invalidate on that release — a freed page can never be
  matched again.
* **A weight change flushes everything** (:meth:`flush`): K/V rows are
  a function of the weights, so stale pages must never serve a request
  of new weights.

:func:`prefix_route_key` and :func:`rendezvous_rank` are the fleet
router's side of the same idea (a stable hash of the first matchable
page that ranks replicas), kept beside the index for the fleet's slice.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple


def aligned_prefix_len(prompt_len: int, page_size: int) -> int:
    """Tokens of ``prompt_len`` that are matchable: whole pages only,
    and never the entire prompt (the last token always prefills so
    first-token logits exist on the hit path)."""
    if prompt_len <= 1:
        return 0
    return ((prompt_len - 1) // page_size) * page_size


def prefix_route_key(prompt: Sequence[int],
                     page_size: int) -> Optional[str]:
    """Stable hex digest of the prompt's normalized prefix — the
    router's rendezvous-hash input. ``None`` when the prompt has no
    matchable prefix (no full page clear of the last token): such
    requests carry no affinity and route purely least-loaded.

    The key hashes the FIRST page-aligned chunk only, deliberately:

    * two requests sharing ANY matchable prefix necessarily share
      their first page, so first-chunk hashing co-locates every group
      that could ever share pages (hashing each request's own full
      aligned prefix would split "system prompt + user A" from
      "system prompt + user B" — the exact workload prefix caching
      exists for);
    * :func:`~horovod_tpu_torch.serve.scheduler.rebase_for_recompute` only
      APPENDS tokens, so a redispatched request keeps its key — the
      drained requests of a dead replica all rendezvous onto the same
      survivor, where the first to arrive re-prefills the prefix once
      and the rest hit it.
    """
    n = aligned_prefix_len(len(prompt), page_size)
    if n <= 0:
        return None
    raw = ",".join(str(int(t)) for t in prompt[:page_size]).encode()
    return hashlib.sha256(raw).hexdigest()


def rendezvous_rank(route_key: str, replica_id: int) -> int:
    """Deterministic per-(prefix, replica) weight for highest-random-
    weight routing: every router instance — and every incarnation of
    the fleet — ranks the same replica first for the same prefix, with
    no shared state to migrate when replicas die (the next-ranked
    survivor simply becomes the prefix's home)."""
    h = hashlib.sha256(f"{route_key}:{replica_id}".encode()).digest()
    return int.from_bytes(h[:8], "big")


class _Node:
    __slots__ = ("children", "page", "touch")

    def __init__(self, page: Optional[int] = None):
        #: chunk (tuple of page_size token ids) -> child node
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.page = page
        self.touch = 0


class PrefixIndex:
    """The radix index over one :class:`~horovod_tpu_torch.serve.kvcache.
    PagedKVCache`'s allocator. Host-side bookkeeping only — pages
    themselves never move; the index just remembers which physical
    page holds which chunk's K/V rows and keeps them alive."""

    def __init__(self, allocator, page_size: int):
        self.allocator = allocator
        self.page_size = page_size
        self._root = _Node()
        self._clock = 0
        #: live entries (nodes holding a page)
        self.entries = 0
        # cumulative counters (reset via reset_metrics)
        self.lookups = 0
        self.hits = 0
        self.tokens_hit = 0
        self.pages_shared = 0
        self.inserts = 0
        self.reclaimed = 0
        self.flushes = 0

    # ------------------------------------------------------- matching

    def _chunks(self, prompt: Sequence[int], n_tokens: int):
        ps = self.page_size
        for i in range(n_tokens // ps):
            yield tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])

    def match(self, prompt: Sequence[int]) -> Tuple[List[int], int]:
        """Longest chain of already-filled pages for ``prompt``:
        returns ``(pages, matched_tokens)`` where ``pages[i]`` holds
        positions ``i*page_size..(i+1)*page_size-1``. The caller maps
        the pages (``retain``) into the request's table and starts
        prefill at ``matched_tokens``. Does NOT retain — admission
        does, so a match that loses an admission race leaks nothing.
        Counter-pure for the same reason (reserve-mode admission
        re-probes the waiting queue head every step): the admission
        that STICKS commits the counters via :meth:`note_admission`."""
        self._clock += 1
        node, pages = self._root, []
        matchable = aligned_prefix_len(len(prompt), self.page_size)
        for chunk in self._chunks(prompt, matchable):
            child = node.children.get(chunk)
            if child is None:
                break
            child.touch = self._clock
            pages.append(child.page)
            node = child
        return pages, len(pages) * self.page_size

    def note_admission(self, pages_hit: int, tokens_hit: int) -> None:
        """Commit the hit counters for ONE admitted request — so the
        hit rate is per request served, not per admission probe."""
        self.lookups += 1
        if pages_hit:
            self.hits += 1
            self.tokens_hit += tokens_hit
            self.pages_shared += pages_hit

    # ------------------------------------------------------ insertion

    def insert(self, prompt: Sequence[int],
               page_table: Sequence[int]) -> int:
        """Index a finished prefill: every FULL prompt page of
        ``prompt`` (whose K/V now sit in ``page_table``) becomes a
        radix entry, each newly-indexed page retained once (+1 — the
        index's own hold, so the prefix survives the request). Chunks
        already present keep their existing page (first prefill wins;
        identical weights ⇒ identical K/V, so either copy serves).
        Returns the number of NEW entries created."""
        self._clock += 1
        ps = self.page_size
        full = (len(prompt) // ps) * ps
        node, created = self._root, 0
        for i, chunk in enumerate(self._chunks(prompt, full)):
            child = node.children.get(chunk)
            if child is None:
                page = int(page_table[i])
                if page < 0:
                    break
                self.allocator.retain([page])
                child = _Node(page)
                node.children[chunk] = child
                self.entries += 1
                created += 1
            child.touch = self._clock
            node = child
        self.inserts += created
        return created

    # ------------------------------------------------------- eviction

    def reclaim(self, n_pages: int) -> int:
        """Free up to ``n_pages`` pages by dropping least-recently-
        touched LEAF entries whose pages only the index holds
        (refcount == 1 — releasing actually frees them; a page any
        request still maps is never a victim). Dropping leaves first
        keeps every surviving chain reachable. Returns pages freed."""
        freed = 0
        while freed < n_pages:
            victim = self._lru_reclaimable_leaf()
            if victim is None:
                break
            parent, chunk, child = victim
            self.allocator.release([child.page])
            del parent.children[chunk]
            self.entries -= 1
            self.reclaimed += 1
            freed += 1
        return freed

    def _lru_reclaimable_leaf(self):
        best = None
        stack = [self._root]
        while stack:
            node = stack.pop()
            for chunk, child in node.children.items():
                if child.children:
                    stack.append(child)
                elif self.allocator.refcount(child.page) == 1:
                    if best is None or child.touch < best[2].touch:
                        best = (node, chunk, child)
        return best

    def flush(self) -> int:
        """Drop EVERY entry, releasing the index's holds — the params-
        update path (stale-version K/V must never serve a new-version
        request). Pages still mapped by in-flight requests stay alive
        under their remaining refcounts. Returns entries dropped."""
        dropped = 0
        stack = [self._root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                self.allocator.release([child.page])
                dropped += 1
                stack.append(child)
        self._root = _Node()
        self.entries = 0
        self.flushes += 1
        return dropped

    # ---------------------------------------------------------- stats

    def stats(self) -> Dict[str, int]:
        return {
            "entries": self.entries,
            "lookups": self.lookups,
            "hits": self.hits,
            "tokens_hit": self.tokens_hit,
            "pages_shared": self.pages_shared,
            "inserts": self.inserts,
            "reclaimed": self.reclaimed,
            "flushes": self.flushes,
        }

    def reset_metrics(self) -> None:
        """Zero the cumulative counters (entries stay — the measured
        window starts warm, like the engine's own reset)."""
        self.lookups = self.hits = self.tokens_hit = 0
        self.pages_shared = self.inserts = 0
        self.reclaimed = self.flushes = 0
