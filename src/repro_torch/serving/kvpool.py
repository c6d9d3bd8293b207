"""Paged KV pool with a token-prefix radix index (host-side policy).

A copy of the JAX package's ``repro/serving/kvpool.py`` (pure Python over
numpy), its telemetry binding included (``bind_telemetry``: the pool's
gauges and the ``EVICT`` trace event).

The serving engine's paged mode replaces every per-slot contiguous KV cache
with a **global pool of fixed-size pages**: each attention (or MLA-latent)
layer owns one ``(num_pages, page_size, ...)`` storage array, and a physical
page id addresses the same row in *every* layer's array — allocating one
logical page provisions it across the whole stack (the vLLM block-table
scheme). Slots address the pool through per-slot page tables
(``PageTables`` in ``repro_torch.models.attention``); this module owns the
*policy*: which physical pages are free, which belong to which cached
prefix, and when a cold page gets evicted.

Sharing model:

- **Append-only layers** (full-causal attention, MLA) never rewrite a
  page once the positions it covers are filled, so a prompt prefix's pages
  can be attached read-only to any later request with the same tokens —
  that request skips the prefix's chunked-prefill work entirely.
- **Ring layers** (sliding-window) and **recurrent state** (SSM / hybrid /
  conv) are rewritten during decode, so their prefix-boundary contents are
  stored as a *snapshot* on the radix node and copied into the new
  request's private pages / state rows at attach time (copy-on-attach —
  the degenerate copy-on-write case for state that is always written).
- A request that diverges **mid-page** from a cached prefix copies the
  shared page's valid rows into a fresh private page (copy-on-write) and
  keeps writing there; the cached page is untouched.

The index is a radix tree with one node per ``page_size``-token block.
Nodes are reference-counted (one count per attached slot, along the whole
root path) and evicted lazily, LRU-first, only from refcount-0 leaves —
a page can never be reclaimed while any slot's table still maps it.

Everything in this file is host-side Python over numpy token arrays; the
device-side mechanics (page gather in the attend path, ring-aware page
scatter on write) live in ``repro_torch.models.attention`` and
``repro_torch.kernels.paged_maintenance``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving import telemetry as TM
from repro_torch.serving.telemetry import NULL_TELEMETRY

NULL_PAGE = 0     # physical page 0 is reserved: all-zero K/V, pos == -1


def partition_pages(num_pages: int, pool_shards: int) -> List[range]:
    """Block-partition physical page ids over ``pool_shards`` mesh shards.

    Shard ``i`` owns the contiguous block ``[i * num_pages / S, (i + 1) *
    num_pages / S)``, the block a serving mesh's ``'pool'`` axis keeps on
    its ``i``-th row of devices (``repro_torch.sharding``). The partition
    is a bijection onto ``range(num_pages)``: every physical page lives on
    exactly one shard, which keeps the host-side page accounting
    (allocator, radix index, eviction) shard-oblivious.

    Raises :class:`ValueError` when ``pool_shards`` is non-positive or does
    not divide ``num_pages`` (the serving rules replicate the pool axis in
    that case, so an uneven partition is never meaningful).
    """
    if pool_shards < 1:
        raise ValueError(f'pool_shards must be positive, got {pool_shards}')
    if num_pages % pool_shards:
        raise ValueError(f'{num_pages} pages do not divide over '
                         f'{pool_shards} pool shards (GSPMD would pad; the '
                         f'serving rules replicate instead)')
    per = num_pages // pool_shards
    return [range(i * per, (i + 1) * per) for i in range(pool_shards)]


class RadixNode:
    """One cached ``page_size``-token block of some prompt prefix."""
    __slots__ = ('key', 'page', 'parent', 'children', 'refs', 'last_used',
                 'snapshot', 'depth')

    def __init__(self, key: bytes, page: int, parent: Optional['RadixNode'],
                 depth: int):
        self.key = key                  # the block's tokens, as bytes
        self.page = page                # physical page holding its K/V
        self.parent = parent
        self.children: Dict[bytes, RadixNode] = {}
        self.refs = 0                   # attached slots whose path crosses us
        self.last_used = 0
        self.snapshot: Any = None       # non-paged state at this boundary
        self.depth = depth              # blocks from root (root = 0)


@dataclasses.dataclass
class MatchResult:
    node: Optional[RadixNode]           # deepest usable node (None = miss)
    n_blocks: int                       # full blocks matched (node.depth)
    pages: List[int]                    # physical pages, root -> node order


class PrefixCache:
    """Page allocator + refcounted radix prefix index + LRU eviction."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError('need at least 2 pages (page 0 is the null page)')
        self.num_pages = num_pages
        self.page_size = page_size
        # LIFO free list, low ids first out; page 0 reserved as the null page
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self.root = RadixNode(b'', NULL_PAGE, None, 0)
        self._clock = 0
        # stats
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.evictions = 0
        self._tel = NULL_TELEMETRY

    def bind_telemetry(self, tel) -> None:
        """Register this pool's occupancy gauges and counters on ``tel``'s
        registry (callback gauges — exports read live pool state) and route
        eviction trace events through its tracer. Metric names are the
        ``KV_*`` constants in :mod:`repro_torch.serving.telemetry` — the
        same strings :meth:`stats` uses, defined in exactly one place."""
        self._tel = tel
        reg = tel.registry
        reg.gauge(TM.KV_PAGES_IN_USE, fn=self.pages_in_use)
        reg.gauge(TM.KV_PAGES_FREE, fn=self.pages_free)
        reg.gauge(TM.KV_PAGES_RECLAIMABLE, fn=self.reclaimable)
        reg.gauge(TM.KV_PREFIX_HITS, fn=lambda: self.hits)
        reg.gauge(TM.KV_PREFIX_MISSES, fn=lambda: self.misses)
        reg.gauge(TM.KV_PREFIX_HIT_TOKENS, fn=lambda: self.hit_tokens)
        reg.gauge(TM.KV_EVICTIONS, fn=lambda: self.evictions)

    # ------------------------------------------------------------ allocator
    def pages_free(self) -> int:
        return len(self._free)

    def pages_in_use(self) -> int:
        return self.num_pages - 1 - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` pages, evicting cold cached blocks if needed.

        Atomic on failure: if even full eviction cannot free enough
        (refcounted pages are never reclaimed), returns None having
        changed NOTHING — free list, radix index, refcounts and LRU state
        are exactly as before the call. (It used to evict one block at a
        time until eviction ran dry, so a doomed alloc still tore cached
        prefixes out of the index before failing — turning pool pressure
        into gratuitous prefix-cache misses for every later request.)
        """
        if n > len(self._free) and self.reclaimable() < n:
            return None
        while len(self._free) < n:
            if not self._evict_one():       # unreachable after the precheck
                return None
        return [self._free.pop() for _ in range(n)]

    def free(self, pages) -> None:
        for p in pages:
            assert p != NULL_PAGE, 'freeing the null page'
            self._free.append(int(p))

    def reclaimable(self) -> int:
        """Pages that ``alloc`` could obtain right now: the free list plus
        every refcount-0 cached block (a refs-0 node's whole subtree is
        refs-0, so each such node is one evictable page). The engine's
        preemption/admission decisions don't need this — ``alloc`` already
        evicts on demand — but overload diagnostics do."""
        n = len(self._free)
        stack = [self.root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is not self.root and not node.refs:
                n += 1
        return n

    def _evict_one(self) -> bool:
        """Drop the least-recently-used refcount-0 leaf block."""
        victim: Optional[RadixNode] = None
        stack = [self.root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is self.root or node.children or node.refs:
                continue
            if victim is None or node.last_used < victim.last_used:
                victim = node
        if victim is None:
            return False
        del victim.parent.children[victim.key]
        victim.snapshot = None
        self.free([victim.page])
        self.evictions += 1
        if self._tel.enabled:
            self._tel.event(None, TM.EV_EVICT, page=int(victim.page),
                            depth=victim.depth)
        return True

    # ---------------------------------------------------------------- radix
    def _touch(self, node: RadixNode) -> None:
        self._clock += 1
        while node is not None and node is not self.root:
            node.last_used = self._clock
            node = node.parent

    @staticmethod
    def _block_key(tokens: np.ndarray) -> bytes:
        return np.ascontiguousarray(tokens, dtype=np.int64).tobytes()

    def match(self, tokens: np.ndarray, *, max_tokens: Optional[int] = None,
              need_snapshot: bool = False) -> MatchResult:
        """Longest cached prefix of ``tokens``, in whole-page blocks.

        ``max_tokens`` caps the usable depth (a request must re-run at
        least its last prompt token, so callers pass ``len(prompt) - 1``).
        With ``need_snapshot`` the walk additionally stops at the deepest
        matching node that *has* a snapshot — architectures with ring /
        recurrent state can only resume from a snapshotted boundary.
        """
        ps = self.page_size
        limit = len(tokens) if max_tokens is None else min(len(tokens),
                                                           max_tokens)
        node, pages = self.root, []
        path: List[RadixNode] = []
        for b in range(len(tokens) // ps):
            child = node.children.get(self._block_key(tokens[b * ps:(b + 1)
                                                             * ps]))
            if child is None:
                break
            node = child
            path.append(node)
            pages.append(node.page)
        while path and (path[-1].depth * ps > limit
                        or (need_snapshot and path[-1].snapshot is None)):
            path.pop()
            pages.pop()
        node = path[-1] if path else self.root
        if node is self.root:
            return MatchResult(None, 0, [])
        self._touch(node)
        return MatchResult(node, node.depth, pages)

    def find_extension(self, node: Optional[RadixNode],
                       tail: np.ndarray) -> int:
        """Physical page of a cached child of ``node`` whose block *starts
        with* ``tail`` (a partial block) — the copy-on-write source when a
        request diverges from (or stops short inside) a cached block.
        Returns -1 if no cached block extends the tail.
        """
        node = node or self.root
        n = len(tail)
        if n == 0 or n >= self.page_size:
            return -1
        want = np.ascontiguousarray(tail, dtype=np.int64)
        for child in node.children.values():
            blk = np.frombuffer(child.key, dtype=np.int64)
            if np.array_equal(blk[:n], want):
                self._touch(child)
                return child.page
        return -1

    def attach(self, node: Optional[RadixNode]) -> None:
        """Pin a matched path: +1 ref on every node from ``node`` to root."""
        while node is not None and node is not self.root:
            node.refs += 1
            node = node.parent

    def release(self, node: Optional[RadixNode]) -> None:
        while node is not None and node is not self.root:
            assert node.refs > 0, 'release without attach'
            node.refs -= 1
            node = node.parent

    def insert(self, tokens: np.ndarray, n_blocks: int, pages: List[int],
               snapshot: Any = None) -> Tuple[RadixNode, List[int]]:
        """Publish the first ``n_blocks`` pages of a prefilled prompt.

        ``pages[b]`` is the caller's physical page for block ``b``. Blocks
        already present keep the *existing* node's page (the caller's
        duplicate stays private — contents are bitwise identical, both were
        produced by the same params on the same tokens at the same
        positions). New blocks adopt the caller's page: ownership moves to
        the radix tree and the returned ``transferred`` list names them so
        the caller stops treating them as private. ``snapshot`` lands on
        the deepest node.

        Besides prefill publishing, this is the engine's preemption
        mechanism: a preempted slot publishes every fully-written page
        (prompt AND generated tokens — radix keys are token values, so
        identical tokens at identical positions give bitwise-identical
        pages) before releasing, making its resume a prefix hit that
        recomputes only the uncached tail.
        """
        ps = self.page_size
        assert n_blocks * ps <= len(tokens) and n_blocks <= len(pages)
        node = self.root
        transferred: List[int] = []
        for b in range(n_blocks):
            key = self._block_key(tokens[b * ps:(b + 1) * ps])
            child = node.children.get(key)
            if child is None:
                child = RadixNode(key, pages[b], node, node.depth + 1)
                node.children[key] = child
                transferred.append(pages[b])
            node = child
        if node is not self.root:
            if snapshot is not None and node.snapshot is None:
                node.snapshot = snapshot
            self._touch(node)
        return node, transferred

    # ---------------------------------------------------------------- stats
    def stats(self) -> Dict[str, float]:
        """Pool statistics. Key names are the ``KV_*`` constants in
        :mod:`repro_torch.serving.telemetry`, the single place they are
        defined (the registry gauges from :meth:`bind_telemetry` and every
        consumer use the same constants)."""
        total = self.hits + self.misses
        return {
            TM.KV_PREFIX_HITS: self.hits,
            TM.KV_PREFIX_MISSES: self.misses,
            TM.KV_PREFIX_HIT_RATE: self.hits / total if total else 0.0,
            TM.KV_PREFIX_HIT_TOKENS: self.hit_tokens,
            TM.KV_PAGES_IN_USE: self.pages_in_use(),
            TM.KV_PAGES_FREE: self.pages_free(),
            TM.KV_PAGES_RECLAIMABLE: self.reclaimable(),
            TM.KV_EVICTIONS: self.evictions,
        }
