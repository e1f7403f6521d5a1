"""Physical paged KV allocator + radix-backed prefix KV store.

`KVPool` hands out real block ids for the decode engine's per-layer KV
arenas (vLLM-style PagedAttention). Block id 0 is reserved as the null /
scratch block — table entries past a request's resident count point at it,
and writes from freed slots are redirected to it — so the pool allocates ids
in [1, n_blocks]. Blocks are refcounted: a prefix-sharing admission maps the
lender's full prefix blocks into the borrower's table (refcount++) instead
of copying, and `release` only frees a block when its last mapper leaves.

Sharing is restricted to FULL blocks of the cached prefix
(`shareable_blocks` = floor(cached / block_size)): a prefix that ends
mid-block leaves a partial tail block that the borrower must own privately
(its content diverges as the borrower appends), so the tail is always
freshly allocated and copied — crediting `ceil` here (the pre-paging
arithmetic) both under-allocated and let a sharer's release free a block
another request still mapped.

The pool also serves accounting-only admission control for the slot-dense
decode path (`cached_tokens` credit without physical sharing).

With paged prefill the pool is SHARED between the prefill and decode
engines (one arena): decode requests map blocks under their integer rid;
prefill tasks under ("prefill", rid); finished-but-unadmitted handoffs
under ("handoff", i); prefix-store snapshots under ("store", handle). Any
hashable key works — `rid` below is a mapping key, not necessarily an int.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.proxy.radix import RadixTree


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict/list/tuple (other leaves count
    0) — the resident size of a prefix snapshot."""
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if hasattr(tree, "element_size") and hasattr(tree, "numel"):
        return tree.numel() * tree.element_size()
    return 0


@dataclass
class StoreEntry:
    """One stored prefix: `n` tokens of KV as either a dense snapshot
    (`cache` holds the full-attention KV too) or — under paged prefill —
    a refcounted arena block list (`blocks`, held in the pool under this
    entry's key) plus the bounded private leaves (ring KV / mamba state) in
    `cache`. `nbytes` is the REAL resident size (prefix-length KV, not a
    max_len allocation) — what byte-capped LRU eviction weighs. `tail`
    (int8 arenas): the partial tail block as it was published
    (`KVArena.read_block`); the block itself stays shared with the request
    that wrote it, whose decode appends seal it later and re-quantize the
    stored tokens, so adopters copy the published rows instead."""
    n: int
    tokens: tuple
    cache: object
    logits: object
    blocks: Optional[Tuple[int, ...]] = None
    nbytes: int = 0
    tail: Optional[list] = None


class PrefixKVStore:
    """Radix-backed prefix → KV-cache store for the prefill engine.

    Entries are prefix-KV snapshots keyed by full stored prompts. `lookup`
    returns the deepest stored prompt that is a prefix of the query, so
    prefill resumes at that boundary (resuming mid-entry is unsound for
    ring caches — the ring beyond the cut holds later tokens). When
    constructed over the proxy's per-instance RadixTree, eq. 8 Match_P
    scoring and the engine agree on what is actually resident.

    Dense entries hold prefix-LENGTH caches (the engine trims the dense
    max_len allocation before storing); paged entries hold refcounted arena
    block lists adopted in the shared KVPool under ("store", handle) —
    dropping an entry (supersede, LRU, byte-cap, reclaim) releases its
    blocks and detaches its radix handle. Eviction is LRU over BOTH an
    entry-count cap and a real-byte cap, so a 16-token prefix no longer
    weighs the same as a 2048-token one.
    """

    _n_stores = 0       # namespace counter: several stores can share one
                        # pool (one per co-located prefill engine), so pool
                        # keys must be unique ACROSS stores, not just within

    def __init__(self, tree: Optional[RadixTree] = None, capacity: int = 32,
                 pool: Optional["KVPool"] = None,
                 capacity_bytes: Optional[int] = None):
        self.tree = tree if tree is not None else RadixTree()
        self.capacity = capacity
        self.capacity_bytes = capacity_bytes
        self.pool = pool
        self.entries: OrderedDict[int, StoreEntry] = OrderedDict()
        self._next_id = 0
        self._ns = PrefixKVStore._n_stores
        PrefixKVStore._n_stores += 1

    def _key(self, handle: int) -> tuple:
        return ("store", self._ns, handle)

    @property
    def size_bytes(self) -> int:
        return sum(e.nbytes for e in self.entries.values())

    def _drop(self, handle: int):
        ent = self.entries.pop(handle, None)
        if ent is None:
            return
        if ent.blocks is not None and self.pool is not None:
            self.pool.release(self._key(handle))
        self.tree.detach(ent.tokens, handle)

    def put(self, tokens, cache, logits, now: Optional[float] = None, *,
            blocks: Optional[Sequence[int]] = None,
            nbytes: Optional[int] = None, tail: Optional[list] = None):
        """Store a prefix snapshot. `blocks` (paged mode): arena block ids
        covering the prefix — adopted in the pool under this entry's key so
        a later release by the writing request cannot free them. `nbytes`:
        real resident bytes (computed from the tensors when omitted — pass
        it for paged entries, whose arena bytes live outside `cache`).
        `tail`: the published rows of a partial tail block (StoreEntry)."""
        if self.capacity <= 0:
            return
        tokens = tuple(tokens)
        # a payload already attached at exactly this boundary is about to be
        # superseded — drop its entry or the dead snapshot stays resident
        old = None
        for depth, handle in self.tree.payload_prefixes(tokens, now):
            if depth == len(tokens):
                old = handle
        handle = self._next_id
        self._next_id += 1
        if not self.tree.attach(tokens, handle, now):
            return       # tree evicted the path (prompt > tree capacity):
                         # an unreachable entry would only pin memory
        if old is not None:
            self._drop(old)
        if blocks is not None and self.pool is not None:
            self.pool.adopt(self._key(handle), blocks)
        if nbytes is None:
            nbytes = tree_bytes(cache) + tree_bytes(logits)
        self.entries[handle] = StoreEntry(len(tokens), tokens, cache, logits,
                                          tuple(blocks) if blocks is not None
                                          else None, nbytes, tail)
        self._enforce_caps()

    def _enforce_caps(self):
        while len(self.entries) > self.capacity or (
                self.capacity_bytes is not None
                and self.size_bytes > self.capacity_bytes
                and len(self.entries) > 1):
            self._drop(next(iter(self.entries)))

    def lookup_entry(self, tokens, now: Optional[float] = None
                     ) -> Optional[StoreEntry]:
        """Deepest resident stored prefix of `tokens` (LRU-touched)."""
        for depth, handle in reversed(self.tree.payload_prefixes(tokens, now)):
            hit = self.entries.get(handle)
            if hit is not None and hit.n == depth:
                self.entries.move_to_end(handle)
                return hit
        return None

    def lookup(self, tokens, now: Optional[float] = None):
        """→ (n_matched, cache, logits) for the deepest resident stored
        prefix of `tokens`, or (0, None, None)."""
        hit = self.lookup_entry(tokens, now)
        if hit is None:
            return 0, None, None
        return hit.n, hit.cache, hit.logits

    def clear(self):
        """Drop every entry (benchmarks reset between warmup and the
        measured run; paged entries release their pool blocks)."""
        for handle in list(self.entries):
            self._drop(handle)

    def evict_for_blocks(self, n_blocks: int) -> int:
        """Backpressure reclaim: drop LRU paged entries until `n_blocks`
        pool blocks came free (an entry only frees blocks whose last mapper
        it was) or no paged entries remain. → blocks actually freed."""
        if self.pool is None:
            return 0
        start = self.pool.free_blocks
        for handle in list(self.entries):
            if self.pool.free_blocks - start >= n_blocks:
                break
            if self.entries[handle].blocks is not None:
                self._drop(handle)
        return self.pool.free_blocks - start

    def drop_containing(self, blocks) -> int:
        """Corruption recovery: drop every paged entry whose block list
        intersects `blocks` (a set of condemned arena block ids) — a stored
        prefix built on a quarantined block must never seed a resume.
        → number of entries dropped."""
        bad = set(blocks)
        dropped = 0
        for handle in list(self.entries):
            eb = self.entries[handle].blocks
            if eb is not None and bad & set(eb):
                self._drop(handle)
                dropped += 1
        return dropped


@dataclass
class KVPool:
    n_blocks: int                       # allocatable blocks (ids 1..n_blocks)
    block_size: int = 16
    refcount: dict = field(default_factory=dict)       # block id → mappers
    per_request: dict = field(default_factory=dict)    # rid → [block ids]
    _free: List[int] = field(default_factory=list)
    # blocks pulled from circulation by the corruption scan: never returned
    # to the free list, still counted in the conservation invariant
    quarantined: set = field(default_factory=set)
    # FaultPlane hook: next N real allocations/extensions fail as if the
    # pool were exhausted (callers must take their preempt/defer path)
    inject_alloc_failures: int = 0

    def __post_init__(self):
        self._free = list(range(self.n_blocks, 0, -1))   # pop() → id 1 first

    # ---- arithmetic ---------------------------------------------------
    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def shareable_blocks(self, cached_tokens: int) -> int:
        """FULL blocks of a cached prefix — the only ones a borrower may map.
        A prefix ending mid-block leaves a partial tail the borrower must
        own privately (floor, not ceil: the pre-paging bug)."""
        return cached_tokens // self.block_size

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def utilization(self) -> float:
        return 1.0 - len(self._free) / max(self.n_blocks, 1)

    def owned(self, rid: int) -> List[int]:
        return list(self.per_request.get(rid, ()))

    def __contains__(self, rid: int) -> bool:
        """True while `rid` holds any block mapping — abort-hygiene tests
        assert `rid not in pool` after a cancellation in any phase."""
        return rid in self.per_request

    @property
    def live_rids(self) -> List[int]:
        return list(self.per_request)

    # ---- admission ----------------------------------------------------
    def can_admit(self, n_tokens: int, cached_tokens: int = 0) -> bool:
        need = self.blocks_for(n_tokens) - self.shareable_blocks(cached_tokens)
        return max(need, 0) <= len(self._free)

    def allocate(self, rid: int, n_tokens: int, cached_tokens: int = 0,
                 shared: Optional[Sequence[int]] = None) -> Optional[List[int]]:
        """Admit `rid` with capacity for `n_tokens`. → the request's block
        table (logical order) or None if the pool cannot serve it.

        shared: physical block ids mapped from a lender's resident prefix
        (refcounted, never written by the borrower). Without `shared`,
        `cached_tokens` is an accounting-only credit (slot-dense engines):
        floor(cached/block_size) blocks are assumed resident elsewhere.
        """
        if rid in self.per_request:
            raise ValueError(f"rid {rid} already admitted")
        total = self.blocks_for(n_tokens)
        if shared is not None:
            shared = list(shared[:total])
            for b in shared:
                # a shared block must be mapped by SOMEONE (lender, store
                # entry, or pin) — silently refcounting a free-listed id
                # would let the pool hand the same block out twice
                if b not in self.refcount:
                    raise ValueError(f"sharing unmapped block {b}")
            fresh_n = total - len(shared)
        else:
            shared = []
            fresh_n = total - min(self.shareable_blocks(cached_tokens), total)
        if fresh_n > len(self._free):
            return None
        if fresh_n > 0 and self.inject_alloc_failures > 0:
            self.inject_alloc_failures -= 1
            return None
        fresh = [self._free.pop() for _ in range(fresh_n)]
        table = shared + fresh
        for b in table:
            self.refcount[b] = self.refcount.get(b, 0) + 1
        self.per_request[rid] = table
        return table

    def adopt(self, rid, blocks: Sequence[int]) -> List[int]:
        """Map an EXISTING block list under `rid` (refcount++ each; no
        allocation). Prefix-store snapshots and resume borrowers use this:
        the blocks stay alive until every mapper — writer, store entry,
        borrowers — has released."""
        if rid in self.per_request:
            raise ValueError(f"rid {rid} already admitted")
        table = list(blocks)
        for b in table:
            if b not in self.refcount:
                raise ValueError(f"adopting unmapped block {b}")
            self.refcount[b] += 1
        self.per_request[rid] = table
        return table

    def transfer(self, old_rid, new_rid) -> List[int]:
        """Rename a block mapping (zero refcount churn) — the zero-copy
        admission handoff: a finished prefill's blocks move from the
        handoff handle to the decode rid without touching a single byte."""
        if new_rid in self.per_request:
            raise ValueError(f"rid {new_rid} already admitted")
        if old_rid not in self.per_request:
            raise KeyError(f"rid {old_rid} holds no blocks")
        table = self.per_request.pop(old_rid)
        self.per_request[new_rid] = table
        return table

    def extend(self, rid: int, old_tokens: int, new_tokens: int
               ) -> Optional[List[int]]:
        """Grow `rid`'s allocation from old_tokens → new_tokens. → the newly
        allocated block ids ([] if the tail block still has room) or None if
        the pool is exhausted (caller preempts). New blocks are always
        private: shared prefix blocks are full by construction, so growth
        never lands in a block another request maps."""
        need = self.blocks_for(new_tokens) - self.blocks_for(old_tokens)
        if need <= 0:
            return []
        if need > len(self._free):
            return None
        if self.inject_alloc_failures > 0:
            self.inject_alloc_failures -= 1
            return None
        fresh = [self._free.pop() for _ in range(need)]
        for b in fresh:
            self.refcount[b] = self.refcount.get(b, 0) + 1
        self.per_request.setdefault(rid, []).extend(fresh)
        return fresh

    def shrink(self, rid: int, old_tokens: int, new_tokens: int) -> List[int]:
        """Shrink `rid`'s allocation from old_tokens → new_tokens, returning
        the block ids dropped from its table (tail-first order). The
        speculative-decode partial-accept path: blocks pre-extended to cover
        a draft window hand back the never-written tail when the window is
        cut short. Tail blocks past the prefix are private by construction
        (`extend` only allocates fresh ids), so a shrink back to the
        pre-extension count can never cut into a shared prefix; refcounts
        are still honored (a block another mapper holds is unmapped here
        but stays alive), and quarantined blocks skip the free list exactly
        as in `release`."""
        drop = self.blocks_for(old_tokens) - self.blocks_for(new_tokens)
        if drop <= 0:
            return []
        table = self.per_request.get(rid)
        if table is None:
            raise KeyError(f"rid {rid} holds no blocks")
        if drop > len(table):
            raise ValueError(f"shrink past rid {rid}'s table")
        released = []
        for _ in range(drop):
            b = table.pop()
            released.append(b)
            n = self.refcount.get(b, 0) - 1
            if n <= 0:
                self.refcount.pop(b, None)
                if b not in self.quarantined:
                    self._free.append(b)
            else:
                self.refcount[b] = n
        return released

    def release(self, rid: int):
        """Unmap all of `rid`'s blocks; a block returns to the free list only
        when its last mapper releases (prefix sharers keep it alive).
        Quarantined blocks never rejoin the free list."""
        for b in self.per_request.pop(rid, ()):
            n = self.refcount.get(b, 0) - 1
            if n <= 0:
                self.refcount.pop(b, None)
                if b not in self.quarantined:
                    self._free.append(b)
            else:
                self.refcount[b] = n

    def quarantine(self, b: int):
        """Pull block `b` out of circulation (corruption scan hit). A free
        block leaves the free list immediately; a mapped block stays mapped
        until its last holder releases (the caller is responsible for
        restarting those holders), after which `release` skips the free
        list. Idempotent."""
        if b in self.quarantined:
            return
        self.quarantined.add(b)
        try:
            self._free.remove(b)
        except ValueError:
            pass

    # ---- invariants (property tests) ---------------------------------
    def check_invariants(self, arena=None):
        """No block is both free and mapped; refcounts match mapper counts;
        block population is conserved. With `arena` (the KVArena whose
        blocks this pool hands out) additionally asserts the zero-stale-
        summary invariant: every arena block's stored key summaries equal a
        fresh reduction of its content — admission handoff, preemption/
        resume re-admission, and copy_block tail CoW must all leave the
        block-summary metadata plane coherent."""
        if arena is not None:
            arena.check_summaries()
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate ids in free list"
        assert not (free & set(self.refcount)), "block both free and mapped"
        assert not (free & self.quarantined), "quarantined block in free list"
        assert free | set(self.refcount) | self.quarantined \
            == set(range(1, self.n_blocks + 1)), \
            "block population not conserved"
        counts: dict = {}
        for blocks in self.per_request.values():
            assert len(set(blocks)) == len(blocks), "duplicate block in table"
            for b in blocks:
                counts[b] = counts.get(b, 0) + 1
        assert counts == self.refcount, "refcounts diverge from mappings"
