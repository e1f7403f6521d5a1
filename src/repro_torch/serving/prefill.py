"""Prefill engine (the P side of PD disaggregation): chunked over paged KV,
or whole-prompt into dense caches.

Chunked (the model supports it, `LM.chunked_prefill_support`, and a shared
KVArena is given): prompts run in fixed-size token chunks, scheduled
shortest-remaining-first at chunk granularity, so a short prompt never
waits behind a long in-flight prefill. Each chunk reserves real KVPool
blocks and writes its KV straight into the per-layer block arenas through
the task's block table, so an in-flight prompt pins blocks in proportion to
its length, and a reservation the pool cannot serve DEFERS the task
(backpressure). Completed prefixes land in a radix-backed PrefixKVStore as
refcounted block lists: a later prompt sharing an N-token prefix maps the
entry's full blocks (copying only the partial tail block) and resumes at
token N.

Whole-prompt (chunking unsupported — OmniAttn-compressed layers without
`prefill_sparse`, the default — or switched off): FIFO, one whole prompt
per `LM.prefill` call through the flash-prefill kernel, into a dense B=1
cache that the decode engine scatters into its own layout at admission.
Stored prefixes are dense prefix-length snapshots adopted only by an exact
repeat of the whole prompt.

First tokens of every prompt finished in one engine round are sampled in
one fused call with one host fetch. MoE layers route through the engine's
`tables` (the server rewrites them in place at a migration).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core.proxy.params import GREEDY, SamplingParams, device_row
from repro_torch.core.proxy.radix import RadixTree
from repro_torch.models.lm import LM
from repro_torch.models.stack import (alloc_prefill_private_cache,
                                      full_attn_layer, merge_arena_cache,
                                      split_arena_cache)
from repro_torch.serving.arena import (BlockHandoff, KVArena, _bucket,
                                       _pow2_floor)
from repro_torch.serving.kvpool import PrefixKVStore, tree_bytes
from repro_torch.serving.placement import DevicePlacement
from repro_torch.serving.sampling import sample_tokens


def clone_tree(tree):
    """Deep copy of every tensor in a nested dict/list (snapshots must not
    alias the task's live private state)."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return tree


@dataclass
class PrefillTask:
    rid: int
    prompt: tuple
    cache: object = None              # B=1 private cache (None until started)
    logits: object = None             # last-token logits of the latest chunk
    cursor: int = 0                   # tokens resident (incl. reused prefix)
    reused: int = 0                   # prefix tokens resumed from the store
    snap: int = 0                     # snapshot boundary (shared-prefix hint)
    params: SamplingParams = GREEDY   # first-token decoding config
    t_start: float = 0.0
    compute_s: float = 0.0            # pure prefill compute (excl. queue wait)
    handoff: object = None            # BlockHandoff once finished

    @property
    def remaining(self) -> int:
        return len(self.prompt) - self.cursor


@dataclass
class PrefillResult:
    rid: int
    cache: object
    first_token: int
    prompt_len: int
    reused: int
    elapsed_s: float                  # prefill compute time (EWMA batch time)
    t_done: float = 0.0               # wall time the first token materialized


@dataclass
class PrefillEngine:
    _next_handoff_id = 0              # shared-pool-unique handoff keys
    lm: LM
    params: dict
    max_len: int
    arena: Optional[KVArena] = None   # shared paged-KV runtime → paged mode
    chunk_tokens: int = 64            # target chunk size (TTFT/TPOT knob)
    enable_chunked: bool = True
    allow_partial_reuse: bool = True
    cache_cap: int = 32               # PrefixKVStore entries
    cache_cap_bytes: Optional[int] = None   # PrefixKVStore byte cap (LRU)
    tree: Optional[RadixTree] = None  # share the proxy's per-instance tree
    block_size: int = 16              # accounting granularity (dense mode)
    placement: Optional[DevicePlacement] = None
    tables: Optional[dict] = None     # MoE placement tables (rewritten in
                                      # place by the server at migration)
    stats: dict = field(default_factory=lambda: {
        "prefills": 0, "cache_hits": 0, "prefix_hits": 0, "reused_tokens": 0,
        "tokens": 0, "chunks": 0, "busy_s": 0.0, "host_fetches": 0,
        "blocks_mapped": 0, "prefill_kv_peak_blocks": 0, "defers": 0})

    def __post_init__(self):
        if self.placement is None:
            self.placement = (self.arena.placement if self.arena is not None
                              else DevicePlacement.of(self.lm.device))
        self.device = self.placement.device
        self.queue: deque = deque()
        self._ready: list = []
        sup, limit = self.lm.chunked_prefill_support
        self.chunk = _pow2_floor(max(min(self.chunk_tokens, limit), 1))
        self.chunked = bool(self.enable_chunked and sup and self.chunk >= 8)
        # chunked prefill rides the paged arenas; without chunking the
        # engine runs whole prompts into dense caches
        self.paged = bool(self.arena is not None and self.chunked)
        if self.chunked:
            cfg = self.lm.cfg
            if not self.paged or any(
                    s.kind == "attn" and not full_attn_layer(cfg, s)
                    for s in self.lm.plan.all_specs()):
                # the reference's `prefill_resume_attention` path
                raise NotImplementedError(
                    "chunked prefill over ring layers (sliding window, or "
                    "compressed with prefill_sparse) or over dense KV "
                    "(paged_kv=False) is not ported yet; chunked_prefill="
                    "False serves such a model whole-prompt")
            self.block_size = self.arena.block_size
        self.store = PrefixKVStore(
            self.tree, self.cache_cap,
            pool=self.arena.pool if self.paged else None,
            capacity_bytes=self.cache_cap_bytes)
        if self.paged:
            self.arena.reclaimers.append(self.store.evict_for_blocks)

    # ---- paged-KV helpers --------------------------------------------
    @staticmethod
    def _pf_key(rid: int) -> tuple:
        return ("prefill", rid)

    def _resize_full_attn(self, cache: dict, length: int) -> dict:
        """A copy of a dense B=1 cache whose full-attention KV is sliced or
        zero-padded to `length` tokens (stored prefixes pin prefix-length
        KV, not a max_len allocation). Ring entries are shared, not copied:
        nothing writes a B=1 cache after its prefill — admission copies it
        into the decode engine's own layout."""
        cfg = self.lm.cfg
        layers = []
        for spec, e in zip(self.lm.plan.all_specs(), cache["layers"]):
            if e is None or not full_attn_layer(cfg, spec):
                layers.append(e)
                continue
            ent = {}
            for name, x in e.items():
                W = x.shape[1]
                if W >= length:
                    ent[name] = x[:, :length].clone()
                else:
                    ent[name] = torch.nn.functional.pad(
                        x, (0, 0, 0, 0, 0, length - W))
            layers.append(ent)
        return {"layers": layers, "pos": cache["pos"]}

    def _grow_blocks(self, task: PrefillTask, cl: int) -> bool:
        """Reserve pool blocks for the next `cl` chunk tokens. On
        exhaustion, reclaim shared cache (LRU store entries) and retry;
        still short → False (the caller defers this task)."""
        pool, key = self.arena.pool, self._pf_key(task.rid)
        target = task.cursor + cl

        def attempt():
            if key in pool:
                return pool.extend(key, task.cursor, target)
            return pool.allocate(key, target)

        got = attempt()
        if got is None:
            held = len(pool.owned(key)) if key in pool else 0
            need = pool.blocks_for(target) - held - pool.free_blocks
            self.arena.reclaim(max(need, 1))
            got = attempt()
        return got is not None

    def _table_row(self, rid: int) -> torch.Tensor:
        nb = -(-self.max_len // self.block_size)
        row = np.zeros((1, nb), np.int32)
        owned = self.arena.pool.owned(self._pf_key(rid))
        row[0, :len(owned)] = owned
        return torch.from_numpy(row).to(self.device)

    def _store_put_paged(self, task: PrefillTask, n: int,
                         copy_private: bool) -> None:
        """Publish the first `n` tokens of a task as a store entry: the
        covering blocks are adopted (refcounted) by the store — zero copy —
        and only the bounded private leaves are snapshotted."""
        pool = self.arena.pool
        blocks = pool.owned(self._pf_key(task.rid))[:pool.blocks_for(n)]
        priv = clone_tree(task.cache) if copy_private else task.cache
        priv = dict(priv, pos=n)
        nbytes = (len(blocks) * self.arena.block_nbytes + tree_bytes(priv)
                  + tree_bytes(task.logits))
        self.store.put(task.prompt[:n], priv, task.logits, blocks=blocks,
                       nbytes=nbytes)

    def _release_result(self, rec: PrefillResult) -> None:
        """Drop an undelivered result (supersede/abort): its handoff still
        owns pool blocks nobody will admit."""
        if isinstance(rec.cache, BlockHandoff):
            self.arena.pool.release(rec.cache.key)

    def _note_peak(self, task: PrefillTask) -> None:
        """Peak KV blocks pinned by a single in-flight prefill: a paged task
        grows per chunk, so it is blocks_for(prompt_len); a dense task pins
        a max_len cache whatever its length."""
        if self.paged:
            held = len(self.arena.pool.owned(self._pf_key(task.rid)))
        else:
            held = -(-self.max_len // self.block_size)
        if held > self.stats["prefill_kv_peak_blocks"]:
            self.stats["prefill_kv_peak_blocks"] = held

    # ---- scheduling --------------------------------------------------
    def start(self, rid: int, prompt: tuple, prefix_hint: int = 0,
              params: Optional[SamplingParams] = None) -> None:
        """Enqueue a prompt. Exact store hits complete on the next step();
        partial hits resume at the stored boundary. prefix_hint (the
        proxy's Match_P) marks a prefix shared with other prompts: the task
        snapshots its cache at that boundary so later sharers resume
        there."""
        for t in list(self.queue):
            if t.rid == rid:
                self.queue.remove(t)
                if self.paged:
                    self.arena.pool.release(self._pf_key(rid))
        for r in self._ready:
            if r.rid == rid:
                self._release_result(r)
        self._ready = [r for r in self._ready if r.rid != rid]
        task = PrefillTask(rid, tuple(prompt), params=params or GREEDY,
                           t_start=time.monotonic())
        if (self.chunked and self.allow_partial_reuse
                and 8 <= prefix_hint < len(task.prompt)):
            task.snap = prefix_hint
        self._try_resume(task)
        self.queue.append(task)

    def _try_resume(self, task: PrefillTask) -> None:
        """Resume from the deepest stored prefix. Dense (whole-prompt) mode
        adopts only an exact hit of the whole prompt: its stored cache,
        full-attention KV padded back to max_len (a new tensor), ring
        entries shared read-only (see `_resize_full_attn`)."""
        if self.paged:
            self._try_resume_paged(task)
            return
        n, cache, logits = self.store.lookup(task.prompt)
        if cache is None or n <= task.cursor or n != len(task.prompt):
            return
        task.cache = self._resize_full_attn(cache, self.max_len)
        task.logits = logits
        task.cursor = task.reused = n

    def _try_resume_paged(self, task: PrefillTask) -> None:
        """Map the deepest stored prefix's FULL blocks into the task's table
        (refcount++, zero copy); a partial tail block is copied into a
        private block, since its content diverges as the task appends."""
        ent = self.store.lookup_entry(task.prompt)
        if ent is None or ent.n <= task.cursor or ent.blocks is None:
            return
        if not (self.allow_partial_reuse or ent.n == len(task.prompt)):
            return
        pool, key = self.arena.pool, self._pf_key(task.rid)
        if key in pool:                 # mid-flight deepening is unsound
            return
        n = ent.n
        full = n // pool.block_size
        # pin the entry's blocks: reclaim below may evict this very entry,
        # and its released blocks must not reach the free list while they
        # are being mapped (and the tail read for the copy)
        pin = ("resume-pin", task.rid)
        pool.adopt(pin, ent.blocks)
        try:
            tbl = pool.allocate(key, n, shared=ent.blocks[:full])
            if tbl is None:
                self.arena.reclaim(pool.blocks_for(n) - full)
                tbl = pool.allocate(key, n, shared=ent.blocks[:full])
                if tbl is None:
                    return              # backpressure: prefill from scratch
            if pool.blocks_for(n) > full:   # partial tail → copy-on-write
                self.arena.copy_block(ent.blocks[full], tbl[full])
        finally:
            pool.release(pin)
        task.cache = clone_tree(ent.cache)
        task.logits = ent.logits
        task.cursor = task.reused = n
        self.stats["blocks_mapped"] += full
        if n < len(task.prompt):
            self.stats["prefix_hits"] += 1
            self.stats["reused_tokens"] += n

    def has_work(self) -> bool:
        return bool(self.queue or self._ready)

    def abort(self, rid: int) -> bool:
        """Drop a queued / in-flight / completed-but-undelivered prompt and
        release its pool blocks; store snapshots it published stay (they
        are shared cache, refcounted under the store's own key)."""
        hit = False
        for t in list(self.queue):
            if t.rid == rid:
                self.queue.remove(t)
                hit = True
        if self.paged:
            self.arena.pool.release(self._pf_key(rid))
        n0 = len(self._ready)
        for r in self._ready:
            if r.rid == rid:
                self._release_result(r)
        self._ready = [r for r in self._ready if r.rid != rid]
        return hit or len(self._ready) != n0

    def step(self, token_budget: int = 1 << 30) -> list:
        """Run up to `token_budget` tokens of prefill work; → completed
        prompts. Chunked: shortest-remaining-first at chunk granularity; a
        task that cannot grow its block reservation is deferred for the
        round (stats.defers) and retries when blocks come free. Whole-prompt:
        FIFO, whole prompts while budget remains (at least one)."""
        done, budget = self._ready, token_budget
        self._ready = []
        fresh: list = []
        blocked: set = set()
        t0 = time.monotonic()
        while budget > 0:
            cands = [t for t in self.queue if t.rid not in blocked]
            if not cands:
                break
            task = (min(cands, key=lambda t: t.remaining)
                    if self.chunked else cands[0])
            if task.cursor == 0:
                # entries stored since enqueue (a queued sharer's snapshot)
                # are visible to tasks that have not started
                self._try_resume(task)
            if task.remaining > 0:
                ran = (self._run_chunk(task, min(budget, self.chunk))
                       if self.chunked else self._run_full(task))
                if ran == 0 and task.remaining > 0:
                    blocked.add(task.rid)       # pool backpressure: defer
                    continue
                budget -= ran
            if task.remaining == 0:
                self.queue.remove(task)
                fresh.append(self._finish(task))
        if fresh:
            done.extend(self._emit(fresh))
        self.stats["busy_s"] += time.monotonic() - t0
        return done

    def _run_chunk(self, task: PrefillTask, budget: int) -> int:
        t0 = time.monotonic()
        cl = min(self.chunk, task.remaining, max(budget, 1))
        if task.cursor < task.snap:
            cl = min(cl, task.snap - task.cursor)   # land on the boundary
        if not self._grow_blocks(task, cl):
            self.stats["defers"] += 1
            return 0
        if task.cache is None:
            task.cache = alloc_prefill_private_cache(
                self.lm.cfg, self.lm.plan, self.max_len, self.device)
        S = min(_bucket(cl, lo=8), self.chunk)
        toks = list(task.prompt[task.cursor:task.cursor + cl]) + [0] * (S - cl)
        cfg, plan = self.lm.cfg, self.lm.plan
        # the composed cache's full-attention entries ARE the shared arenas;
        # the chunk's K/V is written into the task's blocks in place
        composed = merge_arena_cache(cfg, plan, task.cache, self.arena.kv)
        composed, task.logits, _ = self.lm.prefill_resume(
            self.params,
            torch.tensor([toks], dtype=torch.int32, device=self.device),
            composed, chunk_len=cl, block_tables=self._table_row(task.rid),
            tables=self.tables)
        task.cache, _ = split_arena_cache(cfg, plan, composed)
        task.cursor += cl
        self.stats["tokens"] += cl
        self.stats["chunks"] += 1
        self._note_peak(task)
        if task.cursor == task.snap:
            if self.store.lookup(task.prompt[:task.snap])[0] != task.snap:
                self._store_put_paged(task, task.snap, copy_private=True)
        task.compute_s += time.monotonic() - t0
        return cl

    def _run_full(self, task: PrefillTask) -> int:
        """The whole prompt in one `LM.prefill`, right-padded to its pow2
        bucket (lo=8, capped at max_len) so prompt lengths share shapes."""
        t0 = time.monotonic()
        S = len(task.prompt)
        pad = min(_bucket(S, lo=8), self.max_len) - S
        toks = torch.tensor([list(task.prompt) + [0] * pad],
                            dtype=torch.int32, device=self.device)
        task.cache, task.logits, _ = self.lm.prefill(
            self.params, toks, max_len=self.max_len, true_len=S,
            tables=self.tables)
        task.cursor = S
        self.stats["tokens"] += S
        self._note_peak(task)
        task.compute_s += time.monotonic() - t0
        return S

    def _finish(self, task: PrefillTask) -> PrefillTask:
        """Store bookkeeping for a completed prompt. Paged tasks turn into a
        BlockHandoff: pool ownership moves from the task to the handoff
        record, which admission later renames to the decode rid — zero copy
        end to end. Dense tasks store a prefix-length snapshot. The first
        token is sampled for the whole round in `_emit`."""
        L = len(task.prompt)
        if task.reused == L:                    # whole prompt adopted
            self.stats["cache_hits"] += 1
        else:
            self.stats["prefills"] += 1
            if self.paged:
                self._store_put_paged(task, L, copy_private=False)
            else:
                self.store.put(task.prompt, self._resize_full_attn(
                    task.cache, min(_bucket(L, lo=8), self.max_len)),
                    task.logits)
        if not self.paged:
            return task
        pool, key = self.arena.pool, self._pf_key(task.rid)
        # class-level counter: engines sharing one pool need handoff keys
        # unique across engines
        hkey = ("handoff", PrefillEngine._next_handoff_id)
        PrefillEngine._next_handoff_id += 1
        blocks = tuple(pool.transfer(key, hkey))
        task.handoff = BlockHandoff(hkey, blocks, task.cache, L)
        return task

    def _emit(self, tasks: list) -> list:
        toks = self.sample_first([t.logits for t in tasks],
                                 [t.params for t in tasks],
                                 [t.rid for t in tasks],
                                 [len(t.prompt) for t in tasks])
        t_done = time.monotonic()
        return [PrefillResult(t.rid, t.handoff if t.handoff is not None
                              else t.cache, int(tok), len(t.prompt),
                              t.reused, t.compute_s, t_done)
                for t, tok in zip(tasks, toks)]

    def sample_first(self, logits_list, params_list, rids, folds
                     ) -> np.ndarray:
        """Sample the first token of a batch of finished prompts under each
        one's SamplingParams in ONE fused call + ONE host fetch.
        logits_list: [1, V] tensors; folds: context lengths (prompt
        lengths)."""
        dev = self.device
        rows = [device_row(p, r) for p, r in zip(params_list, rids)]
        logits = torch.cat(list(logits_list), dim=0)
        temp = torch.tensor([r[0] for r in rows], dtype=torch.float32,
                            device=dev)
        tk = torch.tensor([r[1] for r in rows], dtype=torch.int32, device=dev)
        tp = torch.tensor([r[2] for r in rows], dtype=torch.float32,
                          device=dev)
        keys = torch.from_numpy(
            np.stack([r[3] for r in rows]).astype(np.int64)).to(dev)
        fold = torch.tensor(list(folds), dtype=torch.int32, device=dev)
        out = sample_tokens(logits, temp, tk, tp, keys, fold,
                            all_greedy=all(r[0] <= 0.0 for r in rows))
        out = out.cpu().numpy()         # the round's single host fetch
        self.stats["host_fetches"] += 1
        return out
