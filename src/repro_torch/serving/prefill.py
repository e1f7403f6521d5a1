"""Prefill engine (the P side of PD disaggregation): chunked over paged or
dense KV, or whole-prompt into dense caches.

Chunked (the model supports it, `LM.chunked_prefill_support`): prompts run
in fixed-size token chunks, scheduled shortest-remaining-first at chunk
granularity, so a short prompt never waits behind a long in-flight
prefill. With a shared KVArena the chunks are paged: each chunk reserves
real KVPool blocks and writes its full-attention KV straight into the
per-layer block arenas through the task's block table, so an in-flight
prompt pins blocks in proportion to its length, and a reservation the pool
cannot serve DEFERS the task (backpressure); ring layers (OmniAttn
sink+recent under `prefill_sparse`, sliding windows) keep a bounded dense
ring per task. Completed prefixes land in a radix-backed PrefixKVStore as
refcounted block lists: a later prompt sharing an N-token prefix maps the
entry's full blocks (copying only the partial tail block) and resumes at
token N. Without an arena (`paged_kv=False`) each task threads a dense B=1
max_len cache through its chunks, and stored prefixes are prefix-length
snapshots that a later prompt resumes from, whole or in part.

Every chunk runs through the placement's "prefill.chunk" hot-loop entry,
keyed by (chunk bucket S, layout): on `cuda` one CUDA graph per key,
replayed for every chunk of every task. The graph reads only engine-owned
static buffers: the chunk's tokens, the task's table row, a [2] device
buffer holding the chunk's offset and real length (uploaded together from
pinned staging), the arenas, and one private cache whose leaves each chunk
copies the task's bounded leaves (ring KV, Mamba-2 state and convolution
rows; dense, the full KV too) into before the replay and back out after; the logits land in a static [1, V] buffer that the task
keeps a clone of.

Whole-prompt (chunking unsupported — OmniAttn-compressed layers without
`prefill_sparse`, the default — or switched off): FIFO, one whole prompt
per `LM.prefill` through the flash-prefill kernel, run through the
"prefill.full" hot-loop entry keyed by the prompt bucket S: its graph reads
the prompt's tokens and true length from one static upload buffer and
writes one static dense B=1 cache (every bucket shares it) and the [1, V]
logits, of which the task keeps clones. The decode engine scatters the
cache into its own layout at admission. Stored prefixes are dense
prefix-length snapshots adopted only by an exact repeat of the whole
prompt.

Over ranks each rank prefills its KV heads (`stack.head_layout`): the
arenas' blocks, each task's dense ring (chunks over it through
`prefill_resume_attention` with the `prefill_sparse` sink + recent mask),
the whole prompt's cache compressed by `compress_prefill_kv`, and the ring
leaves a handoff carries; and its share of each Mamba-2 state and
`conv_x` rows (`stack.mamba_layout`), which a re-prefill rebuilds.

First tokens of every prompt finished in one engine round are sampled in
one fused call (the "prefill.first" entry, keyed by the batch padded to a
power of two and all_greedy) with one host fetch. MoE layers route through
the engine's `tables` (the server rewrites them in place at a migration).
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
from repro_torch.device import torch_dtype
from repro_torch.models.lm import LM
from repro_torch.models.stack import (alloc_cache,
                                      alloc_prefill_private_cache,
                                      full_attn_layer, merge_arena_cache)
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


class StagedUpload:
    """A device int32 buffer of n values written from two alternating
    pinned host stages. No fetch separates two uploads, so an earlier copy
    may still be reading a stage: each is rewritten only after the event
    recorded behind its last copy has completed. `stage()` → the next
    stage as a numpy array to fill; `send()` copies it into `buf`."""

    def __init__(self, n: int, device: torch.device):
        self.buf = torch.zeros(n, dtype=torch.int32, device=device)
        cuda = device.type == "cuda"
        self._stages = [(torch.zeros(n, dtype=torch.int32, pin_memory=cuda),
                         torch.cuda.Event() if cuda else None)
                        for _ in range(2)]
        self._next = 0

    def stage(self) -> np.ndarray:
        stage, done = self._stages[self._next]
        if done is not None:
            done.synchronize()
        return stage.numpy()

    def send(self) -> None:
        stage, done = self._stages[self._next]
        self._next ^= 1
        self.buf.copy_(stage, non_blocking=True)
        if done is not None:
            done.record()


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
        # chunked prefill rides the paged arenas when there are some, else
        # threads a dense B=1 cache; without chunking the engine runs whole
        # prompts into dense caches
        self.paged = bool(self.arena is not None and self.chunked)
        if self.paged:
            self.block_size = self.arena.block_size
        self.store = PrefixKVStore(
            self.tree, self.cache_cap,
            pool=self.arena.pool if self.paged else None,
            capacity_bytes=self.cache_cap_bytes)
        if self.paged:
            self.arena.reclaimers.append(self.store.evict_for_blocks)
        self._logits = torch.zeros(
            (1, self.lm.cfg.vocab_size),
            dtype=torch_dtype(self.lm.cfg.compute_dtype), device=self.device)
        self._tok_bufs: dict = {}
        if self.chunked:
            self._init_chunk_buffers()
        else:
            self._init_full_buffers()
        self._first_bufs: dict = {}
        self._first_step = self.placement.hot_loop(self._first_impl,
                                                   name="prefill.first")

    def _init_chunk_buffers(self):
        """The static buffers of the "prefill.chunk" entry, owned by the
        engine for its life (beside the [1, V] logits): one upload buffer
        holding the chunk's tokens [:chunk], the task's table row
        [chunk:chunk + nb] and (off, chunk_len) at the end, each bucket's
        tokens a [1, S] view of it; the private cache (ring leaves; dense,
        every leaf) composed with the arenas."""
        cfg, plan = self.lm.cfg, self.lm.plan
        self.layout = "paged" if self.paged else "dense"
        nb = -(-self.max_len // self.block_size) if self.paged else 0
        n = self.chunk + nb + 2
        self._upload_buf = StagedUpload(n, self.device)
        self._up = self._upload_buf.buf
        self._row = (self._up[self.chunk:self.chunk + nb].view(1, nb)
                     if self.paged else None)
        self._ctl = self._up[n - 2:]
        self._priv = self._alloc_task_cache()
        cache = (merge_arena_cache(cfg, plan, self._priv, self.arena.kv)
                 if self.paged else self._priv)
        self._cache = dict(cache, pos=self._ctl[0])
        self._leaves = tuple(t for e in self._cache["layers"]
                             if e is not None for t in e.values())
        self._chunk_step = self.placement.hot_loop(
            self._chunk_impl, name="prefill.chunk",
            arenas=lambda: self._cache["layers"])

    def _init_full_buffers(self):
        """The static buffers of the "prefill.full" entry, owned by the
        engine for its life (beside the [1, V] logits): one upload buffer
        holding the prompt's tokens [:max_len] and its true length at the
        end, each bucket's tokens a [1, S] view of it; one dense B=1
        max_len cache that every bucket writes (its leaves are max_len or
        ring-width shaped whatever S is)."""
        self._upload_buf = StagedUpload(self.max_len + 1, self.device)
        self._up = self._upload_buf.buf
        self._ctl = self._up[self.max_len:]
        self._cache = alloc_cache(self.lm.cfg, self.lm.plan, 1, self.max_len,
                                  self.device, tp=self.lm.ctx.tp)
        self._leaves = tuple(t for e in self._cache["layers"]
                             for t in e.values())
        self._full_step = self.placement.hot_loop(self._full_impl,
                                                  name="prefill.full")

    def _alloc_task_cache(self) -> dict:
        """A task's private chunk cache: the bounded leaves (ring KV, mamba
        entries) only when paged (full layers live in the arenas), else
        the dense B=1 max_len cache."""
        cfg, plan = self.lm.cfg, self.lm.plan
        if self.paged:
            return alloc_prefill_private_cache(cfg, plan, self.max_len,
                                               self.device, tp=self.lm.ctx.tp)
        return alloc_cache(cfg, plan, 1, self.max_len, self.device,
                           tp=self.lm.ctx.tp)

    # ---- paged-KV helpers --------------------------------------------
    @staticmethod
    def _pf_key(rid: int) -> tuple:
        return ("prefill", rid)

    def _resize_full_attn(self, cache: dict, length: int,
                          copy_rest: bool = False) -> dict:
        """A copy of a dense B=1 cache whose full-attention KV is sliced or
        zero-padded to `length` tokens (stored prefixes pin prefix-length
        KV, not a max_len allocation). Ring entries are shared unless
        `copy_rest`: a snapshot taken while its task keeps chunking, or a
        stored prefix a task resumes from, must not alias a cache the
        chunks write."""
        cfg = self.lm.cfg
        layers = []
        for spec, e in zip(self.lm.plan.all_specs(), cache["layers"]):
            if e is None or not full_attn_layer(cfg, spec):
                layers.append(clone_tree(e) if copy_rest else e)
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

    def _store_put_paged(self, task: PrefillTask, n: int,
                         copy_private: bool) -> None:
        """Publish the first `n` tokens of a task as a store entry: the
        covering blocks are adopted (refcounted) by the store — zero copy —
        and only the bounded private leaves are snapshotted. On int8 arenas
        a partial tail block's rows are copied too: the task goes on
        writing that block (its next chunk, or its decode appends once
        admitted), and the seal at the block's last slot re-quantizes the
        stored tokens per channel, so an adopter copying the shared block
        would read other KV than this prefill wrote — a restarted request
        re-adopting its own prompt would leave its fault-free stream."""
        pool = self.arena.pool
        blocks = pool.owned(self._pf_key(task.rid))[:pool.blocks_for(n)]
        priv = clone_tree(task.cache) if copy_private else task.cache
        priv = dict(priv, pos=n)
        tail = (self.arena.read_block(blocks[-1])
                if self.arena.quant and n % pool.block_size else None)
        nbytes = (len(blocks) * self.arena.block_nbytes + tree_bytes(priv)
                  + tree_bytes(task.logits) + tree_bytes(tail))
        self.store.put(task.prompt[:n], priv, task.logits, blocks=blocks,
                       nbytes=nbytes, tail=tail)

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
        """Resume from the deepest stored prefix. Dense mode adopts an exact
        hit of the whole prompt (full-attention KV padded back to max_len, a
        new tensor; ring entries shared read-only, as no chunk follows) and,
        chunked with partial reuse on, resumes a shorter prefix from a copy
        of its snapshot."""
        if self.paged:
            self._try_resume_paged(task)
            return
        n, cache, logits = self.store.lookup(task.prompt)
        if cache is None or n <= task.cursor:
            return
        if n == len(task.prompt):
            task.cache = self._resize_full_attn(cache, self.max_len)
        elif self.chunked and self.allow_partial_reuse:
            task.cache = self._resize_full_attn(cache, self.max_len,
                                                copy_rest=True)
            self.stats["prefix_hits"] += 1
            self.stats["reused_tokens"] += n
        else:
            return
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
            if ent.tail is not None:        # int8: the published rows
                self.arena.write_block(ent.tail, tbl[full])
            elif pool.blocks_for(n) > full:     # partial tail → copy
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

    def drop_results(self) -> int:
        """Discard every completed-but-undelivered result and release its
        handoff blocks (a dead instance's results are never drained by the
        server, so their ("handoff", i) keys would leak). → results
        dropped."""
        n = len(self._ready)
        for r in self._ready:
            self._release_result(r)
        self._ready = []
        return n

    def step(self, token_budget: int = 1 << 30) -> list:
        """Run up to `token_budget` tokens of prefill work; → completed
        prompts. Chunked: shortest-remaining-first at chunk granularity,
        whole chunks while the next one fits in the budget (at least one a
        round); a task that cannot grow its block reservation is deferred
        for the round (stats.defers) and retries when blocks come free.
        Whole-prompt: FIFO, whole prompts while budget remains (at least
        one).

        The budget never cuts a chunk (the reference cuts the last one of a
        round to the budget left): on int8 arenas a chunk attends its own
        K/V unquantized and its history dequantized, so the KV a prompt
        leaves depends on where its chunks end. Without cuts the ends are
        set by the prompt, its resume point and its snapshot boundary
        alone, not by the round's mix, so a prompt prefilled again after a
        fault lands the same int8 KV."""
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
                if self.chunked:
                    cl = self._chunk_len(task)
                    if cl > budget and budget < token_budget:
                        break           # the next whole chunk does not fit
                    ran = self._run_chunk(task, cl)
                else:
                    ran = self._run_full(task)
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

    def _chunk_len(self, task: PrefillTask) -> int:
        """Tokens of `task`'s next chunk: a whole chunk, cut only by the
        prompt's end and its snapshot boundary."""
        cl = min(self.chunk, task.remaining)
        if task.cursor < task.snap:
            cl = min(cl, task.snap - task.cursor)   # land on the boundary
        return cl

    def _run_chunk(self, task: PrefillTask, cl: int) -> int:
        t0 = time.monotonic()
        if self.paged and not self._grow_blocks(task, cl):
            self.stats["defers"] += 1
            return 0
        if task.cache is None:
            task.cache = self._alloc_task_cache()
        S = min(_bucket(cl, lo=8), self.chunk)
        self._upload(task, S, cl)
        self._swap(task.cache, into_static=True)
        self._chunk_step((S, self.layout), self._static_inputs(S))
        self._swap(task.cache, into_static=False)
        task.logits = self._logits.clone()
        task.cursor += cl
        task.cache["pos"] = task.cursor
        self.stats["tokens"] += cl
        self.stats["chunks"] += 1
        self._note_peak(task)
        if task.cursor == task.snap:
            shared = task.prompt[:task.snap]
            if self.store.lookup(shared)[0] != task.snap:
                if self.paged:
                    self._store_put_paged(task, task.snap, copy_private=True)
                else:
                    self.store.put(shared, self._resize_full_attn(
                        task.cache, min(_bucket(task.snap, lo=8),
                                        self.max_len), copy_rest=True),
                        task.logits)
        task.compute_s += time.monotonic() - t0
        return cl

    # ---- the "prefill.chunk" hot loop -----------------------------------
    def _upload(self, task: PrefillTask, S: int, cl: int) -> None:
        """The chunk's tokens, the task's table row and (off, chunk_len) in
        one copy from pinned staging into the static upload buffer."""
        a = self._upload_buf.stage()
        a[:cl] = task.prompt[task.cursor:task.cursor + cl]
        a[cl:S] = 0
        if self.paged:
            owned = self.arena.pool.owned(self._pf_key(task.rid))
            row = a[self.chunk:self.chunk + self._row.shape[1]]
            row[:] = 0
            row[:len(owned)] = owned
        a[-2:] = (task.cursor, cl)
        self._upload_buf.send()

    def _swap(self, cache: dict, into_static: bool) -> None:
        """Copy a task's private leaves into the static private cache
        (before the chunk) or back out of it (after)."""
        for s, t in zip(self._priv["layers"], cache["layers"]):
            if s is None:
                continue
            for name, x in s.items():
                if into_static:
                    x.copy_(t[name])
                else:
                    t[name].copy_(x)

    def _tokens(self, S: int) -> torch.Tensor:
        tok = self._tok_bufs.get(S)
        if tok is None:
            tok = self._tok_bufs[S] = self._up[:S].view(1, S)
        return tok

    def _static_inputs(self, S: int) -> tuple:
        return (self._tokens(S), self._row, self._ctl,
                self._logits) + self._leaves

    def _chunk_impl(self, key, tokens, row, ctl, logits, *leaves):
        """The device side of one chunk (the "prefill.chunk" hot loop): the
        chunk through every layer against the static cache (offset and real
        length read from `ctl` on the device), its K/V written into the
        arenas and the private leaves in place, the last real row's logits
        into the static `logits`. key (S, layout). → logits."""
        _, lg, _ = self.lm.prefill_resume(
            self.params, tokens, self._cache, chunk_len=ctl[1],
            block_tables=row, tables=self.tables)
        return logits.copy_(lg)

    # ---- the "prefill.full" hot loop ------------------------------------
    def _run_full(self, task: PrefillTask) -> int:
        """The whole prompt in one `LM.prefill`, right-padded to its pow2
        bucket S (lo=8, capped at max_len) so prompt lengths share shapes:
        tokens and true length uploaded, the "prefill.full" entry run at
        key S, and clones of its static cache and logits kept by the task
        (prefix snapshots and decode admission read them after later
        prompts have rewritten the static ones)."""
        t0 = time.monotonic()
        L = len(task.prompt)
        S = min(_bucket(L, lo=8), self.max_len)
        a = self._upload_buf.stage()
        a[:L] = task.prompt
        a[L:S] = 0
        a[-1] = L
        self._upload_buf.send()
        self._full_step(S, (self._tokens(S), self._ctl, self._logits)
                        + self._leaves)
        task.cache = dict(clone_tree(self._cache), pos=L)
        task.logits = self._logits.clone()
        task.cursor = L
        self.stats["tokens"] += L
        self._note_peak(task)
        task.compute_s += time.monotonic() - t0
        return L

    def _full_impl(self, key, tokens, ctl, logits, *leaves):
        """The device side of one whole prefill (the "prefill.full" hot
        loop): `LM.prefill` of the [1, S] tokens with the true length read
        from `ctl` on the device, its cache copied into the static cache
        and the last real row's logits into the static `logits`. key S.
        → logits."""
        cache, lg, _ = self.lm.prefill(self.params, tokens,
                                       max_len=self.max_len,
                                       true_len=ctl[0], tables=self.tables)
        for s, e in zip(self._cache["layers"], cache["layers"]):
            for name, x in s.items():
                assert x.shape == e[name].shape and x.dtype == e[name].dtype, \
                    (name, x.shape, e[name].shape, x.dtype, e[name].dtype)
                x.copy_(e[name])
        return logits.copy_(lg)

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

    # ---- the "prefill.first" hot loop -----------------------------------
    def sample_first(self, logits_list, params_list, rids, folds
                     ) -> np.ndarray:
        """Sample the first token of a batch of finished prompts under each
        one's SamplingParams in ONE fused call + ONE host fetch, padded to
        a power of two by repeating the last row (as the reference does)
        and run through the "prefill.first" entry at key (npad,
        all_greedy). logits_list: [1, V] tensors; folds: context lengths
        (prompt lengths)."""
        n = len(logits_list)
        npad = _bucket(n, lo=1)
        idx = list(range(n)) + [n - 1] * (npad - n)
        rows = [device_row(params_list[i], rids[i]) for i in idx]
        up, logits, out = self._first_buffers(npad)
        a = up.stage().reshape(6, npad)
        a[0] = np.array([r[0] for r in rows], np.float32).view(np.int32)
        a[1] = [r[1] for r in rows]
        a[2] = np.array([r[2] for r in rows], np.float32).view(np.int32)
        a[3:5] = np.stack([r[3] for r in rows]).astype(np.uint32).T.view(
            np.int32)
        a[5] = [folds[i] for i in idx]
        up.send()
        for i, j in enumerate(idx):
            logits[i].copy_(logits_list[j][0])
        all_greedy = all(r[0] <= 0.0 for r in rows)
        self._first_step((npad, all_greedy), (up.buf, logits, out))
        toks = out.cpu().numpy()        # the round's single host fetch
        self.stats["host_fetches"] += 1
        return toks[:n]

    def _first_buffers(self, npad: int) -> tuple:
        """The static inputs of "prefill.first" at batch npad, allocated at
        its first use and kept: the upload of (temperature, top_k, top_p,
        key[0], key[1], fold) rows (the floats by their bits), the [npad,
        V] logits and the [npad] tokens."""
        bufs = self._first_bufs.get(npad)
        if bufs is None:
            bufs = self._first_bufs[npad] = (
                StagedUpload(6 * npad, self.device),
                torch.zeros((npad, self._logits.shape[1]),
                            dtype=self._logits.dtype, device=self.device),
                torch.zeros(npad, dtype=torch.int32, device=self.device))
        return bufs

    def _first_impl(self, key, up, logits, out):
        """The device side of one round's first tokens (the "prefill.first"
        hot loop): the fused draw of `sample_tokens` over the static logits
        with the rows' parameters read from the upload. key (npad,
        all_greedy). → out."""
        npad, all_greedy = key
        u = up.view(6, npad)
        return out.copy_(sample_tokens(
            logits, u[0].view(torch.float32), u[1], u[2].view(torch.float32),
            u[3:5].t(), u[5], all_greedy=all_greedy))
