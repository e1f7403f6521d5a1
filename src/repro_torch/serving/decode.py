"""Continuous-batch decode engine (the D side of PD disaggregation).

With a KVArena (paged): full-attention KV lives in the shared per-layer
block arenas, each ring layer (OmniAttn sink+recent, sliding window) in
the engine's per-slot ring block runs and each Mamba-2 layer's recurrent
state in its per-slot rows. Admission is either a zero-copy BlockHandoff
(the chunked prefill engine already wrote the blocks; pool ownership
renames to the decode rid, and only the handoff's bounded private leaves
are written into the slot) or a dense scatter of a B=1 cache into
fresh blocks (whole-prompt prefill, and re-admission after preemption). A
step that cannot grow a request's allocation reclaims prefix-store blocks
first and then preempts the request (its KV is gathered back out of the
arenas for later re-admission).

Without one (slot-dense): caches [n_slots, W, K, h] per attention layer,
attended by the sink-decode kernel, and the per-slot mamba rows, with an
accounting-only KVPool for admission control and preemption.

Paged engines run OmniAttn online top-k block selection when
cfg.omniattn sets a budget (`sparsity`, a SparsityController), and SpecPlane
speculative decoding when given a SpecConfig (`spec_ctl`): drafts gathered
on the host, one batched read-only verify forward over [n_slots, k+1]
window positions, the greedy-prefix acceptance on the device, and a masked
commit of the accepted rows. The slot-dense layout refuses speculation and
ignores the top-k knobs, as the reference does.

Over ranks every leaf is the rank's: the arenas, the ring block runs, the
slot-dense caches and the handoff and preemption leaves hold its KV heads
(`stack.head_layout`) and its share of each Mamba-2 state and `conv_x`
rows (`stack.mamba_layout`), and a ring run's slot arithmetic
(`attn_mod.ring_slot`) is the same on every rank; int8 arenas hold the
rank's KV heads with their scale plane. Top-k stats are the same on every
rank (the selection follows one max over `model`), and so are the
speculation stats: drafts come from the host's tokens alone, and the
verify step's accept decision from logits every rank holds whole, so
every rank accepts the same prefix and commits, rolls back and emits
alike. Both are drained per rank and never summed over ranks.

MoE layers route through the engine's `tables`; each step adds the live
rows' expert counts to a [L_moe, E] device accumulator that the server
drains at placement ticks (`take_moe_counts`); a verify step adds the
counts of every window row of a live slot, as the reference's does.

Slot state (position, current token, active flag, per-slot sampling
parameters and base keys, the sparsity, speculation and MoE-count
accumulators) lives
on the device and is updated in place by the step, so a decode step does
exactly ONE device→host fetch: the sampled tokens, or the packed verify
window (`host_fetches == steps`).

The decode step and the verify step are hot-loop entries of the placement
(`DevicePlacement.hot_loop`): on `cuda` each is one captured CUDA graph per
key, replayed every step. The key is (table bucket nb, or None on the
slot-dense layout; all_greedy), the only Python values that reach a
captured op besides the engine's fixed shapes. Everything else the steps
read or write is static for the engine's life: the slot state, the arenas
and ring runs, one [n_slots, nb] table buffer per bucket (filled from a
pinned host copy), the verify step's draft buffers, and the static outputs
the single fetch reads.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core.proxy.params import device_row
from repro_torch.device import torch_dtype
from repro_torch.models import attention as attn_mod
from repro_torch.models.lm import LM
from repro_torch.models.stack import (alloc_cache, alloc_paged_private_cache,
                                      cache_window, full_attn_layer,
                                      head_layout, mamba_cache_shapes,
                                      merge_arena_cache, ring_block_count)
from repro_torch.serving.arena import (BlockHandoff, KVArena, _bucket,
                                       blocks_to_dense_kv, dense_kv_to_blocks)
from repro_torch.serving.kvpool import KVPool, tree_bytes
from repro_torch.serving.placement import DevicePlacement
from repro_torch.serving.sampling import sample_tokens
from repro_torch.serving.sparsity import SparsityController
from repro_torch.serving.spec import SpecConfig, SpecController
from repro_torch.serving.stats import drain_accumulator


HBM_BUDGET_BYTES = 1 << 34     # sizes the dense accounting pool (reference)


@dataclass
class DecodeEngine:
    lm: LM
    params: dict
    n_slots: int
    max_len: int
    arena: Optional[KVArena] = None   # shared paged-KV runtime; None →
                                      # slot-dense caches
    kv_blocks: Optional[int] = None   # dense accounting pool size
    block_size: int = 16              # dense accounting granularity
    placement: Optional[DevicePlacement] = None
    spec: Optional[SpecConfig] = None   # model-free speculative decoding
    spec_radix: Optional[object] = None  # proxy RadixTree for draft lookup
    tables: Optional[dict] = None     # MoE placement tables (rewritten in
                                      # place by the server at migration)
    stats: dict = field(default_factory=lambda: {
        "steps": 0, "tokens": 0, "busy_s": 0.0, "kv_transfer_bytes": 0,
        "kv_transfer_bytes_padded": 0, "handoff_copy_bytes": 0,
        "admits": 0, "preemptions": 0, "blocks_touched": 0,
        "blocks_shared": 0, "blocks_fresh": 0, "host_fetches": 0})

    def __post_init__(self):
        cfg, plan = self.lm.cfg, self.lm.plan
        if self.placement is None:
            self.placement = (self.arena.placement if self.arena is not None
                              else DevicePlacement.of(self.lm.device))
        dev = self.device = self.placement.device
        self.paged = self.arena is not None
        if self.paged:
            self.pool = self.arena.pool
            self.block_size = self.arena.block_size
            self.max_blocks = -(-self.max_len // self.block_size)
            # engine-private side: the per-slot ring block runs (the
            # full-attention arenas live in the shared KVArena)
            self.cache = alloc_paged_private_cache(
                cfg, plan, self.n_slots, self.max_len, self.block_size, dev,
                tp=self.lm.ctx.tp)
            self.tables_h = np.zeros((self.n_slots, self.max_blocks),
                                     np.int32)
            # one static device table per bucket nb, each with its pinned
            # host staging copy: the captured steps read the table in place
            self._tbl_bufs: dict = {}
            self._tbl_dev = None
            self._tbl_bucket = None
            self._tbl_dirty = True
            # online top-k block selection, resolved once from
            # cfg.omniattn (the layers read the same config)
            self.sparsity = SparsityController.from_model(
                cfg, plan, self.block_size, self.max_blocks)
        else:
            # online top-k selects arena blocks: on the slot-dense layout
            # its knobs are ignored, as the reference ignores them (it
            # builds the controller in the paged branch only)
            self.sparsity = None
            self.max_blocks = -(-self.max_len // self.block_size)
            self.cache = alloc_cache(cfg, plan, self.n_slots, self.max_len,
                                     dev, tp=self.lm.ctx.tp)
            if self.kv_blocks is None:
                per_slot = tree_bytes(self.cache) // max(self.n_slots, 1)
                budget = max(HBM_BUDGET_BYTES // max(per_slot, 1),
                             self.n_slots) * 4
                # the reference's sizing: blocks for 4 x the slots a
                # HBM_BUDGET_BYTES budget holds, capped at 4 x the
                # physical capacity (at full width with sink+recent rings
                # it admits a single max_len request)
                self.kv_blocks = min(budget,
                                     self.n_slots * self.max_blocks * 4)
            self.pool = KVPool(n_blocks=self.kv_blocks,
                               block_size=self.block_size)
        self.kv_blocks = self.pool.n_blocks
        if self.sparsity is not None:
            self.stats.update(SparsityController.stats_keys())
        # speculation: drafting state lives host-side in the controller; the
        # verify is one batched forward over [n_slots, k+1] positions
        self.spec_ctl = SpecController.from_model(
            self.lm, self.spec, sparsity=self.sparsity, radix=self.spec_radix)
        if self.spec_ctl is not None:
            if not self.paged:
                raise ValueError("speculative decoding requires paged "
                                 "attention KV (block/summary rollback is "
                                 "defined on the paged plane)")
            self.stats.update(SpecController.stats_keys())
        # transfer-cost metering: a B=1 dense interchange cache holds
        # max_len tokens of full-attention KV plus the bounded ring KV (and
        # the int32 position); the TRUE payload grows by `_full_tok_nbytes`
        # per resident token (this rank's KV heads and Mamba-2 share)
        tp = self.lm.ctx.tp
        it = torch_dtype(cfg.compute_dtype).itemsize
        kvh = 2 * head_layout(cfg, tp).nk * cfg.head_dim * it
        specs = plan.all_specs()
        n_full = sum(1 for sp in specs if full_attn_layer(cfg, sp))
        self._full_tok_nbytes = kvh * n_full
        # bounded leaves: ring KV and each mamba layer's state and
        # convolution rows
        mamba_nbytes = sum(
            math.prod(shp) * dt.itemsize
            for shp, dt in mamba_cache_shapes(cfg, 1, tp=tp).values())
        bounded = sum(mamba_nbytes if sp.kind == "mamba" else
                      kvh * sum(cache_window(cfg, sp)) for sp in specs
                      if not full_attn_layer(cfg, sp))
        self._dense_kv_nbytes = (self._full_tok_nbytes * self.max_len
                                 + bounded + 4)
        self.free = list(range(self.n_slots))
        self.slot_rid: dict = {}
        self.rid_slot: dict = {}
        self._prompts: dict = {}       # live rid → prompt (prefix sharing)
        n = self.n_slots
        self.state = {
            "pos": torch.zeros(n, dtype=torch.int32, device=dev),
            "tok": torch.zeros(n, dtype=torch.int32, device=dev),
            "active": torch.zeros(n, dtype=torch.bool, device=dev),
            "temp": torch.zeros(n, dtype=torch.float32, device=dev),
            "top_k": torch.zeros(n, dtype=torch.int32, device=dev),
            "top_p": torch.ones(n, dtype=torch.float32, device=dev),
            "key": torch.zeros((n, 2), dtype=torch.int64, device=dev)}
        if self.sparsity is not None:
            # [blocks_scored, blocks_attended, mass_sum, mass_n], summed
            # over layers on the device; drained by take_sparsity_stats()
            self.state["sparsity"] = torch.zeros(4, dtype=torch.float32,
                                                 device=dev)
        n_moe = sum(1 for sp in plan.all_specs() if sp.use_moe)
        if n_moe:
            # expert activation counts [L_moe, E] of the live rows,
            # accumulated on the device; drained only at placement ticks
            # (take_moe_counts)
            self.state["moe_counts"] = torch.zeros(
                (n_moe, cfg.moe.n_experts), dtype=torch.float32, device=dev)
        if self.spec_ctl is not None:
            # [drafted, accepted, emitted, verifies]; drained by
            # take_spec_stats()
            self.state["spec"] = torch.zeros(4, dtype=torch.float32,
                                             device=dev)
        # the static outputs the per-step fetch reads, and the hot-loop
        # entries of the two steps
        self._next = torch.zeros(n, dtype=torch.int32, device=dev)
        self._step = self.placement.hot_loop(self._step_impl,
                                             name="decode.step",
                                             arenas=self._cache_layers)
        if self.spec_ctl is not None:
            k = self.spec_ctl.k
            self._drafts = (torch.zeros((n, k), dtype=torch.int32,
                                        device=dev), self._stage((n, k)))
            self._dlen = (torch.zeros(n, dtype=torch.int32, device=dev),
                          self._stage((n,)))
            self._packed = torch.zeros((n, k + 2), dtype=torch.int32,
                                       device=dev)
            self._verify = self.placement.hot_loop(self._verify_impl,
                                                   name="decode.verify",
                                                   arenas=self._cache_layers)
        self.pos_h = np.zeros(n, np.int64)      # next write position
        self.tok_h = np.zeros(n, np.int64)      # current input token
        self.tokens_h = np.zeros(n, np.int64)   # pool-accounted tokens
        self.greedy_h = np.ones(n, bool)        # slot temperature <= 0
        self.preempted: list = []   # (rid, cache_one, next_tok, pos)

    # ---- static buffers ----------------------------------------------
    def _stage(self, shape) -> torch.Tensor:
        """An int32 host staging copy, pinned on the card."""
        return torch.zeros(shape, dtype=torch.int32,
                           pin_memory=self.device.type == "cuda")

    @staticmethod
    def _upload(buf_stage: tuple, arr) -> torch.Tensor:
        """Copy the host int array `arr` into a static device buffer
        through its pinned staging copy (buf_stage = (buffer, staging)).
        The previous step's fetch has synchronised the stream, so no
        earlier copy still reads the staging copy."""
        buf, stage = buf_stage
        stage.numpy()[...] = arr
        buf.copy_(stage, non_blocking=True)
        return buf

    def _all_greedy(self) -> bool:
        return bool(all(self.greedy_h[s] for s in self.slot_rid))

    # ---- arena compose -----------------------------------------------
    def _full_cache(self):
        if not self.paged:
            return self.cache
        return merge_arena_cache(self.lm.cfg, self.lm.plan, self.cache,
                                 self.arena.kv)

    def _cache_layers(self) -> list:
        """The per-layer cache entries the decode and verify steps update
        in place (the hot-loop entries' `arenas`)."""
        return self._full_cache()["layers"]

    def _true_kv_nbytes(self, n_tokens: int) -> int:
        """Real bytes of a request's cache at `n_tokens` resident tokens:
        the bounded leaves (ring KV, mamba state) plus the per-token
        full-attention KV, without the max_len padding."""
        bounded = self._dense_kv_nbytes - self._full_tok_nbytes * self.max_len
        return bounded + self._full_tok_nbytes * min(n_tokens, self.max_len)

    def _ring_run(self, spec, slot: int) -> tuple:
        """(first block, blocks) of `slot`'s ring block run in a paged ring
        layer, and the ring width W."""
        sink, recent = cache_window(self.lm.cfg, spec)
        bpw = ring_block_count(sink, recent, self.block_size)
        return slot * bpw, bpw, sink + recent

    # ---- dense interchange (whole-prompt admission / preemption) -----
    def _insert_dense(self, one: dict, slot: int, wtbl: Optional[np.ndarray]):
        """Write a B=1 dense cache ({"layers": [{"k","v": [1, L, K, h]} or a
        mamba entry]}) into `slot`. Paged: full layers scatter into the
        arena blocks of table row `wtbl` [max_blocks] (entries that map a
        lender's prefix blocks are already redirected to the null block:
        mapped, not written) and have those blocks' summaries recomputed;
        ring layers overwrite the slot's own block run, mamba layers its
        row. Dense: every leaf copied into row `slot`."""
        if not self.paged:
            for e, o in zip(self.cache["layers"], one["layers"]):
                for name, t in e.items():
                    t[slot] = o[name][0].to(t.dtype)
            return
        bs = self.block_size
        tbl = torch.from_numpy(wtbl.astype(np.int64)).to(self.device)
        for e, o in zip(self.arena.kv, one["layers"]):
            if e is not None and "kscale" in e:
                self._insert_quant(e, o, tbl)
            elif e is not None:
                for name in ("k", "v"):
                    e[name][tbl] = dense_kv_to_blocks(
                        o[name][0], self.max_blocks, bs).to(e[name].dtype)
                attn_mod.update_block_summaries(e["kmin"], e["kmax"],
                                                e["kmean"], e["k"], tbl)
        self._insert_private(one, slot)

    def _insert_private(self, one: dict, slot: int):
        """Write the bounded leaves of a B=1 cache (dense, or a handoff's
        private leaves; full-attention entries are skipped) into `slot`:
        each paged ring layer's [1, W, K, h] ring KV over the slot's ring
        block run, each mamba layer's entry into the slot's row."""
        bs = self.block_size
        for spec, priv, o in zip(self.lm.plan.all_specs(),
                                 self.cache["layers"], one["layers"]):
            if priv is None:
                continue
            if spec.kind == "mamba":
                for name, t in priv.items():
                    t[slot] = o[name][0].to(t.dtype)
                continue
            b0, bpw, _ = self._ring_run(spec, slot)
            for name in ("k", "v"):
                priv[name][b0:b0 + bpw] = dense_kv_to_blocks(
                    o[name][0], bpw, bs).to(priv[name].dtype)

    def _insert_quant(self, e: dict, o: dict, tbl):
        """Dense-scatter admission into an int8 arena entry `e` through the
        table row `tbl` (shared prefix entries already redirected to the
        null block, so a lender's payload, scales and summaries stand). A
        cache extracted at preemption carries the raw sidecar ("kq",
        "kscale", "ktok", v likewise, block-major): it is scattered back
        verbatim, so the round trip is exact (requantizing the dequantized
        view would not be). A fresh float cache takes the per-token
        quantization, every rewritten block unsealed — the reference's
        admission, so the streams stay the same. The written blocks'
        summaries are recomputed over the dequantized content."""
        for name in ("k", "v"):
            sn, tn = name + "scale", name + "tok"
            if name + "q" in o:
                e[name][tbl] = o[name + "q"][0]
                e[sn][tbl] = o[sn][0]
                e[tn][tbl] = o[tn][0]
            else:
                q, ts = attn_mod.quant_tokens(o[name][0])   # [L,K,h], [L,K]
                e[name][tbl] = dense_kv_to_blocks(q, self.max_blocks,
                                                  self.block_size)
                e[sn][tbl] = 0.0
                e[tn][tbl] = dense_kv_to_blocks(
                    ts[..., None], self.max_blocks, self.block_size)[..., 0]
        attn_mod.update_block_summaries(e["kmin"], e["kmax"], e["kmean"],
                                        e["k"], tbl, k_scale=e["kscale"],
                                        k_tok=e["ktok"])

    def _extract_dense(self, slot: int) -> dict:
        """One slot's KV as a B=1 dense cache: max_len tokens of each full
        layer (gathered out of the arenas through the slot's table when
        paged), W slots of each ring layer and each mamba layer's row (the
        preemption interchange format). An int8 arena entry gives its dequantized float32 view
        under "k"/"v" plus the raw sidecar ("kq", "kscale", "ktok", v
        likewise, [1, max_blocks, ...] block-major) that `_insert_quant`
        scatters back verbatim."""
        if not self.paged:
            layers = [{n: x[slot:slot + 1].clone() for n, x in e.items()}
                      for e in self.cache["layers"]]
            return {"layers": layers, "pos": int(self.pos_h[slot])}
        tbl = torch.from_numpy(self.tables_h[slot].astype(np.int64)).to(
            self.device)
        layers = []
        for spec, e, priv in zip(self.lm.plan.all_specs(), self.arena.kv,
                                 self.cache["layers"]):
            if e is not None and "kscale" in e:
                ent = {}
                for n in ("k", "v"):
                    raw = {n + "q": e[n][tbl],
                           n + "scale": e[n + "scale"][tbl],
                           n + "tok": e[n + "tok"][tbl]}
                    ent[n] = blocks_to_dense_kv(attn_mod.dequant_pages(
                        raw[n + "q"], raw[n + "scale"], raw[n + "tok"]),
                        self.max_len)[None].clone()
                    ent.update({k: x[None] for k, x in raw.items()})
                layers.append(ent)
            elif e is not None:
                layers.append({n: blocks_to_dense_kv(
                    e[n][tbl], self.max_len)[None].clone()
                    for n in ("k", "v")})
            elif priv is not None and spec.kind == "mamba":
                layers.append({n: x[slot:slot + 1].clone()
                               for n, x in priv.items()})
            elif priv is not None:
                b0, bpw, W = self._ring_run(spec, slot)
                layers.append({n: blocks_to_dense_kv(
                    priv[n][b0:b0 + bpw], W)[None].clone()
                    for n in ("k", "v")})
            else:
                layers.append(None)
        return {"layers": layers, "pos": int(self.pos_h[slot])}

    def _slot_state(self, slots, toks, poss, rows):
        """Write the admitted slots' scalar state + sampling rows."""
        dev = self.device
        idx = torch.tensor(slots, dtype=torch.long, device=dev)
        st = self.state
        st["pos"][idx] = torch.tensor(poss, dtype=torch.int32, device=dev)
        st["tok"][idx] = torch.tensor(toks, dtype=torch.int32, device=dev)
        st["active"][idx] = True
        st["temp"][idx] = torch.tensor([r[0] for r in rows],
                                       dtype=torch.float32, device=dev)
        st["top_k"][idx] = torch.tensor([r[1] for r in rows],
                                        dtype=torch.int32, device=dev)
        st["top_p"][idx] = torch.tensor([r[2] for r in rows],
                                        dtype=torch.float32, device=dev)
        st["key"][idx] = torch.from_numpy(
            np.stack([r[3] for r in rows]).astype(np.int64)).to(dev)

    # ------------------------------------------------------------------
    def _refresh_tables(self):
        """Upload the block tables when they changed, cut to the
        pow2-bucketed (lo=8) resident block count of the live slots: short
        contexts hand the kernel a narrow table. Stale rows of freed slots
        are all null blocks."""
        cur = 1
        for slot in self.slot_rid:
            cur = max(cur, self.pool.blocks_for(int(self.tokens_h[slot])))
        nb = min(_bucket(cur, lo=8), self.max_blocks)
        if self._tbl_dirty or nb != self._tbl_bucket:
            if nb not in self._tbl_bufs:
                self._tbl_bufs[nb] = (
                    torch.zeros((self.n_slots, nb), dtype=torch.int32,
                                device=self.device),
                    self._stage((self.n_slots, nb)))
            self._tbl_dev = self._upload(self._tbl_bufs[nb],
                                         self.tables_h[:, :nb])
            self._tbl_bucket = nb
            self._tbl_dirty = False

    def _find_shared(self, prompt, cached: int) -> list:
        """FULL prefix blocks a live request sharing the first `cached`
        tokens can lend (the partial tail is always copied)."""
        shn = self.pool.shareable_blocks(cached)
        if shn <= 0 or prompt is None:
            return []
        prompt = tuple(prompt)
        for rid, ptoks in self._prompts.items():
            if (ptoks is not None and len(ptoks) >= cached
                    and tuple(ptoks[:cached]) == prompt[:cached]):
                blocks = self.pool.owned(rid)
                if len(blocks) >= shn:
                    return blocks[:shn]
        return []

    def _admit_handle(self, rid: int, hb: BlockHandoff, pos: int) -> bool:
        """Zero-copy admission: rename the handoff's pool ownership to the
        decode rid and extend capacity for the next token (the caller then
        writes the handoff's ring leaves into the slot's ring runs). Fails
        clean — ownership is handed back so the server can requeue the
        handoff."""
        self.pool.transfer(hb.key, rid)
        grown = self.pool.extend(rid, pos, pos + 1)
        if grown is None:
            self.arena.reclaim(1)
            grown = self.pool.extend(rid, pos, pos + 1)
        if grown is None:
            self.pool.transfer(rid, hb.key)
            return False
        self.stats["blocks_fresh"] += len(grown)
        return True

    def admit_batch(self, items: list) -> dict:
        """items: (rid, cache_one, next_token, pos, cached_tokens[, prompt
        [, sampling_params]]). `cache_one` is a BlockHandoff (zero-copy,
        paged) or a B=1 dense cache (whole-prompt prefill, or re-admission
        after preemption). Paged: the dense cache is scattered into fresh
        blocks, with full prefix blocks mapped from a live lender sharing
        `prompt`. Dense: it is copied into the slot's row, admission
        accounted in the pool (`cached_tokens` credit). → {rid: admitted}."""
        out: dict = {}
        slots, toks, poss, rows = [], [], [], []
        for item in items:
            rid, cache_one, tok, pos, cached = item[:5]
            prompt = item[5] if len(item) > 5 else None
            sparams = item[6] if len(item) > 6 else None
            handoff = isinstance(cache_one, BlockHandoff)
            if not self.free:
                out[rid] = False
                continue
            if handoff:
                if not self.paged:
                    raise ValueError("BlockHandoff admission needs paged KV")
                if not self._admit_handle(rid, cache_one, pos):
                    out[rid] = False
                    continue
                tbl = self.pool.owned(rid)
                shn = 0
            elif self.paged:
                shared = self._find_shared(prompt, cached)
                tbl = self.pool.allocate(rid, pos + 1, shared=shared)
                if tbl is None:
                    self.arena.reclaim(self.pool.blocks_for(pos + 1)
                                       - len(shared))
                    tbl = self.pool.allocate(rid, pos + 1, shared=shared)
                if tbl is None:
                    out[rid] = False
                    continue
                shn = len(shared)
                self.stats["blocks_shared"] += shn
                self.stats["blocks_fresh"] += len(tbl) - shn
            elif self.pool.allocate(rid, pos + 1,
                                    cached_tokens=cached) is None:
                out[rid] = False
                continue
            slot = self.free.pop()
            wtbl = None
            if self.paged:
                row = np.zeros(self.max_blocks, np.int32)
                row[:len(tbl)] = tbl
                self.tables_h[slot] = row
                wtbl = row.copy()
                wtbl[:shn] = 0
            if handoff:
                # the full-attention KV is already in the tabled blocks;
                # only the bounded private leaves are written
                self._insert_private(cache_one.private, slot)
            else:
                self._insert_dense(cache_one, slot, wtbl)
                self.stats["handoff_copy_bytes"] += \
                    self._full_tok_nbytes * self.max_len
            self.slot_rid[slot] = rid
            self.rid_slot[rid] = slot
            self._prompts[rid] = tuple(prompt) if prompt is not None else None
            self.pos_h[slot] = pos
            self.tok_h[slot] = tok
            self.tokens_h[slot] = pos + 1
            self.stats["kv_transfer_bytes"] += self._true_kv_nbytes(pos)
            self.stats["kv_transfer_bytes_padded"] += self._dense_kv_nbytes
            self.stats["admits"] += 1
            drow = device_row(sparams, rid)
            self.greedy_h[slot] = float(drow[0]) <= 0.0
            if self.spec_ctl is not None:
                self.spec_ctl.on_admit(rid, prompt, tok)
            slots.append(slot)
            toks.append(tok)
            poss.append(pos)
            rows.append(drow)
            out[rid] = True
        if slots:
            self._slot_state(slots, toks, poss, rows)
            self._tbl_dirty = True
        return out

    # ------------------------------------------------------------------
    def _step_impl(self, key, tbl, out) -> torch.Tensor:
        """The device side of one step (the "decode.step" hot loop): decode
        every slot, sample, advance the slot state in place. key (nb,
        all_greedy); tbl the bucket's static table (None slot-dense); out
        the static [n_slots] output. → out, the sampled tokens."""
        all_greedy = key[1]
        st = self.state
        _, logits, aux = self.lm.decode(
            self.params, self._full_cache(), st["tok"][:, None],
            st["pos"][:, None], block_tables=tbl,
            token_mask=st["active"], tables=self.tables)
        if "sparsity" in st and aux["sparsity"]:
            st["sparsity"] += torch.stack(aux["sparsity"]).sum(dim=0)
        if "moe_counts" in st:
            st["moe_counts"] += torch.stack(aux["moe_counts"])
        # the token after position pos sees pos + 1 context tokens: that is
        # the draw's counter, so a stream is a pure function of
        # (seed, position)
        nxt = sample_tokens(logits, st["temp"], st["top_k"], st["top_p"],
                            st["key"], st["pos"] + 1, all_greedy=all_greedy)
        act = st["active"]
        st["pos"] += act.to(torch.int32)
        st["tok"].copy_(torch.where(act, nxt, st["tok"]))
        return out.copy_(nxt)

    def _verify_impl(self, key, tbl, drafts, draft_len, out) -> torch.Tensor:
        """The device side of one speculative step: feed every slot's window
        [current token, draft_1..draft_k] through the read-only verify
        forward, accept the longest draft prefix equal to the model's own
        greedy argmax, and commit exactly the accepted rows' K/V — rejected
        positions never touch a block or its summary. Position 0 reproduces
        the single-token step (greedy slots take the same argmax, sampled
        slots draw with the same (key, pos + 1) fold), so the emitted stream
        equals non-speculative decode under any draft source. The
        "decode.verify" hot loop: key (nb, all_greedy); tbl the bucket's
        static table; drafts [B, k], draft_len [B] int32 static buffers;
        out the static [B, k+2] output. → out, packed: the emitted tokens,
        then the per-slot emit count."""
        all_greedy = key[1]
        st = self.state
        B, k = drafts.shape
        act = st["active"]
        toks = torch.cat([st["tok"][:, None], drafts], dim=1)
        cache = self._full_cache()
        logits, staged, aux = self.lm.verify(
            self.params, cache, toks, st["pos"], block_tables=tbl,
            tables=self.tables, token_mask=act)
        greedy = logits.float().argmax(dim=-1).to(torch.int32)   # [B, k+1]
        nxt0 = sample_tokens(logits[:, 0], st["temp"], st["top_k"],
                             st["top_p"], st["key"], st["pos"] + 1,
                             all_greedy=all_greedy)
        is_greedy = st["temp"] <= 0.0
        dmask = torch.arange(k, device=self.device)[None] \
            < draft_len[:, None]
        match = (drafts == greedy[:, :k]) & dmask & is_greedy[:, None]
        # draft i is right iff it equals the greedy continuation given the
        # positions before it, all accepted themselves (cumprod): the
        # sequential decode induction
        a = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
        n_emit = torch.where(act, a + 1, torch.zeros_like(a)).to(torch.int32)
        emit = torch.cat([nxt0[:, None], greedy[:, 1:]], dim=1)
        new_tok = torch.where(
            act, emit[torch.arange(B, device=self.device), a.long()],
            st["tok"])
        self.lm.verify_commit(cache, staged, st["pos"], n_emit, tbl)
        if "moe_counts" in st:
            # every window row of a live slot is routed and counted, the
            # rejected drafts' rows too, as the reference counts them
            st["moe_counts"] += torch.stack(aux["moe_counts"])
        st["pos"] += n_emit
        st["tok"].copy_(new_tok)
        actf = act.float()
        st["spec"] += torch.stack([
            (actf * draft_len.float()).sum(), (actf * a.float()).sum(),
            n_emit.sum().float(), torch.ones((), device=self.device)])
        return out.copy_(torch.cat([emit, n_emit[:, None]], dim=1))

    def take_sparsity_stats(self):
        """Fetch and reset the device-side online-sparsity window and fold
        it into stats (blocks_scored / blocks_attended / attn_mass_*,
        layer-averaged — see serving/sparsity.py). → the layer-averaged [4]
        numpy vector, or None when online sparsity is off. A host sync: call
        at monitor ticks / run end, not per step."""
        v = drain_accumulator(self.state, "sparsity")
        if v is None:
            return None
        self.sparsity.note(self.stats, v)
        return v / max(self.sparsity.plan.n_sparse_layers, 1)

    def take_moe_counts(self):
        """Fetch and reset the device-side expert activation window: the
        [L_moe, E] float64 numpy counts of the live rows since the last
        call, or None for a model without MoE layers. The only host read of
        the counts: call at placement ticks, not per step."""
        return drain_accumulator(self.state, "moe_counts")

    def take_spec_stats(self):
        """Fetch and reset the device-side speculation window ([drafted,
        accepted, emitted, verify steps]) and fold it into stats. → the raw
        [4] numpy vector, or None when speculation is off. A host sync: call
        at monitor ticks / run end, not per step."""
        v = drain_accumulator(self.state, "spec")
        if v is None:
            return None
        SpecController.note(self.stats, v)
        return v

    def step(self) -> dict:
        """One batched decode step. Without speculation: {rid: next_token}
        for live slots. With it: {rid: [tokens]} (≥ 1 each) — up to k drafts
        per greedy slot go through the batched verify window instead of the
        single-token step, still with exactly one device→host fetch.
        Requests whose allocation cannot grow are preempted into
        self.preempted (cache extracted for re-admission)."""
        if not self.slot_rid:
            return {}
        if self.spec_ctl is None:
            return self._step_base()
        drafts_h, dlen_h = self._gather_drafts()
        if not dlen_h.any():
            # nothing to speculate: the single-token step is cheaper than a
            # window of empty drafts
            out = {rid: [t] for rid, t in self._step_base().items()}
            for rid, ts in out.items():
                self.spec_ctl.on_tokens(rid, ts)
            return out
        return self._step_spec(drafts_h, dlen_h)

    def _gather_drafts(self):
        """Host-side draft gather → (drafts [n_slots, k] int32, dlen
        [n_slots] int32). Sampled slots and slots at the max_len wall draft
        nothing (they ride the window as single-token rows); a draft is cut
        so every candidate write position stays below max_len."""
        k = self.spec_ctl.k
        drafts = np.zeros((self.n_slots, k), np.int32)
        dlen = np.zeros(self.n_slots, np.int32)
        for slot, rid in self.slot_rid.items():
            if not self.greedy_h[slot]:
                continue
            room = self.max_len - int(self.tokens_h[slot])
            if room <= 0:
                continue
            d = self.spec_ctl.draft(rid)[:room]
            if not d:
                continue
            drafts[slot, :len(d)] = d
            dlen[slot] = len(d)
        return drafts, dlen

    def _step_spec(self, drafts_h, dlen_h) -> dict:
        """One speculative verify step → {rid: [tokens]}."""
        t0 = time.monotonic()
        # pre-extend each drafting slot's allocation over its window's write
        # positions; a slot that cannot grow (even after reclaim) degrades
        # to a single-token row — never preempt here, the single-token row
        # fits the blocks it already owns
        touched = 0
        for slot, rid in self.slot_rid.items():
            cur = int(self.tokens_h[slot])
            touched += self.pool.blocks_for(cur)
            d = int(dlen_h[slot])
            want = min(cur + d, self.max_len)
            if d <= 0 or want <= cur:
                continue
            nb_used = self.pool.blocks_for(cur)
            grown = self.pool.extend(rid, cur, want)
            if grown is None and self.arena.reclaim(
                    max(self.pool.blocks_for(want) - nb_used, 1)):
                grown = self.pool.extend(rid, cur, want)
            if grown is None:
                drafts_h[slot] = 0
                dlen_h[slot] = 0
                continue
            for b in grown:
                self.tables_h[slot, nb_used] = b
                nb_used += 1
            if grown:
                self._tbl_dirty = True
                self.stats["blocks_fresh"] += len(grown)
            self.tokens_h[slot] = want
        self.stats["blocks_touched"] += touched
        self._refresh_tables()
        packed = self._verify(
            (self._tbl_bucket, self._all_greedy()),
            (self._tbl_dev, self._upload(self._drafts, drafts_h),
             self._upload(self._dlen, dlen_h), self._packed))
        packed_np = packed.cpu().numpy()   # the single per-step host fetch
        self.stats["host_fetches"] += 1
        out = {}
        ntok = 0
        for slot, rid in list(self.slot_rid.items()):
            n = int(packed_np[slot, -1])
            toks = [int(t) for t in packed_np[slot, :n]]
            out[rid] = toks
            ntok += n
            self.pos_h[slot] += n
            if n:
                self.tok_h[slot] = toks[-1]
            covered = int(self.tokens_h[slot])
            new_tokens = min(int(self.pos_h[slot]) + 1, self.max_len)
            if new_tokens > covered:
                # full accept: the next input token needs one position past
                # the pre-extended window — the single-token grow path
                nb_used = self.pool.blocks_for(covered)
                grown = self.pool.extend(rid, covered, new_tokens)
                if grown is None and self.arena.reclaim(1):
                    grown = self.pool.extend(rid, covered, new_tokens)
                if grown is None:
                    self.stats["preemptions"] += 1
                    self.preempted.append(self._preempt(rid))
                    continue
                for b in grown:
                    self.tables_h[slot, nb_used] = b
                    nb_used += 1
                if grown:
                    self._tbl_dirty = True
                    self.stats["blocks_fresh"] += len(grown)
            elif new_tokens < covered:
                # rejected tail: hand the over-extended blocks back and zero
                # their table entries. The masked commit never wrote them
                # (rejected rows land in the null block), so they carry no
                # new content and no summary goes stale: the rollback.
                dropped = self.pool.shrink(rid, covered, new_tokens)
                if dropped:
                    nb_new = self.pool.blocks_for(new_tokens)
                    self.tables_h[slot, nb_new:nb_new + len(dropped)] = 0
                    self._tbl_dirty = True
            self.tokens_h[slot] = new_tokens
            self.spec_ctl.on_tokens(rid, toks)
        self.stats["steps"] += 1
        self.stats["tokens"] += ntok
        self.stats["busy_s"] += time.monotonic() - t0
        return out

    def _step_base(self) -> dict:
        t0 = time.monotonic()
        if self.paged:
            self._refresh_tables()
        nxt = self._step((self._tbl_bucket if self.paged else None,
                          self._all_greedy()),
                         (self._tbl_dev if self.paged else None, self._next))
        next_np = nxt.cpu().numpy()        # the single per-step host fetch
        self.stats["host_fetches"] += 1
        out = {}
        for slot, rid in list(self.slot_rid.items()):
            tok = int(next_np[slot])
            out[rid] = tok
            self.pos_h[slot] += 1
            self.tok_h[slot] = tok
            # full-attention blocks read for this slot this step (the dense
            # layout always reads max_blocks)
            self.stats["blocks_touched"] += (
                self.pool.blocks_for(int(self.tokens_h[slot]))
                if self.paged else self.max_blocks)
            # capacity is capped at max_len: past it a request keeps
            # emitting (its writes land in the null block, or are dropped
            # by the dense cache write) but never grows
            cur = int(self.tokens_h[slot])
            new_tokens = min(cur + 1, self.max_len)
            nb_used = self.pool.blocks_for(cur)
            grown = self.pool.extend(rid, cur, new_tokens)
            if grown is None and self.paged and self.arena.reclaim(1):
                grown = self.pool.extend(rid, cur, new_tokens)
            if grown is None:
                # the sampled token is already in `out`; the preemption
                # record carries it as the resume input
                self.stats["preemptions"] += 1
                self.preempted.append(self._preempt(rid))
                continue
            if grown and self.paged:
                for b in grown:
                    self.tables_h[slot, nb_used] = b
                    nb_used += 1
                self._tbl_dirty = True
                self.stats["blocks_fresh"] += len(grown)
            self.tokens_h[slot] = new_tokens
        self.stats["steps"] += 1
        self.stats["tokens"] += len(out)
        self.stats["busy_s"] += time.monotonic() - t0
        return out

    def _preempt(self, rid: int) -> tuple:
        slot = self.rid_slot[rid]
        cache_one = self._extract_dense(slot)
        rec = (rid, cache_one, int(self.tok_h[slot]), int(self.pos_h[slot]))
        self._free_slot(rid, slot)
        return rec

    def _free_slot(self, rid: int, slot: int):
        del self.slot_rid[slot]
        del self.rid_slot[rid]
        self._prompts.pop(rid, None)
        if self.spec_ctl is not None:
            self.spec_ctl.on_release(rid)
        self.state["active"][slot] = False
        # a stale temperature > 0 on a freed slot would keep the sampled
        # branch alive for rows nobody reads
        self.state["temp"][slot] = 0.0
        self.greedy_h[slot] = True
        self.free.append(slot)
        self.pool.release(rid)
        if self.paged:
            # the freed slot keeps decoding garbage until reused: its writes
            # must land in the null block (or its own ring run), not in
            # blocks the pool hands out
            self.tables_h[slot] = 0
            self._tbl_dirty = True

    def release(self, rid: int):
        slot = self.rid_slot.get(rid)
        if slot is not None:
            self._free_slot(rid, slot)
