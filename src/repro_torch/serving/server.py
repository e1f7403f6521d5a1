"""PD-disaggregated continuous-batching server of the port: OmniProxy +
paged prefill/decode engines over one shared KV arena.

Request-level API: `add_request(prompt, SamplingParams) → rid` registers a
request; `step()` advances every engine one round and returns per-request
`RequestOutput` deltas (new tokens, finish_reason in {stop, length,
abort}); `abort(rid)` cancels a request wherever it lives; `generate()` is
a streaming iterator over the same primitives and `run()` the closed-batch
entry point.

Request lifecycle: proxy tick (APC-aware dispatch) → prefill → decode
admission → batched decode with device-side sampling (preempted requests
re-enter decode_wait with their extracted cache). Prefill is chunked and
paged (shortest-remaining-first, resumed at radix prefix boundaries, then a
zero-copy BlockHandoff) where the model allows it, and whole-prompt through
the flash-prefill kernel otherwise — as for the default OmniAttn pattern
(`pattern=None`), whose compressed layers keep a sink+recent ring. Decode KV
is paged (`paged_kv=True`: shared arenas + per-slot ring block runs) or
slot-dense (`paged_kv=False`, no arena). On paged KV, decode runs OmniAttn
online top-k block selection when the model config sets a budget
(cfg.omniattn.topk_*), or SpecPlane speculative decoding with
`ServerConfig.spec` (a SpecConfig; the two do not compose); their
device-side stats are drained into the metrics every STAT_DRAIN_ROUNDS
decode rounds and at the end of `run`. With `ServerConfig.quant` (a
QuantConfig, QuantPlane) every full-attention arena is int8 with its scale
plane; it composes with top-k and speculation.

MoE models (qwen2-moe-a2.7b) serve through the same path: every MoE layer
routes through the server's OmniPlacement tables, and with
`enable_placement` a DynamicScheduler reads the decode engines' expert
counts every `placement_interval` decode rounds (the only host read of
them) and, when it accepts a rebalance, `_apply_migration` re-slots the
expert weights and rewrites the tables, both in place. On one device (ep = 1) the
imbalance is always 1.0, so the loop monitors and never rebalances;
`_apply_migration` also takes a forced plan.

FaultPlane (`Server(faults=FaultPlane(...))`, serving/faults.py) fires
seeded faults at the top of every `step`, before any engine round and
outside every captured graph; the recovery machinery behind it (instance
death and revival, KV loss, dropped handoffs, corruption scan, quarantine
and scrub, retry caps, the no-progress watchdog, admission shedding) keeps
every completed stream equal to the fault-free run's. Recovery never
rebinds a tensor a graph was captured with: the arenas are scrubbed in
place, and a freed slot's table row goes to the null block.

Speculation and online top-k compose with MoE layers (a verify step's
window rows are routed and counted like decode rows).

Over several ranks (a placement from `DevicePlacement.build(tp, ep)`)
every rank runs the same Server in lockstep (SPMD): the parameters and
arenas are the rank's shards, the collectives live in the layers, and
every host decision — admission, proxy order, chunking, preemption,
placement ticks, stopping — must come from the same inputs on every rank,
or the next collective hangs. So no rank reads its own clock for a
decision: each round starts with one broadcast of rank 0's clock (and, in
`run` / `generate`, its go-on flag), and the engines' measured batch times
reach the proxy as rank 0's. With `ctx.check_lockstep` every round ends
with an all-gather of a digest of the scheduled request ids, the step
count and the emitted tokens, and a difference raises. A migration moves
an expert's canonical rows from the rank that holds them
(`_apply_migration`); it moves expert rows only, never a slot's ring KV.
OmniAttn runs over ranks as on one: ring layers (paged ring runs or
slot-dense, sink + recent or a sliding window), chunks over them, whole
prompts compressed into them, and preemption's handoff of their leaves,
all at the rank's KV heads (`stack.head_layout`: K / tp under 'kv', the
one head its query heads read under 'wseq', all of them for a replicated
sublayer); online top-k max-reduces its block scores over `model` before
ranking, so every rank attends the same blocks. Mamba-2 layers carry the
rank's share of each slot's state (`stack.mamba_layout`) through
admission, prefix reuse, handoff and preemption. QuantPlane serves over
ranks on int8 arenas of the rank's KV heads (its residency figures are
the rank's own); SpecPlane drafts on the host from tokens and finished
requests alone, which every rank holds alike, and its verify step takes
its accept decision from logits that every rank holds whole after the
`model` reductions, so every rank accepts the same prefix; the lockstep
digest carries the speculation counters. FaultPlane serves over ranks:
every rank builds the same plane from the same seed and fires the same
schedule at the top of the same step, and every target it draws comes from
host state that lockstep keeps equal. The one recovery that reads
rank-local device state, `recover_corruption`, is a collective: each
rank's summary scan sees only its own KV heads, so the scan's mask is
max-reduced over the world before its one fetch and every rank condemns,
quarantines and scrubs the union of what any rank found (a block corrupted
on one rank's heads only included); `kv_corrupt`'s "written" check on int8
arenas is reduced alike. The lockstep digest carries the recovery state
too (quarantined blocks, swept handoffs, the instances' health, each
request's retries and the plane's counts), so a recovery that parts the
ranks raises in the round where it happened.
"""
from __future__ import annotations

import time
import zlib
from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.placement import DynamicScheduler, SchedulerConfig
from repro_torch.core.placement.migration import \
    tables_from_placement_from_slots
from repro_torch.core.proxy import (BackpressureError, MetricsAggregator,
                                    OASConfig, OmniProxy, Phase, Request,
                                    RequestOutput, SamplingParams)
from repro_torch.models import moe as moe_mod
from repro_torch.models.lm import LM
from repro_torch.serving.arena import BlockHandoff, KVArena
from repro_torch.serving.decode import DecodeEngine
from repro_torch.serving.faults import FaultPlane
from repro_torch.serving.placement import DevicePlacement
from repro_torch.serving.prefill import PrefillEngine
from repro_torch.serving.quant import QuantConfig, QuantController
from repro_torch.serving.spec import SpecConfig

# decode rounds between drains of the engines' device-side sparsity and
# speculation windows (a host sync each; the reference's monitor interval)
STAT_DRAIN_ROUNDS = 16
# the decode engines' device accumulators the lockstep digest carries:
# state key → (leading entries compared, the drained stats keys)
LOCKSTEP_COUNTERS = {
    "sparsity": (2, ("blocks_scored", "blocks_attended")),
    "spec": (4, ("spec_drafted", "spec_accepted", "spec_emitted",
                 "spec_verifies"))}


@dataclass
class ServerConfig:
    n_prefill: int = 1
    n_decode: int = 1
    decode_slots: int = 8
    max_len: int = 256
    oas: OASConfig = field(default_factory=OASConfig)
    chunked_prefill: bool = True      # chunk + interleave prefill with decode
    chunk_tokens: int = 64            # prefill chunk size
    prefill_tick_budget: int = 128    # prefill tokens per tick: ↑TTFT-biased,
                                      # ↓TPOT-biased (the paper's P/D knob)
    prefix_reuse: bool = True         # radix partial-prefix KV resume
    prefix_cache_cap: int = 32        # stored prefixes per prefill instance
    prefix_cache_cap_bytes: Optional[int] = None   # byte cap (real sizes)
    kv_blocks: Optional[int] = None   # KVPool size override
    paged_kv: bool = True             # physically paged KV arenas
    kv_block_size: int = 16           # tokens per KV block
    idle_sleep_s: float = 0.01        # max per-iteration sleep while run()
                                      # waits for a future arrival
    spec: Optional[SpecConfig] = None  # model-free speculative decoding
    enable_placement: bool = True     # OmniPlacement dynamic scheduler
    placement_interval: int = 16      # decode rounds between monitor ticks
    placement_cfg: Optional[SchedulerConfig] = None  # scheduler override
                                      # (None → defaults with budget=0,
                                      # table-width max_slots)
    quant: Optional[QuantConfig] = None  # int8 paged KV arenas
                                      # (QuantPlane; None → float arenas)
    # ---- FaultPlane recovery knobs (None → off) ----
    watchdog_steps: Optional[int] = None    # retire a request whose progress
                                            # marker is unchanged for N steps
                                            # with finish_reason="timeout"
    watchdog_wall_s: Optional[float] = None  # same, wall-clock bound
    admission_queue_cap: Optional[int] = None  # shed (BackpressureError) when
                                               # the admission backlog reaches
                                               # this many waiting requests

    def check_supported(self):
        if self.spec is not None and not isinstance(self.spec, SpecConfig):
            raise TypeError(f"ServerConfig.spec takes a SpecConfig, got "
                            f"{type(self.spec).__name__}")
        if self.quant is not None and not isinstance(self.quant,
                                                     QuantConfig):
            raise TypeError(f"ServerConfig.quant takes a QuantConfig, got "
                            f"{type(self.quant).__name__}")


def check_servable(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a model the server cannot serve: an
    encoder-only config has no decode step, and the frontend families take
    frames or patches that a request of token ids does not carry. The
    reference's Server feeds its prefill tokens only
    (src/repro/serving/prefill.py), so it cannot serve them either; serving
    a vlm on its tokens alone would be another model."""
    if cfg.encoder_only or cfg.family in ("vlm", "audio"):
        kind = "an encoder-only" if cfg.encoder_only else f"a {cfg.family}"
        raise NotImplementedError(
            f"{cfg.arch_id}: the Server cannot serve {kind} model — its "
            f"requests carry token ids only (no frames or patches) and its "
            f"engines prefill and decode tokens, as the reference's do; "
            f"run it through LM.prefill / LM.decode instead")


class Server:
    def __init__(self, cfg: ModelConfig, scfg: ServerConfig, *,
                 pattern: Optional[list] = None, params=None, seed: int = 0,
                 device=None, faults=None,
                 placement: Optional[DevicePlacement] = None):
        """`params`: the port's parameter dict (e.g. from
        `bridge.params_from_numpy`) — one-rank parameters, or over several
        ranks this rank's part (`DevicePlacement.place_params`) — or None
        for the seed's one-rank `LM.init(seed)`. `device` None → cuda.
        `faults`: a FaultPlane, or None."""
        if faults is not None and not isinstance(faults, FaultPlane):
            raise TypeError(f"Server(faults=...) takes a FaultPlane, got "
                            f"{type(faults).__name__}")
        scfg.check_supported()
        check_servable(cfg)
        self.cfg, self.scfg = cfg, scfg
        # fired at the top of every step(), before any engine work
        self.faults = faults
        self.placement = placement if placement is not None else \
            DevicePlacement.of(device)
        self.ctx = self.placement.ctx
        self.lm = LM.build(cfg, pattern=pattern,
                           device=self.placement.device, ctx=self.ctx)
        if params is None:
            params = self.lm.one_rank().init(seed)
        self.params = self.placement.place_params(params, self.lm)
        self.tables = self.lm.default_tables()
        if self.tables is not None:
            # fixed shapes: _apply_migration rewrites them in place
            self.tables = moe_mod.pad_replicas(self.tables)
        self.proxy = OmniProxy(scfg.n_prefill, scfg.n_decode, scfg.oas)
        self.metrics = MetricsAggregator()
        # one shared paged-KV runtime for every engine: by default every
        # decode slot gets max_len capacity plus one prompt of prefill
        # headroom per prefill instance
        self.kv_arena = None
        # QuantPlane: validated against this stack (raises on a width other
        # than 8 bits or over slot-dense KV; None when no full-attention
        # layer exists to quantize) before any arena is allocated; its
        # residency figures are this rank's KV heads'
        self.quant_ctl = QuantController.from_model(
            cfg, self.lm.plan, scfg.quant, scfg.kv_block_size,
            paged_kv=scfg.paged_kv, tp=self.ctx.tp)
        if scfg.paged_kv:
            max_blocks = -(-scfg.max_len // scfg.kv_block_size)
            n_blocks = scfg.kv_blocks if scfg.kv_blocks is not None else \
                (scfg.n_decode * scfg.decode_slots + scfg.n_prefill) \
                * max_blocks
            self.kv_arena = KVArena.build(self.lm, n_blocks,
                                          scfg.kv_block_size,
                                          placement=self.placement,
                                          quant=self.quant_ctl is not None)
        self.prefills = [
            PrefillEngine(self.lm, self.params, scfg.max_len,
                          arena=self.kv_arena,
                          chunk_tokens=scfg.chunk_tokens,
                          enable_chunked=scfg.chunked_prefill,
                          allow_partial_reuse=scfg.prefix_reuse,
                          cache_cap=scfg.prefix_cache_cap,
                          cache_cap_bytes=scfg.prefix_cache_cap_bytes,
                          tree=self.proxy.trees[i],
                          block_size=scfg.kv_block_size,
                          placement=self.placement, tables=self.tables)
            for i in range(scfg.n_prefill)]
        self.decodes = [DecodeEngine(self.lm, self.params, scfg.decode_slots,
                                     scfg.max_len, arena=self.kv_arena,
                                     kv_blocks=scfg.kv_blocks,
                                     block_size=scfg.kv_block_size,
                                     placement=self.placement,
                                     spec=scfg.spec,
                                     spec_radix=self.proxy.trees[0]
                                     if self.proxy.trees else None,
                                     tables=self.tables)
                        for _ in range(scfg.n_decode)]
        if self.quant_ctl is not None:
            # static residency figures beside the per-step counters
            for eng in self.decodes:
                eng.stats.update(QuantController.stats_keys())
                self.quant_ctl.note(eng.stats)
        # rid → (handoff or B=1 cache, next_token, pos, cached_tokens,
        # prompt, params) awaiting decode admission
        self._pending_kv: dict = {}
        self._step_count = 0
        self._next_rid = 0
        self._fresh: dict = {}
        self._emitted: dict = {}          # rid → tokens delivered
        self._finish_info: dict = {}      # rid → (reason, total)
        self._events: list = []
        self._idle_slept_s = 0.0
        # watchdog state: rid → (progress marker, step seen, wall seen)
        self._wd: dict = {}
        self.n_handoffs_swept = 0
        self._round_now = 0.0             # the round's clock (rank 0's)
        self.placement_sched = None
        if scfg.enable_placement and cfg.moe.n_experts:
            s = int(self.tables["slot_expert"].shape[1])
            # the engines apply ONE placement table across layers, so the
            # monitor runs on layer-summed counts (n_layers=1 collapse)
            pcfg = scfg.placement_cfg
            if pcfg is None:
                pcfg = SchedulerConfig(budget=0, max_slots=s)
            self.placement_sched = DynamicScheduler(
                ep=self.ctx.ep, n_experts=cfg.moe.n_experts, n_layers=1,
                cfg=pcfg, placements=[moe_mod.round_robin_placement(
                    cfg.moe.n_experts, self.ctx.ep, s)])
        self.n_migrations = 0
        self.migration_log: list = []
        # bytes of expert rows moved between ranks, and seconds, summed over
        # the migrations applied
        self.migration_stats = {"bytes": 0, "seconds": 0.0}

    # ---- request-level API -------------------------------------------
    def add_request(self, prompt: tuple,
                    params: Optional[SamplingParams] = None,
                    now: Optional[float] = None) -> int:
        """Register a request under its own SamplingParams; → rid."""
        now = self._clock() if now is None else now
        params = params if params is not None else SamplingParams()
        rid = self._next_rid
        while rid in self.proxy.inflight:
            rid += 1
        return self._submit(rid, tuple(prompt), params, now)

    def _submit(self, rid: int, prompt: tuple, params: SamplingParams,
                now: float) -> int:
        self._admission_check(prompt)
        self.proxy.submit(Request(rid, prompt, params.max_tokens,
                                  arrival=now, sampling=params), now)
        self._next_rid = max(self._next_rid, rid + 1)
        return rid

    def _admission_check(self, prompt: tuple):
        """Shed at the door with a BackpressureError instead of admitting a
        request that would defer inside the engines forever. Two gates: a
        prompt no sequence of releases could ever make fit (larger than
        every non-quarantined block), and a bounded admission backlog
        (`admission_queue_cap`, None → unbounded)."""
        if self.kv_arena is not None:
            pool = self.kv_arena.pool
            usable = pool.n_blocks - len(pool.quarantined)
            need = pool.blocks_for(len(prompt))
            if need > usable:
                self.metrics.note_shed()
                raise BackpressureError(
                    f"prompt needs {need} KV blocks but the pool has only "
                    f"{usable} usable ({len(pool.quarantined)} quarantined)")
        cap = self.scfg.admission_queue_cap
        if cap is not None:
            backlog = (len(self.proxy.pending) + len(self.proxy.decode_wait)
                       + len(self._pending_kv)
                       + sum(len(e.queue) for e in self.prefills))
            if backlog >= cap:
                self.metrics.note_shed()
                raise BackpressureError(
                    f"admission backlog {backlog} >= cap {cap}")

    # ---- lockstep over ranks -------------------------------------------
    def _clock(self) -> float:
        """The time a host decision reads: the local clock on one rank,
        the round's broadcast clock (rank 0's) over several."""
        if self.ctx.world == 1:
            return time.monotonic()
        return self._round_now

    def _rank0(self, values: list) -> list:
        """Rank 0's float values on every rank (the values themselves on
        one rank): for locally measured inputs of host decisions."""
        return self.ctx.broadcast_floats(values)

    def _check_lockstep(self):
        """Raise if the ranks' host state diverged this round: a CRC of the
        step count, the scheduled request ids of every engine and queue,
        the tokens emitted, the recovery state (the quarantined blocks,
        the handoffs swept, every instance's health, each in-flight
        request's retries and, with a FaultPlane, its injected and skipped
        counts) and each decode engine's device counters — with
        online top-k the blocks scored and attended, with speculation
        [drafted, accepted, emitted, verifies] (each the device accumulator
        and the drained stats: one more device read a round, made only
        here) — all-gathered over the world. These counters are the same
        on every rank by construction (the top-k scores are max-reduced
        over `model` before any rank ranks them; every rank holds the
        verify window's whole logits and the same drafts), so a difference
        means a rank's budget, residency or accept decision drifted; they
        are never summed over ranks."""
        counters = [(e.state[n][:k].tolist(), [e.stats[s] for s in keys])
                    for e in self.decodes
                    for n, (k, keys) in LOCKSTEP_COUNTERS.items()
                    if n in e.state]
        recovery = (
            sorted(self.kv_arena.pool.quarantined)
            if self.kv_arena is not None else [], self.n_handoffs_swept,
            [s.healthy for s in self.proxy.prefill + self.proxy.decode],
            sorted((r, q.n_retries) for r, q in self.proxy.inflight.items()),
            None if self.faults is None else
            (sorted(self.faults.injected.items()),
             sorted(self.faults.skipped.items())))
        state = (self._step_count, sorted(self.proxy.inflight),
                 sorted(self._pending_kv),
                 [sorted(e.rid_slot.items()) for e in self.decodes],
                 [[t.rid for t in e.queue] for e in self.prefills],
                 sorted((r, tuple(t)) for r, t in self._fresh.items()),
                 recovery, counters)
        digest = zlib.crc32(repr(state).encode())
        got = self.ctx.all_gather_ints([self._step_count, digest])
        if any(g != got[0] for g in got):
            raise RuntimeError(f"ranks diverged at step {self._step_count}: "
                               f"(step, digest) per rank {got}")

    def step(self, now: Optional[float] = None) -> list:
        """Advance the whole server one round → per-request deltas. Faults
        and their recovery run first, before any engine round and outside
        every graph, so no token is computed from corrupt or lost KV; then
        the orphan-handoff sweep, the proxy tick, the retirement of failed
        requests, the prefill round, the decode round and the watchdog.
        Over several ranks `now` is rank 0's (one broadcast)."""
        now = time.monotonic() if now is None else now
        return self._round(self._rank0([now])[0])

    def _round(self, now: float) -> list:
        self._round_now = now
        if self.faults is not None:
            self.faults.on_step(self, self._step_count, now)
        if self.kv_arena is not None:
            self._sweep_orphan_handoffs()
        self._drain_actions(now)
        self._sweep_failed(now)
        self._prefill_round()
        self._decode_round()
        self._watchdog(now)
        if self.ctx.check_lockstep:
            self._check_lockstep()
        return self._flush_outputs()

    def abort(self, rid: int, now: Optional[float] = None) -> bool:
        """Cancel a request wherever it lives. → True if it was in flight;
        the next step() carries RequestOutput(finish_reason="abort")."""
        now = self._clock() if now is None else now
        req = self.proxy.abort(rid, now)
        if req is None:
            return False
        kv = self._pending_kv.pop(rid, None)
        if kv is not None:
            self._release_handoff(kv[0])
        for eng in self.prefills:
            eng.abort(rid)
        for eng in self.decodes:
            eng.release(rid)
        self._fresh.pop(rid, None)
        self._finish_info.pop(rid, None)
        n_out = max(len(req.output_tokens), self._emitted.pop(rid, 0))
        self.metrics.add_aborted(req)
        self._events.append(RequestOutput(rid, (), True, "abort", n_out))
        return True

    def generate(self, prompts, params=None,
                 max_wall_s: float = 300.0) -> Iterator[RequestOutput]:
        """Streaming front door: submit one prompt or a list of prompts
        (`params` one SamplingParams, a matching list, or None → greedy),
        then drive step() and yield every RequestOutput until all submitted
        requests finish."""
        single = bool(prompts) and isinstance(prompts[0], (int, np.integer))
        plist = [tuple(prompts)] if single else [tuple(p) for p in prompts]
        if params is None or isinstance(params, SamplingParams):
            pparams = [params] * len(plist)
        else:
            pparams = list(params)
            if len(pparams) != len(plist):
                raise ValueError(f"{len(plist)} prompts but "
                                 f"{len(pparams)} SamplingParams")
        t0 = self._rank0([time.monotonic()])[0]
        live = {self.add_request(p, sp, now=t0)
                for p, sp in zip(plist, pparams)}
        while live:
            # one broadcast a round: rank 0's clock and go-on flag
            now = time.monotonic()
            now, go = self._rank0([now, float(now - t0 < max_wall_s)])
            if not go:
                break
            for out in self._round(now):
                if out.finished:
                    live.discard(out.rid)
                yield out

    # ---- internals ---------------------------------------------------
    def _release_handoff(self, cache) -> None:
        """Free the arena blocks a zero-copy handoff still owns; every exit
        path that drops a handoff before admission goes through here."""
        if isinstance(cache, BlockHandoff):
            self.kv_arena.pool.release(cache.key)

    # ---- FaultPlane recovery machinery -------------------------------
    def _retire_faulted(self, rid: int, reason: str, now: float):
        """Retire a request the recovery gave up on ("error": retries
        exhausted, "timeout": watchdog): release every engine and pool
        resource it holds and emit a terminal RequestOutput. proxy.abort
        does the accounting unwind (a FAILED request matches none of its
        branches)."""
        req = self.proxy.abort(rid, now)
        if req is None:
            return
        req.finish_reason = reason
        kv = self._pending_kv.pop(rid, None)
        if kv is not None:
            self._release_handoff(kv[0])
        for eng in self.prefills:
            eng.abort(rid)
        for eng in self.decodes:
            eng.release(rid)
        self._fresh.pop(rid, None)
        self._finish_info.pop(rid, None)
        self._wd.pop(rid, None)
        n_out = max(len(req.output_tokens), self._emitted.pop(rid, 0))
        if reason == "timeout":
            self.metrics.add_timeout(req)
        else:
            self.metrics.add_error(req)
        self._events.append(RequestOutput(rid, (), True, reason, n_out))

    def _sweep_failed(self, now: float):
        """Retire every FAILED request with finish_reason="error": retry-cap
        exhaustion only advances the phase, and a FAILED request left in
        proxy.inflight would keep run()/generate() from returning."""
        for rid in [r.rid for r in list(self.proxy.inflight.values())
                    if r.phase == Phase.FAILED]:
            self._retire_faulted(rid, "error", now)

    def _watchdog(self, now: float):
        """Retire with finish_reason="timeout" the requests whose progress
        marker has not changed for `watchdog_steps` steps or
        `watchdog_wall_s` seconds. The marker puts DECODE_WAIT and
        DECODE_SCHEDULED in one class (admission-requeue ping-pong is not
        progress); a prefill cursor advance, a new output token or a
        granted retry each re-earn the full window."""
        ws, ww = self.scfg.watchdog_steps, self.scfg.watchdog_wall_s
        if ws is None and ww is None:
            return
        live = set()
        for rid, req in list(self.proxy.inflight.items()):
            live.add(rid)
            phase_class = (Phase.DECODE_WAIT if req.phase in
                           (Phase.DECODE_WAIT, Phase.DECODE_SCHEDULED)
                           else req.phase)
            cursor = max((t.cursor for eng in self.prefills
                          for t in eng.queue if t.rid == rid), default=0)
            marker = (phase_class, cursor, len(req.output_tokens),
                      req.n_retries)
            prev = self._wd.get(rid)
            if prev is None or prev[0] != marker:
                self._wd[rid] = (marker, self._step_count, now)
                continue
            _, step0, t0 = prev
            if (ws is not None and self._step_count - step0 >= ws) or \
                    (ww is not None and now - t0 >= ww):
                self._retire_faulted(rid, "timeout", now)
                live.discard(rid)
        for rid in [r for r in self._wd if r not in live]:
            del self._wd[rid]

    def _sweep_orphan_handoffs(self):
        """Leak backstop for the ("handoff", i) rename stage: a handoff key
        in the pool that neither a parked `_pending_kv` record nor an
        engine's undelivered result references belongs to nobody. Its
        blocks go back to the free list (`n_handoffs_swept` counts them):
        dead-instance drops and injected handoff faults land here."""
        pool = self.kv_arena.pool
        refs = {kv[0].key for kv in self._pending_kv.values()
                if isinstance(kv[0], BlockHandoff)}
        for eng in self.prefills:
            refs |= {r.cache.key for r in eng._ready
                     if isinstance(r.cache, BlockHandoff)}
        for key in list(pool.per_request):
            if isinstance(key, tuple) and len(key) == 2 \
                    and key[0] == "handoff" and key not in refs:
                pool.release(key)
                self.n_handoffs_swept += 1

    def recover_corruption(self, now: Optional[float] = None) -> list:
        """Summary-plane corruption recovery: scan the arenas (on the
        device, one fetch) for blocks whose stored key summaries disagree
        with their content, then (1) drop the prefix-store entries built on
        them, (2) drop the parked handoffs and (3) abort and restart the
        prefill work touching them, (4) restart the decode residents that
        map them (their slots' table rows go to the null block), and (5)
        quarantine and scrub the now unmapped blocks in place. → condemned
        block ids. Restarted requests regenerate the same prefix
        (positional draws) and the delivered counter keeps it from being
        streamed again. Over several ranks this is a collective: the scan's
        mask is max-reduced over the world before its fetch, so every rank
        condemns the union of what any rank's KV heads show, and every
        rank must call it at the same step (FaultPlane does: its schedule
        is seeded and fires at the top of the same step on every rank)."""
        if self.kv_arena is None:
            return []
        now = self._clock() if now is None else now
        bad = self.kv_arena.find_corrupt_blocks(self.ctx)
        if not bad:
            return []
        badset = set(bad)
        pool = self.kv_arena.pool
        # an orphaned handoff key may map a condemned block: sweep first so
        # the holder scan below sees only live owners
        self._sweep_orphan_handoffs()
        for eng in self.prefills:
            eng.store.drop_containing(badset)
        for rid in list(self._pending_kv):
            kv = self._pending_kv[rid]
            if isinstance(kv[0], BlockHandoff) and badset & set(kv[0].blocks):
                self._pending_kv.pop(rid)
                self._release_handoff(kv[0])
                req = self.proxy.inflight.get(rid)
                if req is not None:
                    self.proxy.on_handoff_lost(req, now)
        for eng in self.prefills:
            hit = {r.rid for r in eng._ready
                   if isinstance(r.cache, BlockHandoff)
                   and badset & set(r.cache.blocks)}
            hit |= {t.rid for t in eng.queue
                    if badset & set(pool.owned(("prefill", t.rid)))}
            for rid in hit:
                eng.abort(rid)
                req = self.proxy.inflight.get(rid)
                if req is not None:
                    self.proxy.on_prefill_restart(req, now)
        for eng in self.decodes:
            for rid in list(eng.rid_slot):
                if badset & set(pool.owned(rid)):
                    eng.release(rid)
                    req = self.proxy.inflight.get(rid)
                    if req is not None and req.phase == Phase.DECODE_RUNNING:
                        self.proxy.on_decode_restart(req, now)
        self._sweep_failed(now)
        for b in bad:
            pool.quarantine(b)
            assert b not in pool.refcount, \
                f"corrupt block {b} still mapped after recovery"
            self.kv_arena.scrub_block(b)
        self.metrics.note_quarantine(len(bad))
        return bad

    # ---- fault-injection entry points (FaultPlane hooks) -------------
    def inject_instance_failure(self, kind: str, iid: int,
                                now: Optional[float] = None):
        """Kill one engine instance: the proxy reroutes its in-flight
        requests (retry-capped) and the next step's engine rounds release
        its slots, queued tasks and undelivered results."""
        now = self._clock() if now is None else now
        self.proxy.mark_unhealthy(kind, iid, now)

    def revive_instance(self, kind: str, iid: int):
        self.proxy.mark_healthy(kind, iid)

    def inject_kv_lost(self, rid: int, now: Optional[float] = None):
        """Lose one resident decode request's KV: its slot and blocks are
        released and the request reroutes through prefill, retry-capped."""
        now = self._clock() if now is None else now
        req = self.proxy.inflight.get(rid)
        for eng in self.decodes:
            eng.release(rid)
        if req is not None and req.phase == Phase.DECODE_RUNNING:
            self.proxy.on_decode_restart(req, now)

    def inject_handoff_drop(self, rid: int) -> bool:
        """Drop a parked handoff WITHOUT releasing its pool key (a payload
        lost mid-rename). The orphan-handoff sweep reclaims the blocks; the
        request recovers through the kv-lost path at dispatch."""
        return self._pending_kv.pop(rid, None) is not None

    def _note_token(self, req: Request, tok: int) -> Optional[str]:
        """Record one generated token; → finish reason or None. A request
        restarted through prefill regenerates from scratch: the draws are
        positional, so the replayed prefix is the same, and the delivered
        counter keeps it from being streamed again."""
        req.output_tokens.append(tok)
        n = len(req.output_tokens)
        if n > self._emitted.get(req.rid, 0):
            self._fresh.setdefault(req.rid, []).append(tok)
            self._emitted[req.rid] = n
        if req.sampling is not None and tok in req.sampling.stop_token_ids:
            return "stop"
        if n >= req.max_tokens:
            return "length"
        return None

    def _record_finish(self, req: Request, reason: str):
        req.finish_reason = reason
        self._finish_info[req.rid] = (reason, len(req.output_tokens))
        self._emitted.pop(req.rid, None)
        self.metrics.add(req)

    def _flush_outputs(self) -> list:
        outs = []
        for rid, toks in self._fresh.items():
            reason, total = self._finish_info.pop(rid, (None, None))
            if total is None:
                total = self._emitted.get(rid, len(toks))
            outs.append(RequestOutput(rid, tuple(toks), reason is not None,
                                      reason, total))
        self._fresh.clear()
        self._finish_info.clear()
        outs.extend(self._events)
        self._events = []
        return outs

    def _drain_actions(self, now: float):
        admissions: dict = {}
        for req, inst, stage in self.proxy.tick(now):
            if stage == "prefill":
                self.proxy.on_prefill_start(req, self._clock())
                self.prefills[inst.iid].start(req.rid, req.tokens,
                                              prefix_hint=req.prefix_match,
                                              params=req.sampling)
            else:
                admissions.setdefault(inst.iid, []).append(req)
        for iid, reqs in admissions.items():
            eng = self.decodes[iid]
            tnow = self._clock()
            items, live = [], []
            for r in reqs:
                kv = self._pending_kv.pop(r.rid, None)
                if kv is None:   # KV died with a failed decode instance
                    self.proxy.on_decode_kv_lost(r, tnow)
                    continue
                items.append((r.rid,) + kv)
                live.append(r)
            t0 = eng.stats["kv_transfer_bytes"]
            p0 = eng.stats["kv_transfer_bytes_padded"]
            granted = eng.admit_batch(items)
            self.metrics.note_kv_transfer(
                eng.stats["kv_transfer_bytes"] - t0,
                eng.stats["kv_transfer_bytes_padded"] - p0)
            for req, item in zip(live, items):
                if granted[req.rid]:
                    self.proxy.on_decode_start(req, tnow)
                else:
                    self._pending_kv[req.rid] = item[1:]
                    self.proxy.on_decode_requeue(req, tnow)

    def _prefill_round(self):
        budget = self.scfg.prefill_tick_budget
        for iid, eng in enumerate(self.prefills):
            if not self.proxy.prefill[iid].healthy:
                # died: the proxy re-dispatches its requests; abort() frees
                # the tasks' blocks and undelivered results die too
                for t in list(eng.queue):
                    eng.abort(t.rid)
                eng.drop_results()
                continue
            if not eng.has_work():
                continue
            recs = eng.step(budget)
            # the measured times reach the proxy as rank 0's
            times = self._rank0([x for r in recs
                                 for x in (r.elapsed_s, r.t_done)])
            for i, rec in enumerate(recs):
                req = self.proxy.inflight.get(rec.rid)
                tnow = self._clock()
                if req is None or req.prefill_instance != iid:
                    self._release_handoff(rec.cache)    # stale result
                    continue
                elapsed, t_done = times[2 * i], times[2 * i + 1]
                self.proxy.on_prefill_done(req, tnow, batch_time=elapsed)
                self.proxy.on_first_token(req, t_done or tnow)
                reason = self._note_token(req, rec.first_token)
                if reason:
                    # finished at its FIRST token: never admitted to decode
                    self._release_handoff(rec.cache)
                    self.proxy.on_early_finish(req, tnow)
                    self._record_finish(req, reason)
                else:
                    self._pending_kv[req.rid] = (rec.cache, rec.first_token,
                                                 rec.prompt_len, rec.reused,
                                                 req.tokens, req.sampling)

    def _decode_round(self):
        for iid, eng in enumerate(self.decodes):
            if not self.proxy.decode[iid].healthy:
                for rid in list(eng.rid_slot):   # died: slots are garbage,
                    eng.release(rid)             # the proxy re-routes them
                eng.preempted.clear()
                continue
            toks = eng.step()
            now = self._clock()
            batch_time = None
            finished = set()
            for rid, tok in toks.items():
                req = self.proxy.inflight.get(rid)
                if req is None or req.decode_instance != iid:
                    eng.release(rid)             # done or re-routed elsewhere
                    finished.add(rid)
                    continue
                # a speculating engine emits a list per slot (≥ 1 token per
                # verify step): note them in order and stop at the first
                # finish reason, exactly as if decoded one at a time
                reason = None
                for t in (tok if isinstance(tok, list) else (tok,)):
                    reason = self._note_token(req, t)
                    if reason:
                        break
                if reason:
                    finished.add(rid)
                    eng.release(rid)
                    if batch_time is None:
                        batch_time = self._rank0([
                            eng.stats["busy_s"]
                            / max(eng.stats["steps"], 1)])[0]
                    self.proxy.on_decode_done(req, now,
                                              batch_time=batch_time)
                    self._record_finish(req, reason)
            for rid, cache_one, tok, pos in eng.preempted:
                req = self.proxy.inflight.get(rid)
                if rid in finished or req is None:
                    continue
                self._pending_kv[rid] = (cache_one, tok, pos, 0, req.tokens,
                                         req.sampling)
                self.proxy.on_decode_preempt(req, now)
            eng.preempted.clear()
        self._step_count += 1
        self._maybe_placement_tick()
        if self._step_count % STAT_DRAIN_ROUNDS == 0:
            self.drain_decode_stats()

    # ---- OmniPlacement closed loop -----------------------------------
    def _maybe_placement_tick(self):
        """One monitor tick every `placement_interval` decode rounds, on the
        expert counts drained from every decode engine (the scheduler's
        activation window is time-indexed)."""
        if (self.placement_sched is None or self._step_count
                % max(self.scfg.placement_interval, 1) != 0):
            return
        counts = None
        for eng in self.decodes:
            c = eng.take_moe_counts()           # fetch + reset the window
            if c is not None:
                counts = c if counts is None else counts + c
        if counts is None:
            return
        plans = self.placement_sched.step(counts.sum(axis=0, keepdims=True))
        if plans:
            self._apply_migration(plans[0])

    @torch.no_grad()
    def _apply_migration(self, plan):
        """Re-slot the MoE expert weights for `plan`'s slot layout and
        rewrite the tables. Layer by layer and tensor by tensor, in place:
        each expert's canonical rows are gathered through the OLD tables'
        first replica, then scattered into the new slot layout (two
        slot-sized temporaries at a time, never a copy of the stack). Over
        EP ranks a slot whose expert lived on another rank receives its
        rows from that rank (`_migrate_slots`; `migration_stats` sums the
        bytes moved between ranks and the seconds). The tables every engine
        holds are rewritten in place too (padded, every placement's tables
        have the same shapes), so the decode step's captured graphs read
        the new layout."""
        t0 = time.monotonic()
        old = self.tables
        rr = old["rep_rank"][:, 0].long()
        rs = old["rep_slot"][:, 0].long()
        new_se = np.asarray(plan.new_slot_expert)
        moved = 0
        for p in self.params["layers"]:
            for k in ("moe_w1", "moe_w3", "moe_w2"):
                if k not in p:
                    continue
                if self.ctx.ep == 1:
                    p[k].copy_(moe_mod.slots_from_canonical(p[k][rr, rs],
                                                            new_se))
                else:
                    moved += self._migrate_slots(p[k], rr.cpu().numpy(),
                                                 rs.cpu().numpy(), new_se)
        new = moe_mod.pad_replicas(tables_from_placement_from_slots(
            new_se, self.placement.device))
        for k, t in self.tables.items():
            t.copy_(new[k])
        if self.placement.device.type == "cuda":
            torch.cuda.synchronize(self.placement.device)
        self.migration_stats["bytes"] += moved
        self.migration_stats["seconds"] += time.monotonic() - t0
        self.n_migrations += 1
        hist = self.placement_sched.history[-1] \
            if self.placement_sched is not None and \
            self.placement_sched.history else {}
        self.migration_log.append({
            "step": self._step_count,
            "b_before": float(hist.get("b", 0.0)),
            "b_after": float(hist.get("b_sim", 0.0))})

    def _migrate_slots(self, w, rr: np.ndarray, rs: np.ndarray,
                       new_se: np.ndarray) -> int:
        """One slot tensor w [1, s, ...] (this rank's slots) re-slotted for
        new_se [ep, s] in place. Expert x's canonical rows sit in old slot
        rs[x] of rank rr[x]: a slot keeping its expert on the same rank
        copies locally, the rest travel in one uneven all_to_all over
        `data` that carries exactly the moved rows. → bytes moved between
        ranks over the whole world (every `model` rank moves its part),
        the same on every rank."""
        ctx = self.ctx
        ep, s = new_se.shape
        new = torch.zeros_like(w[0])
        send_rows, send = [], [0] * ep
        recv_slots: list = [[] for _ in range(ep)]
        n_cross = 0
        for d in range(ep):
            for j in range(s):
                x = int(new_se[d, j])
                if x < 0:
                    continue
                src = int(rr[x])
                if src == d:
                    if d == ctx.e:
                        new[j] = w[0, int(rs[x])]
                    continue
                n_cross += 1
                if src == ctx.e:
                    send_rows.append(int(rs[x]))
                    send[d] += 1
                if d == ctx.e:
                    recv_slots[src].append(j)
        if n_cross:
            idx = torch.tensor(send_rows, dtype=torch.long, device=w.device)
            got = ctx.all_to_all_rows(w[0][idx], send,
                                      [len(r) for r in recv_slots])
            dst = [j for r in recv_slots for j in r]
            if dst:
                new[torch.tensor(dst, dtype=torch.long,
                                 device=w.device)] = got
        w[0].copy_(new)
        return n_cross * w[0, 0].numel() * w.element_size() * ctx.tp

    def drain_decode_stats(self):
        """Fold the decode engines' device-side online-sparsity and
        speculation windows into the metrics (one host sync per engine with
        either on; none otherwise). `step` calls it every
        STAT_DRAIN_ROUNDS decode rounds and `run` at its end; a caller
        driving `generate` calls it once the stream ends."""
        for eng in self.decodes:
            if eng.sparsity is not None:
                self.metrics.note_sparsity(*eng.take_sparsity_stats())
            if eng.spec_ctl is not None:
                self.metrics.note_spec(*eng.take_spec_stats())

    # ------------------------------------------------------------------
    def run(self, requests: list, max_wall_s: float = 300.0,
            arrivals: Optional[list] = None):
        """Closed-batch loop over the streaming primitives. requests:
        [(prompt_tokens, max_tokens:int)] or [(prompt_tokens,
        SamplingParams)]; arrivals: per-request offsets from t=0 (None → all
        at t=0). → the metrics summary plus engine stats."""
        t_start = self._rank0([time.monotonic()])[0]
        todo = sorted(
            ((0.0 if arrivals is None else arrivals[i], i, p, spec)
             for i, (p, spec) in enumerate(requests)))
        k = 0
        while k < len(todo) or self.proxy.inflight:
            # one broadcast a round: rank 0's clock decides arrivals, naps
            # and the wall limit on every rank
            now = self._rank0([time.monotonic()])[0]
            if now - t_start >= max_wall_s:
                break
            while k < len(todo) and now - t_start >= todo[k][0]:
                _, i, prompt, spec = todo[k]
                params = spec if isinstance(spec, SamplingParams) else \
                    SamplingParams(max_tokens=int(spec))
                try:
                    self._submit(i, tuple(prompt), params, now)
                except BackpressureError:
                    pass        # shed (counted in metrics.n_shed)
                k += 1
            if not self.proxy.inflight and k < len(todo):
                wait = (t_start + todo[k][0]) - now
                if wait > 0:
                    nap = min(wait, self.scfg.idle_sleep_s)
                    time.sleep(nap)
                    self._idle_slept_s += nap
                    continue
            self._round(now)
        wall = self._rank0([time.monotonic()])[0] - t_start
        self.drain_decode_stats()
        summary = self.metrics.summary(wall)
        summary["wall_s"] = wall
        summary["n_migrations"] = self.n_migrations
        summary["migration_log"] = list(self.migration_log)
        summary["idle_slept_s"] = self._idle_slept_s
        summary["n_handoffs_swept"] = self.n_handoffs_swept
        if self.faults is not None:
            summary["faults_injected"] = dict(self.faults.injected)
        summary["prefill_stats"] = [e.stats for e in self.prefills]
        summary["decode_stats"] = [e.stats for e in self.decodes]
        return summary
