"""OmniProxy: Omni Adaptive Scheduling (OAS) — paper §5.1.

A deterministic, runtime-agnostic scheduling layer driven by explicit
`tick(now)` calls (the Nginx event loop of the paper becomes an explicit
scheduler tick so the SAME policy code runs under the real in-process engine
and the discrete-event cluster simulator).

Policies:
  · Prefill: cache-informed load balancing — π_P(i) = Match_P(i) − α·ρ_P
    (eq. 8), Match from the per-instance radix tree, ρ_P = running requests +
    queued tokens (normalized);
  · Decode: Longest-Processing-Time-first on ℓ_i = T_prompt + T_max (eq. 9),
    dispatched to the least-loaded healthy decode instance;
  · Deferred submission & resorting: requests are held up to
    `defer_window` (bounded by the predicted upstream batch cycle — EWMA of
    instance batch time) so each tick dispatches a coherent, re-sorted group;
  · Straggler mitigation (beyond-paper, required at 1000+ nodes): EWMA batch
    time per instance; instances slower than `straggler_factor` × peer median
    are score-penalized, and prefills stuck longer than `timeout_factor` ×
    expected service time are re-dispatched elsewhere.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.proxy.lifecycle import Phase, Request
from repro_torch.core.proxy.radix import RadixTree


@dataclass
class OASConfig:
    alpha: float = 0.5              # cache-affinity vs load trade-off (eq. 8)
    defer_window: float = 0.02      # max deferred-submission delay (s)
    ewma_beta: float = 0.2
    straggler_factor: float = 2.0
    straggler_penalty: float = 0.5
    timeout_factor: float = 10.0
    max_retries: int = 2
    retry_backoff_s: float = 0.0    # re-dispatch delay × n_retries (0 → off)
    lpt: bool = True                # decode LPT ordering (ablation switch)
    cache_aware: bool = True        # prefill APC-aware scoring (ablation)
    deferred: bool = True           # deferred submission (ablation)


@dataclass
class InstanceStats:
    iid: int
    kind: str                       # 'prefill' | 'decode'
    queue_len: int = 0
    running: int = 0
    queued_tokens: int = 0
    running_tokens: int = 0
    ewma_batch_time: float = 0.0
    completed: int = 0
    healthy: bool = True

    def load(self) -> float:
        """ρ_P: running requests + tokens, normalized (eq. 8)."""
        return (self.running + self.queue_len) + \
            (self.running_tokens + self.queued_tokens) / 4096.0

    def observe_batch_time(self, dt: float, beta: float):
        self.ewma_batch_time = dt if self.ewma_batch_time == 0 else \
            beta * dt + (1 - beta) * self.ewma_batch_time


class OmniProxy:
    def __init__(self, n_prefill: int, n_decode: int,
                 cfg: Optional[OASConfig] = None,
                 radix_capacity: int = 1 << 20):
        self.cfg = cfg or OASConfig()
        self.prefill = [InstanceStats(i, "prefill") for i in range(n_prefill)]
        self.decode = [InstanceStats(i, "decode") for i in range(n_decode)]
        self.trees = [RadixTree(radix_capacity) for _ in range(n_prefill)]
        self.pending: list[Request] = []          # deferred submission pool
        self.decode_wait: list[Request] = []
        self.inflight: dict[int, Request] = {}
        self._rr = 0                              # round-robin fallback state
        self.dispatch_log: list[dict] = []

    # ------------------------------------------------------------------
    def submit(self, req: Request, now: float):
        req.advance(Phase.TOKENIZE, now)
        req.advance(Phase.APC_MATCH, now)
        self.pending.append(req)
        self.inflight[req.rid] = req

    # ------------------------------------------------------------------
    def _prefill_score(self, req: Request, inst: InstanceStats) -> float:
        match = self.trees[inst.iid].match(req.tokens) if self.cfg.cache_aware else 0
        rho = inst.load()
        score = match / max(req.prompt_len, 1) - self.cfg.alpha * rho
        if self._is_straggler(inst, self.prefill):
            score -= self.cfg.straggler_penalty
        return score

    def _is_straggler(self, inst: InstanceStats, peers) -> bool:
        times = [p.ewma_batch_time for p in peers if p.ewma_batch_time > 0]
        if not times or inst.ewma_batch_time == 0:
            return False
        return inst.ewma_batch_time > self.cfg.straggler_factor * float(np.median(times))

    def _predicted_cycle(self) -> float:
        times = [p.ewma_batch_time for p in self.prefill if p.ewma_batch_time > 0]
        return float(np.median(times)) if times else 0.0

    # ------------------------------------------------------------------
    def tick(self, now: float) -> list[tuple[Request, InstanceStats, str]]:
        """Dispatch decisions for this tick: (request, instance, stage)."""
        actions: list[tuple[Request, InstanceStats, str]] = []

        # ---- deferred submission: release requests whose defer window
        # expired or who align with the predicted upstream batch cycle
        if self.cfg.deferred:
            cycle = min(self._predicted_cycle(), self.cfg.defer_window)
            ready = [r for r in self.pending if now - r.arrival >= cycle
                     and now >= r.not_before]
        else:
            ready = [r for r in self.pending if now >= r.not_before]

        # ---- resorting: coherent groups — short prompts first within the
        # released group keeps prefill batches uniform (reduces bubbles)
        ready.sort(key=lambda r: r.prompt_len)

        for req in ready:
            self.pending.remove(req)
            healthy = [p for p in self.prefill if p.healthy]
            if not healthy:
                req.advance(Phase.FAILED, now)
                continue
            if self.cfg.cache_aware:
                inst = max(healthy, key=lambda p: self._prefill_score(req, p))
            else:                                  # round-robin baseline (Nginx)
                inst = healthy[self._rr % len(healthy)]
                self._rr += 1
            req.prefix_match = self.trees[inst.iid].match(req.tokens, now)
            req.prefill_instance = inst.iid
            req.advance(Phase.PREFILL_SCHEDULED, now)
            inst.queue_len += 1
            inst.queued_tokens += req.prompt_len - req.prefix_match
            self.trees[inst.iid].insert(req.tokens, now)
            actions.append((req, inst, "prefill"))
            self.dispatch_log.append({"rid": req.rid, "stage": "prefill",
                                      "iid": inst.iid, "match": req.prefix_match})

        # ---- decode side: LPT over waiting requests
        wait = sorted(self.decode_wait,
                      key=lambda r: -r.effective_load if self.cfg.lpt else r.rid)
        for req in wait:
            healthy = [d for d in self.decode if d.healthy]
            if not healthy:
                break
            inst = min(healthy, key=lambda d: d.load() +
                       (self.cfg.straggler_penalty
                        if self._is_straggler(d, self.decode) else 0))
            self.decode_wait.remove(req)
            req.decode_instance = inst.iid
            req.advance(Phase.DECODE_SCHEDULED, now)
            inst.queue_len += 1
            inst.queued_tokens += req.max_tokens
            actions.append((req, inst, "decode"))
            self.dispatch_log.append({"rid": req.rid, "stage": "decode",
                                      "iid": inst.iid})
        return actions

    # ---- engine callbacks --------------------------------------------
    def on_prefill_start(self, req: Request, now: float):
        inst = self.prefill[req.prefill_instance]
        inst.queue_len -= 1
        inst.queued_tokens -= req.prompt_len - req.prefix_match
        inst.running += 1
        inst.running_tokens += req.prompt_len
        req.advance(Phase.PREFILL_RUNNING, now)

    def on_prefill_done(self, req: Request, now: float, batch_time: float = 0.0):
        inst = self.prefill[req.prefill_instance]
        inst.running -= 1
        inst.running_tokens -= req.prompt_len
        inst.completed += 1
        if batch_time > 0:
            inst.observe_batch_time(batch_time, self.cfg.ewma_beta)
        req.advance(Phase.DECODE_WAIT, now)
        self.decode_wait.append(req)

    def on_decode_start(self, req: Request, now: float):
        inst = self.decode[req.decode_instance]
        inst.queue_len -= 1
        inst.queued_tokens -= req.max_tokens
        inst.running += 1
        inst.running_tokens += req.effective_load
        req.advance(Phase.DECODE_RUNNING, now)

    def on_decode_requeue(self, req: Request, now: float):
        """Admission refused (no slot / no KV blocks): return the request to
        the decode wait pool, undoing the schedule-time accounting."""
        inst = self.decode[req.decode_instance]
        inst.queue_len -= 1
        inst.queued_tokens -= req.max_tokens
        req.decode_instance = None
        req.advance(Phase.DECODE_WAIT, now)
        self.decode_wait.append(req)

    def _reroute_to_prefill(self, req: Request, now: float) -> bool:
        """Shared recovery tail for every KV-loss path: clear placement,
        wipe the output buffer (draws are positional, so the regenerated
        prefix is bit-identical and the server's per-rid delivered counter
        suppresses re-streaming it) and re-enter the deferred-submission
        pool. Bounded by `max_retries`: a request whose KV keeps vanishing
        must not re-enter the prefill queue forever — exhausted retries
        advance to Phase.FAILED, which the server retires with
        finish_reason="error". retry_backoff_s > 0 delays the re-dispatch
        by backoff × n_retries (linear backoff)."""
        if req.n_retries >= self.cfg.max_retries:
            req.advance(Phase.FAILED, now)
            return False
        req.n_retries += 1
        req.prefill_instance = None
        req.decode_instance = None
        req.output_tokens.clear()
        if self.cfg.retry_backoff_s > 0:
            req.not_before = max(req.not_before,
                                 now + self.cfg.retry_backoff_s * req.n_retries)
        req.advance(Phase.APC_MATCH, now)
        self.pending.append(req)
        return True

    def on_decode_kv_lost(self, req: Request, now: float) -> bool:
        """Scheduled for decode but its KV vanished (e.g. decode-instance
        failure between admissions, a dropped handoff payload): undo the
        schedule accounting and route the request back through prefill from
        scratch — retry-capped (see _reroute_to_prefill). → re-dispatched?"""
        inst = self.decode[req.decode_instance]
        inst.queue_len -= 1
        inst.queued_tokens -= req.max_tokens
        req.decode_instance = None
        return self._reroute_to_prefill(req, now)

    def on_decode_restart(self, req: Request, now: float) -> bool:
        """A RUNNING decode request lost its KV (engine-detected loss,
        corruption quarantine): undo the running accounting and route back
        through prefill from scratch — retry-capped."""
        inst = self.decode[req.decode_instance]
        inst.running -= 1
        inst.running_tokens -= req.effective_load
        req.decode_instance = None
        return self._reroute_to_prefill(req, now)

    def on_prefill_restart(self, req: Request, now: float) -> bool:
        """An in-flight prefill lost its blocks (corruption quarantine —
        whole-instance death goes through mark_unhealthy): undo the phase
        accounting and re-dispatch — retry-capped."""
        if req.prefill_instance is not None:
            inst = self.prefill[req.prefill_instance]
            if req.phase == Phase.PREFILL_RUNNING:
                inst.running -= 1
                inst.running_tokens -= req.prompt_len
            elif req.phase == Phase.PREFILL_SCHEDULED:
                inst.queue_len -= 1
                inst.queued_tokens -= req.prompt_len - req.prefix_match
        return self._reroute_to_prefill(req, now)

    def on_handoff_lost(self, req: Request, now: float) -> bool:
        """A parked (prefill-done, not yet admitted) handoff lost its KV:
        prefill accounting is closed and decode accounting not yet opened —
        just leave the wait pool and reroute through prefill, retry-capped."""
        self.decode_wait = [r for r in self.decode_wait if r.rid != req.rid]
        return self._reroute_to_prefill(req, now)

    def on_decode_preempt(self, req: Request, now: float):
        """Running request evicted by the engine (KV block exhaustion):
        back to the wait pool for re-admission with its extracted cache."""
        inst = self.decode[req.decode_instance]
        inst.running -= 1
        inst.running_tokens -= req.effective_load
        req.decode_instance = None
        req.advance(Phase.DECODE_WAIT, now)
        self.decode_wait.append(req)

    def on_first_token(self, req: Request, now: float):
        if req.first_token_time is None:
            req.first_token_time = now

    def on_early_finish(self, req: Request, now: float):
        """Request finished at its FIRST token (stop token hit, or
        max_tokens == 1): it sits in decode_wait with no decode instance —
        retire it without ever admitting to decode."""
        self.decode_wait = [r for r in self.decode_wait if r.rid != req.rid]
        req.finish_time = now
        req.advance(Phase.DONE, now)
        self.inflight.pop(req.rid, None)

    def abort(self, rid: int, now: float) -> Optional[Request]:
        """Cancel a request wherever it lives, undoing any instance
        accounting its current phase holds. → the Request (finish_reason
        set to "abort"), or None if the rid is not in flight. The caller
        (server) releases engine-side state: prefill queue tasks,
        pending-KV handoffs, decode slots + KVPool blocks."""
        req = self.inflight.pop(rid, None)
        if req is None:
            return None
        if any(r.rid == rid for r in self.pending):
            self.pending = [r for r in self.pending if r.rid != rid]
        elif any(r.rid == rid for r in self.decode_wait):
            # prefill accounting already closed by on_prefill_done; decode
            # accounting not yet opened (or undone by requeue/preempt)
            self.decode_wait = [r for r in self.decode_wait if r.rid != rid]
        elif req.phase == Phase.PREFILL_RUNNING and \
                req.prefill_instance is not None:
            inst = self.prefill[req.prefill_instance]
            inst.running -= 1
            inst.running_tokens -= req.prompt_len
        elif req.phase == Phase.PREFILL_SCHEDULED and \
                req.prefill_instance is not None:
            inst = self.prefill[req.prefill_instance]
            inst.queue_len -= 1
            inst.queued_tokens -= req.prompt_len - req.prefix_match
        elif req.phase == Phase.DECODE_RUNNING and \
                req.decode_instance is not None:
            inst = self.decode[req.decode_instance]
            inst.running -= 1
            inst.running_tokens -= req.effective_load
        elif req.phase == Phase.DECODE_SCHEDULED and \
                req.decode_instance is not None:
            inst = self.decode[req.decode_instance]
            inst.queue_len -= 1
            inst.queued_tokens -= req.max_tokens
        req.finish_reason = "abort"
        req.finish_time = now
        req.advance(Phase.DONE, now)
        return req

    def on_decode_done(self, req: Request, now: float, batch_time: float = 0.0):
        inst = self.decode[req.decode_instance]
        inst.running -= 1
        inst.running_tokens -= req.effective_load
        inst.completed += 1
        if batch_time > 0:
            inst.observe_batch_time(batch_time, self.cfg.ewma_beta)
        req.finish_time = now
        req.advance(Phase.DONE, now)
        self.inflight.pop(req.rid, None)

    # ---- fault handling ----------------------------------------------
    def mark_unhealthy(self, kind: str, iid: int, now: float) -> list[Request]:
        """Instance failure: requeue its in-flight requests (fault tolerance)."""
        pool = self.prefill if kind == "prefill" else self.decode
        pool[iid].healthy = False
        requeued = []
        for req in list(self.inflight.values()):
            if kind == "prefill" and req.prefill_instance == iid and \
                    req.phase in (Phase.PREFILL_SCHEDULED, Phase.PREFILL_RUNNING):
                # accounting is zeroed wholesale below — only reroute here
                if self._reroute_to_prefill(req, now):
                    requeued.append(req)
            elif kind == "decode" and req.decode_instance == iid and \
                    req.phase in (Phase.DECODE_SCHEDULED, Phase.DECODE_RUNNING):
                if req.n_retries >= self.cfg.max_retries:
                    req.advance(Phase.FAILED, now)
                    continue
                req.n_retries += 1
                req.decode_instance = None
                req.advance(Phase.DECODE_WAIT, now)
                self.decode_wait.append(req)
                requeued.append(req)
        pool[iid].queue_len = 0
        pool[iid].running = 0
        pool[iid].queued_tokens = 0
        pool[iid].running_tokens = 0
        return requeued

    def mark_healthy(self, kind: str, iid: int):
        (self.prefill if kind == "prefill" else self.decode)[iid].healthy = True
