"""Discrete-event cluster simulator for paper Tables 1-2 (a copy of the
reference's src/repro/sim/cluster.py on the port's core/). Its figures are
the Ascend 910C / DeepSeek-R1 model's of hardware.py, not an H100's.

Runs the REAL OmniProxy (core/proxy) against simulated Ascend-910C prefill /
decode instances under a closed-loop workload. Component effects:

  OmniPlacement → per-step MoE imbalance multiplier B(t). Without placement,
    B(t) follows drifting zipf expert loads (sampled trajectory from
    core/placement's imbalance calculator under round-robin placement); with
    placement, the DynamicScheduler rebalances the same trajectory and the
    achieved B(t) is used. Same algorithm code as production.
  OmniAttn → KV bytes ratio (kv_bytes_for_pattern on the DeepSeek-like stack)
    scales decode-step KV reads AND raises the HBM-capacity sequence cap.
  OmniProxy → the actual scheduling policies (APC-aware prefill dispatch,
    LPT decode, deferred submission). Disabling reverts to Nginx round-robin.

Time advances on a heap of events; decode instances emit one token per step
for all resident sequences (continuous batching).
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.placement.dynamic import DynamicScheduler, SchedulerConfig
from repro_torch.core.placement.static import calculate_imbalance, round_robin
from repro_torch.core.proxy import MetricsAggregator, OASConfig, OmniProxy, Request
from repro_torch.sim.hardware import AscendNodeModel, DeepSeekR1Model
from repro_torch.sim.workload import WorkloadConfig, closed_loop_requests


@dataclass
class SimConfig:
    n_prefill: int = 6            # xP in xPyD
    n_decode: int = 1             # yD
    decode_dies: int = 64         # D32 = 64 dies (4 nodes)
    prefill_dies: int = 16        # P8 → one node TP16
    batch_per_die: int = 40
    concurrency: Optional[int] = None   # default: system batch × 1.2
    n_requests: int = 1500
    use_placement: bool = True
    use_omniattn: bool = True
    use_proxy: bool = True
    attn_window: int = 4224       # sink+recent: OmniAttn caps effective ctx
    placement_interval: float = 2.0     # scheduler tick period (s)
    seed: int = 0
    workload: WorkloadConfig = field(default_factory=WorkloadConfig)
    node: AscendNodeModel = field(default_factory=AscendNodeModel)
    model: DeepSeekR1Model = field(default_factory=DeepSeekR1Model)
    max_sim_s: float = 3600.0


class _ExpertLoadProcess:
    """Drifting zipf expert-load trajectory shared by both arms (placement
    on/off) so the comparison is paired."""

    def __init__(self, cfg: SimConfig):
        self.rng = np.random.default_rng(cfg.seed + 7)
        m = cfg.model
        self.n_layers = 8                 # representative MoE layers tracked
        self.E = m.n_experts
        self.ep = 16
        # moderately skewed expert popularity (hot experts ≈ 6-10× median,
        # matching published DeepSeek routing statistics) with slow drift
        self.loads = self.rng.lognormal(0.0, 0.8, (self.n_layers, self.E))
        self.slots = self.E // self.ep + 1

    def step(self):
        """Random-walk drift + occasional hot-spot shift."""
        drift = self.rng.lognormal(0, 0.08, self.loads.shape)
        self.loads = self.loads * drift
        if self.rng.random() < 0.10:      # workload shift: new hot experts
            l = self.rng.integers(0, self.n_layers)
            hot = self.rng.integers(0, self.E, 3)
            self.loads[l, hot] *= self.rng.uniform(1.5, 3.0)
        self.loads *= self.E / self.loads.sum(axis=1, keepdims=True)
        return self.loads.copy()


class ClusterSim:
    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        oas = OASConfig() if cfg.use_proxy else \
            OASConfig(cache_aware=False, lpt=False, deferred=False)
        self.proxy = OmniProxy(cfg.n_prefill, cfg.n_decode, oas)
        self.metrics = MetricsAggregator()
        # decode capacity: slots per instance bounded by HBM KV capacity
        avg_ctx = cfg.workload.mean_in + cfg.workload.mean_out / 2
        kv_cap_ratio = (min(cfg.attn_window, avg_ctx) / avg_ctx
                        if cfg.use_omniattn else 1.0)
        cap = cfg.model.kv_hbm_capacity_seqs(cfg.node, avg_ctx,
                                             cfg.decode_dies, kv_cap_ratio)
        self.slots_per_instance = min(cfg.batch_per_die, cap) * cfg.decode_dies
        # expert-load process + optional dynamic scheduler
        self.loadproc = _ExpertLoadProcess(cfg)
        self.placement_sched = None
        if cfg.use_placement:
            self.placement_sched = DynamicScheduler(
                ep=self.loadproc.ep, n_experts=self.loadproc.E,
                n_layers=self.loadproc.n_layers,
                cfg=SchedulerConfig(budget=self.loadproc.n_layers * 2,
                                    max_slots=self.loadproc.slots + 2,
                                    b_trigger=1.15, delta=0.02),
                placements=[round_robin(self.loadproc.E, self.loadproc.ep,
                                        self.loadproc.slots)
                            for _ in range(self.loadproc.n_layers)])
        self.moe_B = self._imbalance_now(init=True)
        self.migration_count = 0

        # simulated instance state (speed factor models real-cluster
        # stragglers: transient 1.5-2.5× slowdowns the proxy must route around)
        self._straggle_rng = np.random.default_rng(cfg.seed + 99)
        self.prefill_speed = np.ones(cfg.n_prefill)
        self.prefill_busy_until = [0.0] * cfg.n_prefill
        self.decode_active: list[dict] = [dict() for _ in range(cfg.n_decode)]
        self.decode_queue: list[list] = [[] for _ in range(cfg.n_decode)]
        self._step_scheduled = [False] * cfg.n_decode
        self._events: list = []
        self._eid = itertools.count()
        self._done_count = 0
        self._rid = itertools.count()
        self._req_meta: dict[int, tuple] = {}

    # ------------------------------------------------------------------
    def _imbalance_now(self, init=False) -> float:
        loads = self.loadproc.loads if init else self.loadproc.step()
        if self.placement_sched is not None:
            self.placement_sched.step(loads)
            return self.placement_sched.current_imbalance()
        rr = round_robin(self.loadproc.E, self.loadproc.ep, self.loadproc.slots)
        return float(np.mean([calculate_imbalance(rr, loads[l])
                              for l in range(self.loadproc.n_layers)]))

    def _push(self, t, kind, payload=None):
        heapq.heappush(self._events, (t, next(self._eid), kind, payload))

    # ------------------------------------------------------------------
    def run(self) -> dict:
        cfg = self.cfg
        reqs = closed_loop_requests(cfg.workload, cfg.n_requests)
        conc = cfg.concurrency or int(self.slots_per_instance *
                                      cfg.n_decode * 1.05)
        self._backlog = list(reversed(reqs))
        now = 0.0
        for _ in range(min(conc, len(self._backlog))):
            self._inject(now)
        self._push(cfg.placement_interval, "placement_tick")
        self._push(0.0, "proxy_tick")

        while self._events and now < cfg.max_sim_s:
            now, _, kind, payload = heapq.heappop(self._events)
            if kind == "proxy_tick":
                self._handle_proxy_tick(now)
                if self.proxy.inflight or self._backlog:
                    self._push(now + 0.005, "proxy_tick")
            elif kind == "prefill_done":
                self._handle_prefill_done(now, payload)
            elif kind == "decode_step":
                self._handle_decode_step(now, payload)
            elif kind == "placement_tick":
                self.moe_B = self._imbalance_now()
                # straggler process: each tick, instances may enter/leave a
                # degraded state (e.g. host contention, link flaps)
                r = self._straggle_rng
                for i in range(self.cfg.n_prefill):
                    if self.prefill_speed[i] == 1.0 and r.random() < 0.10:
                        self.prefill_speed[i] = r.uniform(1.6, 2.6)
                    elif self.prefill_speed[i] > 1.0 and r.random() < 0.4:
                        self.prefill_speed[i] = 1.0
                if self.placement_sched and self.placement_sched.history and \
                        self.placement_sched.history[-1].get("rebalanced"):
                    self.migration_count += 1
                self._push(now + cfg.placement_interval, "placement_tick")
            if not self.proxy.inflight and not self._backlog:
                break
        summary = self.metrics.summary(now)
        # steady-state QPM: completions between the 20th and 80th percentile
        # finish times (excludes warmup fill and long-tail drain)
        fins = sorted(r.finish_time for r in self.metrics.done)
        if len(fins) >= 20:
            i0, i1 = int(0.2 * len(fins)), int(0.8 * len(fins))
            span = max(fins[i1] - fins[i0], 1e-9)
            summary["qpm"] = 60.0 * (i1 - i0) / span
        summary.update(wall_s=now, moe_imbalance_final=self.moe_B,
                       migrations=self.migration_count,
                       slots_per_instance=self.slots_per_instance,
                       rebalances=(self.placement_sched.n_rebalances
                                   if self.placement_sched else 0))
        return summary

    # ------------------------------------------------------------------
    def _inject(self, now):
        if not self._backlog:
            return
        lin, lout, group = self._backlog.pop()
        rid = next(self._rid)
        # token-id stand-in: group prefix ids make the radix tree see real
        # shared prefixes without materializing full token arrays
        if group >= 0:
            pfx = min(self.cfg.workload.prefix_len, lin)
            tokens = tuple([(group << 20) | i for i in range(pfx)]) + \
                tuple([(rid << 22) | i for i in range(lin - pfx)])
        else:
            tokens = tuple([(rid << 22) | i for i in range(lin)])
        req = Request(rid, tokens, lout, arrival=now)
        self._req_meta[rid] = (lin, lout)
        self.proxy.submit(req, now)

    def _handle_proxy_tick(self, now):
        for req, inst, stage in self.proxy.tick(now):
            if stage == "prefill":
                iid = inst.iid
                new_tokens = req.prompt_len - req.prefix_match
                t_service = self.cfg.model.prefill_time(
                    max(new_tokens, 64), self.cfg.node, self.cfg.prefill_dies,
                    self.moe_B) * self.prefill_speed[iid]
                start = max(now, self.prefill_busy_until[iid])
                self.prefill_busy_until[iid] = start + t_service
                self._push(start + t_service, "prefill_done",
                           (req.rid, t_service))
            else:
                iid = inst.iid
                self.decode_queue[iid].append(req.rid)
                if not self._step_scheduled[iid]:
                    self._step_scheduled[iid] = True
                    self._push(now, "decode_step", iid)

    def _handle_prefill_done(self, now, payload):
        rid, t_service = payload
        req = self.proxy.inflight.get(rid)
        if req is None:
            return
        self.proxy.on_prefill_start(req, now - t_service)
        # KV transfer P→D before the decode queue sees it
        eff_len = min(req.prompt_len, self.cfg.attn_window) \
            if self.cfg.use_omniattn else req.prompt_len
        kv_bytes = eff_len * self.cfg.model.kv_bytes_per_token
        t_xfer = kv_bytes / self.cfg.node.interconnect_bw
        self.proxy.on_prefill_done(req, now + t_xfer, batch_time=t_service)
        self.proxy.on_first_token(req, now + t_xfer)
        req.output_tokens.append(0)

    def _handle_decode_step(self, now, iid):
        self._step_scheduled[iid] = False
        active = self.decode_active[iid]
        # admit from queue up to slot cap
        while self.decode_queue[iid] and len(active) < self.slots_per_instance:
            rid = self.decode_queue[iid].pop(0)
            req = self.proxy.inflight.get(rid)
            if req is None:
                continue
            self.proxy.on_decode_start(req, now)
            active[rid] = 0
        if not active:
            if self.proxy.inflight or self._backlog:
                self._step_scheduled[iid] = True
                self._push(now + 0.005, "decode_step", iid)
            return
        bpd = max(len(active) / self.cfg.decode_dies, 0.25)
        ctxs = np.array([self._req_meta[r][0] + active[r] for r in active],
                        dtype=float)
        if self.cfg.use_omniattn:   # compressed layers cap effective context
            ctxs = np.minimum(ctxs, self.cfg.attn_window)
        t_step = self.cfg.model.decode_step_time(
            bpd, float(ctxs.mean()), self.cfg.node, self.cfg.decode_dies,
            moe_imbalance=self.moe_B)
        done_rids = []
        for rid in list(active):
            active[rid] += 1
            req = self.proxy.inflight.get(rid)
            if req is None:
                done_rids.append(rid)
                continue
            req.output_tokens.append(0)
            if active[rid] >= self._req_meta[rid][1]:
                done_rids.append(rid)
        for rid in done_rids:
            req = self.proxy.inflight.get(rid)
            active.pop(rid, None)
            if req is not None:
                self.proxy.on_decode_done(req, now + t_step, batch_time=t_step)
                self.metrics.add(req)
                self._done_count += 1
                self._inject(now + t_step)   # closed loop
        self._step_scheduled[iid] = True
        self._push(now + t_step, "decode_step", iid)
