"""FaultPlane: seeded deterministic fault injection for the serving stack.

A `FaultPlane` is built from a `FaultConfig` (seed + per-kind fault counts
over a step horizon) and handed to `Server(faults=...)`. The server calls
`on_step(server, step, now)` at the TOP of every step, before any engine
round, so each fault's recovery (instance reroute, corruption quarantine,
handoff sweep) completes before the next token is computed, and outside
every captured graph. That ordering is what upholds the contract: under any
fault schedule, every completed request's output equals the fault-free
run's, because no token is ever produced from lost or corrupt KV and
restarted requests regenerate their prefix from positional draws.

Injectable faults, all drawn from one `np.random.default_rng(seed)` stream
in the reference's order, so a (seed, workload) pair replays the exact same
schedule (and `FaultPlane(cfg).schedule` equals the reference's):

  · kill_prefill / kill_decode: mark an instance unhealthy for a drawn
    number of steps, then revive it. The plane never kills the LAST healthy
    instance of a kind (the proxy would fail every pending request: a
    cluster loss, not a recoverable fault).
  · kv_corrupt: add a nonzero offset to one mapped arena block's keys,
    in place and WITHOUT updating its summary plane, then run
    `server.recover_corruption()` at once: the `summary != reduce(content)`
    scan is the detection under test (value corruption is invisible to the
    key-summary plane and out of scope).
  · kv_lost: release a resident decode request's KV out from under it (a
    decode node's memory lost); the request reroutes through prefill.
  · handoff_drop: drop a parked prefill→decode handoff without releasing
    its pool key (a payload lost mid-rename); the orphan-handoff sweep
    reclaims the blocks and the request recovers at dispatch.
  · alloc_fail: arm the pool to fail its next N real allocations
    (transient memory pressure); engines take their defer/preempt paths.
  · straggler: inflate one instance's EWMA batch time so the proxy's
    straggler penalty routes around it (scheduling only).

A fault whose precondition is absent when it fires (nothing resident to
corrupt, no parked handoff, no killable instance) is counted in `skipped`,
so chaos harnesses can assert on what actually fired.

Over several ranks every rank builds the same plane from the same seed and
its server calls `on_step` at the same step with rank 0's clock, so every
rank fires the same schedule. Every target draw reads the shared rng and
host state that lockstep keeps equal on every rank (the proxy's health and
EWMA, the pool's mappings, the parked handoffs, the resident rids); no
draw reads a rank-local value. The two reads of device state are
`kv_corrupt`'s: whether an int8 block holds a written slot, and which
blocks the summary scan condemns. Each rank holds only its own KV heads of
a block, so both are max-reduced over the world (`RankCtx.pmax_world`)
before any decision: every rank skips the same faults and condemns, drops
and restarts the same blocks and requests.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.serving.arena import BlockHandoff, KVArena

FAULT_KINDS = ("kill_prefill", "kill_decode", "kv_corrupt", "kv_lost",
               "handoff_drop", "alloc_fail", "straggler")


@torch.no_grad()
def corrupt_block(arena: KVArena, b: int, offset: float = 1.0):
    """Add `offset` to block `b`'s KEYS in every full-attention layer arena
    (every entry that carries `kmin`), in place, without touching the
    summary plane: `kmin/kmax` no longer equal a fresh reduction of the
    block's content, so `KVArena.find_corrupt_blocks()` condemns it. Int8
    arenas perturb the payload ints by a clipped integer delta (at least one
    step, so the change survives the grid); the summaries bound the
    dequantized content, so the same scan detects it. In place, because a
    captured graph keeps reading the tensors it was captured with."""
    for e in arena.kv:
        if e is None or "kmin" not in e:
            continue
        k = e["k"]
        if k.dtype == torch.int8:
            delta = max(1, round(abs(offset)))
            k[b] = (k[b].to(torch.int16) + delta).clamp_(-127, 127) \
                .to(torch.int8)
        else:
            k[b] += offset


def _unwritten_int8(arena: KVArena, b: int, ctx) -> bool:
    """Block `b` of an int8 arena holds no written slot: every scale row
    (sealed per channel or per token) is zero in every layer, as for a
    block a decode slot has grown into but not written yet. The "written"
    bit of this rank's KV heads is max-reduced over `ctx`'s world (a
    RankCtx; the identity on one rank), so every rank takes the same skip
    decision: a collective, every rank calls it for the same block."""
    ents = [e for e in arena.kv if e is not None and "kscale" in e]
    if not ents:
        return False
    written = torch.stack([e["kscale"][b].any() | e["ktok"][b].any()
                           for e in ents]).any().reshape(1)
    return not bool(ctx.pmax_world(written))


@dataclass(frozen=True)
class FaultSpec:
    step: int                   # server step the fault fires at
    kind: str                   # one of FAULT_KINDS
    arg: Optional[int] = None   # kind-specific (down steps / burst size)


@dataclass
class FaultConfig:
    seed: int = 0
    horizon: int = 120          # faults are scheduled in [warmup, horizon)
    warmup_steps: int = 2       # let the first dispatches land before chaos
    n_kill_prefill: int = 1
    n_kill_decode: int = 1
    n_kv_corrupt: int = 2
    n_kv_lost: int = 2
    n_handoff_drop: int = 2
    n_alloc_fail: int = 2
    n_straggler: int = 1
    kill_down_steps: tuple = (2, 8)     # inclusive range of downtime draws
    alloc_fail_burst: tuple = (1, 3)    # inclusive range of burst sizes
    straggler_slowdown: float = 4.0     # EWMA inflation factor


class FaultPlane:
    """Deterministic fault scheduler: builds the whole (step, kind, arg)
    schedule up front from the config's rng stream, then fires due specs at
    each `on_step`. Targets (which instance / block / rid) draw from the
    same stream when they fire: still deterministic for a fixed workload,
    since the server itself is deterministic between faults."""

    def __init__(self, cfg: Optional[FaultConfig] = None):
        self.cfg = cfg or FaultConfig()
        self.rng = np.random.default_rng(self.cfg.seed)
        self.injected = {k: 0 for k in FAULT_KINDS}
        self.skipped = {k: 0 for k in FAULT_KINDS}
        # (step, kind, target) of every injected fault: the killed instance
        # id, (corrupted block, blocks the scan condemned), the rid whose KV
        # or handoff was lost, the burst size, or the straggler's
        # (kind, iid)
        self.fired: list = []
        self._revive: list = []     # (due_step, kind, iid)
        self._start: Optional[int] = None   # server step of the first call
        self.schedule = deque(self._build())

    def _build(self) -> list:
        c, rng = self.cfg, self.rng
        lo, hi = c.warmup_steps, max(c.horizon, c.warmup_steps + 1)

        def at(n):
            return [int(s) for s in rng.integers(lo, hi, size=n)]

        def down():
            return int(rng.integers(c.kill_down_steps[0],
                                    c.kill_down_steps[1] + 1))
        specs = []
        for s in at(c.n_kill_prefill):
            specs.append(FaultSpec(s, "kill_prefill", down()))
        for s in at(c.n_kill_decode):
            specs.append(FaultSpec(s, "kill_decode", down()))
        for s in at(c.n_kv_corrupt):
            specs.append(FaultSpec(s, "kv_corrupt"))
        for s in at(c.n_kv_lost):
            specs.append(FaultSpec(s, "kv_lost"))
        for s in at(c.n_handoff_drop):
            specs.append(FaultSpec(s, "handoff_drop"))
        for s in at(c.n_alloc_fail):
            specs.append(FaultSpec(s, "alloc_fail", int(rng.integers(
                c.alloc_fail_burst[0], c.alloc_fail_burst[1] + 1))))
        for s in at(c.n_straggler):
            specs.append(FaultSpec(s, "straggler"))
        return sorted(specs, key=lambda f: (f.step, f.kind))

    def _pick(self, seq):
        seq = list(seq)
        return seq[int(self.rng.integers(len(seq)))] if seq else None

    # ------------------------------------------------------------------
    def on_step(self, server, step: int, now: float):
        """Fire every fault scheduled at or before `step` and process due
        instance revivals. Called by Server.step() before engine rounds.
        Steps count from the first server step the plane sees: step 0 when
        the plane is handed to the constructor, so a plane attached to a
        server that already served keeps its schedule."""
        if self._start is None:
            self._start = step
        step -= self._start
        for due, kind, iid in [r for r in self._revive if r[0] <= step]:
            server.revive_instance(kind, iid)
            self._revive.remove((due, kind, iid))
        while self.schedule and self.schedule[0].step <= step:
            self._fire(server, self.schedule.popleft(), step, now)

    def _fire(self, server, spec: FaultSpec, step: int, now: float):
        kind = spec.kind
        if kind in ("kill_prefill", "kill_decode"):
            ekind = "prefill" if kind == "kill_prefill" else "decode"
            stats = server.proxy.prefill if ekind == "prefill" \
                else server.proxy.decode
            healthy = [s.iid for s in stats if s.healthy]
            if len(healthy) <= 1:       # never kill the last healthy one
                self.skipped[kind] += 1
                return
            target = iid = self._pick(healthy)
            server.inject_instance_failure(ekind, iid, now)
            self._revive.append((step + max(spec.arg or 1, 1), ekind, iid))
        elif kind == "kv_corrupt":
            arena = server.kv_arena
            if arena is None or not any(e is not None and "kmin" in e
                                        for e in arena.kv):
                # no summary plane → the corruption would be undetectable
                self.skipped[kind] += 1
                return
            pool = arena.pool
            cands = [b for b in sorted(pool.refcount)
                     if b not in pool.quarantined]
            if not cands:
                self.skipped[kind] += 1
                return
            b = self._pick(cands)
            offset = 0.5 + float(self.rng.random())
            if _unwritten_int8(arena, b, server.ctx):
                # every slot's scale is zero, so the block dequantizes to
                # zero whatever its payload: no content to corrupt, and no
                # scan could see it (the reference asserts here and fails)
                self.skipped[kind] += 1
                return
            corrupt_block(arena, b, offset=offset)
            got = server.recover_corruption(now)
            assert b in got, f"corrupted block {b} not detected"
            target = (b, tuple(got))
        elif kind == "kv_lost":
            resident = sorted({r for eng in server.decodes
                               for r in eng.rid_slot})
            if not resident:
                self.skipped[kind] += 1
                return
            target = self._pick(resident)
            server.inject_kv_lost(target, now)
        elif kind == "handoff_drop":
            parked = sorted(r for r, kv in server._pending_kv.items()
                            if isinstance(kv[0], BlockHandoff))
            if not parked:
                self.skipped[kind] += 1
                return
            target = self._pick(parked)
            server.inject_handoff_drop(target)
        elif kind == "alloc_fail":
            if server.kv_arena is None:
                self.skipped[kind] += 1
                return
            target = max(spec.arg or 1, 1)
            server.kv_arena.pool.inject_alloc_failures += target
        elif kind == "straggler":
            stats = self._pick(server.proxy.prefill + server.proxy.decode)
            if stats is None:
                self.skipped[kind] += 1
                return
            stats.ewma_batch_time = max(stats.ewma_batch_time, 1e-3) \
                * self.cfg.straggler_slowdown
            target = (stats.kind, stats.iid)
        self.injected[kind] += 1
        self.fired.append((step, kind, target))
