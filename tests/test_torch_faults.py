"""FaultPlane of the PyTorch port against the JAX reference, on the CPU.

The reference's `tests/test_faults.py` scenarios on the port's `Server`
(reduced qwen2-1.5b, 2 layers, float32, weights bridged from the JAX
`LM.init(PRNGKey(0))`):

  · the schedule of a `FaultConfig` equals `repro.serving.faults.FaultPlane`'s
    exactly (same rng stream, same draw order);
  · retry-cap exhaustion retires with "error", the orphan-handoff sweep,
    the watchdog's "timeout", admission shedding (quarantine-aware gate and
    backlog cap), an allocation-failure burst, the disaggregated failure
    drill (two prefill instances, sampled requests, a kill and an abort);
  · corruption under a live decode request: exactly the corrupted block is
    found, quarantined and scrubbed (float32 and int8, scales zeroed), and
    the output equals the fault-free run's; the device scan equals a numpy
    scan over `_dense_k` of the same arena;
  · chaos soaks (float32, speculation, int8) on the reference's soak server
    (two prefill and two decode instances): the port's fault-free streams
    equal the JAX `Server`'s on the same workload, and every chaos run's
    streams equal the fault-free run's.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest tests/test_torch_faults.py -q
"""
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config
from repro.core.proxy import OASConfig
from repro.serving import FaultConfig, FaultPlane, SamplingParams, Server, \
    ServerConfig
from repro.serving.quant import QuantConfig
from repro_torch import bridge
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.core.proxy import BackpressureError
from repro_torch.core.proxy import MetricsAggregator as TMetricsAggregator
from repro_torch.core.proxy import OASConfig as TOASConfig
from repro_torch.core.proxy import SamplingParams as TSamplingParams
from repro_torch.serving import FaultConfig as TFaultConfig
from repro_torch.serving import FaultPlane as TFaultPlane
from repro_torch.serving import Server as TServer
from repro_torch.serving import ServerConfig as TServerConfig
from repro_torch.serving.faults import FAULT_KINDS, corrupt_block
from repro_torch.serving.quant import QuantConfig as TQuantConfig
from repro_torch.serving.spec import SpecConfig as TSpecConfig

torch.set_num_threads(2)

SOAK_SEEDS = (1, 2, 5, 7, 9)
SOAK = dict(n_prefill=2, n_decode=2, decode_slots=4, max_len=128,
            chunk_tokens=32, prefill_tick_budget=64, kv_blocks=96,
            watchdog_steps=200)
SMALL = dict(n_prefill=1, n_decode=1, decode_slots=4, max_len=96)


def _jcfg():
    return reduced_config("qwen2-1.5b").with_updates(
        compute_dtype="float32", param_dtype="float32", n_layers=2)


@pytest.fixture(scope="module")
def port():
    """→ (torch config, bridged params, JAX soak server for references)."""
    jcfg = _jcfg()
    tcfg = t_reduced_config("qwen2-1.5b").with_updates(
        compute_dtype="float32", param_dtype="float32", n_layers=2)
    jsrv = Server(jcfg, ServerConfig(**SOAK, oas=OASConfig(
        defer_window=0.0, max_retries=10)), pattern=[0, 0])
    params = bridge.params_from_numpy(
        jax.tree.map(np.asarray, jsrv.params), tcfg, jsrv.lm.plan,
        device="cpu")
    return tcfg, params, jsrv


def _server(port, faults=None, **kw):
    tcfg, params, _ = port
    oas = kw.pop("oas", TOASConfig(defer_window=0.0, max_retries=4))
    return TServer(tcfg, TServerConfig(**kw, oas=oas), pattern=[0, 0],
                   params=params, device="cpu", faults=faults)


def _soak_server(port, faults=None, spec=None, quant=None):
    return _server(port, faults=faults, spec=spec, quant=quant,
                   oas=TOASConfig(defer_window=0.0, max_retries=10), **SOAK)


def _drive(srv, reqs, params_cls=TSamplingParams, max_steps=3000):
    """Submit every request at t=0 and step() until quiescent; → (rids,
    streamed deltas per rid, finish records per rid)."""
    t0 = time.monotonic()
    rids = []
    for p, spec in reqs:
        sp = spec if isinstance(spec, params_cls) \
            else params_cls(max_tokens=int(spec))
        try:
            rids.append(srv.add_request(p, sp, now=t0))
        except BackpressureError:
            rids.append(None)
    deltas: dict = {}
    finishes: dict = {}
    steps = 0
    while srv.proxy.inflight and steps < max_steps:
        for out in srv.step():
            deltas.setdefault(out.rid, []).extend(out.new_tokens)
            if out.finished:
                finishes[out.rid] = (out.finish_reason, out.n_generated)
        steps += 1
    assert not srv.proxy.inflight, f"not quiescent after {steps} steps"
    return rids, deltas, finishes


def _outs(srv) -> dict:
    return {r.rid: tuple(r.output_tokens) for r in srv.metrics.done}


def _assert_no_leaks(srv):
    """Pool invariants (the zero-stale-summary scan included) hold and the
    only block mappings left are prefix-store entries."""
    if srv.kv_arena is None:
        return
    pool = srv.kv_arena.pool
    pool.check_invariants(arena=srv.kv_arena)
    for key in pool.per_request:
        assert isinstance(key, tuple) and key[0] == "store", \
            f"leaked block mapping under {key!r}"


def _soak_workload(vocab):
    rng = np.random.default_rng(42)
    return [(tuple(int(t) for t in rng.integers(0, vocab, 24)), 12)
            for _ in range(8)]


def _spec_workload(vocab):
    rng = np.random.default_rng(7)
    gram = tuple(int(t) for t in rng.integers(0, vocab, 6))
    return [(gram * 3, 12) for _ in range(4)] + \
        [(tuple(int(t) for t in rng.integers(0, vocab, 24)), 12)
         for _ in range(4)]


# ---------------------------------------------------------------------
@pytest.mark.parametrize("cfg", [
    dict(seed=1), dict(seed=2), dict(seed=5), dict(seed=7), dict(seed=9),
    dict(seed=3, horizon=40, warmup_steps=5, n_kill_prefill=3,
         n_kv_corrupt=4, n_alloc_fail=3, kill_down_steps=(1, 3),
         alloc_fail_burst=(2, 5))])
def test_schedule_equals_reference(cfg):
    """Same config → exactly the reference's schedule; it stays inside
    [warmup, horizon) and names only known kinds."""
    ref = list(FaultPlane(FaultConfig(**cfg)).schedule)
    got = list(TFaultPlane(TFaultConfig(**cfg)).schedule)
    assert [(f.step, f.kind, f.arg) for f in got] == \
        [(f.step, f.kind, f.arg) for f in ref]
    c = TFaultConfig(**cfg)
    assert len(got) == (c.n_kill_prefill + c.n_kill_decode + c.n_kv_corrupt
                        + c.n_kv_lost + c.n_handoff_drop + c.n_alloc_fail
                        + c.n_straggler)
    for spec in got:
        assert spec.kind in FAULT_KINDS
        assert c.warmup_steps <= spec.step < c.horizon


def test_metrics_robustness_keys():
    """The robustness counters ride along in both summary branches (the
    zero-done early return included)."""
    m = TMetricsAggregator()
    empty = m.summary(1.0)
    for k in ("n_errors", "n_timeouts", "n_shed", "n_retries",
              "blocks_quarantined"):
        assert k in empty and empty[k] == 0
    m.note_shed()
    m.note_quarantine(3)
    assert m.summary(1.0)["n_shed"] == 1
    assert m.summary(1.0)["blocks_quarantined"] == 3


def test_kv_lost_retry_cap_surfaces_error(port):
    """Losing a request's decode KV more often than `max_retries` allows
    retires it with "error" and leaks nothing."""
    srv = _server(port, oas=TOASConfig(defer_window=0.0, max_retries=1),
                  **SMALL)
    rng = np.random.default_rng(21)
    prompt = tuple(int(t) for t in rng.integers(0, port[0].vocab_size, 10))
    rid = srv.add_request(prompt, TSamplingParams(max_tokens=8))
    finish, injections = None, 0
    for _ in range(200):
        if any(rid in eng.rid_slot for eng in srv.decodes):
            srv.inject_kv_lost(rid)
            injections += 1
        for out in srv.step():
            if out.rid == rid and out.finished:
                finish = out.finish_reason
        if finish is not None:
            break
    assert finish == "error"
    assert injections == 2          # retry 1 granted, retry 2 over the cap
    assert not srv.proxy.inflight
    s = srv.metrics.summary(1.0)
    assert s["n_errors"] == 1 and s["n_retries"] >= 1
    _assert_no_leaks(srv)


def test_orphan_handoff_sweep_reclaims_and_recovers(port):
    """A parked handoff dropped without releasing its pool key is reclaimed
    by the sweep, and the request still completes via the kv-lost path."""
    srv = _server(port, **SMALL)
    rng = np.random.default_rng(22)
    rid = srv.add_request(
        tuple(int(t) for t in rng.integers(0, port[0].vocab_size, 12)),
        TSamplingParams(max_tokens=4))
    dropped, finish = False, None
    for _ in range(200):
        if not dropped and rid in srv._pending_kv:
            assert srv.inject_handoff_drop(rid)
            assert rid not in srv._pending_kv
            dropped = True
        for out in srv.step():
            if out.rid == rid and out.finished:
                finish = out.finish_reason
        srv.kv_arena.pool.check_invariants()
        if finish is not None:
            break
    assert dropped, "handoff never parked: the test lost its injection point"
    assert srv.n_handoffs_swept >= 1
    assert finish == "length"
    assert srv.metrics.summary(1.0)["n_retries"] >= 1
    assert srv.run([], max_wall_s=1.0)["n_handoffs_swept"] >= 1
    _assert_no_leaks(srv)


def test_watchdog_retires_stuck_request(port):
    """With every decode instance dead, a prefilled request never leaves
    DECODE_WAIT: the watchdog retires it with "timeout" and releases its
    parked KV."""
    srv = _server(port, watchdog_steps=5,
                  oas=TOASConfig(defer_window=0.0, max_retries=10), **SMALL)
    srv.inject_instance_failure("decode", 0)
    rng = np.random.default_rng(23)
    rid = srv.add_request(
        tuple(int(t) for t in rng.integers(0, port[0].vocab_size, 8)),
        TSamplingParams(max_tokens=6))
    finish = None
    for _ in range(60):
        for out in srv.step():
            if out.rid == rid and out.finished:
                finish = out.finish_reason
        if finish is not None:
            break
    assert finish == "timeout"
    assert not srv.proxy.inflight
    assert srv.metrics.summary(1.0)["n_timeouts"] == 1
    _assert_no_leaks(srv)


@pytest.mark.parametrize("gate", ["quarantine", "cap"])
def test_backpressure_shedding(port, gate):
    """Typed load shedding at the door. "quarantine": a prompt that fits
    the pool but not its non-quarantined blocks is shed. "cap": a prompt
    no release could fit, and an admission backlog at the cap, are shed.
    The shed requests never enter the proxy; the admitted ones serve."""
    vocab = port[0].vocab_size
    srv = _server(port, **dict(SMALL, decode_slots=2, kv_blocks=6,
                               admission_queue_cap=2))
    rng = np.random.default_rng(24)
    if gate == "quarantine":
        # 6 blocks × 16 tokens: 90 tokens fit until two blocks quarantine
        prompt = tuple(int(t) for t in rng.integers(0, vocab, 90))
        srv.kv_arena.pool.quarantine(1)
        srv.kv_arena.pool.quarantine(2)
        with pytest.raises(BackpressureError, match="2 quarantined"):
            srv.add_request(prompt, TSamplingParams(max_tokens=2))
        assert not srv.proxy.inflight
        assert srv.metrics.summary(1.0)["n_shed"] == 1
        short = tuple(int(t) for t in rng.integers(0, vocab, 6))
        r0 = srv.add_request(short, TSamplingParams(max_tokens=2))
        done = set()
        for _ in range(200):
            done |= {o.rid for o in srv.step() if o.finished}
            if done == {r0}:
                break
        assert done == {r0}
        srv.kv_arena.pool.check_invariants(arena=srv.kv_arena)
        return
    with pytest.raises(BackpressureError):
        srv.add_request(tuple(int(t) for t in rng.integers(0, vocab, 200)),
                        TSamplingParams(max_tokens=2))
    assert not srv.proxy.inflight
    short = [tuple(int(t) for t in rng.integers(0, vocab, 6))
             for _ in range(3)]
    r0 = srv.add_request(short[0], TSamplingParams(max_tokens=2))
    r1 = srv.add_request(short[1], TSamplingParams(max_tokens=2))
    with pytest.raises(BackpressureError):     # backlog 2 >= cap 2
        srv.add_request(short[2], TSamplingParams(max_tokens=2))
    assert srv.metrics.summary(1.0)["n_shed"] == 2
    done = set()
    for _ in range(200):
        done |= {o.rid for o in srv.step() if o.finished}
        if done == {r0, r1}:
            break
    assert done == {r0, r1}
    _assert_no_leaks(srv)


@pytest.mark.parametrize("quant", [False, True], ids=["float32", "int8"])
def test_corruption_detected_quarantined_bit_identical(port, quant):
    """KV corruption under a live decode request: the scan finds exactly the
    corrupted block, it is quarantined and scrubbed in place (every leaf
    zero, the int8 scale rows too; no arena tensor rebound), the request
    restarts, and every output equals the fault-free run's."""
    q = TQuantConfig() if quant else None
    rng = np.random.default_rng(27 if quant else 25)
    reqs = [(tuple(int(t) for t in rng.integers(0, port[0].vocab_size, 14)),
             6) for _ in range(2)]
    base = _server(port, quant=q, **SMALL)
    _drive(base, reqs)
    ref = _outs(base)

    srv = _server(port, quant=q, **SMALL)
    assert all(e is not None and "kmin" in e for e in srv.kv_arena.kv)
    assert srv.kv_arena.quant == quant
    ptrs = [t.data_ptr() for e in srv.kv_arena.kv for t in e.values()]
    t0 = time.monotonic()
    for p, m in reqs:
        srv.add_request(p, TSamplingParams(max_tokens=m), now=t0)
    corrupted = None
    pool = srv.kv_arena.pool
    for _ in range(300):
        if corrupted is None:
            owned = [pool.owned(rid) for eng in srv.decodes
                     for rid in eng.rid_slot if pool.owned(rid)]
            if owned:
                corrupted = owned[0][0]
                corrupt_block(srv.kv_arena, corrupted, offset=0.75)
                assert srv.recover_corruption() == [corrupted]
                assert corrupted in pool.quarantined
                assert corrupted not in pool.refcount
                srv.kv_arena.check_summaries()
                for e in srv.kv_arena.kv:
                    for name, t in e.items():
                        assert not t[corrupted].any(), \
                            f"scrub left {name} nonzero on {corrupted}"
        srv.step()
        if not srv.proxy.inflight:
            break
    assert corrupted is not None, "no decode-resident block to corrupt"
    assert not srv.proxy.inflight
    assert _outs(srv) == ref, "post-corruption replay diverged"
    assert srv.metrics.summary(1.0)["blocks_quarantined"] == 1
    assert [t.data_ptr() for e in srv.kv_arena.kv
            for t in e.values()] == ptrs
    _assert_no_leaks(srv)


def _numpy_scan(arena) -> list:
    """The reference's host scan over `_dense_k`."""
    bad = np.zeros(arena.pool.n_blocks + 1, bool)
    for e in arena.kv:
        if e is None or "kmin" not in e:
            continue
        k = arena._dense_k(e)
        mism = (e["kmin"].numpy() != k.min(axis=-2)) | \
            (e["kmax"].numpy() != k.max(axis=-2))
        bad |= mism.reshape(mism.shape[0], -1).any(axis=1)
    return [int(b) for b in np.nonzero(bad)[0]]


@pytest.mark.parametrize("quant", [False, True], ids=["float32", "int8"])
def test_find_corrupt_blocks_matches_numpy_scan(port, quant):
    """The device scan equals the reference's numpy scan over `_dense_k` on
    the same served arena: nothing flagged at quiescence, then exactly the
    corrupted blocks (one per offset sign, and one channel of one layer)."""
    srv = _server(port, quant=TQuantConfig() if quant else None, **SMALL)
    rng = np.random.default_rng(5)
    _drive(srv, [(tuple(int(t) for t in rng.integers(
        0, port[0].vocab_size, 30)), 5) for _ in range(3)])
    arena = srv.kv_arena
    assert arena.find_corrupt_blocks() == _numpy_scan(arena) == []
    live = sorted({b for blocks in arena.pool.per_request.values()
                   for b in blocks})
    assert len(live) >= 3
    corrupt_block(arena, live[0], offset=0.6)
    corrupt_block(arena, live[1], offset=-1.3)
    k1 = arena.kv[1]["k"][live[2], 0, :, 0]     # one channel of one layer
    if quant:
        k1.copy_((k1.to(torch.int16) - 3).clamp(-127, 127).to(torch.int8))
    else:
        k1 += 5.0
    got = arena.find_corrupt_blocks()
    assert got == _numpy_scan(arena) == sorted(live[:3])
    mask = arena.corrupt_mask()
    assert mask.dtype == torch.bool and mask.shape == (arena.pool.n_blocks
                                                       + 1,)


@pytest.mark.parametrize("quant", [False, True], ids=["float32", "int8"])
def test_chunk_ends_do_not_follow_the_round(port, quant):
    """A prompt's chunks end where its prompt and resume point put them,
    whatever else shares the round: alone, or after a short prompt that
    takes part of the budget, it lands the same KV bytes and logits (on
    int8 arenas a chunk attends its own K/V unquantized, so other ends
    would change them)."""
    vocab = port[0].vocab_size
    rng = np.random.default_rng(9)
    prompt = tuple(int(t) for t in rng.integers(0, vocab, 60))
    short = tuple(int(t) for t in rng.integers(0, vocab, 8))
    got = []
    for first in ((), (short,)):
        srv = _server(port, quant=TQuantConfig() if quant else None,
                      **dict(SMALL, chunk_tokens=16, prefill_tick_budget=32,
                             kv_block_size=8))
        _drive(srv, [(p, 1) for p in first + (prompt,)])
        eng = srv.prefills[0]
        ent = eng.store.lookup_entry(prompt)
        assert ent.n == len(prompt)
        kv = [torch.stack([e[n][list(ent.blocks)] for e in srv.kv_arena.kv])
              for n in ("k", "v")]
        got.append((ent.logits, kv, eng.stats["chunks"]))
    (la, kva, ca), (lb, kvb, cb) = got
    assert cb == ca + 1                 # the short prompt's one chunk
    assert torch.equal(la, lb)
    assert all(torch.equal(x, y) for x, y in zip(kva, kvb))


def test_alloc_failure_burst_recovers(port):
    """A burst of injected allocation failures only defers or preempts:
    every request completes and the pool balances."""
    srv = _server(port, **SMALL)
    srv.kv_arena.pool.inject_alloc_failures = 3
    rng = np.random.default_rng(26)
    reqs = [(tuple(int(t) for t in rng.integers(0, port[0].vocab_size, 12)),
             5) for _ in range(3)]
    _, _, finishes = _drive(srv, reqs)
    assert srv.kv_arena.pool.inject_alloc_failures == 0, \
        "armed failures never consumed: injection point dead"
    assert {f[0] for f in finishes.values()} == {"length"}
    assert len(finishes) == 3
    _assert_no_leaks(srv)


def test_disaggregated_failure_drill(port):
    """Sampled streaming requests over two prefill instances, a mid-stream
    prefill death and revival, and an abort: delivered counters hold, no
    delta is replayed, no block leaks."""
    srv = _server(port, **dict(SMALL, n_prefill=2, chunk_tokens=8,
                               prefill_tick_budget=8))
    rng = np.random.default_rng(1)
    prompts = [tuple(int(t) for t in rng.integers(
        0, port[0].vocab_size, int(rng.integers(6, 20)))) for _ in range(6)]
    params = [TSamplingParams(temperature=0.7, top_k=32, seed=i,
                              max_tokens=4) for i in range(6)]
    deltas: dict = {}
    finishes: dict = {}
    kicked = aborted = None
    for out in srv.generate(prompts, params, max_wall_s=120):
        deltas.setdefault(out.rid, []).extend(out.new_tokens)
        if out.finished:
            finishes[out.rid] = (out.finish_reason, out.n_generated)
        if kicked is None and out.new_tokens:
            kicked = out.rid
            srv.inject_instance_failure("prefill", 0)
            srv.revive_instance("prefill", 0)
        if aborted is None and kicked is not None:
            quiet = [r for r in range(6)
                     if r not in finishes and not deltas.get(r)]
            if quiet:
                aborted = quiet[0]
                assert srv.abort(aborted)
    assert len(finishes) == 6
    for rid, (reason, n_out) in finishes.items():
        if rid == aborted:
            assert reason == "abort"
            assert len(deltas.get(rid, [])) <= n_out
        else:
            assert reason in ("stop", "length")
            assert len(deltas[rid]) == n_out == 4
    for rid, toks in _outs(srv).items():
        assert tuple(deltas[rid]) == toks
    s = srv.metrics.summary(1.0)
    assert s["n_done"] == 5 and len(srv.metrics.aborted) == 1
    _assert_no_leaks(srv)


# ---------------------------------------------------------------------
SOAKS = {"float32": (_soak_workload, {}),
         "spec": (_spec_workload, {"spec": TSpecConfig(k=4)}),
         "int8": (_soak_workload, {"quant": TQuantConfig()})}


@pytest.fixture(scope="module")
def fault_free(port):
    """Per soak: the port's fault-free run (a server without speculation
    for "spec", as the reference's soak holds it), checked against the JAX
    `Server` on the same workload and weights. → {kind: (reqs, streams)}."""
    tcfg, _, jsrv = port
    out = {}
    for kind, (work, kw) in SOAKS.items():
        reqs = work(tcfg.vocab_size)
        if kind == "int8":
            jq = Server(_jcfg(), ServerConfig(**SOAK, quant=QuantConfig(),
                                              oas=OASConfig(defer_window=0.0,
                                                            max_retries=10)),
                        pattern=[0, 0], params=jsrv.params)
            jq.run([(p, SamplingParams(max_tokens=m)) for p, m in reqs],
                   max_wall_s=600)
            jref = _outs(jq)
        else:
            before = len(jsrv.metrics.done)
            jsrv.run([(p, SamplingParams(max_tokens=m)) for p, m in reqs],
                     max_wall_s=600)
            jref = {r.rid: tuple(r.output_tokens)
                    for r in jsrv.metrics.done[before:]}
        base = _soak_server(port, quant=kw.get("quant"))
        _drive(base, reqs)
        ref = _outs(base)
        _assert_no_leaks(base)
        out[kind] = (reqs, ref, jref)
    return out


@pytest.mark.parametrize("kind", list(SOAKS))
def test_fault_free_soak_equals_jax_server(fault_free, kind):
    reqs, ref, jref = fault_free[kind]
    assert len(ref) == len(reqs) == 8
    assert ref == jref


@pytest.mark.parametrize("seed", SOAK_SEEDS)
@pytest.mark.parametrize("kind", list(SOAKS))
def test_chaos_soak_bit_identical(port, fault_free, kind, seed):
    """Under a full seeded schedule (kills, corruption, KV loss, handoff
    drops, allocation failures, stragglers) over two prefill and two decode
    instances, every request completes with the fault-free run's output,
    no streamed delta is replayed or lost, and the quiescent pool passes
    its invariants with nothing leaked."""
    reqs, ref, _ = fault_free[kind]
    plane = TFaultPlane(TFaultConfig(seed=seed, horizon=20))
    srv = _soak_server(port, faults=plane, **SOAKS[kind][1])
    _, deltas, finishes = _drive(srv, reqs)
    outs = _outs(srv)
    assert len(outs) == 8, f"incomplete: {finishes}"
    assert outs == ref, "outputs diverged from the fault-free run"
    for rid, toks in outs.items():
        assert tuple(deltas[rid]) == toks, f"rid {rid}: deltas replayed/lost"
    assert sum(plane.injected.values()) > 0, "chaos run injected nothing"
    for _, k, target in plane.fired:
        if k == "kv_corrupt":           # condemned exactly its block
            assert target[1] == (target[0],), target
    if (kind, seed) == ("int8", 5):
        # its first kv_corrupt picks a block a decode slot has grown into
        # but not written: every scale zero, nothing to corrupt (the
        # reference's assert fails there on the same block)
        assert plane.skipped["kv_corrupt"] == 1
    pool = srv.kv_arena.pool
    assert len(pool.quarantined) == srv.metrics.blocks_quarantined
    s = srv.metrics.summary(1.0)
    assert s["n_errors"] == 0 and s["n_timeouts"] == 0
    for eng in srv.decodes:
        assert eng.stats["host_fetches"] == eng.stats["steps"]
    _assert_no_leaks(srv)
