"""OmniPlacement slice of the PyTorch port against the JAX reference: the
placement control plane (static placement, the dynamic scheduler, migration
plans) on seeded loads, and MoE serving through the port's `Server` —
greedy streams and drained expert counts equal to the JAX `Server`'s, and a
forced migration that changes no output. The reference server is built on
an Auto-axis mesh (its MoE decode needs one on this jax; ROADMAP C1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import reduced_config
from repro.core import placement as jpl
from repro.core.placement import migration as jmig
from repro.core.proxy import OASConfig
from repro.distributed.ctx import MeshCtx
from repro.models import moe as jmoe
from repro.serving import SamplingParams, Server, ServerConfig
from repro_torch import bridge
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.core import placement as tpl
from repro_torch.core.placement import migration as tmig
from repro_torch.core.proxy import OASConfig as TOASConfig
from repro_torch.core.proxy import SamplingParams as TSamplingParams
from repro_torch.models import moe as tmoe
from repro_torch.serving import Server as TServer
from repro_torch.serving import ServerConfig as TServerConfig

torch.set_num_threads(2)


def _np(tables):
    return {k: np.asarray(v) for k, v in tables.items()}


# ---- control plane ---------------------------------------------------
@pytest.mark.parametrize("ep,E,s", [(1, 8, 8), (4, 8, 2), (4, 10, 3)])
def test_tables_and_slots_match_reference(ep, E, s):
    place = jmoe.round_robin_placement(E, ep, s)
    np.testing.assert_array_equal(tmoe.round_robin_placement(E, ep, s), place)
    jt = _np(jmoe.tables_from_placement(place, s))
    tt = {k: v.numpy() for k, v in tmoe.tables_from_placement(place,
                                                              s).items()}
    assert jt.keys() == tt.keys()
    for k in jt:
        np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)
    can = np.arange(E * 6, dtype=np.float32).reshape(E, 2, 3) + 1
    np.testing.assert_array_equal(
        tmoe.slots_from_canonical(torch.from_numpy(can),
                                  jt["slot_expert"]).numpy(),
        np.asarray(jmoe.slots_from_canonical(jnp.asarray(can),
                                             jt["slot_expert"])))


def _loads(seed, L, E, skew):
    rng = np.random.default_rng(seed)
    d = rng.gamma(2.0, 10.0, (L, E))
    if skew:
        d[:, rng.choice(E, 3, replace=False)] *= skew
    return d


@pytest.mark.parametrize("skew", [0.0, 8.0])
def test_static_placement_matches_reference(skew):
    L, E, ep = 3, 16, 4
    D = _loads(1, L, E, skew)
    for budget in (0, 4):
        jp, js = jpl.static_expert_placement(D, ep, budget)
        tp, ts = tpl.static_expert_placement(D, ep, budget)
        np.testing.assert_array_equal(ts, js)
        for a, b in zip(tp, jp):
            np.testing.assert_array_equal(a, b)
            assert tpl.calculate_imbalance(a, D[0]) == \
                jpl.calculate_imbalance(b, D[0])
    cnt = tpl.determine_replicas(D[0], 4, ep, 5)
    np.testing.assert_array_equal(cnt, jpl.determine_replicas(D[0], 4, ep, 5))
    np.testing.assert_array_equal(
        tpl.allocate_budget_by_imbalance(D, 4, 6, ep),
        jpl.allocate_budget_by_imbalance(D, 4, 6, ep))
    prev = jpl.generate_placement(cnt, D[1], ep, 5)
    np.testing.assert_array_equal(
        tpl.generate_placement(cnt, D[0], ep, 5, prev=prev),
        jpl.generate_placement(cnt, D[0], ep, 5, prev=prev))


def test_dynamic_scheduler_and_migration_match_reference():
    """A balanced load, then a shift onto three hot experts at ep = 4: both
    schedulers trigger at the same tick with the same plans and the same
    history; applying a plan gives the reference's slots and tables."""
    ep, E, s = 4, 16, 5
    place = [jpl.static.round_robin(E, ep, 4)]

    def sched(mod):
        return mod.DynamicScheduler(
            ep=ep, n_experts=E, n_layers=1,
            cfg=mod.SchedulerConfig(budget=4, max_slots=s),
            placements=[p.copy() for p in place])
    js, ts = sched(jpl), sched(tpl)
    fired = 0
    for tick in range(8):
        c = _loads(10 + tick, 1, E, 6.0 if tick >= 3 else 0.0)
        jplans, tplans = js.step(c), ts.step(c)
        assert (jplans is None) == (tplans is None), tick
        if jplans is None:
            continue
        fired += 1
        for a, b in zip(tplans, jplans):
            np.testing.assert_array_equal(a.old_slot_expert,
                                          b.old_slot_expert)
            np.testing.assert_array_equal(a.new_slot_expert,
                                          b.new_slot_expert)
            assert a.moves == b.moves and a.n_moves == b.n_moves
        rng = np.random.default_rng(tick)
        can = {"w": rng.standard_normal((E, 3, 2)).astype(np.float32)}
        jslots, jtab = jmig.apply_migration(
            jplans[0], {"w": jnp.asarray(can["w"])}, None,
            jmoe.slots_from_canonical)
        tslots, ttab = tmig.apply_migration(
            tplans[0], {"w": torch.from_numpy(can["w"])})
        np.testing.assert_array_equal(tslots["w"].numpy(),
                                      np.asarray(jslots["w"]))
        for k in jtab:
            np.testing.assert_array_equal(ttab[k].numpy(),
                                          np.asarray(jtab[k]), err_msg=k)
    assert fired >= 1
    assert ts.history == js.history
    assert (ts.n_rebalances, ts.n_checks) == (js.n_rebalances, js.n_checks)
    for a, b in zip(ts.placements, js.placements):
        np.testing.assert_array_equal(a, b)


# ---- serving ---------------------------------------------------------
SCFG = dict(n_prefill=1, n_decode=1, decode_slots=3, max_len=96,
            chunk_tokens=16, prefill_tick_budget=32, kv_blocks=40,
            kv_block_size=8, placement_interval=2)


def _workload(vocab, n=5, prefix=24):
    rng = np.random.default_rng(17)
    base = tuple(int(t) for t in rng.integers(0, vocab, prefix))
    return [base + tuple(int(t) for t in rng.integers(0, vocab, 6))
            if i % 3 != 2 else
            tuple(int(t) for t in rng.integers(0, vocab, 7))
            for i in range(n)]


@pytest.fixture(scope="module")
def moe_servers():
    cfg = reduced_config("qwen2-moe-a2.7b").with_updates(
        compute_dtype="float32", param_dtype="float32")
    tcfg = t_reduced_config("qwen2-moe-a2.7b").with_updates(
        compute_dtype="float32", param_dtype="float32")
    mesh = MeshCtx(jax.make_mesh((1, 1), ("data", "model"),
                                 axis_types=(AxisType.Auto,) * 2))
    jsrv = Server(cfg, ServerConfig(**SCFG, oas=OASConfig(defer_window=0.0)),
                  mesh=mesh, pattern=[0, 0])
    np_params = jax.tree.map(np.asarray, jsrv.params)

    def port(**kw):
        tparams = bridge.params_from_numpy(np_params, tcfg, jsrv.lm.plan,
                                           device="cpu")
        return TServer(tcfg, TServerConfig(**dict(SCFG, **kw), oas=TOASConfig(
            defer_window=0.0)), pattern=[0, 0], params=tparams, device="cpu")
    return cfg, jsrv, port


def _window(srv):
    return [np.asarray(w) for w in srv.placement_sched._window]


def test_moe_server_streams_and_counts_match_jax_server(moe_servers):
    cfg, jsrv, port = moe_servers
    tsrv = port()
    prompts = _workload(cfg.vocab_size)
    js = jsrv.run([(p, SamplingParams(max_tokens=6)) for p in prompts],
                  max_wall_s=600)
    ts = tsrv.run([(p, TSamplingParams(max_tokens=6)) for p in prompts],
                  max_wall_s=600)
    jout = {r.rid: tuple(r.output_tokens) for r in jsrv.metrics.done}
    tout = {r.rid: tuple(r.output_tokens) for r in tsrv.metrics.done}
    assert len(tout) == len(prompts) and tout == jout
    assert ts["prefill_stats"][0]["reused_tokens"] > 0
    ds = ts["decode_stats"][0]
    assert ds["host_fetches"] == ds["steps"] > 0
    # every monitor tick drained the same expert counts, and at ep = 1
    # nothing rebalanced
    jw, tw = _window(jsrv), _window(tsrv)
    assert len(tw) == len(jw) >= 2
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a, b)
    assert tsrv.placement_sched.history == jsrv.placement_sched.history
    assert all(h == {"b": 1.0, "rebalanced": False}
               for h in tsrv.placement_sched.history)
    assert ts["n_migrations"] == 0 and ts["migration_log"] == []
    left = tsrv.decodes[0].take_moe_counts()
    np.testing.assert_array_equal(left, jsrv.decodes[0].take_moe_counts())
    # counted: top_k x layers x live decode rows, summed over the run
    assert sum(float(w.sum()) for w in tw) + float(left.sum()) == \
        cfg.moe.top_k * cfg.n_layers * ds["tokens"]
    tsrv.kv_arena.pool.check_invariants(arena=tsrv.kv_arena)


def _reversed_plan(srv):
    old = srv.tables["slot_expert"].numpy().copy()
    new = old[:, ::-1].copy()
    return tmig.MigrationPlan(old, new, tuple(
        (0, i, int(new[0, i])) for i in range(new.shape[1])), new.shape[1])


def test_apply_migration_keeps_logits_and_streams(moe_servers):
    """Reversing the slot order re-slots the weights in place and swaps the
    tables: the prefill logits and every greedy stream stay the same bit
    for bit (a token's rows sit at the same positions of whichever slot
    hosts its expert)."""
    cfg, _, port = moe_servers
    srv = port(enable_placement=False)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (1, 9)).astype(np.int32))
    w1 = srv.params["layers"][1]["moe_w1"]
    before = srv.lm.prefill(srv.params, toks, max_len=64,
                            tables=srv.tables)[1]
    e0 = int(srv.tables["slot_expert"][0, 0])
    canon = w1[0, 0].clone()
    srv._apply_migration(_reversed_plan(srv))
    assert srv.n_migrations == 1
    assert srv.params["layers"][1]["moe_w1"] is w1           # in place
    assert int(srv.tables["slot_expert"][0, -1]) == e0
    assert torch.equal(w1[0, -1], canon)
    assert srv.decodes[0].tables is srv.tables is srv.prefills[0].tables
    after = srv.lm.prefill(srv.params, toks, max_len=64,
                           tables=srv.tables)[1]
    assert torch.equal(before, after)

    prompts = _workload(cfg.vocab_size)

    def drive(srv, migrate_at):
        for p in prompts:
            srv.add_request(p, TSamplingParams(max_tokens=6))
        out, steps = {}, 0
        while srv.proxy.inflight:
            for o in srv.step():
                out.setdefault(o.rid, []).extend(o.new_tokens)
            steps += 1
            if steps == migrate_at:
                srv._apply_migration(_reversed_plan(srv))
        return out
    plain = drive(port(), None)
    moved_srv = port()
    moved = drive(moved_srv, 6)
    assert moved_srv.n_migrations == 1
    assert moved == plain and len(moved) == len(prompts)
    moved_srv.kv_arena.pool.check_invariants(arena=moved_srv.kv_arena)


def test_placement_cfg_override_drives_scheduled_migrations(moe_servers):
    """`placement_cfg` replaces the scheduler's defaults. A trigger below
    the one-rank imbalance of 1.0 and a negative margin make every tick
    accept its candidate, so the scheduler's own plans run through
    `_apply_migration` at every tick: history, migration log and greedy
    streams equal the JAX Server's under the same override."""
    cfg, jsrv0, port = moe_servers
    s = int(jsrv0.tables["slot_expert"].shape[1])
    over = dict(b_trigger=0.5, delta=-1.0, budget=0, max_slots=s)
    jsrv = Server(cfg, ServerConfig(
        **SCFG, oas=OASConfig(defer_window=0.0),
        placement_cfg=jpl.SchedulerConfig(**over)),
        mesh=jsrv0.lm.mesh, pattern=[0, 0],
        params=jax.tree.map(jnp.copy, jsrv0.params))   # migrations donate
    tsrv = port(placement_cfg=tpl.SchedulerConfig(**over))
    prompts = _workload(cfg.vocab_size)
    js = jsrv.run([(p, SamplingParams(max_tokens=6)) for p in prompts],
                  max_wall_s=600)
    ts = tsrv.run([(p, TSamplingParams(max_tokens=6)) for p in prompts],
                  max_wall_s=600)
    jout = {r.rid: tuple(r.output_tokens) for r in jsrv.metrics.done}
    tout = {r.rid: tuple(r.output_tokens) for r in tsrv.metrics.done}
    assert len(tout) == len(prompts) and tout == jout
    hist = tsrv.placement_sched.history
    assert hist == jsrv.placement_sched.history
    assert len(hist) >= 2 and all(h["rebalanced"] for h in hist)
    assert ts["n_migrations"] == js["n_migrations"] == len(hist)
    assert ts["migration_log"] == js["migration_log"]
    np.testing.assert_array_equal(tsrv.tables["slot_expert"].numpy(),
                                  np.asarray(jsrv.tables["slot_expert"]))
    tsrv.kv_arena.pool.check_invariants(arena=tsrv.kv_arena)


def test_speculation_with_moe_layers_raises(moe_servers):
    """Speculation with MoE layers, once refused, now serves as the
    reference serves it: on the reference's weights the port's spec server
    gives the JAX spec server's streams, draft counts and drained expert
    counts at every monitor tick (a verify step routes and counts every
    window row of a live slot, rejected drafts included), and its greedy
    streams equal spec off."""
    from repro.serving.spec import SpecConfig
    from repro_torch.serving.spec import SpecConfig as TSpecConfig
    cfg = moe_servers[0]
    tcfg = t_reduced_config("qwen2-moe-a2.7b").with_updates(
        compute_dtype="float32", param_dtype="float32")
    mesh = MeshCtx(jax.make_mesh((1, 1), ("data", "model"),
                                 axis_types=(AxisType.Auto,) * 2))
    jsrv = Server(cfg, ServerConfig(**SCFG, spec=SpecConfig(k=2),
                                    oas=OASConfig(defer_window=0.0)),
                  mesh=mesh, pattern=[0, 0])
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jsrv.params),
                                       tcfg, jsrv.lm.plan, device="cpu")
    rng = np.random.default_rng(3)
    gram = tuple(int(t) for t in rng.integers(0, 64, 5))
    prompts = [gram * 5, tuple(int(t) for t in rng.integers(0, 512, 9)),
               gram * 3 + (7,)]
    js = jsrv.run([(p, SamplingParams(max_tokens=10)) for p in prompts],
                  max_wall_s=600)
    outs = {}
    for name, spec in (("on", TSpecConfig(k=2)), ("off", None)):
        tsrv = TServer(tcfg, TServerConfig(**SCFG, spec=spec, oas=TOASConfig(
            defer_window=0.0)), pattern=[0, 0], params=tparams, device="cpu")
        s = tsrv.run([(p, TSamplingParams(max_tokens=10)) for p in prompts],
                     max_wall_s=600)
        outs[name] = ({r.rid: tuple(r.output_tokens)
                       for r in tsrv.metrics.done}, s, tsrv)
    tout, ts, tsrv = outs["on"]
    jout = {r.rid: tuple(r.output_tokens) for r in jsrv.metrics.done}
    assert len(tout) == len(prompts) and tout == jout == outs["off"][0]
    for key in ("spec_drafted", "spec_accepted", "spec_verifies"):
        assert ts[key] == js[key], key
    assert ts["spec_accepted"] > 0
    jw, tw = _window(jsrv), _window(tsrv)
    assert len(tw) == len(jw) >= 1
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tsrv.decodes[0].take_moe_counts(),
                                  jsrv.decodes[0].take_moe_counts())
    ds = ts["decode_stats"][0]
    assert ds["host_fetches"] == ds["steps"] > 0
    tsrv.kv_arena.pool.check_invariants(arena=tsrv.kv_arena)
