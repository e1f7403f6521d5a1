"""Multi-rank placement of the PyTorch port against the JAX reference, on
the CPU: one (tp 2, ep 2) world of four gloo ranks (`torch.multiprocessing`
spawn, a FileStore under tmp_path; the rank side is tests/
torch_dist_worker.py) runs every case once, while this process builds the
JAX references on the same bridged inputs.

- `moe_ffn` at (tp 1, ep 2) and (tp 2, ep 2), the batch split over `data`
  or not, against the JAX `moe_ffn` and the one-rank port; with
  `moe_dispatch_int8` against its quantized-transport oracle;
- the TP attention and FFN sublayers, embedding, head and whole-prompt
  logits against one rank;
- `transfer_params` round trips, and `place_params` carrying one-rank
  parameters into a rank's part (or refusing a tree that is neither);
- tests/test_mesh_parity.py's three cases on reduced qwen2-moe-a2.7b with
  every attention layer full (`pattern=[0, 0]`; the default pattern's ring
  layers and online top-k over ranks are
  tests/test_torch_distributed_omniattn.py's), each four-rank greedy
  stream equal to the JAX one-device
  `Server`'s, `KVPool.check_invariants` on every rank, and the lockstep
  digest checked every round; two of them hand the Server the one-rank
  parameters themselves;
- what ROADMAP A16b item 4 once refused, held on a fake (tp 2, ep 2)
  rank: the restore template (`LM.shapes()`, the `param_cuts` lengths),
  `init_state`'s rank-local moments and a meta train loss on the dry
  backend (training itself runs in tests/test_torch_train_ranks.py;
  what a rank cannot lay out is none: tests/test_torch_distributed_layouts.py
  builds and serves every layout; the planes are none either: QuantPlane,
  SpecPlane and FaultPlane build here over a fake rank and serve in
  tests/test_torch_distributed_planes.py and _faults.py).

The JAX references run on an Auto-axis mesh (its MoE decode needs one on
this jax; ROADMAP C1). Every process group has a 60 s timeout and the
world joins within WORLD_LIMIT_S, so a hang fails the tests instead of
running out the suite's clock."""
import time
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import AxisType

import torch_dist_worker as W
from repro.configs import reduced_config
from repro.distributed.ctx import MeshCtx
from repro.models import LM
from repro.models import moe as jmoe
from repro.serving import Server
from repro_torch import bridge
from repro_torch.distributed import RankCtx
from repro_torch.models import moe as tmoe
from repro_torch.models import stack as tstack
from repro_torch.models.lm import LM as TLM
from repro_torch.serving import DevicePlacement
from repro_torch.serving import Server as TServer

torch.set_num_threads(2)

WORLD_LIMIT_S = 150
TOL = dict(rtol=1e-5, atol=1e-5)
# f32 logits through two stacks summing in different orders
# (tests/test_consistency.py:40)
LOGIT_TOL = dict(rtol=2e-3, atol=2e-3)


def auto_mesh():
    return MeshCtx(jax.make_mesh((1, 1), ("data", "model"),
                                 axis_types=(AxisType.Auto,) * 2))


def jax_moe_cfg(**kw):
    return reduced_config("qwen2-moe-a2.7b").with_updates(
        compute_dtype="float32", param_dtype="float32", **kw)


def _jax_moe(cfg, x, rw, cw, sh, mask):
    """The JAX moe_ffn on one device (round-robin slots, the token mask)."""
    s = jmoe.default_slot_count(cfg, 1)
    jt = jmoe.tables_from_placement(
        jmoe.round_robin_placement(cfg.moe.n_experts, 1, s), s)
    slots = [jmoe.slots_from_canonical(jnp.asarray(c), jt["slot_expert"])
             for c in cw]
    y, c = jmoe.moe_ffn(auto_mesh(), cfg, jnp.asarray(x), jnp.asarray(rw),
                        *slots, jt, tuple(jnp.asarray(a) for a in sh),
                        batch_part="data", token_mask=jnp.asarray(mask))
    return np.asarray(y), np.asarray(c)


def _port_moe_one_rank(tcfg, x, rw, cw, sh, mask):
    s = tmoe.default_slot_count(tcfg, 1)
    tt = tmoe.tables_from_placement(
        tmoe.round_robin_placement(tcfg.moe.n_experts, 1, s), s)
    slots = [tmoe.slots_from_canonical(torch.from_numpy(c),
                                       tt["slot_expert"]) for c in cw]
    y, c = tmoe.moe_ffn(tcfg, torch.from_numpy(x), torch.from_numpy(rw),
                        *slots, tt, tuple(torch.from_numpy(a) for a in sh),
                        token_mask=torch.from_numpy(mask))
    return y.numpy(), c.numpy()


def _jax_streams(cfg, jparams, case):
    _, kind = W.SERVER_CASES[case]
    # the preemption case's reference runs with a free pool, the migration
    # case's with placement off (tests/test_mesh_parity.py)
    scfg = W.server_config(case, port=False, placement_on=False)
    if case == "preempt":
        scfg = replace(scfg, kv_blocks=None)
    srv = Server(cfg, scfg, mesh=auto_mesh(), pattern=[0, 0],
                 params=jax.tree.map(jnp.copy, jparams))
    s = srv.run(W.case_requests(kind, cfg.vocab_size), max_wall_s=300)
    assert s["n_done"] == len(W.case_requests(kind, cfg.vocab_size))
    return {r.rid: tuple(r.output_tokens) for r in srv.metrics.done}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("world")
    cfg = jax_moe_cfg()
    tcfg = W.moe_cfg()
    jlm = LM.build(cfg, auto_mesh(), pattern=[0, 0])
    jparams = jlm.init(jax.random.PRNGKey(0))
    tone = TLM.build(tcfg, pattern=[0, 0], device="cpu")
    moe_params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                          tcfg, tone.plan, device="cpu")
    dcfg = W.dense_cfg()
    dense = TLM.build(dcfg, pattern=[0] * dcfg.n_layers, device="cpu")
    g = torch.Generator().manual_seed(4)
    inputs = {"moe_params": moe_params, "dense_params": dense.init(seed=3),
              "dense_x": torch.randn((1, 12, dcfg.d_model), generator=g),
              "dense_tokens": torch.randint(0, dcfg.vocab_size, (1, 12),
                                            generator=g)}
    torch.save(inputs, d / "inputs.pt")
    t0 = time.monotonic()
    procs = mp.start_processes(
        W.child, args=(str(d / "store"), str(d / "inputs.pt"), str(d)),
        nprocs=W.WORLD, join=False, start_method="spawn")
    # the JAX references, while the ranks run
    refs = {"servers": {c: _jax_streams(cfg, jparams, c)
                        for c in W.SERVER_CASES}}
    for cf in (8.0, 0.5):
        jc = replace(cfg, moe=replace(cfg.moe, capacity_factor=cf))
        tc = replace(tcfg, moe=replace(tcfg.moe, capacity_factor=cf))
        ins = W.ffn_inputs(tc)
        refs[("jax", cf)] = _jax_moe(jc, *ins)
        refs[("port", cf)] = _port_moe_one_rank(tc, *ins)
    try:
        while not procs.join(timeout=max(1.0, WORLD_LIMIT_S
                                         - (time.monotonic() - t0))):
            if time.monotonic() - t0 > WORLD_LIMIT_S:
                raise TimeoutError(f"the world did not finish within "
                                   f"{WORLD_LIMIT_S} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(W.WORLD)]
    for r, res in enumerate(ranks):
        assert "error" not in res, f"rank {r}: {res['error']}"
    return {"ranks": ranks, "refs": refs, "inputs": inputs, "tcfg": tcfg}


def _all_ranks_equal(world, get):
    """The value every rank computed (they are identical: replicated
    outputs over TP and EP)."""
    vals = [get(res) for res in world["ranks"]]
    for v in vals[1:]:
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, vals[0])
        else:
            assert v == vals[0]
    return vals[0]


# ---- moe_ffn over ranks ------------------------------------------------
@pytest.mark.parametrize("cf,layout,split", [
    (8.0, "tp1ep2", False), (8.0, "tp1ep2", True), (8.0, "tp2ep2", False),
    (8.0, "tp2ep2", True),
    # drops: replicated rows fill each (rank, slot) bucket as one rank's
    # slot fills, so the drops equal the one-device run's
    (0.5, "tp1ep2", False), (0.5, "tp2ep2", False)])
def test_moe_ffn_over_ranks_matches_reference(world, cf, layout, split):
    y = _all_ranks_equal(world, lambda r: r["moe"][(cf, layout, False,
                                                    split)][0])
    _, cnt = world["ranks"][0]["moe"][(cf, layout, False, split)]
    jy, jc = world["refs"][("jax", cf)]
    py, pc = world["refs"][("port", cf)]
    np.testing.assert_allclose(y.numpy(), jy, **TOL)
    np.testing.assert_allclose(y.numpy(), py, **TOL)
    np.testing.assert_array_equal(cnt.numpy(), jc)
    np.testing.assert_array_equal(cnt.numpy(), pc)


def _q(v):
    """Per-row int8 quantize-dequantize of the dispatch transport."""
    scale = np.maximum(np.abs(v).max(-1, keepdims=True) / np.float32(127),
                       np.float32(1e-9)).astype(np.float32)
    return (np.clip(np.round(v / scale), -127, 127) * scale).astype(
        np.float32)


def _int8_oracle(tcfg, x, rw, cw, sh, mask, tp=1):
    """moe_ffn with every dispatched row quantized per row and every
    returned expert row too — at tp > 1 each `model` rank's partial row
    over its Fe / tp columns, quantized before the psum sums them (no
    drops at capacity factor 8): the transport's function."""
    gates, eidx, _ = tmoe.router(tcfg, torch.from_numpy(x),
                                 torch.from_numpy(rw))
    gates, eidx = gates.numpy(), eidx.numpy()
    silu = lambda z: z / (1 + np.exp(-z))
    Fp = cw[0].shape[2] // tp
    y = np.zeros_like(x)
    for t in range(x.shape[0]):
        xq = _q(x[t:t + 1])
        for j in range(eidx.shape[1]):
            e = eidx[t, j]
            for r in range(tp):
                c = slice(r * Fp, (r + 1) * Fp)
                o = (silu(xq @ cw[0][e][:, c]) * (xq @ cw[1][e][:, c])) \
                    @ cw[2][e][c]
                y[t] += gates[t, j] * _q(o)[0]
    y += ((silu(x @ sh[0]) * (x @ sh[1])) @ sh[2])
    return y


@pytest.mark.parametrize("layout", ["tp1ep2", "tp2ep2"])
@pytest.mark.parametrize("split", [False, True])
def test_moe_ffn_int8_transport(world, layout, split):
    """cfg.moe_dispatch_int8: rows cross `data` as int8 with a max-abs
    scale each. The output is the quantized transport's oracle: at tp 2
    the returned rows are the `model` ranks' partial sums, each quantized
    before the psum. The counts never change."""
    tcfg = world["tcfg"]
    y, cnt = world["ranks"][0]["moe"][(8.0, layout, True, split)]
    y = y.numpy()
    jy, jc = world["refs"][("jax", 8.0)]
    np.testing.assert_array_equal(cnt.numpy(), jc)
    assert np.abs(y - jy).max() > 0          # the transport quantized
    ins = W.ffn_inputs(tcfg)
    tp = {"tp1ep2": 1, "tp2ep2": W.TP}[layout]
    np.testing.assert_allclose(y, _int8_oracle(tcfg, *ins, tp=tp), **TOL)


# ---- tensor parallelism ------------------------------------------------
def _one_rank_parts(world):
    from repro_torch.models.lm import LM as OneLM
    inputs = world["inputs"]
    cfg = W.dense_cfg()
    lm = OneLM.build(cfg, pattern=[0] * cfg.n_layers, device="cpu")
    p = inputs["dense_params"]
    x, toks = inputs["dense_x"], inputs["dense_tokens"]
    spec, lay = lm.plan.all_specs()[0], p["layers"][0]
    out = {"attn": tstack.attn_sublayer(cfg, spec, lay, x, mode="prefill",
                                        positions=torch.arange(x.shape[1]),
                                        cache=None, max_len=32)[0],
           "ffn": tstack.ffn_sublayer(cfg, spec, lay, x)[0],
           "embed": lm._embed(p, toks), "head": lm._logits(p, x),
           "dense_prefill": lm.prefill(p, toks, max_len=32)[1]}
    mlm = OneLM.build(W.moe_cfg(), pattern=[0, 0], device="cpu")
    _, logits, aux = mlm.prefill(inputs["moe_params"], toks, max_len=32,
                                 tables=mlm.default_tables())
    out["moe_prefill"] = (logits, aux["moe_counts"])
    return out


@pytest.mark.parametrize("part", ["attn", "ffn", "embed", "head",
                                  "dense_prefill", "moe_prefill"])
def test_tp_parts_match_one_rank(world, part):
    """Column-parallel q/k/v and w1/w3 with row-parallel wo / w2 and a psum
    over `model`, the masked vocabulary-sharded lookup, the gathered
    vocabulary-sharded head: each equals one rank's (the embedding
    exactly, one rank adds each row and the others zeros)."""
    got = _all_ranks_equal(world, lambda r: r["tp"][part]
                           if part != "moe_prefill"
                           else r["tp"][part][0])
    want = _one_rank_parts(world)[part]
    if part == "moe_prefill":
        want_logits, want_counts = want
        _, counts = world["ranks"][0]["tp"][part]
        for a, b in zip(counts, want_counts):
            assert torch.equal(a, b)
        want = want_logits
    if part == "embed":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, **LOGIT_TOL)


def test_transfer_params_round_trip(world):
    """One-rank parameters → each rank's (tp 2, ep 2) shard → the four
    shards put back together (the [ep, s, ...] slot layout) → one rank
    again: bit for bit the parameters we started from."""
    tcfg = world["tcfg"]
    src = world["inputs"]["moe_params"]
    shards = [r["tp"]["moe_shard"] for r in world["ranks"]]
    wide = TLM(tcfg, TLM.build(tcfg, pattern=[0, 0], device="cpu").plan,
               torch.device("cpu"), RankCtx(ep=W.EP, tp=W.TP))
    specs = wide.param_specs()

    def whole(leaves, spec):
        """Leaves of the ranks in rank order → the whole leaf."""
        grid = [[leaves[e * W.TP + t] for t in range(W.TP)]
                for e in range(W.EP)]
        rows = []
        for row in grid:
            d = spec.index("model") if "model" in spec else None
            rows.append(torch.cat(row, d) if d is not None else row[0])
        d = spec.index("data") if "data" in spec else None
        return torch.cat(rows, d) if d is not None else rows[0]

    tree = {k: whole([s[k] for s in shards], specs[k]) for k in src
            if k != "layers"}
    tree["layers"] = [{k: whole([s["layers"][i][k] for s in shards],
                                specs["layers"][i][k]) for k in lay}
                      for i, lay in enumerate(src["layers"])]
    assert tree["layers"][0]["moe_w1"].shape[:2] == (
        W.EP, tmoe.default_slot_count(tcfg, W.EP))
    one = TLM.build(tcfg, pattern=[0, 0], device="cpu")
    back = DevicePlacement.of("cpu").transfer_params(wide, tree, one)
    for k in src:
        if k != "layers":
            assert torch.equal(back[k], src[k]), k
    for a, b in zip(back["layers"], src["layers"]):
        for k in b:
            assert torch.equal(a[k], b[k]), k


# ---- tests/test_mesh_parity.py over four gloo ranks ------------------
def _server(world, case):
    return _all_ranks_equal(world, lambda r: r["servers"][case]["streams"]), \
        world["ranks"][0]["servers"][case]


def _assert_jax_streams(world, case, streams):
    """The case's streams equal the JAX Server's; a mismatch names the
    first differing token and the one-rank port's top-2 logit margin
    there."""
    want = world["refs"]["servers"][case]
    reqs = W.case_requests(W.SERVER_CASES[case][1], world["tcfg"].vocab_size)
    W.assert_streams(streams, want, case, lambda rid, i: W.top2_margin(
        world["tcfg"], world["inputs"]["moe_params"], reqs[rid][0],
        want[rid], i, [0, 0]))


@pytest.mark.parametrize("case", ["bs8", "bs16"])
def test_greedy_parity_with_jax_server(world, case):
    """Chunked prefill with prefix reuse at block sizes 8 and 16: the
    (tp 2, ep 2) greedy streams equal the JAX one-device Server's."""
    streams, rec = _server(world, case)
    assert rec["n_done"] == 4
    _assert_jax_streams(world, case, streams)
    assert all(len(v) == 8 for v in streams.values())


def test_server_carries_one_rank_params(world):
    """`Server(params=<one-rank bridged parameters>, placement=(tp 2, ep
    2))`: place_params carries them into each rank's part — bit for bit
    what transfer_params gives — and the streams equal the JAX one-device
    Server's (cases bs16 and preempt)."""
    for case in W.ONE_RANK_PARAMS:
        for res in world["ranks"]:
            assert res["servers"][case]["params_are_shard"], case
        streams, _ = _server(world, case)
        _assert_jax_streams(world, case, streams)


def test_parity_under_forced_preemption(world):
    """A five-block pool forces preemption and re-admission mid-stream;
    the four ranks recover to the JAX Server's tokens with a free pool."""
    streams, rec = _server(world, "preempt")
    assert rec["preemptions"] >= 1
    _assert_jax_streams(world, "preempt", streams)


def test_live_migration_parity_mid_decode(world):
    """An aggressive DynamicScheduler migrates experts between the two EP
    ranks while decode slots are live; the streams equal the never-
    migrating JAX one-device Server's, every logged migration lowered the
    imbalance, and the moved rows are counted."""
    streams, rec = _server(world, "migrate")
    assert rec["n_migrations"] >= 1, \
        "scheduler never migrated — skew/trigger config no longer fires"
    _assert_jax_streams(world, "migrate", streams)
    for entry in rec["migration_log"]:
        assert entry["b_after"] < entry["b_before"]
    assert rec["migration_stats"]["bytes"] > 0
    se = rec["slot_expert"]
    assert sorted(x for x in se.flatten().tolist() if x >= 0) == \
        list(range(world["tcfg"].moe.n_experts))


# ---- what this slice refuses (ROADMAP A16b) ----------------------------
def _fake(tp=2, ep=2):
    return RankCtx(ep=ep, tp=tp)


def _refused(case):
    from repro_torch.serving import ServerConfig
    from repro_torch.serving.faults import FaultPlane
    from repro_torch.serving.quant import QuantConfig
    from repro_torch.serving.spec import SpecConfig
    from repro_torch.training.trainer import init_state
    moe = W.moe_cfg()
    cpu = torch.device("cpu")
    if case in ("quant", "spec", "both", "faults"):
        kw = {"quant": dict(quant=QuantConfig()),
              "spec": dict(spec=SpecConfig(k=2)),
              "both": dict(quant=QuantConfig(),
                           spec=SpecConfig(k=2))}.get(case, {})
        faults = FaultPlane() if case == "faults" else None
        return lambda: TServer(moe, ServerConfig(**kw), pattern=[0, 0],
                               faults=faults, placement=DevicePlacement(
                                   cpu, ctx=_fake()))
    lm = TLM(moe, TLM.build(moe, pattern=[0, 0], device="cpu").plan, cpu,
             _fake())
    if case == "train":
        dry = TLM(moe, lm.plan, torch.device("meta"), RankCtx.dry(2, 2, 0))
        batch = {k: torch.empty((4, 8), dtype=torch.long, device="meta")
                 for k in ("tokens", "labels")}
        return lambda: dry.train_loss(dry.shapes(), batch,
                                      tables=dry.default_tables())[0]
    if case == "opt_specs":
        return lambda: (lm, init_state(lm))
    return lambda: lm       # a sharded checkpoint restore's template


@pytest.mark.parametrize("case", ["train", "opt_specs", "restore"])
def test_a16b_refusals(case):
    """ROADMAP A16b item 4's refusals are gone: on a fake (tp 2, ep 2)
    rank a train loss traces on the dry backend to a 0-d meta loss,
    `init_state` gives the rank's parts with moments of their shapes (the
    reference's `opt_specs`), and `LM.shapes()` gives the `param_cuts`
    lengths."""
    from repro_torch.serving.placement import _flat, _shapes
    from repro_torch.tree import tree_leaves
    got = _refused(case)()
    if case == "train":
        assert got.device.type == "meta" and got.shape == ()
        return
    if case == "opt_specs":
        lm, st = got
        local = _shapes(lm, local=True)
        assert {k: tuple(v.shape) for k, v in _flat(st.params).items()} \
            == local
        for name in ("m", "v"):
            assert {k: tuple(v.shape) for k, v in
                    _flat(st.opt[name]).items()} == local
        assert int(st.opt["step"]) == 0
        assert all(float(m.abs().max()) == 0
                   for m in tree_leaves(st.opt["m"]))
        return
    shapes = {k: tuple(v.shape) for k, v in _flat(got.shapes()).items()}
    assert shapes == _shapes(got, local=True)
    assert shapes != _shapes(got.one_rank())
    assert all(v.device.type == "meta" for v in tree_leaves(got.shapes()))


@pytest.mark.parametrize("case", ["quant", "spec", "both", "faults"])
def test_planes_build_over_ranks(case):
    """QuantPlane, SpecPlane (alone and together) and FaultPlane build over
    a fake (tp 2, ep 2) rank (they raised A16b before): int8 arenas of the
    rank's one KV head of two, a verify entry on the decode engine, the
    plane on the server; tests/test_torch_distributed_planes.py and
    tests/test_torch_distributed_faults.py serve them over four ranks."""
    srv = _refused(case)()
    assert srv.ctx.world == 4
    eng = srv.decodes[0]
    assert (eng.spec_ctl is not None) == (case in ("spec", "both"))
    assert (srv.faults is not None) == (case == "faults")
    arena = [e for e in srv.kv_arena.kv if e is not None]
    assert arena and all(e["k"].shape[1] == W.moe_cfg().n_kv_heads // 2
                         for e in arena)
    assert all((e["k"].dtype == torch.int8) == (case in ("quant", "both"))
               for e in arena)


@pytest.mark.parametrize("arch,upd,tp,kind", [
    ("qwen2-moe-a2.7b", {}, 2, "kv"),
    ("qwen2-moe-a2.7b", {}, 1, "kv"),
    ("granite-34b", {}, 2, "wseq"),
    ("qwen2-1.5b", dict(n_heads=3, n_kv_heads=1), 2, "replicated")])
def test_quant_figures_are_the_ranks(arch, upd, tp, kind):
    """QuantController's residency figures over ranks are one rank's: the
    KV heads `head_layout` gives the rank (K / tp under 'kv', the one head
    under 'wseq', every head replicated), equal to the bytes one block of
    that rank's int8 arenas pins; at tp 1 the whole model's."""
    from repro_torch.configs import reduced_config
    from repro_torch.serving import ServerConfig
    from repro_torch.serving.quant import QuantConfig, QuantController
    cfg = reduced_config(arch).with_updates(compute_dtype="float32",
                                            param_dtype="float32", **upd)
    lm = TLM.build(cfg, pattern=[0] * cfg.n_layers, device="cpu")
    one = QuantController.from_model(cfg, lm.plan, QuantConfig(), 16)
    got = QuantController.from_model(cfg, lm.plan, QuantConfig(), 16, tp=tp)
    hl = tstack.head_layout(cfg, tp)
    assert hl.kind == kind
    assert got.plan.payload_bytes_int8 * cfg.n_kv_heads == \
        one.plan.payload_bytes_int8 * hl.nk
    assert got.compression() == one.compression()
    srv = TServer(cfg, ServerConfig(quant=QuantConfig(), decode_slots=2,
                                    max_len=32, kv_blocks=4),
                  pattern=[0] * cfg.n_layers, placement=DevicePlacement(
                      torch.device("cpu"), ctx=_fake(tp=tp, ep=1)))
    st = srv.decodes[0].stats
    # one block's int8 payload and scale plane over the full layers
    pinned = sum(e[n][0].numel() * e[n].element_size()
                 for e in srv.kv_arena.kv if e is not None
                 for n in ("k", "v", "kscale", "vscale", "ktok", "vtok"))
    assert all(e["k"].shape[1] == hl.nk for e in srv.kv_arena.kv
               if e is not None)
    assert st["quant_block_bytes"] == pinned
    assert st["quant_block_bytes_f32"] * cfg.n_kv_heads == \
        one.plan.payload_bytes_f32 * one.plan.n_quant_layers * hl.nk


@pytest.mark.parametrize("where", ["device", "drained"])
def test_lockstep_digest_carries_spec_counters(where):
    """The round digest carries each decode engine's speculation counters,
    the device accumulator's [drafted, accepted, emitted, verifies] and
    the drained spec_* stats: a rank whose counters alone differ raises."""
    from repro_torch.serving import ServerConfig
    from repro_torch.serving.spec import SpecConfig

    class TwoRanks(RankCtx):
        other = None

        def all_gather_ints(self, values):
            # "rank 1" keeps the digest of the first round it saw
            if self.other is None:
                self.other = list(values)
            return [list(values), self.other]

    srv = TServer(W.moe_cfg(), ServerConfig(decode_slots=2, max_len=32,
                                            spec=SpecConfig(k=2)),
                  pattern=[0, 0], device="cpu")
    srv.ctx = TwoRanks(ep=2, check_lockstep=True)
    srv._check_lockstep()
    srv._check_lockstep()            # nothing moved: the digests agree
    eng = srv.decodes[0]
    if where == "device":
        eng.state["spec"][1] += 1
    else:
        eng.stats["spec_accepted"] += 1
    with pytest.raises(RuntimeError, match="diverged"):
        srv._check_lockstep()


def _recovery_moves():
    """What each recovery can change on one rank alone (the server's)."""
    def quarantine(srv):
        srv.kv_arena.pool.quarantine(3)

    def sweep(srv):
        srv.n_handoffs_swept += 1

    def health(srv):
        srv.proxy.mark_unhealthy("decode", 0, 0.0)

    def retry(srv):
        next(iter(srv.proxy.inflight.values())).n_retries += 1

    def plane(srv):
        srv.faults.skipped["kv_corrupt"] += 1
    return {"quarantined": quarantine, "swept": sweep, "healthy": health,
            "retries": retry, "plane": plane}


@pytest.mark.parametrize("what", list(_recovery_moves()))
def test_lockstep_digest_carries_recovery_state(what):
    """The round digest carries what FaultPlane's recovery changes: the
    quarantined blocks, the handoffs swept, every instance's health, each
    in-flight request's retries and the plane's injected / skipped
    counts. A rank whose recovery state alone differs raises in that
    round, not later at a collective."""
    from repro_torch.core.proxy import SamplingParams
    from repro_torch.serving import ServerConfig
    from repro_torch.serving.faults import FaultPlane

    class TwoRanks(RankCtx):
        other = None

        def all_gather_ints(self, values):
            # "rank 1" keeps the digest of the first round it saw
            if self.other is None:
                self.other = list(values)
            return [list(values), self.other]

    srv = TServer(W.moe_cfg(), ServerConfig(n_decode=2, decode_slots=2,
                                            max_len=32),
                  pattern=[0, 0], device="cpu", faults=FaultPlane())
    srv.add_request((1, 2, 3), SamplingParams(max_tokens=2))
    srv.ctx = TwoRanks(ep=2, check_lockstep=True)
    srv._check_lockstep()
    srv._check_lockstep()            # nothing moved: the digests agree
    _recovery_moves()[what](srv)
    with pytest.raises(RuntimeError, match="diverged"):
        srv._check_lockstep()


def test_lockstep_divergence_raises():
    """The round digest: a rank whose host state differs raises instead of
    hanging in the next collective."""
    from repro_torch.serving import ServerConfig

    class Split(RankCtx):
        def all_gather_ints(self, values):
            return [list(values), [values[0], values[1] + 1]]

    srv = TServer(W.moe_cfg(), ServerConfig(decode_slots=2, max_len=32),
                  pattern=[0, 0], device="cpu")
    srv.ctx = Split(ep=2, check_lockstep=True)
    with pytest.raises(RuntimeError, match="diverged"):
        srv._check_lockstep()


def test_build_needs_an_initialised_group():
    with pytest.raises(RuntimeError, match="process group"):
        DevicePlacement.build(tp=2, ep=2, device="cpu")


def test_specs_describe_the_rank_local_allocations():
    """What one (tp 2, ep 2) rank's engines allocate, as the reference's
    arena and slot-state specs lay it out under the 'kv' strategy
    (`stack.head_layout` decides it): K / tp KV heads in every block of
    the shared arena and in the prefill engine's dense cache, the decode
    slot state whole, and the transfer metering of K / tp heads a
    token."""
    from repro_torch.serving.arena import KVArena
    from repro_torch.serving.decode import DecodeEngine
    from repro_torch.serving.prefill import PrefillEngine
    cfg, cpu = W.moe_cfg(), torch.device("cpu")

    def engines(ctx):
        lm = TLM.build(cfg, pattern=[0, 0], device="cpu", ctx=ctx)
        pl = DevicePlacement(cpu, ctx=ctx)
        arena = KVArena.build(lm, 12, 8, placement=pl)
        return (DecodeEngine(lm, {}, 2, 32, arena=arena, placement=pl),
                PrefillEngine(lm, {}, 32, placement=pl))    # dense cache

    one, one_pf = engines(RankCtx.local())
    eng, pf = engines(_fake())
    K = cfg.n_kv_heads
    assert tstack.head_layout(cfg, 2).kind == "kv"
    assert tstack.head_layout(cfg, 2).nk == K // 2
    for whole, part in zip(one.arena.kv, eng.arena.kv):
        for name, t in whole.items():
            assert part[name].shape[0] == t.shape[0] == 13      # + null
            assert t.shape[1] == K and part[name].shape[1] == K // 2, name
            assert part[name].shape[2:] == t.shape[2:], name
    for whole, part in zip(one_pf._cache["layers"], pf._cache["layers"]):
        for name in ("k", "v"):
            assert whole[name].shape[2] == K
            assert part[name].shape == whole[name].shape[:2] + (K // 2,) \
                + whole[name].shape[3:]
    assert eng.state.keys() == one.state.keys()
    for name, t in one.state.items():
        assert eng.state[name].shape == t.shape, name
    assert eng._full_tok_nbytes * 2 == one._full_tok_nbytes


def _place_case(kind):
    """(the tree handed to place_params, what it must give or raise) for a
    fake (tp 2, ep 2) rank 3."""
    cfg = W.moe_cfg()
    ctx = RankCtx(ep=2, tp=2, rank=3)
    pl = DevicePlacement(torch.device("cpu"), ctx=ctx)
    lm = TLM.build(cfg, pattern=[0, 0], device="cpu", ctx=ctx)
    one = lm.one_rank()
    params = one.init(seed=7)
    shard = pl.transfer_params(one, params, lm)
    if kind == "one_rank":
        return pl, lm, params, shard
    if kind == "rank_part":
        return pl, lm, shard, shard
    if kind == "whole_slots":
        # the [ep, s, ...] slot layout of every rank: neither shape
        wide = TLM(cfg, lm.plan, torch.device("cpu"), RankCtx(ep=2, tp=1))
        tree = DevicePlacement(torch.device("cpu"), ctx=wide.ctx) \
            .transfer_params(one, params, wide)
        return pl, lm, tree, "moe_w1"
    bad = dict(params, layers=[dict(params["layers"][0]),
                               *params["layers"][1:]])
    if kind == "mixed":
        # one leaf at the rank's shape, the rest one-rank
        bad["layers"][0]["wq"] = shard["layers"][0]["wq"]
        return pl, lm, bad, "mixes one-rank and rank-local"
    bad["layers"][0]["wq"] = bad["layers"][0]["wq"][:, :-1]
    return pl, lm, bad, "layers.0.wq"


@pytest.mark.parametrize("kind", ["one_rank", "rank_part", "whole_slots",
                                  "bad_leaf", "mixed"])
def test_place_params_carries_one_rank_or_raises(kind):
    """Over several ranks place_params takes one-rank parameters (carried
    by transfer_params) or the rank's part; a tree at any other shape —
    the whole [ep, s, ...] slot layout, a mis-cut leaf, a mix of the two
    layouts — raises instead of reaching moe_ffn with the wrong slot
    count."""
    pl, lm, tree, want = _place_case(kind)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            pl.place_params(tree, lm)
        return
    got = pl.place_params(tree, lm)
    assert got.keys() == want.keys()
    for k in want:
        if k != "layers":
            assert torch.equal(got[k], want[k]), k
    for a, b in zip(got["layers"], want["layers"]):
        assert a.keys() == b.keys()
        for k in b:
            assert torch.equal(a[k], b[k]), k
    assert got["layers"][0]["moe_w1"].shape[:2] == (
        1, tmoe.default_slot_count(lm.cfg, 2))
