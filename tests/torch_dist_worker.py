"""The rank side of tests/test_torch_distributed.py: one process of a
(tp 2, ep 2) gloo world on the CPU. It imports neither jax nor the JAX
package (a spawned rank starts a fresh interpreter), runs every case of the
test module in one world and writes this rank's results to
`<out>/rank<r>.pt`; the test process compares them with the JAX
references and the one-rank port."""
from __future__ import annotations

import traceback
from dataclasses import replace
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

TP, EP = 2, 2
WORLD = TP * EP
TIMEOUT = timedelta(seconds=60)
MOE_T = 48                       # moe_ffn rows (24 per rank when split)


def moe_cfg(**kw):
    from repro_torch.configs import reduced_config
    return reduced_config("qwen2-moe-a2.7b").with_updates(
        compute_dtype="float32", param_dtype="float32", **kw)


def dense_cfg():
    from repro_torch.configs import reduced_config
    return reduced_config("qwen2-1.5b").with_updates(
        compute_dtype="float32", param_dtype="float32")


def ffn_inputs(cfg, seed=5, T=MOE_T):
    """Seeded numpy inputs of one moe_ffn call: x, router, canonical expert
    weights [E, ...], the shared experts and a token mask."""
    rng = np.random.default_rng(seed)
    E, Fe, D = cfg.moe.n_experts, cfg.moe.d_ff_expert, cfg.d_model
    x = rng.standard_normal((T, D)).astype(np.float32)
    rw = (rng.standard_normal((D, E)) * 0.1).astype(np.float32)
    cw = [(rng.standard_normal(shp) * 0.05).astype(np.float32)
          for shp in ((E, D, Fe), (E, D, Fe), (E, Fe, D))]
    Fsh = cfg.moe.n_shared_experts * Fe
    sh = [(rng.standard_normal(shp) * 0.05).astype(np.float32)
          for shp in ((D, Fsh), (D, Fsh), (Fsh, D))]
    mask = rng.random(T) < 0.7
    return x, rw, cw, sh, mask


def parity_requests(vocab, n=4, seed=11, max_tokens=8):
    """tests/test_mesh_parity.py's request mix: a shared 12-token prefix on
    every other request."""
    rng = np.random.default_rng(seed)
    base = tuple(rng.integers(0, vocab, 12).tolist())
    reqs = []
    for i in range(n):
        if i % 2 == 0:
            p = base + tuple(rng.integers(0, vocab, 5 + i).tolist())
        else:
            length = int(rng.integers(8, 24))
            p = tuple(rng.integers(0, vocab, length).tolist())
        reqs.append((p, max_tokens))
    return reqs


def preempt_requests(vocab):
    rng = np.random.default_rng(23)
    return [(tuple(rng.integers(0, vocab, 14).tolist()), 8) for _ in range(2)]


# the server cases of tests/test_mesh_parity.py: (ServerConfig kwargs,
# requests); "placement" switches the aggressive DynamicScheduler on
SERVER_CASES = {
    "bs8": (dict(max_len=96, kv_block_size=8, chunk_tokens=16), "parity"),
    "bs16": (dict(max_len=96, kv_block_size=16, chunk_tokens=16), "parity"),
    "preempt": (dict(max_len=96, kv_block_size=8, kv_blocks=5), "preempt"),
    "migrate": (dict(max_len=128, kv_block_size=8, placement_interval=2,
                     placement=True), "migrate"),
}


def case_requests(kind, vocab):
    if kind == "parity":
        return parity_requests(vocab)
    if kind == "preempt":
        return preempt_requests(vocab)
    return parity_requests(vocab, n=4, seed=5, max_tokens=24)


def server_config(case, port: bool, placement_on: bool = True):
    """The ServerConfig of a case, the port's (port=True) or the JAX
    reference's."""
    kw, _ = SERVER_CASES[case]
    kw = dict(kw)
    enable = kw.pop("placement", False) and placement_on
    if port:
        from repro_torch.core.placement import SchedulerConfig
        from repro_torch.core.proxy import OASConfig
        from repro_torch.serving import ServerConfig
    else:
        from repro.core.placement import SchedulerConfig
        from repro.core.proxy import OASConfig
        from repro.serving import ServerConfig
    pcfg = SchedulerConfig(b_trigger=1.01, delta=0.0, window=2,
                           ema_alpha=1.0, budget=0) if enable else None
    return ServerConfig(n_prefill=1, n_decode=1, decode_slots=4,
                        enable_placement=enable, placement_cfg=pcfg,
                        oas=OASConfig(defer_window=0.0), **kw)


def top2_margin(cfg, params, prompt, stream, i, pattern=None) -> float:
    """The one-rank port's top-2 logit margin at stream position i: a
    whole-prompt prefill of prompt + stream[:i] on the CPU."""
    from repro_torch.models.lm import LM
    lm = LM.build(cfg, pattern=pattern, device="cpu")
    ctx = list(prompt) + list(stream[:i])
    with torch.no_grad():
        _, logits, _ = lm.prefill(params, torch.tensor([ctx]),
                                  max_len=len(ctx) + 1,
                                  tables=lm.default_tables())
    top = torch.topk(logits[0].float(), 2).values
    return float(top[0] - top[1])


def first_diff(a, b) -> int:
    """The first position where token lists a and b differ (the shorter
    length where one is a prefix of the other)."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def assert_streams(got: dict, want: dict, what: str, margin=None):
    """Equal streams {rid: tokens}, or an AssertionError naming the first
    differing token and, with `margin` (rid, i → float), the one-rank
    model's top-2 logit margin there."""
    assert got.keys() == want.keys(), (what, sorted(got), sorted(want))
    for rid in sorted(want):
        a, b = got[rid], want[rid]
        if a == b:
            continue
        i = first_diff(a, b)
        m = f" (one-rank top-2 logit margin there {margin(rid, i):.3g})" \
            if margin is not None and i < len(b) else ""
        raise AssertionError(f"{what}: request {rid} differs from the "
                             f"reference at token {i}{m}: {a} vs {b}")


# ---- the rank side ----------------------------------------------------
def _slots(ctx, cfg, cw):
    """This rank's slot weights [1, s, ...] (expert width cut over
    `model`) from canonical [E, ...] weights, by the round-robin tables
    over ctx.ep."""
    from repro_torch.models import moe as tmoe
    s = tmoe.default_slot_count(cfg, ctx.ep)
    se = tmoe.tables_from_placement(
        tmoe.round_robin_placement(cfg.moe.n_experts, ctx.ep, s),
        s)["slot_expert"]
    out = []
    for i, c in enumerate(cw):
        w = tmoe.slots_from_canonical(torch.from_numpy(c), se[ctx.e][None])
        dim = 3 if i < 2 else 2
        n = w.shape[dim] // ctx.tp
        out.append(w.narrow(dim, ctx.t * n, n).contiguous())
    return out


def _shared(ctx, sh):
    n = sh[0].shape[1] // ctx.tp
    a, b, c = (torch.from_numpy(x) for x in sh)
    return (a[:, ctx.t * n:(ctx.t + 1) * n].contiguous(),
            b[:, ctx.t * n:(ctx.t + 1) * n].contiguous(),
            c[ctx.t * n:(ctx.t + 1) * n].contiguous())


def run_moe(ctx, ctx12):
    """moe_ffn over (tp 1, ep 2) and (tp 2, ep 2), int8 transport off and
    on, the batch split over `data` or not."""
    from repro_torch.models import moe as tmoe
    out = {}
    for cf in (8.0, 0.5):
        cfg = moe_cfg()
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=cf))
        x, rw, cw, sh, mask = ffn_inputs(cfg)
        tables = None
        for name, c in (("tp1ep2", ctx12), ("tp2ep2", ctx)):
            s = tmoe.default_slot_count(cfg, c.ep)
            tables = tmoe.tables_from_placement(
                tmoe.round_robin_placement(cfg.moe.n_experts, c.ep, s), s)
            w = _slots(c, cfg, cw)
            for int8 in (False, True):
                ccfg = replace(cfg, moe_dispatch_int8=int8)
                for split in (False, True):
                    y, cnt = tmoe.moe_ffn(
                        ccfg, torch.from_numpy(x), torch.from_numpy(rw), *w,
                        tables, _shared(c, sh),
                        token_mask=torch.from_numpy(mask), ctx=c,
                        shard_tokens=split)
                    out[(cf, name, int8, split)] = (y, cnt)
    return out


def run_tp_parts(ctx, inputs):
    """The TP attention and FFN sublayers, the embedding and the head of a
    reduced qwen2-1.5b, and whole-prompt logits of it and of qwen2-moe."""
    from repro_torch.models import stack as tstack
    from repro_torch.models.lm import LM
    from repro_torch.serving import DevicePlacement
    out = {}
    pl = DevicePlacement(torch.device("cpu"), ctx=ctx)
    cfg = dense_cfg()
    lm = LM.build(cfg, pattern=[0] * cfg.n_layers, device="cpu", ctx=ctx)
    p = pl.place_params(inputs["dense_params"], lm)
    x = inputs["dense_x"]
    spec = lm.plan.all_specs()[0]
    lay = p["layers"][0]
    pos = torch.arange(x.shape[1])
    out["attn"] = tstack.attn_sublayer(cfg, spec, lay, x, mode="prefill",
                                       positions=pos, cache=None, max_len=32,
                                       ctx=ctx)[0]
    out["ffn"] = tstack.ffn_sublayer(cfg, spec, lay, x, ctx=ctx)[0]
    toks = inputs["dense_tokens"]
    out["embed"] = lm._embed(p, toks)
    out["head"] = lm._logits(p, x)
    out["dense_prefill"] = lm.prefill(p, toks, max_len=32)[1]
    mcfg = moe_cfg()
    mlm = LM.build(mcfg, pattern=[0, 0], device="cpu", ctx=ctx)
    mp = pl.transfer_params(mlm.one_rank(), inputs["moe_params"], mlm)
    _, logits, aux = mlm.prefill(mp, toks, max_len=32,
                                 tables=mlm.default_tables())
    out["moe_prefill"] = (logits, aux["moe_counts"])
    out["moe_shard"] = mp
    return out


# the server cases whose Server takes the one-rank parameters themselves
# (it carries them into the rank's part); the others take this rank's part
ONE_RANK_PARAMS = ("bs16", "preempt")


def run_servers(ctx, inputs):
    from repro_torch.models.lm import LM
    from repro_torch.serving import DevicePlacement, Server
    cfg = moe_cfg()
    out = {}
    for case, (_, kind) in SERVER_CASES.items():
        pl = DevicePlacement(torch.device("cpu"), ctx=ctx)
        lm = LM.build(cfg, pattern=[0, 0], device="cpu", ctx=ctx)
        shard = pl.transfer_params(lm.one_rank(), inputs["moe_params"], lm)
        params = inputs["moe_params"] if case in ONE_RANK_PARAMS else shard
        srv = Server(cfg, server_config(case, port=True), pattern=[0, 0],
                     params=params, placement=pl)
        # the parameters the server holds are this rank's part either way
        same = all(torch.equal(a, b) for a, b in zip(
            _leaves(srv.params), _leaves(shard)))
        s = srv.run(case_requests(kind, cfg.vocab_size), max_wall_s=120)
        for eng in srv.decodes:
            eng.pool.check_invariants(arena=srv.kv_arena)
            assert eng.stats["host_fetches"] == eng.stats["steps"]
        srv.kv_arena.pool.check_invariants(arena=srv.kv_arena)
        out[case] = {
            "n_done": s["n_done"],
            "streams": {r.rid: tuple(r.output_tokens)
                        for r in srv.metrics.done},
            "preemptions": s["decode_stats"][0]["preemptions"],
            "n_migrations": s["n_migrations"],
            "migration_log": s["migration_log"],
            "migration_stats": dict(srv.migration_stats),
            "slot_expert": srv.tables["slot_expert"].clone(),
            "params_are_shard": same}
    return out


def _leaves(tree: dict) -> list:
    return [v for k, v in sorted(tree.items()) if k != "layers"] + \
        [v for lay in tree["layers"] for _, v in sorted(lay.items())]


def child(rank: int, store_path: str, in_path: str, out_dir: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD, timeout=TIMEOUT)
    res = {}
    try:
        from repro_torch.distributed import RankCtx
        ctx = RankCtx.build(TP, EP, check_lockstep=True)
        # (tp 1, ep 2): the two ranks that share t form its data group
        ctx12 = RankCtx(ep=EP, tp=1, rank=ctx.e, backend=ctx.backend,
                        data_group=ctx.data_group)
        inputs = torch.load(in_path, weights_only=False)
        res["moe"] = run_moe(ctx, ctx12)
        res["tp"] = run_tp_parts(ctx, inputs)
        res["servers"] = run_servers(ctx, inputs)
    except BaseException:
        res["error"] = traceback.format_exc()
        raise
    finally:
        torch.save(res, f"{out_dir}/rank{rank}.pt")
        dist.destroy_process_group()


# ---- tests/test_torch_distributed_omniattn.py: OmniAttn over ranks -------
# the reference's mesh-parity cases at the default pattern (pattern None:
# reduced qwen2-moe's two layers are both sink 4 + recent 16 rings, and
# whole prompts prefill because prefill_sparse is off), chunks over the
# rings (prefill_sparse on), the slot-dense layout, and online top-k over
# two full layers: name → (ServerConfig case or kwargs, requests, pattern,
# config updates)
TOPK_SCFG = dict(max_len=128, kv_block_size=8, chunk_tokens=16,
                 prefill_tick_budget=32, kv_blocks=60)
TOPK_KNOBS = dict(topk_blocks=3, topk_measure_mass=True)
OMNI_CASES = {
    "bs8": ("bs8", "parity", None, {}),
    "bs16": ("bs16", "parity", None, {}),
    "preempt": ("preempt", "preempt", None, {}),
    "migrate": ("migrate", "migrate", None, {}),
    "sparse": ("bs8", "parity", None, dict(prefill_sparse=True)),
    "dense": (dict(max_len=96, kv_block_size=8, chunk_tokens=16,
                   paged_kv=False), "parity", None, {}),
    "topk": (TOPK_SCFG, "topk", [0, 0], {"omniattn": TOPK_KNOBS}),
}
G3_SCFG = dict(max_len=96, kv_block_size=8, chunk_tokens=16)
# _select_blocks' unit case: B slots over nb blocks of SEL_BS tokens, the
# reduced qwen2-moe's H 4 query / K 2 KV heads (one KV head a rank at tp 2)
SEL_B, SEL_NB, SEL_BS = 3, 10, 8


def omni_cfg(case):
    """The port's config of an OmniAttn case."""
    upd = dict(OMNI_CASES[case][3])
    knobs = upd.pop("omniattn", None)
    cfg = moe_cfg(**upd)
    if knobs:
        cfg = cfg.with_updates(omniattn=replace(cfg.omniattn, **knobs))
    return cfg


def g3_cfg():
    from repro_torch.configs import reduced_config
    return reduced_config("gemma3-4b").with_updates(
        compute_dtype="float32", param_dtype="float32")


def topk_requests(vocab):
    """Four prompts of 33-90 tokens: up to 13 resident blocks of 8 against
    a budget of 3."""
    rng = np.random.default_rng(11)
    return [(tuple(int(x) for x in rng.integers(0, vocab, n)), 8)
            for n in (50, 70, 33, 90)]


def g3_requests(vocab):
    """Prompts past reduced gemma3's 32-token windows and 20-token rings."""
    rng = np.random.default_rng(61)
    return [(tuple(int(x) for x in rng.integers(0, vocab, n)), 10)
            for n in (40, 48, 21, 57)]


def omni_requests(kind, vocab):
    if kind == "topk":
        return topk_requests(vocab)
    return case_requests(kind, vocab)


def omni_server_config(case, port: bool, placement_on: bool = True):
    scase = OMNI_CASES[case][0]
    if isinstance(scase, str):
        return server_config(scase, port, placement_on)
    return server_config_kw(scase, port)


def server_config_kw(kw, port: bool):
    if port:
        from repro_torch.core.proxy import OASConfig
        from repro_torch.serving import ServerConfig
    else:
        from repro.core.proxy import OASConfig
        from repro.serving import ServerConfig
    return ServerConfig(n_prefill=1, n_decode=1, decode_slots=4,
                        enable_placement=False, oas=OASConfig(
                            defer_window=0.0), **kw)


def select_inputs(seed=3):
    """Seeded inputs of one top-k decode step over one paged layer: q
    [B, H, h], the block summaries kmin/kmax [N, K, h], tables and lens,
    with the first KV head's queries scaled down so that each rank, ranking
    its own heads alone, keeps other blocks than the max over all heads."""
    cfg = moe_cfg()
    H, K, h = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rng = np.random.default_rng(seed)
    N = SEL_B * SEL_NB + 1
    q = rng.standard_normal((SEL_B, H, h)).astype(np.float32)
    q[:, :H // K] *= 0.25
    lo = rng.standard_normal((N, K, h)).astype(np.float32)
    hi = lo + np.abs(rng.standard_normal((N, K, h))).astype(np.float32)
    tables = (1 + np.arange(SEL_B * SEL_NB)).reshape(SEL_B, SEL_NB)
    lens = np.array([SEL_NB * SEL_BS, SEL_NB * SEL_BS - 3, 5 * SEL_BS + 1])
    return {"q": torch.from_numpy(q), "kmin": torch.from_numpy(lo),
            "kmax": torch.from_numpy(hi),
            "tables": torch.from_numpy(tables.astype(np.int32)),
            "lens": torch.from_numpy(lens.astype(np.int32)),
            "mask": torch.tensor([True, True, False])}


def run_select(cfg, ins, t: int = 0, tp: int = 1, ctx=None):
    """`stack._select_blocks` on the heads of `model` rank t of tp (all of
    them at tp 1) → (table, lens, aux) on the CPU; `ctx` None ranks that
    rank's own scores alone."""
    from repro_torch.models import stack as tstack
    H, K, h = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    hq, hk = H // tp, K // tp
    N = ins["kmin"].shape[0]
    cache = {"k": torch.zeros((N, hk, SEL_BS, h)),
             "kmin": ins["kmin"][:, t * hk:(t + 1) * hk].contiguous(),
             "kmax": ins["kmax"][:, t * hk:(t + 1) * hk].contiguous()}
    q = ins["q"][:, t * hq:(t + 1) * hq].contiguous()
    scfg = cfg.with_updates(omniattn=replace(cfg.omniattn, topk_blocks=4))
    tbl, lens, aux = tstack._select_blocks(scfg, q, cache, ins["tables"],
                                           ins["lens"], ins["mask"], ctx)
    return tbl, lens, aux


class PairCtx:
    """(tp 2, ep 1) inside the (tp 2, ep 2) world: the two ranks that share
    e serve a dense model as a world of their own. The server's world
    collectives (the round's clock, the lockstep digest) run over their
    `model` group."""

    @staticmethod
    def of(ctx):
        from repro_torch.distributed import RankCtx

        class _Pair(RankCtx):
            def broadcast_floats(self, values):
                t = torch.tensor(values, dtype=torch.float64)
                dist.broadcast(t, src=dist.get_global_rank(
                    self.model_group, 0), group=self.model_group)
                return t.tolist()

            def all_gather_ints(self, values):
                t = torch.tensor(values, dtype=torch.int64)
                parts = [torch.empty_like(t) for _ in range(self.world)]
                dist.all_gather(parts, t, group=self.model_group)
                return [p.tolist() for p in parts]

        return _Pair(ep=1, tp=ctx.tp, rank=ctx.t, backend=ctx.backend,
                     model_group=ctx.model_group, check_lockstep=True)


def _ring_leaves(srv) -> list:
    """Every ring-layer leaf of the decode engines' private caches."""
    return [t for eng in srv.decodes for e in eng.cache["layers"]
            if e is not None for t in e.values()]


def _serve(srv, reqs, spy_migration=False) -> dict:
    kept = []
    if spy_migration:
        # a migration moves expert rows, never ring KV
        orig = srv._apply_migration

        def spied(plan):
            before = [t.clone() for t in _ring_leaves(srv)]
            out = orig(plan)
            kept.append(all(torch.equal(a, b) for a, b in zip(
                before, _ring_leaves(srv))) and len(before) > 0)
            return out
        srv._apply_migration = spied
    s = srv.run(reqs, max_wall_s=120)
    for eng in srv.decodes:
        eng.pool.check_invariants(arena=srv.kv_arena)
        assert eng.stats["host_fetches"] == eng.stats["steps"]
    if srv.kv_arena is not None:
        srv.kv_arena.pool.check_invariants(arena=srv.kv_arena)
    ds = s["decode_stats"][0]
    return {"n_done": s["n_done"],
            "streams": {r.rid: tuple(r.output_tokens)
                        for r in srv.metrics.done},
            "preemptions": ds["preemptions"],
            "n_migrations": s["n_migrations"],
            "migration_bytes": srv.migration_stats["bytes"],
            "ring_kept": kept,
            "prefill_chunked": srv.prefills[0].chunked,
            "sparsity": {k: s[k] for k in ("blocks_scored", "blocks_attended",
                                           "attn_mass_kept") if k in s}}


def run_omni_servers(ctx, inputs):
    from repro_torch.serving import DevicePlacement, Server
    out = {}
    cpu = torch.device("cpu")
    for case, (_, kind, pattern, _) in OMNI_CASES.items():
        cfg = omni_cfg(case)
        srv = Server(cfg, omni_server_config(case, port=True),
                     pattern=pattern, params=inputs["moe_params"],
                     placement=DevicePlacement(cpu, ctx=ctx))
        out[case] = _serve(srv, omni_requests(kind, cfg.vocab_size),
                           spy_migration=case == "migrate")
    pair = PairCtx.of(ctx)
    cfg = g3_cfg()
    srv = Server(cfg, server_config_kw(G3_SCFG, port=True),
                 params=inputs["g3_params"],
                 placement=DevicePlacement(cpu, ctx=pair))
    out["gemma3"] = _serve(srv, g3_requests(cfg.vocab_size))
    return out


def omni_child(rank: int, store_path: str, in_path: str, out_dir: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD, timeout=TIMEOUT)
    res = {}
    try:
        from repro_torch.distributed import RankCtx
        ctx = RankCtx.build(TP, EP, check_lockstep=True)
        inputs = torch.load(in_path, weights_only=False)
        cfg = moe_cfg()
        res["select"] = run_select(cfg, inputs["select"], ctx.t, TP, ctx)
        res["select_local"] = run_select(cfg, inputs["select"], ctx.t, TP)
        res["servers"] = run_omni_servers(ctx, inputs)
    except BaseException:
        res["error"] = traceback.format_exc()
        raise
    finally:
        torch.save(res, f"{out_dir}/omni_rank{rank}.pt")
        dist.destroy_process_group()


# ---- tests/test_torch_distributed_layouts.py: every layout over ranks --
# name → (arch, config updates, pattern, ServerConfig kwargs, requests):
# reduced granite-34b (H 4 over K 1: 'wseq', two query heads a rank over
# the one KV head) at its default pattern (both layers rings) whole-prompt
# and in chunks, at [0, 1] (a shared arena holds the one head) and with a
# top-k budget of 3 blocks; reduced qwen2-1.5b at H 3 over K 1 (the
# replicated sublayer); reduced mamba2-130m on a shared-prefix mix, once
# with a pool cut until it preempts; reduced jamba cut to one period at its
# default pattern (Mamba-2 at tp 2, MoE over ep 2, attention under 'kv')
PARITY_SCFG = dict(max_len=96, kv_block_size=8, chunk_tokens=16)
SSM_SCFG = dict(max_len=96, chunk_tokens=16, prefill_tick_budget=32,
                kv_blocks=40, kv_block_size=8)
LAYOUT_CASES = {
    "granite_whole": ("granite-34b", {}, None, PARITY_SCFG, "parity"),
    "granite_chunks": ("granite-34b", dict(prefill_sparse=True), None,
                       PARITY_SCFG, "parity"),
    "granite_arena": ("granite-34b", dict(prefill_sparse=True), [0, 1],
                      PARITY_SCFG, "parity"),
    "granite_topk": ("granite-34b", {"omniattn": TOPK_KNOBS}, [0, 0],
                     TOPK_SCFG, "topk"),
    "qwen2_h3": ("qwen2-1.5b", dict(n_heads=3, n_kv_heads=1,
                                    prefill_sparse=True), [0, 1],
                 PARITY_SCFG, "parity"),
    "mamba2": ("mamba2-130m", {}, None, SSM_SCFG, "ssm"),
    "mamba2_preempt": ("mamba2-130m", {}, None, dict(SSM_SCFG, kv_blocks=12),
                       "ssm"),
    "jamba": ("jamba-1.5-large-398b", dict(n_layers=8), None, PARITY_SCFG,
              "short"),
}
# the cases whose reference is another case's (the same model, weights and
# requests: a pool cut until it preempts gives the free pool's streams)
LAYOUT_REF = {"mamba2_preempt": "mamba2"}


def layout_cfg(case, port: bool = True):
    """The case's reduced config (the port's, or the reference's with
    `port` False), float32."""
    if port:
        from repro_torch.configs import reduced_config
    else:
        from repro.configs import reduced_config
    arch, upd, _, _, _ = LAYOUT_CASES[case]
    upd = dict(upd)
    knobs = upd.pop("omniattn", None)
    cfg = reduced_config(arch).with_updates(
        compute_dtype="float32", param_dtype="float32", **upd)
    if knobs:
        cfg = cfg.with_updates(omniattn=replace(cfg.omniattn, **knobs))
    return cfg


def ssm_requests(vocab, n=5, prefix=40, new=12):
    """Two of three prompts on a `prefix`-token shared prefix plus 8
    distinct tokens, the rest 6 tokens (tests/test_torch_ssm_serving.py's
    mix)."""
    rng = np.random.default_rng(29)
    base = tuple(int(t) for t in rng.integers(0, vocab, prefix))
    return [(base + tuple(int(t) for t in rng.integers(0, vocab, 8))
             if i % 3 != 2 else
             tuple(int(t) for t in rng.integers(0, vocab, 6)), new)
            for i in range(n)]


def layout_requests(kind, vocab):
    if kind == "ssm":
        return ssm_requests(vocab)
    if kind == "short":
        # four prompts in one 16-token prefill bucket
        rng = np.random.default_rng(37)
        return [(tuple(int(t) for t in rng.integers(0, vocab, n)), 6)
                for n in (13, 16, 15, 11)]
    return omni_requests(kind, vocab)


def layout_server_config(case, port: bool):
    return server_config_kw(LAYOUT_CASES[case][3], port)


# the cases whose weights the test process bridges after the world starts
# (the reference's init of jamba takes longest): the last cases served
LAYOUT_LATE = ("jamba",)


def wait_load(path: str, limit_s: float = 120.0):
    """torch.load of a file another process writes (its writer renames it
    into place when complete), waiting at most `limit_s`."""
    import os
    import time
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > limit_s:
            raise TimeoutError(f"{path} did not appear in {limit_s} s")
        time.sleep(0.1)
    return torch.load(path, weights_only=False)


def run_layout_servers(ctx, inputs, late_path):
    from repro_torch.serving import DevicePlacement, Server
    out = {}
    cpu = torch.device("cpu")
    params = dict(inputs["params"])
    for case, (_, _, pattern, _, kind) in LAYOUT_CASES.items():
        if case not in params:
            params.update(wait_load(late_path)["params"])
        cfg = layout_cfg(case)
        srv = Server(cfg, layout_server_config(case, port=True),
                     pattern=pattern, params=params[case],
                     placement=DevicePlacement(cpu, ctx=ctx))
        out[case] = _serve(srv, layout_requests(kind, cfg.vocab_size))
        out[case]["private_shapes"] = {
            n: tuple(t.shape) for e in srv.decodes[0].cache["layers"]
            if e is not None for n, t in e.items()}
    return out


def layout_child(rank: int, store_path: str, in_path: str, out_dir: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD, timeout=TIMEOUT)
    res = {}
    try:
        from repro_torch.distributed import RankCtx
        ctx = RankCtx.build(TP, EP, check_lockstep=True)
        inputs = torch.load(in_path, weights_only=False)
        res["servers"] = run_layout_servers(ctx, inputs, in_path + ".late")
    except BaseException:
        res["error"] = traceback.format_exc()
        raise
    finally:
        torch.save(res, f"{out_dir}/layout_rank{rank}.pt")
        dist.destroy_process_group()


# ---- tests/test_torch_distributed_planes.py: QuantPlane and SpecPlane ---
# name → (arch, config updates, pattern, ServerConfig kwargs, requests,
# planes, world): reduced qwen2-moe-a2.7b over (tp 2, ep 2) with every
# layer full, int8 arenas ("q"), speculation at k 4 ("s") and both, one
# int8 case with a pool cut until it preempts, speculation over the
# default pattern's rings (prefilled in chunks: a verify window over a
# compressed layer needs `prefill_sparse`, as in the reference); reduced
# granite-34b under 'wseq' served by each pair of ranks that shares e
# ("pair"), int8 at [0, 0] and speculation at [0, 1]
PLANES_SCFG = dict(max_len=96, kv_block_size=16, chunk_tokens=16)
SPARSE = dict(prefill_sparse=True)
PLANES_CASES = {
    "quant": ("qwen2-moe-a2.7b", {}, [0, 0], PLANES_SCFG, "parity", "q",
              "world"),
    "quant_preempt": ("qwen2-moe-a2.7b", {}, [0, 0],
                      SERVER_CASES["preempt"][0], "preempt", "q", "world"),
    "spec": ("qwen2-moe-a2.7b", {}, [0, 0], PLANES_SCFG, "spec", "s",
             "world"),
    "both": ("qwen2-moe-a2.7b", {}, [0, 0], PLANES_SCFG, "spec", "qs",
             "world"),
    "ring_spec": ("qwen2-moe-a2.7b", SPARSE, None, PLANES_SCFG, "spec", "s",
                  "world"),
    "granite_quant": ("granite-34b", {}, [0, 0], PLANES_SCFG, "parity", "q",
                      "pair"),
    "granite_spec": ("granite-34b", SPARSE, [0, 1], PLANES_SCFG, "spec",
                     "s", "pair"),
}
SPEC_K = 4


def planes_cfg(case, port: bool = True):
    """The case's reduced config, float32 (the reference's with `port`
    False)."""
    if port:
        from repro_torch.configs import reduced_config
    else:
        from repro.configs import reduced_config
    arch, upd = PLANES_CASES[case][:2]
    return reduced_config(arch).with_updates(
        compute_dtype="float32", param_dtype="float32", **upd)


def spec_requests(vocab, port: bool = True):
    """Three greedy prompts that draft (a seeded 6-token phrase four times,
    16 new tokens each), one seeded sampled request (temperature 0.8, a
    12-token prompt, 8 tokens), then the first prompt again: it waits for a
    slot and drafts from the suffix table its finished twin fed."""
    if port:
        from repro_torch.core.proxy import SamplingParams
    else:
        from repro.core.proxy import SamplingParams
    rng = np.random.default_rng(41)
    phrases = [tuple(int(t) for t in rng.integers(0, vocab, 6)) * 4
               for _ in range(3)]
    sampled = tuple(int(t) for t in rng.integers(0, vocab, 12))
    greedy = SamplingParams(max_tokens=16)
    return [(phrases[0], greedy), (phrases[1], greedy), (phrases[2], greedy),
            (sampled, SamplingParams(temperature=0.8, seed=907,
                                     max_tokens=8)),
            (phrases[0], greedy)]


def planes_requests(case, vocab, port: bool = True):
    kind = PLANES_CASES[case][4]
    if kind == "spec":
        return spec_requests(vocab, port)
    return case_requests(kind, vocab)


def planes_server_config(case, port: bool):
    """The case's ServerConfig with its planes, the port's or the
    reference's."""
    planes = PLANES_CASES[case][5]
    if port:
        from repro_torch.serving.quant import QuantConfig
        from repro_torch.serving.spec import SpecConfig
    else:
        from repro.serving.quant import QuantConfig
        from repro.serving.spec import SpecConfig
    scfg = server_config_kw(PLANES_CASES[case][3], port)
    return replace(scfg, quant=QuantConfig() if "q" in planes else None,
                   spec=SpecConfig(k=SPEC_K) if "s" in planes else None)


def serve_planes(case, params, placement) -> dict:
    """Serve a case on `placement` (one rank or this rank's) → streams,
    the spec counters (the metrics' and the decode engine's drained
    stats), the quant figures, the capacity cut's drops and the checks
    every rank runs: pool invariants, one host fetch a decode step."""
    from repro_torch.models import moe as tmoe
    from repro_torch.serving import Server
    cfg = planes_cfg(case)
    srv = Server(cfg, planes_server_config(case, port=True),
                 pattern=PLANES_CASES[case][2], params=params,
                 placement=placement)
    drops = tmoe.drop_tally(placement.device)
    drops.zero_()
    s = srv.run(planes_requests(case, cfg.vocab_size), max_wall_s=120)
    for eng in srv.decodes:
        eng.pool.check_invariants(arena=srv.kv_arena)
        assert eng.stats["host_fetches"] == eng.stats["steps"] > 0
    srv.kv_arena.pool.check_invariants(arena=srv.kv_arena)
    ds = s["decode_stats"][0]
    keys = ("spec_drafted", "spec_accepted", "spec_emitted",
            "spec_verifies", "quant_layers", "quant_block_bytes",
            "quant_block_bytes_f32", "preemptions")
    return {"n_done": s["n_done"],
            "streams": {r.rid: tuple(r.output_tokens)
                        for r in srv.metrics.done},
            "summary": {k: s[k] for k in ("spec_drafted", "spec_accepted",
                                          "spec_verifies") if k in s},
            "decode_stats": {k: ds[k] for k in keys if k in ds},
            "arena_heads": [tuple(e["k"].shape) for e in srv.kv_arena.kv
                            if e is not None],
            "arena_int8": [e["k"].dtype == torch.int8
                           for e in srv.kv_arena.kv if e is not None],
            # what one arena block pins across the full layers: its payload
            # and, on int8 arenas, its scale plane
            "block_bytes": sum(t[0].numel() * t.element_size()
                               for e in srv.kv_arena.kv if e is not None
                               for n, t in e.items()
                               if n in ("k", "v", "kscale", "vscale",
                                        "ktok", "vtok")),
            "drops": float(drops)}


def run_planes_servers(ctx, inputs):
    from repro_torch.serving import DevicePlacement
    cpu = torch.device("cpu")
    pair = PairCtx.of(ctx)
    out = {}
    for case, (*_, world) in PLANES_CASES.items():
        c = ctx if world == "world" else pair
        out[case] = serve_planes(case, inputs["params"][case],
                                 DevicePlacement(cpu, ctx=c))
    return out


def planes_child(rank: int, store_path: str, in_path: str, out_dir: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD, timeout=TIMEOUT)
    res = {}
    try:
        from repro_torch.distributed import RankCtx
        ctx = RankCtx.build(TP, EP, check_lockstep=True)
        inputs = torch.load(in_path, weights_only=False)
        res["servers"] = run_planes_servers(ctx, inputs)
    except BaseException:
        res["error"] = traceback.format_exc()
        raise
    finally:
        torch.save(res, f"{out_dir}/planes_rank{rank}.pt")
        dist.destroy_process_group()


# ---- tests/test_torch_distributed_faults.py: FaultPlane over ranks -----
# tests/test_torch_faults.py's soak server (two prefill and two decode
# instances, so that kills can fire; the watchdog on; ten retries) and its
# workloads, served over (tp 2, ep 2) fault-free and under chaos; every MoE
# layer at a capacity factor where no bucket drops an assignment (a
# restart changes which rows share a capacity cut, ROADMAP C5): name →
# (arch, config updates, requests, planes, chaos seeds). Every attention
# layer is full; jamba is cut to one period (Mamba-2 at tp 2, MoE over ep
# 2, attention under 'kv')
FAULT_SOAK = dict(n_prefill=2, n_decode=2, decode_slots=4, max_len=128,
                  chunk_tokens=32, prefill_tick_budget=64, kv_blocks=96,
                  watchdog_steps=200)
FAULT_CF = 16.0
FAULT_HORIZON = 20
FAULT_CASES = {
    "moe": ("qwen2-moe-a2.7b", {}, "soak", "", (1,)),
    "moe_int8": ("qwen2-moe-a2.7b", {}, "soak", "q", (1,)),
    "moe_spec": ("qwen2-moe-a2.7b", {}, "spec", "s", (1,)),
    "jamba": ("jamba-1.5-large-398b", dict(n_layers=8), "soak", "", (1,)),
}
# the rank whose KV heads alone carry the corruption of the one-rank case
CORRUPT_RANK = 3


def faults_cfg(case, port: bool = True):
    """The case's reduced config, float32, at FAULT_CF (the reference's with
    `port` False)."""
    if port:
        from repro_torch.configs import reduced_config
    else:
        from repro.configs import reduced_config
    arch, upd = FAULT_CASES[case][:2]
    return reduced_config(arch).with_updates(
        compute_dtype="float32", param_dtype="float32",
        moe_capacity_factor=FAULT_CF, **upd)


def soak_requests(vocab):
    """tests/test_torch_faults.py's soak workload: 8 prompts of 24 tokens,
    12 new each."""
    rng = np.random.default_rng(42)
    return [(tuple(int(t) for t in rng.integers(0, vocab, 24)), 12)
            for _ in range(8)]


def soak_spec_requests(vocab):
    """tests/test_torch_faults.py's speculation soak workload: four prompts
    of one repeated 6-token phrase, four random ones."""
    rng = np.random.default_rng(7)
    gram = tuple(int(t) for t in rng.integers(0, vocab, 6))
    return [(gram * 3, 12) for _ in range(4)] + \
        [(tuple(int(t) for t in rng.integers(0, vocab, 24)), 12)
         for _ in range(4)]


def faults_requests(case, vocab):
    return (soak_spec_requests if FAULT_CASES[case][2] == "spec"
            else soak_requests)(vocab)


def faults_server_config(case, port: bool):
    """The case's soak ServerConfig with its planes, the port's or the
    reference's."""
    if port:
        from repro_torch.core.proxy import OASConfig
        from repro_torch.serving import ServerConfig
        from repro_torch.serving.quant import QuantConfig
        from repro_torch.serving.spec import SpecConfig
    else:
        from repro.core.proxy import OASConfig
        from repro.serving import ServerConfig
        from repro.serving.quant import QuantConfig
        from repro.serving.spec import SpecConfig
    planes = FAULT_CASES[case][3]
    return ServerConfig(**FAULT_SOAK, oas=OASConfig(defer_window=0.0,
                                                    max_retries=10),
                        quant=QuantConfig() if "q" in planes else None,
                        spec=SpecConfig(k=SPEC_K) if "s" in planes else None)


def faults_server(case, params, placement, plane=None):
    from repro_torch.serving import Server
    cfg = faults_cfg(case)
    return Server(cfg, faults_server_config(case, port=True),
                  pattern=[0] * cfg.n_layers, params=params,
                  placement=placement, faults=plane)


def drive_soak(srv, reqs, before_step=None, max_steps=3000) -> dict:
    """Submit every request at rank 0's clock and step() until quiescent
    (every rank sees the same in-flight set, so every rank steps alike);
    `before_step(srv, step)` runs ahead of each step. → streams, streamed
    deltas, finish records, steps."""
    import time
    t0 = srv.ctx.broadcast_floats([time.monotonic()])[0]
    for p, m in reqs:
        srv.add_request(p, _sampling(m), now=t0)
    deltas: dict = {}
    finishes: dict = {}
    steps = 0
    while srv.proxy.inflight and steps < max_steps:
        if before_step is not None:
            before_step(srv, steps)
        for out in srv.step():
            deltas.setdefault(out.rid, []).extend(out.new_tokens)
            if out.finished:
                finishes[out.rid] = (out.finish_reason, out.n_generated)
        steps += 1
    assert not srv.proxy.inflight, f"not quiescent after {steps} steps"
    return {"streams": {r.rid: tuple(r.output_tokens)
                        for r in srv.metrics.done},
            "deltas": {r: tuple(d) for r, d in deltas.items()},
            "finishes": finishes, "steps": steps}


def _sampling(m):
    from repro_torch.core.proxy import SamplingParams
    return SamplingParams(max_tokens=int(m))


def check_quiescent(srv):
    """One host fetch a decode step, the pool invariants, and no block
    mapping left but the prefix stores'."""
    for eng in srv.decodes:
        assert eng.stats["host_fetches"] == eng.stats["steps"], eng.stats
    pool = srv.kv_arena.pool
    pool.check_invariants(arena=srv.kv_arena)
    left = [k for k in pool.per_request
            if not (isinstance(k, tuple) and k[0] == "store")]
    assert not left, f"pool keys left at quiescence: {left}"


def fault_run(case, params, placement, seed=None) -> dict:
    """One soak of `case` on `placement` (one rank, or this rank of a
    world): fault-free, or under FaultPlane(FaultConfig(seed,
    FAULT_HORIZON)) → streams, deltas, the plane's record, the recovery
    figures, the capacity cut's drops and the host ms of each
    recover_corruption."""
    import time

    from repro_torch.models import moe as tmoe
    from repro_torch.serving import FaultConfig, FaultPlane
    plane = None if seed is None else FaultPlane(
        FaultConfig(seed=seed, horizon=FAULT_HORIZON))
    srv = faults_server(case, params, placement, plane)
    recover, recover_ms = srv.recover_corruption, []

    def timed(now=None):
        t = time.perf_counter()
        got = recover(now)
        recover_ms.append(1e3 * (time.perf_counter() - t))
        return got
    srv.recover_corruption = timed
    drops = tmoe.drop_tally(placement.device)
    drops.zero_()
    rec = drive_soak(srv, faults_requests(case, srv.cfg.vocab_size))
    check_quiescent(srv)
    s = srv.metrics.summary(1.0)
    rec.update({
        "n_errors": s["n_errors"], "n_timeouts": s["n_timeouts"],
        "n_retries": s["n_retries"],
        "blocks_quarantined": s["blocks_quarantined"],
        "quarantined": sorted(srv.kv_arena.pool.quarantined),
        "handoffs_swept": srv.n_handoffs_swept,
        "preemptions": sum(e.stats["preemptions"] for e in srv.decodes),
        "drops": float(drops), "recover_ms": recover_ms,
        "fired": None if plane is None else list(plane.fired),
        "injected": None if plane is None else dict(plane.injected),
        "skipped": None if plane is None else dict(plane.skipped)})
    return rec


def corrupt_on_one_rank(params, placement) -> dict:
    """Case "moe" driven by add_request / step: at the first step where a
    decode slot holds a request, the first arena block of the lowest such
    rid is corrupted on rank CORRUPT_RANK's KV heads only
    (`faults.corrupt_block` on that rank's arena), then every rank calls
    `recover_corruption` at the same step. → the block, each rank's own
    scan before the recovery, what the recovery condemned, whether the
    block left circulation and was scrubbed on this rank, and the run's
    streams."""
    from repro_torch.serving.faults import corrupt_block
    srv = faults_server("moe", params, placement)
    pool, ctx = srv.kv_arena.pool, srv.ctx
    out: dict = {}

    def before_step(srv, step):
        if "block" in out:
            return
        resident = sorted(r for e in srv.decodes for r in e.rid_slot
                          if pool.owned(r))
        if not resident:
            return
        b = pool.owned(resident[0])[0]
        if ctx.rank == CORRUPT_RANK:
            corrupt_block(srv.kv_arena, b, offset=0.75)
        out["block"], out["at_step"] = b, step
        out["local_scan"] = srv.kv_arena.find_corrupt_blocks()
        out["condemned"] = srv.recover_corruption()
        out["left_circulation"] = b in pool.quarantined and \
            b not in pool.refcount
        out["scrubbed"] = all(not t[b].any() for e in srv.kv_arena.kv
                              if e is not None for t in e.values())
    rec = drive_soak(srv, soak_requests(srv.cfg.vocab_size), before_step)
    check_quiescent(srv)
    out.update(streams=rec["streams"], deltas=rec["deltas"],
               quarantined=sorted(pool.quarantined),
               blocks_quarantined=srv.metrics.blocks_quarantined,
               n_retries=srv.metrics.summary(1.0)["n_retries"])
    return out


def pmax_world_check(ctx) -> dict:
    """`RankCtx.pmax_world` on a bool, an int64 and a float32 tensor whose
    values differ by rank."""
    flags = torch.zeros(WORLD + 1, dtype=torch.bool)
    flags[ctx.rank] = True
    ints = torch.tensor([ctx.rank, -ctx.rank, 7], dtype=torch.int64)
    floats = torch.tensor([0.5 * ctx.rank, -1.0])
    return {"bool": ctx.pmax_world(flags), "int": ctx.pmax_world(ints),
            "float": ctx.pmax_world(floats)}


def faults_child(rank: int, store_path: str, in_path: str, out_dir: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD, timeout=TIMEOUT)
    res = {}
    try:
        from repro_torch.distributed import RankCtx
        from repro_torch.serving import DevicePlacement
        ctx = RankCtx.build(TP, EP, check_lockstep=True)
        inputs = torch.load(in_path, weights_only=False)
        cpu = torch.device("cpu")
        res["pmax_world"] = pmax_world_check(ctx)
        for case, (arch, *_, seeds) in FAULT_CASES.items():
            params = inputs["params"][arch]
            res[case] = {seed: fault_run(case, params,
                                         DevicePlacement(cpu, ctx=ctx), seed)
                         for seed in (None,) + seeds}
        res["corrupt_one_rank"] = corrupt_on_one_rank(
            inputs["params"]["qwen2-moe-a2.7b"], DevicePlacement(cpu, ctx=ctx))
    except BaseException:
        res["error"] = traceback.format_exc()
        raise
    finally:
        torch.save(res, f"{out_dir}/faults_rank{rank}.pt")
        dist.destroy_process_group()
