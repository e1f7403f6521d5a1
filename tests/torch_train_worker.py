"""The rank side of tests/test_torch_train_ranks.py: one process of a
four-rank gloo world on the CPU that trains the port over (tp 2, ep 2),
(tp 4, ep 1) and (tp 2, ep 1) pairs, every layout a set of subgroups of
the same world. It imports neither jax nor the JAX package (a spawned rank
starts a fresh interpreter), runs every case once and writes this rank's
results to `<out>/train_rank<r>.pt`: whole trees gathered from the ranks'
parts (`gathered`), every rank's losses and norms,
and the one-rank port's references where a case is held to the port's one
rank. The test process holds them to the JAX reference."""
from __future__ import annotations

import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4
TIMEOUT = timedelta(seconds=60)
LR = 1e-3
B, S = 4, 32                    # a batch: 2 rows a rank over ep 2
STEPS = 2
F32 = dict(compute_dtype="float32", param_dtype="float32")


def cfg_of(arch, **kw):
    from repro_torch.configs import reduced_config
    return reduced_config(arch).with_updates(**F32, **kw)


def moe_cfg():
    """Reduced qwen2-moe-a2.7b at grad_accum 2 (the published value) and
    capacity factor 8: a bucket's capacity follows the rows a rank routes,
    so a cut that drops assignments on one device and over ranks drops
    different ones (the reference's too); at 8 neither drops."""
    from dataclasses import replace
    cfg = cfg_of("qwen2-moe-a2.7b", grad_accum=2)
    return cfg.with_updates(moe=replace(cfg.moe, capacity_factor=8.0))


def batch_np(vocab, seed, masked=False):
    """Seeded numpy tokens and next-token labels [B, S] int32; with
    `masked` a float32 mask whose first half of rows (data rank 0's) keeps
    about 0.8 of the tokens and whose second half about 0.3, so the two
    data ranks hold different token counts."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    out = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    if masked:
        keep = np.where(np.arange(B)[:, None] < B // 2, 0.8, 0.3)
        out["mask"] = (rng.random((B, S)) < keep).astype(np.float32)
    return out


def to_torch(b: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def placement(ctx):
    from repro_torch.serving.placement import DevicePlacement
    return DevicePlacement(torch.device("cpu"), False, ctx)


def lm_of(cfg, ctx=None):
    from repro_torch.models.lm import LM
    return LM.build(cfg, device="cpu", ctx=ctx)


def _clone(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.clone(), tree)


# ---- the autograd collectives' transposes --------------------------------
def _rng_t(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _grad(fn, *xs):
    xs = [x.clone().requires_grad_(True) for x in xs]
    return [g for g in torch.autograd.grad(fn(*xs), xs)]


def run_transposes(ctx) -> dict:
    """Each differentiable collective of a (tp 2, ep 2) rank against its
    one-rank composition (every rank's inputs rebuilt from their seeds):
    {name: (got, want)} gradients."""
    from repro_torch.models.common import rms_norm, rms_norm_over_model
    tp, ep, t, e = ctx.tp, ctx.ep, ctx.t, ctx.e
    n, c = 3, 4
    w = _rng_t(1, (n, tp * c))
    res = {}
    # psum_model: partial sums in, replicated sum out
    xs = [_rng_t(10 + i, (n, tp * c)) for i in range(tp)]
    got = _grad(lambda x: (w * ctx.psum_model(x)).sum(), xs[t])
    want = _grad(lambda *a: (w * sum(a)).sum(), *xs)[t]
    res["psum_model"] = (got[0], want)
    # enter_model → each rank's sharded branch → psum_model
    x = _rng_t(2, (n, c))
    ws = [_rng_t(20 + i, (c, tp * c)) for i in range(tp)]
    got = _grad(lambda a: (w * ctx.psum_model(torch.tanh(
        ctx.enter_model(a) @ ws[t]))).sum(), x)
    want = _grad(lambda a: (w * sum(torch.tanh(a @ wi) for wi in ws)).sum(),
                 x)
    res["enter_model"] = (got[0], want[0])
    # rms_norm_over_model: the channels over `model`, the sum of squares
    # feeding each rank's own; and the identity transpose it must not be
    X = _rng_t(3, (n, tp * c))
    sc = _rng_t(4, (tp * c,)) + 2
    W = _rng_t(5, (tp * c, 5))
    sl = slice(t * c, (t + 1) * c)

    def sharded(a, s_, feeds=True):
        if feeds:
            y = rms_norm_over_model(a, s_, 1e-6, ctx, tp * c)
        else:
            x32 = a.float()
            ss = ctx.psum_model(x32.square().sum(-1, keepdim=True))
            y = x32 * torch.rsqrt(ss / (tp * c) + 1e-6) * s_
        return (w[:, :5] * ctx.psum_model(y @ W[sl])).sum()
    got = _grad(sharded, X[:, sl], sc[sl])
    want = _grad(lambda a, s_: (w[:, :5] * (rms_norm(a, s_, 1e-6) @ W)
                                ).sum(), X, sc)
    res["rms_norm_over_model"] = (torch.cat([got[0].flatten(), got[1]]),
                                  torch.cat([want[0][:, sl].flatten(),
                                             want[1][sl]]))
    wrong = _grad(lambda a, s_: sharded(a, s_, feeds=False), X[:, sl],
                  sc[sl])
    res["rms_norm_identity_transpose"] = torch.cat([wrong[0].flatten(),
                                                   wrong[1]])
    # all_gather_model: the rank's columns in, the whole row out
    got = _grad(lambda a: (w * ctx.all_gather_model(a, dim=-1)).sum(),
                X[:, sl])
    res["all_gather_model"] = (got[0], w[:, sl])
    # all_to_all_data: tile j of rank i lands at rank j, tile i; the loss
    # sums every data rank's (psum_batch)
    xe = [_rng_t(30 + i, (ep * n, c)) for i in range(ep)]
    we = [_rng_t(40 + i, (ep * n, c)) for i in range(ep)]
    got = _grad(lambda a: ctx.psum_batch((we[e] * ctx.all_to_all_data(a))
                                         .sum()), xe[e])

    def a2a_all(*a):
        return sum((we[j] * torch.cat([a[i][j * n:(j + 1) * n]
                                       for i in range(ep)])).sum()
                   for j in range(ep))
    res["all_to_all_data"] = (got[0], _grad(a2a_all, *xe)[e])
    # all_to_all_rows: uneven counts, send[i][j] rows from rank i to j
    send = [[1, 2], [3, 1]]
    recv = [send[i][e] for i in range(ep)]
    xr = [_rng_t(50 + i, (sum(send[i]), c)) for i in range(ep)]
    wr = [_rng_t(60 + j, (sum(send[i][j] for i in range(ep)), c))
          for j in range(ep)]
    got = _grad(lambda a: ctx.psum_batch(
        (wr[e] * ctx.all_to_all_rows(a, send[e], recv)).sum()), xr[e])

    def rows_all(*a):
        tot = 0
        for j in range(ep):
            parts = [a[i][sum(send[i][:j]):sum(send[i][:j + 1])]
                     for i in range(ep)]
            tot = tot + (wr[j] * torch.cat(parts)).sum()
        return tot
    res["all_to_all_rows"] = (got[0], _grad(rows_all, *xr)[e])
    # all_gather_data: the rank's rows in, every rank's out (replicated)
    wd = _rng_t(6, (ep * n, c))
    got = _grad(lambda a: (wd * ctx.all_gather_data(a, dim=0)).sum(),
                xe[e][:n])
    res["all_gather_data"] = (got[0], wd[e * n:(e + 1) * n])
    # psum_batch: the identity backward; share_over_data: 1 / ep
    got = _grad(lambda a: (wd[:n] * ctx.psum_batch(a)).sum(), xe[e][:n])
    res["psum_batch"] = (got[0], wd[:n])
    got = _grad(lambda a: ctx.share_over_data((a * 3.0).sum()), x)
    res["share_over_data"] = (got[0], torch.full_like(x, 3.0 / ep))
    return res


# ---- train steps over ranks ----------------------------------------------
@torch.no_grad()
def gathered(pl, lm, tree):
    """The inverse of `DevicePlacement.transfer_params`: this rank's part
    of a parameter-shaped tree (parameters, gradients or a moment; or an
    AdamW state of such moments) → the whole one-rank tree (the slot
    leaves in the one-rank slots, expert e in slot e) on the CPU, on every
    rank. Collective. Each leaf's parts are gathered over `model`, then
    `data`, and laid into the whole leaf by each rank's cuts (a part
    several ranks hold alike is written once a holder, the same bytes)."""
    from repro_torch.models.lm import SLOT_LEAVES
    from repro_torch.serving.placement import (_flat, _is_opt, _slot_rows,
                                               _slot_table)
    ctx = pl.ctx
    if ctx.world == 1:
        return _clone(tree)
    if _is_opt(tree):
        return {"m": gathered(pl, lm, tree["m"]),
                "v": gathered(pl, lm, tree["v"]), "step": tree["step"]}
    cuts = [_flat(lm.rank_cuts(r)) for r in range(ctx.world)]
    defs = _flat(lm.param_defs())
    if lm.cfg.moe.n_experts:
        src, dst = _slot_table(lm), _slot_table(lm.one_rank())

    def whole(name, part):
        parts = ctx.all_gather_data(
            ctx.all_gather_model(part.contiguous()[None], dim=0)[None],
            dim=0)                                     # [ep, tp, ...]
        out = torch.zeros(defs[name][0], dtype=part.dtype)
        for r, c in enumerate(cuts):
            idx = tuple(slice(None) if cc is None else
                        slice(cc[0], cc[0] + cc[1]) for cc in c[name])
            out[idx] = parts[r // ctx.tp, r % ctx.tp]
        if name.rsplit(".", 1)[-1] in SLOT_LEAVES:
            out = _slot_rows(src, dst, 0, out)[None]
        return out

    flat = {k: whole(k, v) for k, v in _flat(tree).items()}
    res = {k: v for k, v in flat.items() if not k.startswith("layers.")}
    res["layers"] = [{k: flat[f"layers.{i}.{k}"] for k in layer}
                     for i, layer in enumerate(tree["layers"])]
    return res


def grads_tree(lm, params, batch, tables):
    from repro_torch.training.trainer import loss_and_grads
    from repro_torch.tree import tree_unflatten
    loss, grads = loss_and_grads(lm, params, batch, tables)
    return float(loss), tree_unflatten(params, grads)


def train_run(ctx, cfg, params1, opt1, batches, steps=STEPS, int8=False,
              grads_of=0, want_state=True):
    """`steps` make_train_step steps over `ctx` from the one-rank
    parameters / moments carried into the rank's part → {"hist": [(loss,
    grad_norm)], "grads": (loss, whole gradient tree) of batch `grads_of`
    before the first step, "params", "opt": whole trees after the
    steps}."""
    from repro_torch.training.trainer import make_train_step
    lm = lm_of(cfg, ctx)
    pl = placement(ctx)
    params = pl.place_params(_clone(params1), lm)
    opt = pl.place_params(_clone(opt1), lm)
    tables = lm.default_tables()
    out = {}
    if grads_of is not None:
        loss, g = grads_tree(lm, params, to_torch(batches[grads_of]),
                             tables)
        out["grads"] = (loss, gathered(pl, lm, g))
    step = make_train_step(lm, lr=LR, grad_compress_int8=int8)
    hist = []
    for s in range(steps):
        params, opt, m = step(params, opt, to_torch(batches[s]), tables)
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    out["hist"] = hist
    if want_state:
        out["params"] = gathered(pl, lm, params)
        out["opt"] = gathered(pl, lm, opt)
    out["_state"] = (lm, params, opt)
    return out


def one_rank_run(cfg, params1, opt1, batches, steps, int8=False,
                 grads_of=0):
    """The same on the port's one rank (a reference for the cases held
    to it)."""
    from repro_torch.distributed import RankCtx
    return train_run(RankCtx.local(), cfg, params1, opt1, batches, steps,
                     int8, grads_of)


def fresh(cfg):
    from repro_torch.training.optim import adamw_init
    lm = lm_of(cfg)
    params = lm.init(0)
    return params, adamw_init(params)


def strip(run: dict) -> dict:
    return {k: v for k, v in run.items() if not k.startswith("_")}


def run_replicas(ctx) -> dict:
    """Reduced qwen3-moe-235b-a22b (a redundant slot a rank) at (tp 2, ep
    2) over a placement whose spare slots hold second replicas of experts
    0 and 4 (rank 0 hosts 0-4, rank 1 0 and 4-7): each slot keeps its own
    gradient. → the loss and, per slot leaf, the gradient of each expert
    summed over its replicas ([E, ...], gathered over `model`), and which
    replica slots took a gradient."""
    from dataclasses import replace
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.lm import SLOT_LEAVES
    from repro_torch.serving.placement import shard_leaf
    from repro_torch.training.trainer import loss_and_grads
    from repro_torch.tree import tree_unflatten
    cfg = cfg_of("qwen3-moe-235b-a22b")
    cfg = cfg.with_updates(moe=replace(cfg.moe, capacity_factor=8.0))
    E = cfg.moe.n_experts
    p1, _ = fresh(cfg)
    lm, pl = lm_of(cfg, ctx), placement(ctx)
    params = pl.place_params(_clone(p1), lm)
    s = moe_mod.default_slot_count(cfg, ctx.ep)
    hosted = np.zeros((ctx.ep, E), dtype=np.int8)
    hosted[0, :E // 2 + 1] = 1
    hosted[1, E // 2:] = 1
    hosted[1, 0] = 1
    tables = moe_mod.tables_from_placement(hosted, s, "cpu")
    se = tables["slot_expert"][ctx.e]
    cuts = lm.param_cuts()["layers"]
    for i, (lp, l1) in enumerate(zip(params["layers"], p1["layers"])):
        for k in SLOT_LEAVES:
            if k in lp:
                rows = moe_mod.slots_from_canonical(l1[k][0, :E], se[None])
                lp[k] = shard_leaf(rows, (None,) + cuts[i][k][1:])
    batch = to_torch(batch_np(cfg.vocab_size, 400))
    loss, grads = loss_and_grads(lm, params, batch, tables)
    g = tree_unflatten(params, grads)
    out = {"loss": float(loss), "experts": [], "replicas_fed": []}
    live = se >= 0
    for layer in g["layers"]:
        per = {}
        for k in SLOT_LEAVES:
            if k not in layer:
                continue
            x = layer[k][0]
            canon = torch.zeros((E,) + tuple(x.shape[1:]), dtype=x.dtype)
            canon.index_add_(0, se[live].long(), x[live])
            canon = ctx.psum_batch(canon)
            per[k] = ctx.all_gather_model(canon, dim=-1 if k != "moe_w2"
                                          else 1)
            if k == "moe_w1":
                spare = s - 1 if ctx.e == 0 else 0    # the second replica
                out["replicas_fed"].append(float(x[spare].abs().max()) > 0)
        out["experts"].append(per)
    one = lm_of(cfg)
    loss1, g1 = loss_and_grads(one, p1, batch, one.default_tables())
    g1 = tree_unflatten(p1, g1)
    out["one_loss"] = float(loss1)
    out["one_experts"] = [{k: layer[k][0, :E] for k in SLOT_LEAVES
                           if k in layer} for layer in g1["layers"]]
    return out


def run_cases(ctx22, ctx41, pair, inputs, ckpt_dir) -> dict:
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import moe as moe_mod
    from repro_torch.training.optim import adamw_init
    res = {}
    rank0 = dist.get_rank() == 0
    # (a) qwen2-1.5b at (tp 2, ep 2), 'kv'; unmasked and masked
    qcfg = cfg_of("qwen2-1.5b")
    qb = inputs["qwen2_batches"]
    run = train_run(ctx22, qcfg, inputs["qwen2"], inputs["qwen2_opt"], qb)
    lm22, params22, opt22 = run["_state"]
    res["a"] = strip(run)
    # the same loss from this rank's rows handed over as they are
    rows, b0 = lm22.batch_rows(B), to_torch(qb[0])
    with torch.no_grad():
        res["a_local_rows"] = (
            float(lm22.train_loss(params22, {k: v[rows] for k, v in
                                             b0.items()},
                                  local_rows=True)[0]),
            float(lm22.train_loss(params22, b0)[0]))
    res["a_mask"] = strip(train_run(ctx22, qcfg, inputs["qwen2"],
                                    inputs["qwen2_opt"],
                                    inputs["qwen2_masked"], steps=1))
    # remat over ranks: both policies re-run the forward collectives in the
    # backward and give the gradients of remat off bit for bit
    for policy in ("nothing", "dots"):
        rcfg = qcfg.with_updates(remat=True, remat_policy=policy)
        rlm = lm_of(rcfg, ctx22)
        pl = placement(ctx22)
        p = pl.place_params(_clone(inputs["qwen2"]), rlm)
        res[f"remat_{policy}"] = gathered(
            pl, rlm, grads_tree(rlm, p, to_torch(qb[0]), None)[1])
    # (f) save the state after (a)'s steps over (tp 2, ep 2)
    CheckpointManager(ckpt_dir, lm=lm22).save(STEPS, {"params": params22,
                                                      "opt": opt22})
    # ... and restore it onto (tp 4, ep 1)
    lm41 = lm_of(qcfg, ctx41)
    shapes = lm41.shapes()
    state, step, extra = CheckpointManager(ckpt_dir, lm=lm41).restore(
        template={"params": shapes, "opt": adamw_init(shapes)},
        device="cpu")
    pl41 = placement(ctx41)
    res["f_restore41"] = {"step": step, "extra": extra,
                          "params": gathered(pl41, lm41, state["params"]),
                          "opt": gathered(pl41, lm41, state["opt"]),
                          "shapes": {k: tuple(v.shape) for k, v in
                                     state["params"]["layers"][0].items()}}
    # (e) int8 gradient compression at (tp 2, ep 2), one step
    res["e"] = strip(train_run(ctx22, qcfg, inputs["qwen2"],
                               inputs["qwen2_opt"], qb, steps=1, int8=True,
                               grads_of=None))
    # (b) qwen2-moe-a2.7b at (tp 2, ep 2), grad_accum 2 (the published
    # value), and with the int8 dispatch against the port's one rank
    mcfg = moe_cfg()
    mb = inputs["moe_batches"]
    moe_mod.drop_tally("cpu").zero_()
    run = train_run(ctx22, mcfg, inputs["moe"], inputs["moe_opt"], mb)
    res["b"] = strip(run)
    res["b_drops"] = float(moe_mod.drop_tally("cpu"))
    # its state saved over the ranks too: expert slots by their experts
    lm_b, params_b, opt_b = run["_state"]
    CheckpointManager(f"{ckpt_dir}_moe", lm=lm_b).save(
        STEPS, {"params": params_b, "opt": opt_b})
    icfg = mcfg.with_updates(moe_dispatch_int8=True, grad_accum=1)
    res["b_int8"] = strip(train_run(ctx22, icfg, inputs["moe"],
                                    inputs["moe_opt"], mb, steps=1))
    if rank0:
        res["b_int8_one"] = strip(one_rank_run(icfg, inputs["moe"],
                                               inputs["moe_opt"], mb, 1))
    res["b_replicas"] = run_replicas(ctx22)
    # (c) 'wseq' at (tp 4, ep 1): reduced granite-34b (one KV head) and
    # reduced qwen2-1.5b (two KV heads, each read by a pair of ranks)
    for name, arch in (("c_granite", "granite-34b"),
                       ("c_qwen2", "qwen2-1.5b")):
        ccfg = cfg_of(arch)
        p1, o1 = fresh(ccfg)
        cb = [inputs["batches_by_vocab"][ccfg.vocab_size][0]]
        res[name] = strip(train_run(ctx41, ccfg, p1, o1, cb, steps=1))
        if rank0:
            res[name + "_one"] = strip(one_rank_run(ccfg, p1, o1, cb, 1))
    # (d) reduced mamba2-130m at tp 2 (each pair of the world a world of
    # its own): mamba_layout, rms_norm_over_model
    dcfg = cfg_of("mamba2-130m")
    p1, o1 = fresh(dcfg)
    db = [inputs["batches_by_vocab"][dcfg.vocab_size][0]]
    res["d"] = strip(train_run(pair, dcfg, p1, o1, db, steps=1))
    if rank0:
        res["d_one"] = strip(one_rank_run(dcfg, p1, o1, db, 1))
    return res


def child(rank: int, store_path: str, in_path: str, out_dir: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD, timeout=TIMEOUT)
    res = {}
    try:
        from repro_torch.distributed import RankCtx
        ctx22 = RankCtx.build(2, 2)
        ctx41 = RankCtx.build(4, 1)
        # (tp 2, ep 1): the two ranks that share e, a world of their own
        pair = RankCtx(ep=1, tp=2, rank=ctx22.t, backend=ctx22.backend,
                       model_group=ctx22.model_group)
        inputs = torch.load(in_path, weights_only=False)
        res["transposes"] = run_transposes(ctx22)
        res.update(run_cases(ctx22, ctx41, pair, inputs,
                             f"{out_dir}/ckpt"))
    except BaseException:
        res["error"] = traceback.format_exc()
        raise
    finally:
        torch.save(res, f"{out_dir}/train_rank{rank}.pt")
        dist.destroy_process_group()
