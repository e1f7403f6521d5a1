"""The rank side of tests/test_torch_train_fsdp.py: one process of a
four-rank gloo world on the CPU that trains and serves the port under
cfg.fsdp over (tp 2, ep 2), and restores onto (tp 4, ep 1), every layout a
set of subgroups of the same world. It imports neither jax nor the JAX
package, runs every case once and writes this rank's results to
`<out>/fsdp_rank<r>.pt`: whole trees gathered from the ranks' parts,
every rank's losses and norms, the bytes its parameters and moments hold,
and its greedy streams. The test process holds them to the JAX reference
and to the port's one rank."""
from __future__ import annotations

import traceback

import torch
import torch.distributed as dist

import torch_dist_worker as DW
import torch_train_worker as TW

WORLD = TW.WORLD
# (c) a reduced jamba cut to one period of its pattern: one attention
# layer, seven Mamba-2 layers, MoE on every other one
JAMBA_LAYERS = 8
# (c)'s capacity factor: a bucket's capacity follows the rows a rank
# routes, so nothing may drop on either side
MOE_CF = 8.0


def cfg_of(arch, **kw):
    """The reduced config of `arch` in float32 with cfg.fsdp on (the
    reduced configs turn it off, as the reference's do)."""
    from dataclasses import replace
    cfg = TW.cfg_of(arch, fsdp=True, **kw)
    if cfg.moe.n_experts:
        cfg = cfg.with_updates(moe=replace(cfg.moe, capacity_factor=MOE_CF))
    return cfg


def jamba_cfg():
    return cfg_of("jamba-1.5-large-398b", n_layers=JAMBA_LAYERS)


def nbytes(tree) -> int:
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def cut_bytes(lm) -> int:
    """The bytes of `lm`'s rank part by its cuts: each leaf of
    `param_defs` at its `param_cuts` length on every cut dim."""
    import math
    from repro_torch.device import torch_dtype
    from repro_torch.serving.placement import _flat
    cuts = _flat(lm.param_cuts())
    total = 0
    for k, (shape, _, dt) in _flat(lm.param_defs()).items():
        n = math.prod(c[1] if c is not None else s
                      for s, c in zip(shape, cuts[k]))
        total += n * torch.empty((), dtype=torch_dtype(dt)).element_size()
    return total


def leaf_parts(lm, lm_whole_data) -> dict:
    """{leaf: (elements of this rank's part under `lm`, elements of its
    part under `lm_whole_data`, the same layout without FSDP)} for every
    leaf FSDP cuts over `data`."""
    import math
    from repro_torch.models.lm import SLOT_LEAVES
    from repro_torch.serving.placement import _flat, _shapes
    specs = _flat(lm.param_specs())
    got, base = _shapes(lm, local=True), _shapes(lm_whole_data, local=True)
    return {k: (math.prod(got[k]), math.prod(base[k]))
            for k, s in specs.items() if "data" in s
            and k.rsplit(".", 1)[-1] not in SLOT_LEAVES}


def run_train(ctx22, ctx41, inputs, ckpt_dir) -> dict:
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import moe as moe_mod
    from repro_torch.training.optim import adamw_init
    res = {}
    rank0 = dist.get_rank() == 0
    qcfg = cfg_of("qwen3-32b")
    qb = inputs["qwen3_batches"]
    # (a) reduced qwen3-32b under FSDP at (tp 2, ep 2): two steps
    run = TW.train_run(ctx22, qcfg, inputs["qwen3"], inputs["qwen3_opt"],
                       qb)
    lm22, params22, opt22 = run["_state"]
    res["a"] = TW.strip(run)
    # (d) the bytes a rank holds: its parameters and moments, their cuts'
    # sum, and the same layout without FSDP
    base = TW.lm_of(qcfg.with_updates(fsdp=False), ctx22)
    res["d"] = {"params": nbytes(params22),
                "moments": nbytes({"m": opt22["m"], "v": opt22["v"]}),
                "cuts": cut_bytes(lm22), "no_fsdp_cuts": cut_bytes(base),
                "leaves": leaf_parts(lm22, base)}
    # remat over FSDP: each layer's checkpoint re-gathers its leaves in
    # the backward; both policies give remat off's gradients bit for bit
    pl = TW.placement(ctx22)
    for policy in ("nothing", "dots"):
        rlm = TW.lm_of(qcfg.with_updates(remat=True, remat_policy=policy),
                       ctx22)
        p = pl.place_params(TW._clone(inputs["qwen3"]), rlm)
        res[f"remat_{policy}"] = TW.gathered(
            pl, rlm, TW.grads_tree(rlm, p, TW.to_torch(qb[0]), None)[1])
    # (e) the state after (a) saved over (tp 2, ep 2) ...
    CheckpointManager(ckpt_dir, lm=lm22).save(
        TW.STEPS, {"params": params22, "opt": opt22})
    # ... restored onto (tp 4, ep 1), where nothing is cut over `data`
    lm41 = TW.lm_of(qcfg, ctx41)
    shapes = lm41.shapes()
    state, step, extra = CheckpointManager(ckpt_dir, lm=lm41).restore(
        template={"params": shapes, "opt": adamw_init(shapes)},
        device="cpu")
    pl41 = TW.placement(ctx41)
    res["e_restore41"] = {
        "step": step, "extra": extra,
        "params": TW.gathered(pl41, lm41, state["params"]),
        "opt": TW.gathered(pl41, lm41, state["opt"])}
    # ... and a save without FSDP over (tp 2, ep 2) restored onto FSDP
    p0 = pl.place_params(TW._clone(inputs["qwen3"]), base)
    o0 = pl.place_params(TW._clone(inputs["qwen3_opt"]), base)
    CheckpointManager(f"{ckpt_dir}_plain", lm=base).save(
        0, {"params": p0, "opt": o0})
    shapes = lm22.shapes()
    state, step, _ = CheckpointManager(
        f"{ckpt_dir}_plain", lm=lm22).restore(
            template={"params": shapes, "opt": adamw_init(shapes)},
            device="cpu")
    res["e_plain_onto_fsdp"] = {
        "step": step, "params": TW.gathered(pl, lm22, state["params"]),
        "opt": TW.gathered(pl, lm22, state["opt"]),
        "shape_wq": tuple(state["params"]["layers"][0]["wq"].shape)}
    # (b) int8 gradient compression under FSDP, one step
    res["b"] = TW.strip(TW.train_run(ctx22, qcfg, inputs["qwen3"],
                                     inputs["qwen3_opt"], qb, steps=1,
                                     int8=True, grads_of=None))
    # (c) reduced granite-34b ('wseq': its one KV head whole on both
    # `model` ranks, its rows cut over `data`) and reduced jamba
    moe_mod.drop_tally("cpu").zero_()
    for name, ccfg in (("c_granite", cfg_of("granite-34b")),
                       ("c_jamba", jamba_cfg())):
        p1, o1 = TW.fresh(ccfg)
        cb = [inputs["batches_by_vocab"][ccfg.vocab_size][0]]
        res[name] = TW.strip(TW.train_run(ctx22, ccfg, p1, o1, cb,
                                          steps=1))
        if rank0:
            res[name + "_one"] = TW.strip(TW.one_rank_run(ccfg, p1, o1,
                                                          cb, 1))
    res["c_drops"] = float(moe_mod.drop_tally("cpu"))
    return res


def serve_fsdp(ctx) -> dict:
    """(f) reduced qwen3-32b under FSDP served over `ctx` (eager gloo on
    the CPU; one rank with RankCtx.local()) from the seed's one-rank
    weights: its greedy streams, the pool invariants checked, and the
    shape of the rank's wq part."""
    from repro_torch.serving import DevicePlacement, Server
    cfg = cfg_of("qwen3-32b")
    params, _ = TW.fresh(cfg)
    srv = Server(cfg, DW.server_config_kw(DW.PARITY_SCFG, True),
                 params=params,
                 placement=DevicePlacement(torch.device("cpu"), ctx=ctx))
    out = DW._serve(srv, DW.parity_requests(cfg.vocab_size))
    out["shape_wq"] = tuple(srv.params["layers"][0]["wq"].shape)
    return out


def child(rank: int, store_path: str, in_path: str, out_dir: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD,
                            timeout=TW.TIMEOUT)
    res = {}
    try:
        from repro_torch.distributed import RankCtx
        ctx22 = RankCtx.build(2, 2)
        ctx41 = RankCtx.build(4, 1)
        inputs = torch.load(in_path, weights_only=False)
        res.update(run_train(ctx22, ctx41, inputs, f"{out_dir}/ckpt"))
        res["f"] = serve_fsdp(ctx22)
    except BaseException:
        res["error"] = traceback.format_exc()
        raise
    finally:
        torch.save(res, f"{out_dir}/fsdp_rank{rank}.pt")
        dist.destroy_process_group()
