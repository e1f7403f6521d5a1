"""The port's dry run (src/repro_torch/launch/{mesh,specs,cost,dryrun}.py)
on the CPU:

- `n_params`, `n_active_params` and `model_flops` equal the reference's
  for all ten architectures and the four SHAPES;
- at (ep, tp) = (1, 1), (1, 4), (2, 2), `LM.param_specs` equals the
  reference's `LM.specs()` over an AbstractMesh((ep, tp), ('data',
  'model')), FSDP's "data" on the five configs that set it included, and
  the ranks' cut parameters sum to the whole model times each leaf's
  replication; where `param_cuts` cuts by head otherwise than the spec,
  the head layout ('wseq', replicated) is what explains it;
- at one rank the meta decode cache has the reference's `cache_struct`
  shapes and dtypes at decode_32k and long_500k;
- on reduced qwen2-1.5b and qwen2-moe the meta trace counts the product
  flops FlopCounterMode counts on the same step run on the CPU, outside
  the kernel calls; each kernel charge is its formula at the shapes the
  CPU run gives the kernel; the argument bytes are exact;
- at (tp 2, ep 2) the dry backend's collectives of a reduced qwen2-moe
  decode step are the ones counted by hand, per layer; a qwen3-32b train
  cell (FSDP) reduce-scatters every FSDP leaf's gradient once and its
  argument bytes are the sharded ones;
- `run_cell` / the CLI write ok and skipped records."""
import json
import math

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as ref_config
from repro.distributed.ctx import MeshCtx
from repro.launch import dryrun as ref_dryrun
from repro.models.lm import LM as RefLM
from repro.models.stack import cache_struct
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import ops as kops
from repro_torch.launch import cost, dryrun
from repro_torch.launch.mesh import DEFAULT_LAYOUTS, dry_ctx
from repro_torch.launch.specs import param_specs
from repro_torch.models import moe as moe_mod
from repro_torch.models import stack as stack_mod
from repro_torch.models.lm import LM

torch.set_num_threads(2)

# the attention and Mamba-2 leaves LM.param_cuts cuts by head
KV_LEAVES = ("wk", "wv", "bk", "bv")
ATTN_LEAVES = ("wq", "bq", "wo") + KV_LEAVES
MAMBA_LEAVES = ("w_z", "w_x", "conv_x", "ssm_norm", "out_proj", "w_dt",
                "dt_bias", "A_log", "D_skip")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_and_model_flops_equal_reference(arch):
    cfg, ref = get_config(arch), ref_config(arch)
    assert cfg.n_params() == ref.n_params()
    assert cfg.n_active_params() == ref.n_active_params()
    for name, shape in SHAPES.items():
        meta = {"kind": shape.kind, "global_batch": shape.global_batch,
                "seq_len": shape.seq_len,
                "n_active_params": cfg.n_active_params()}
        assert dryrun.model_flops(meta) == ref_dryrun.model_flops(meta), name


def _ref_layer_specs(ref_specs, plan) -> list:
    """The reference's stacked period / rem specs as one dict a layer,
    the stacking dim dropped."""
    st = ref_specs["stack"]
    per = [{k: tuple(v)[1:] for k, v in d.items()} for d in st["period"]]
    rem = [{k: tuple(v) for k, v in d.items()} for d in st["rem"]]
    return per * plan.n_rep + rem


def _rep(spec, ctx) -> int:
    """How many ranks hold each element of a leaf cut by its spec."""
    n = 1
    for a in spec:
        n *= ctx.size(a)
    return ctx.world // n


# the leaves cut by head otherwise than their spec, with the layout that
# explains each: under 'wseq' (K % tp != 0) a rank holds whole KV heads —
# granite-34b's one, one of qwen2-1.5b's two — where the spec would split
# their channels over `model`
def _wseq(arch, names):
    return [(arch, n, "wseq") for n in names]


HEAD_CUTS = {
    (1, 1): [],
    (1, 4): _wseq("granite-34b", ("wk", "wv"))
    + _wseq("qwen2-1.5b", ("bk", "bv", "wk", "wv")),
    (2, 2): _wseq("granite-34b", ("wk", "wv"))}


@pytest.mark.parametrize("layout", DEFAULT_LAYOUTS,
                         ids=[f"ep{e}_tp{t}" for e, t in DEFAULT_LAYOUTS])
def test_param_specs_and_cuts_match_reference(layout):
    ep, tp = layout
    mesh = MeshCtx(AbstractMesh((ep, tp), ("data", "model")))
    explained = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        ref = RefLM.build(ref_config(arch), mesh)
        lms = [LM.build(cfg, device="meta", ctx=dry_ctx(tp, ep, r))
               for r in range(ep * tp)]
        specs = lms[0].param_specs()
        rs = ref.specs()
        for k in ("embed", "final_norm", "head"):
            if k in rs:
                assert specs[k] == tuple(rs[k]), (arch, k)
        for i, (got, want) in enumerate(zip(
                specs["layers"], _ref_layer_specs(rs, lms[0].plan))):
            assert got == want, (arch, i)
        defs = lms[0].param_defs()
        trees = [param_specs(m) for m in lms]
        hl = stack_mod.head_layout(cfg, tp)
        ml = stack_mod.mamba_layout(cfg, tp)
        for i, layer in enumerate(defs["layers"]):
            for name, (shape, _, _) in layer.items():
                whole = math.prod(shape)
                held = sum(t["layers"][i][name].numel() for t in trees)
                spec = specs["layers"][i][name]
                rep = _rep(spec, lms[0].ctx)
                if held == whole * rep:
                    continue
                # a head cut that differs from the even split of the spec
                # (which keeps its FSDP cut over `data` on the other dim)
                fs = ep if "data" in spec else 1
                if name in KV_LEAVES and hl.kind == "wseq":
                    want_rep = ep * tp * hl.nk // cfg.n_kv_heads // fs
                elif name in ATTN_LEAVES and hl.replicated:
                    want_rep = ep * tp // fs
                elif name in MAMBA_LEAVES and ml.replicated:
                    want_rep = ep * tp // fs
                else:
                    raise AssertionError((arch, i, name, held, whole, rep))
                assert held == whole * want_rep, (arch, i, name)
                if (arch, name, hl.kind) not in explained:
                    explained.append((arch, name, hl.kind))
        for k, d in defs.items():
            if k == "layers":
                continue
            held = sum(t[k].numel() for t in trees)
            assert held == math.prod(d[0]) * _rep(specs[k], lms[0].ctx), k
    assert sorted(explained) == HEAD_CUTS[layout]


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_decode_cache_equals_reference_cache_struct(shape):
    sc = SHAPES[shape]
    mesh = MeshCtx(AbstractMesh((1, 1), ("data", "model")))
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        if cfg.encoder_only:
            continue
        fn, args, lm, _ = dryrun.build_cell(arch, shape, dry_ctx())
        cache = args[1]
        ref = RefLM.build(ref_config(arch), mesh)
        sds, _ = cache_struct(ref_config(arch), mesh, ref.plan,
                              sc.global_batch, sc.seq_len)
        want = [{k: (tuple(v.shape)[1:], str(v.dtype)) for k, v in d.items()}
                for d in sds["period"]] * ref.plan.n_rep + \
            [{k: (tuple(v.shape), str(v.dtype)) for k, v in d.items()}
             for d in sds["rem"]]
        got = [{k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in d.items()} for d in cache["layers"]]
        assert got == want, arch


# ---- the meta trace against the same step on the CPU ------------------
KERNELS = {  # wrapper name in its calling module → (module, charge name)
    "flash_prefill": (kops, "flash_prefill"),
    "sink_decode": (kops, "sink_decode"),
    "paged_decode": (kops, "paged_decode"),
    "paged_prefill": (kops, "paged_prefill"),
    "spec_verify": (kops, "spec_verify"),
    "block_topk_select": (kops, "block_topk_scores"),
    "block_topk_scores": (kops, "block_topk_scores"),
    "block_topk_select_scores": (stack_mod, "block_topk_select_scores"),
    "moe_gmm": (moe_mod, "moe_gmm")}
BOUNDS = {"flash_prefill": lambda a, k: cost.flash_bound(
              a[0], a[1], k.get("causal", True), k.get("window", 0),
              k.get("sink", 0)),
          "sink_decode": lambda a, k: cost.sink_bound(a[0], a[1], a[3]),
          "moe_gmm": lambda a, k: cost.moe_gmm_bound(*a)}


def _to_meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    return x


@pytest.fixture
def kernel_calls(monkeypatch):
    """Run every kernel wrapper outside the dispatch modes (the plain twin
    on the CPU counts no flops) and keep its arguments."""
    calls = []
    for attr, (mod, name) in KERNELS.items():
        orig = getattr(mod, attr)

        def wrapped(*a, _orig=orig, _name=name, _attr=attr, **k):
            calls.append((_attr, _name, a, k))
            with _disable_current_modes():
                return _orig(*a, **k)
        monkeypatch.setattr(mod, attr, wrapped)
    return calls


CELLS = [("qwen2-1.5b", ShapeConfig("p", 48, 1, "prefill")),
         ("qwen2-1.5b", ShapeConfig("d", 48, 3, "decode")),
         ("qwen2-1.5b", ShapeConfig("t", 32, 2, "train")),
         ("qwen2-moe-a2.7b", ShapeConfig("p", 48, 2, "prefill")),
         ("qwen2-moe-a2.7b", ShapeConfig("d", 48, 4, "decode"))]


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s.kind}" for a, s in CELLS])
def test_meta_trace_counts_the_cpu_step(arch, shape, kernel_calls):
    cfg = reduced_config(arch).with_updates(compute_dtype="float32",
                                            param_dtype="float32")
    fn, args, lm, _ = dryrun.build_cell(arch, shape, dry_ctx(), cfg=cfg)
    with cost.CostCounter(args) as c:
        out = fn(*args)
    rec = c.finish(out)
    kernel_calls.clear()
    cfn, cargs, _, _ = dryrun.build_cell(arch, shape, dry_ctx(), cfg=cfg,
                                         device="cpu")
    with FlopCounterMode(display=False) as fc:
        out = cfn(*cargs)
    assert rec["product_flops"] == fc.get_total_flops() > 0
    assert rec["memory_analysis"]["argument_bytes"] == \
        cost.distinct_bytes(cargs)
    # every kernel call charged once, at its formula on the CPU run's shapes
    assert [n for n, _, _ in c.kernel_charges] == \
        [name for _, name, _, _ in kernel_calls]
    for (name, nbytes, flops), (attr, _, a, k) in zip(c.kernel_charges,
                                                      kernel_calls):
        assert attr in BOUNDS, f"{attr} is not on these cells' paths"
        want = BOUNDS[attr]([_to_meta(x) for x in a], k)
        assert (nbytes, flops) == want[2:], name
    if shape.kind == "train":
        assert not kernel_calls
    else:
        assert kernel_calls
    last = out[2]["loss"] if shape.kind == "train" else out[1]
    assert torch.isfinite(last).all()


def test_flash_bound_closed_form_equals_the_mask_count():
    """flash_bound counts visible keys in closed form; the [S, S] mask it
    replaced gives the same counts (phase 2's bound_ms unchanged)."""
    for S, causal, window, sink in ((64, True, 0, 0), (64, False, 0, 0),
                                    (96, True, 16, 4), (96, False, 16, 4),
                                    (50, True, 7, 0), (33, False, 8, 40)):
        p = np.arange(S)[:, None]
        t = np.arange(S)[None, :]
        ok = (t <= p) if causal else np.ones((S, S), bool)
        if window > 0:
            ok = ok & (((p - t) < window) | (t < sink))
        q = torch.empty((2, 3 * S, 32), device="meta")
        k = torch.empty((2, S, 32), device="meta")
        flops = cost.flash_bound(q, k, causal, window, sink)[3]
        assert flops == 4 * 32 * 2 * 3 * int(ok.sum())


def test_collectives_at_tp2_ep2_counted_by_hand():
    """Reduced qwen2-moe (2 MoE layers, D 128, V 512, 8 experts top-2, one
    shared expert) decoding 4 slots over (tp 2, ep 2), float32: per
    layer one psum of the attention output, one of the routed + shared
    experts' partial sums, one psum_batch of the counts, two payload
    all_to_alls and one of the bucket counts, one all_gather of the
    rows; then one psum of the embedding and one gather of the logits."""
    cfg = reduced_config("qwen2-moe-a2.7b").with_updates(
        compute_dtype="float32", param_dtype="float32")
    B, L, D, V, E = 4, cfg.n_layers, cfg.d_model, cfg.vocab_size, \
        cfg.moe.n_experts
    fn, args, lm, _ = dryrun.build_cell(
        "qwen2-moe-a2.7b", ShapeConfig("d", 64, B, "decode"),
        dry_ctx(tp=2, ep=2, rank=3), cfg=cfg)
    with cost.CostCounter(args) as c:
        fn(*args)
    ep, s = 2, moe_mod.default_slot_count(cfg, 2)
    T = B // ep                              # the rank's routed rows
    Cb = moe_mod._bucket_capacity(T, cfg.moe.top_k, ep, s,
                                  cfg.moe.capacity_factor)
    payload = ep * s * Cb * D * 4
    assert dict(c.collective_calls) == {
        "psum_model": 1 + 2 * L, "psum_batch": L,
        "all_to_all_data": 3 * L, "all_gather_data": L,
        "all_gather_model": 1}
    assert dict(c.collective_counts) == {
        "all-reduce": 1 + 3 * L, "all-to-all": 3 * L, "all-gather": L + 1}
    assert dict(c.collective_bytes) == {
        "all-reduce": B * D * 4 + L * (B * D * 4 + T * D * 4 + E * 4),
        "all-to-all": L * (2 * payload + ep * s * 4),
        "all-gather": L * T * D * 4 + B * (V // 2) * 4}


def test_fsdp_train_cell_reduce_scatters_and_shards():
    """qwen3-32b (cfg.fsdp, as published) at full width, cut to 2 layers,
    a train cell at (ep 2, tp 2): in each of grad_accum's microbatches
    every leaf cut over `data` has its gradient reduce-scattered once, its
    whole (after the `model` cut) bytes each, and is gathered in the
    forward and, a layer's, again in the backward (remat "nothing"); the
    argument bytes are the sharded parameters' and moments' plus the
    batch's, about half of the same cell's without FSDP."""
    shape = ShapeConfig("t", 128, 8, "train")
    rec = dryrun.dry_cell("qwen3-32b", shape, (2, 2),
                          overrides={"n_layers": 2})
    plain = dryrun.dry_cell("qwen3-32b", shape, (2, 2),
                            overrides={"n_layers": 2, "fsdp": False})
    assert rec["status"] == plain["status"] == "ok", rec.get("traceback")
    assert "fsdp" not in rec
    cfg = get_config("qwen3-32b").with_updates(n_layers=2)
    assert cfg.fsdp and cfg.remat and cfg.remat_policy == "nothing"
    lm = LM.build(cfg, device="meta", ctx=dry_ctx(2, 2, 0))
    specs, shapes = lm.param_specs(), lm.shapes()
    cut = [v for k, v in shapes.items() if k != "layers" and
           "data" in specs[k]] + \
        [v for sl, layer in zip(specs["layers"], shapes["layers"])
         for k, v in layer.items() if "data" in sl[k]]
    nbytes = sum(v.numel() * v.element_size() for v in cut)
    coll, A = rec["collective_bytes_per_device"], cfg.grad_accum
    assert coll["reduce-scatter"] == A * 2 * nbytes > 0
    assert coll["counts"]["reduce-scatter"] == A * len(cut)
    assert coll["calls"]["gather_params"] == A * (len(cut) + sum(
        "data" in sl[k] for sl in specs["layers"] for k in sl))
    assert "reduce-scatter" not in plain["collective_bytes_per_device"]
    batch = 2 * shape.global_batch * shape.seq_len * 4
    param = sum(v.numel() * v.element_size() for v in
                [*(v for k, v in shapes.items() if k != "layers"),
                 *(v for layer in shapes["layers"] for v in layer.values())])
    mom = torch.empty((), dtype=getattr(torch, cfg.optimizer_dtype)
                      ).element_size()
    n = param // torch.empty((), dtype=getattr(torch, cfg.param_dtype)
                             ).element_size()
    args = rec["memory_analysis"]["argument_bytes"]
    assert args == param + 2 * n * mom + batch + 4
    assert args - batch <= 0.55 * (plain["memory_analysis"]
                                   ["argument_bytes"] - batch)


def test_run_cell_and_cli(tmp_path):
    rec = dryrun.dry_cell("qwen2-moe-a2.7b", "decode_32k", (2, 2))
    assert rec["status"] == "ok", rec.get("traceback")
    for k in ("flops_per_device", "bytes_per_device", "min_bytes_per_device",
              "model_flops_total", "useful_flops_ratio"):
        assert math.isfinite(rec[k]) and rec[k] > 0, k
    assert rec["kernel_calls"] == {"sink_decode": 24, "moe_gmm": 72}
    assert rec["collective_bytes_per_device"]["total"] > 0
    assert rec["card"]["name"] == cost.CARD
    assert dryrun.main(["--arch", "qwen2-1.5b", "--shape", "train_4k",
                        "decode_32k", "--mesh-shape", "2x2", "--out",
                        str(tmp_path)]) == 0
    train = json.loads((tmp_path / "ep2_tp2" /
                        "qwen2-1.5b__train_4k.json").read_text())
    assert train["status"] == "ok", train.get("traceback")
    assert train["collective_bytes_per_device"]["all-reduce"] > 0
    dec = json.loads((tmp_path / "ep2_tp2" /
                      "qwen2-1.5b__decode_32k.json").read_text())
    assert dec["status"] == "ok" and isinstance(dec["fits"], bool)
    t = dec["roofline"]["terms"]
    assert t["memory_s"] > 0 and t["compute_s"] > 0
    assert dec["roofline"]["dominant"] == max(t, key=t.get)
