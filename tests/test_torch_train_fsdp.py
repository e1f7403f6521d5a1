"""FSDP over `data` in the PyTorch port (cfg.fsdp: each leaf's otherwise
replicated d_model dim and its AdamW moments cut over `data`, gathered
whole at each layer's entry, the gradients reduce-scattered in the
backward), on the CPU: one four-rank gloo world (`torch.multiprocessing`
spawn, a FileStore under tmp_path; the rank side is
tests/torch_fsdp_worker.py) runs every case once, while this process
builds the JAX reference (reduced qwen3-32b `with_updates(fsdp=True)`,
float32, `LM.init(PRNGKey(0))` bridged through numpy) and serves the
port's one rank.

- (a) reduced qwen3-32b at (tp 2, ep 2): two `make_train_step` steps
  against the JAX one-device step — the loss (rel 1e-5), the gradient
  norm (rel 1e-4), every gradient gathered from the ranks' parts (max
  |diff| within 1e-5 of the leaf's largest magnitude), the updated
  parameters and both moments; remat "nothing" and "dots" (each layer's
  gather re-run in the backward) bit-equal to remat off;
- (b) the same with int8 gradient compression, one step, at
  tests/test_torch_train_ranks.py's (e) tolerances;
- (c) reduced granite-34b ('wseq': one KV head whole on both `model`
  ranks, its rows cut over `data`) and reduced jamba (one period: Mamba-2,
  attention and MoE layers) at (tp 2, ep 2) against the port's one rank;
- (d) each FSDP leaf's part holds the whole leaf / (its `model` cut × ep)
  elements, a rank's parameter and moment bytes are its cuts' sum, and at
  most 0.55 of the same layout's without FSDP;
- (e) the sharded save of (a)'s state restored on one rank and on (tp 4,
  ep 1) bit for bit, and a save without FSDP restored onto FSDP;
- (f) reduced qwen3-32b under FSDP served over (tp 2, ep 2), eager, gives
  the port's one-rank greedy streams, the pool invariants holding.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest \\
        tests/test_torch_train_fsdp.py -q
"""
import time

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_fsdp_worker as W
import torch_train_worker as TW
from repro.configs import reduced_config
from repro.distributed.ctx import local_mesh_ctx
from repro.models import LM
from repro.training.optim import adamw_init as j_adamw_init
from repro_torch import bridge
from repro_torch.checkpoint import load_checkpoint
from repro_torch.distributed import RankCtx
from repro_torch.models.lm import LM as TLM
from repro_torch.training.optim import adamw_init
from test_torch_train_ranks import (GRAD_FRAC, LOSS_RTOL, NORM_RTOL,
                                    _bit_equal, _close_to_max, _jax_run,
                                    _leaves, _params_close)

torch.set_num_threads(2)

WORLD_LIMIT_S = 150
# FSDP's bytes a rank against the same layout without it: every leaf
# but the norms is cut over `data` too
BYTES_RATIO = 0.55


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("fsdp_world")
    jcfg = reduced_config("qwen3-32b").with_updates(**TW.F32, fsdp=True)
    jlm = LM.build(jcfg, local_mesh_ctx())
    jparams = jlm.init(jax.random.PRNGKey(0))
    tcfg = W.cfg_of("qwen3-32b")
    plan = TLM.build(tcfg, device="cpu").plan
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      tcfg, plan, device="cpu")
    opt = bridge.opt_from_numpy(jax.tree.map(np.asarray,
                                             j_adamw_init(jparams)),
                                tcfg, plan, device="cpu")
    V = jcfg.vocab_size
    qb = [TW.batch_np(V, 100 + s) for s in range(TW.STEPS)]
    inputs = {"qwen3": params, "qwen3_opt": opt, "qwen3_batches": qb,
              "batches_by_vocab": {V: qb}}
    torch.save(inputs, d / "inputs.pt")
    t0 = time.monotonic()
    procs = mp.start_processes(
        W.child, args=(str(d / "store"), str(d / "inputs.pt"), str(d)),
        nprocs=W.WORLD, join=False, start_method="spawn")
    # the JAX references and the port's one-rank server, while the ranks
    # run
    refs = {"a": _jax_run(jlm, jparams, qb, TW.STEPS),
            "b": _jax_run(jlm, jparams, qb, 1, int8=True, grads_of=None)}
    one_f = W.serve_fsdp(RankCtx.local())
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
    ranks = [torch.load(d / f"fsdp_rank{r}.pt", weights_only=False)
             for r in range(W.WORLD)]
    for r, res in enumerate(ranks):
        assert "error" not in res, f"rank {r}: {res['error']}"
    return {"ranks": ranks, "refs": refs, "plan": plan, "one_f": one_f,
            "params": params, "opt": opt, "ckpt": d / "ckpt"}


def _same_on_every_rank(world, key):
    runs = [r[key] for r in world["ranks"]]
    for run in runs[1:]:
        assert run["hist"] == runs[0]["hist"]
    return runs[0]


# ---- (a), (b): against the JAX one-device step -----------------------------
@pytest.mark.parametrize("case", ["a", "b"])
def test_fsdp_steps_match_jax(world, case):
    run, ref = _same_on_every_rank(world, case), world["refs"][case]
    plan = world["plan"]
    assert len(run["hist"]) == len(ref["hist"])
    for (tl, tn), (jl, jn) in zip(run["hist"], ref["hist"]):
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
        np.testing.assert_allclose(tn, jn, rtol=1e-3 if case == "b"
                                   else NORM_RTOL)
    steps = len(ref["hist"])
    got, want = _leaves(run["params"], plan), jax.tree.leaves(ref["params"])
    if case == "b":
        # an int8 level taken the other way moves an element by one step
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                       atol=1.1e-3)
    else:
        _params_close(got, want, TW.LR, steps)
    assert int(run["opt"]["step"]) == int(ref["opt"]["step"]) == steps
    frac = {"m": 1.01 / 127, "v": 2.02 / 127} if case == "b" else \
        {"m": 2e-3, "v": 2e-3}
    for name in ("m", "v"):
        for g, w in zip(_leaves(run["opt"][name], plan),
                        jax.tree.leaves(ref["opt"][name])):
            _close_to_max(g, np.asarray(w), frac[name], f"{case} {name}")


def test_fsdp_gradients_match_jax(world):
    """Every gradient, gathered from the ranks' reduce-scattered slices,
    equals jax.value_and_grad's."""
    jloss, jg = world["refs"]["a"]["grads"]
    for res in world["ranks"]:
        loss, g = res["a"]["grads"]
        np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
        got = jax.tree_util.tree_leaves_with_path(
            bridge.params_to_numpy(g, world["plan"]))
        want = jax.tree.leaves(jg)
        assert len(got) == len(want)
        for (path, a), b in zip(got, want):
            _close_to_max(a, np.asarray(b, np.float32), GRAD_FRAC,
                          f"a {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_fsdp_remat_bit_equal(world, policy):
    """Under remat each layer's checkpoint gathers its FSDP leaves again
    in the backward (and "dots" saves no gather's output): the gradients
    equal remat off's bit for bit."""
    plan = world["plan"]
    for res in world["ranks"]:
        _bit_equal(bridge.params_to_numpy(res[f"remat_{policy}"], plan),
                   bridge.params_to_numpy(res["a"]["grads"][1], plan))


# ---- (c): against the port's one rank ---------------------------------------
def _experts(tree, E):
    """A gathered tree with each expert slot leaf cut to its first E
    slots, expert e in slot e. The one rank's spare slot (jamba's
    redundant_slots 1: a second replica, trained on its own share of its
    expert's rows) has no counterpart in the ranks' tree, whose gather
    lays each expert's first replica at its one-rank slot."""
    from repro_torch.models.lm import SLOT_LEAVES
    out = dict(tree)
    out["layers"] = [{k: v[:, :E] if k in SLOT_LEAVES else v
                      for k, v in layer.items()} for layer in tree["layers"]]
    return out


@pytest.mark.parametrize("case", ["c_granite", "c_jamba"])
def test_fsdp_layouts_match_one_rank(world, case):
    cfg = W.cfg_of("granite-34b") if case == "c_granite" else W.jamba_cfg()
    E = cfg.moe.n_experts
    one = dict(world["ranks"][0][case + "_one"])
    one["params"] = _experts(one["params"], E)
    plan = TLM.build(cfg, device="cpu").plan
    for res in world["ranks"]:
        run = res[case]
        (l, n), (ol, on) = run["hist"][0], one["hist"][0]
        np.testing.assert_allclose(l, ol, rtol=LOSS_RTOL)
        np.testing.assert_allclose(run["grads"][0], one["grads"][0],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(n, on, rtol=NORM_RTOL)
        got = jax.tree_util.tree_leaves_with_path(
            bridge.params_to_numpy(run["grads"][1], plan))
        want = _leaves(one["grads"][1], plan)
        for (path, a), b in zip(got, want):
            _close_to_max(a, b, GRAD_FRAC,
                          f"{case} {jax.tree_util.keystr(path)}")
    _params_close(_leaves(_experts(world["ranks"][0][case]["params"], E),
                          plan), _leaves(one["params"], plan), TW.LR, 1)
    assert all(r["c_drops"] == 0 for r in world["ranks"])


# ---- (d): the bytes a rank holds -------------------------------------------
def test_fsdp_rank_bytes_match_the_cuts(world):
    for r, res in enumerate(world["ranks"]):
        d = res["d"]
        assert d["leaves"], r
        for k, (got, base) in d["leaves"].items():
            # the `model` cut is the layout's without FSDP; `data` halves it
            assert got * 2 == base, (r, k, got, base)
        assert d["params"] == d["moments"] // 2 == d["cuts"], (r, d)
        assert d["cuts"] <= BYTES_RATIO * d["no_fsdp_cuts"], (r, d)
    print("FSDP bytes a rank / without:",
          [res["d"]["cuts"] / res["d"]["no_fsdp_cuts"]
           for res in world["ranks"]])


def test_fsdp_leaf_cut_over_data_and_model():
    """A head-cut leaf keeps its `data` cut on the other dim: wq's D rows
    over `data` and its query-head columns over `model`; granite's 'wseq'
    KV head whole on both `model` ranks and cut over `data`; embed's D
    columns over `data`; without a `data` group a cut leaf raises."""
    from repro_torch.models import stack as stack_mod
    q, g = W.cfg_of("qwen3-32b"), W.cfg_of("granite-34b")
    D = q.d_model
    for r in range(4):
        e, t = divmod(r, 2)
        cq = TLM.build(q, device="meta", ctx=RankCtx.dry(2, 2, r)
                       ).param_cuts()
        assert cq["layers"][0]["wq"] == ((e * D // 2, D // 2),
                                         (t * 64, 64))
        assert cq["embed"] == ((t * 256, 256), (e * D // 2, D // 2))
        cg = TLM.build(g, device="meta", ctx=RankCtx.dry(2, 2, r)
                       ).param_cuts()
        assert cg["layers"][0]["wk"] == ((e * D // 2, D // 2), None)
    with pytest.raises(ValueError, match="cut over data"):
        stack_mod.gather_fsdp(q, {"wq": torch.zeros(D // 2, 128)}, None)
    with pytest.raises(ValueError, match="ep 1"):
        RankCtx.dry(2, 1, 0).gather_params(torch.zeros(D // 2, 128), 0)


# ---- (e): the sharded save → an elastic restore ---------------------------
def test_fsdp_save_restores_on_one_rank(world):
    one = TLM.build(W.cfg_of("qwen3-32b"), device="cpu")
    shapes = one.shapes()
    state, step, extra = load_checkpoint(
        world["ckpt"], template={"params": shapes, "opt": adamw_init(shapes)})
    assert step == TW.STEPS and extra == {"saved_tp": 2, "saved_ep": 2}
    saved, plan = world["ranks"][0]["a"], world["plan"]
    _bit_equal(bridge.params_to_numpy(state["params"], plan),
               bridge.params_to_numpy(saved["params"], plan))
    for k in ("m", "v"):
        _bit_equal(bridge.params_to_numpy(state["opt"][k], plan),
                   bridge.params_to_numpy(saved["opt"][k], plan))
    assert int(state["opt"]["step"]) == TW.STEPS


def test_fsdp_save_restores_on_tp4(world):
    plan = world["plan"]
    for res in world["ranks"]:
        got, saved = res["e_restore41"], res["a"]
        assert got["step"] == TW.STEPS
        _bit_equal(bridge.params_to_numpy(got["params"], plan),
                   bridge.params_to_numpy(saved["params"], plan))
        for k in ("m", "v"):
            _bit_equal(bridge.params_to_numpy(got["opt"][k], plan),
                       bridge.params_to_numpy(saved["opt"][k], plan))


def test_plain_save_restores_onto_fsdp(world):
    plan = world["plan"]
    D = W.cfg_of("qwen3-32b").d_model
    for res in world["ranks"]:
        got = res["e_plain_onto_fsdp"]
        assert got["step"] == 0 and got["shape_wq"] == (D // 2, 64)
        _bit_equal(bridge.params_to_numpy(got["params"], plan),
                   bridge.params_to_numpy(world["params"], plan))
        for k in ("m", "v"):
            _bit_equal(bridge.params_to_numpy(got["opt"][k], plan),
                       bridge.params_to_numpy(world["opt"][k], plan))


# ---- (f): served over the ranks ---------------------------------------------
def test_fsdp_serves_the_one_rank_streams(world):
    one = world["one_f"]
    D = W.cfg_of("qwen3-32b").d_model
    assert one["n_done"] == len(one["streams"]) > 0
    for res in world["ranks"]:
        f = res["f"]
        assert f["shape_wq"] == (D // 2, 64)
        assert f["n_done"] == one["n_done"]
        assert f["streams"] == one["streams"]
