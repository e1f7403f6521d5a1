"""Training over (tp, ep) ranks of the PyTorch port against the JAX
reference, on the CPU: one four-rank gloo world (`torch.multiprocessing`
spawn, a FileStore under tmp_path; the rank side is
tests/torch_train_worker.py) runs every case once, its layouts (tp 2,
ep 2), (tp 4, ep 1) and (tp 2, ep 1) pairs built as subgroups of it, while
this process builds the JAX references on the same bridged weights
(`LM.init(PRNGKey(0))`, float32) and the same seeded numpy batches.

- every differentiable collective's transpose against its one-rank
  composition on two ranks, `rms_norm_over_model`'s included (the
  identity transpose gives another gradient);
- (a) reduced qwen2-1.5b at (tp 2, ep 2) ('kv'): two `make_train_step`
  steps against the JAX one-device step — the loss (rel 1e-5), the
  gradient norm (rel 1e-4), every gradient gathered from the ranks' parts
  (max |diff| within 1e-5 of the leaf's largest magnitude), the updated
  parameters (`_params_close`) and moments; and a step with a mask that
  gives the two `data` ranks different token counts; remat "nothing" and
  "dots" over ranks bit-equal to remat off;
- (b) reduced qwen2-moe-a2.7b at (tp 2, ep 2) with grad_accum 2 against
  the JAX step on an Auto-axis mesh (ROADMAP C1), at capacity factor 8 in
  both (a bucket's capacity follows the rows a rank routes, so a cut that
  drops would drop different assignments), no assignment dropped;
  with the int8 dispatch against the port's one rank (the transport
  quantizes each row: within 2e-2 of the scale); replica slots (reduced
  qwen3-moe, experts 0 and 4 on both `data` ranks) each keep their own
  gradient, whose sum over an expert's replicas is the one rank's;
- (c) reduced granite-34b and qwen2-1.5b at (tp 4, ep 1), both 'wseq': the
  gradients, the shared KV heads' included, and a step equal the port's
  one rank;
- (d) reduced mamba2-130m at (tp 2, ep 1) against the port's one rank
  (which tests/test_torch_training.py holds to JAX);
- (e) int8 gradient compression at (tp 2, ep 2) against the JAX step (the
  scale the whole leaf's; tolerances of test_torch_training.py's int8
  case);
- (f) the state after (a) saved over (tp 2, ep 2), restored on one rank
  and on (tp 4, ep 1): parameters and moments bit for bit; and the
  launcher's preemption drill over four gloo ranks.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest \
        tests/test_torch_train_ranks.py -q
"""
import time
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import AxisType

import torch_train_worker as W
from repro.configs import reduced_config
from repro.distributed.ctx import MeshCtx, local_mesh_ctx
from repro.models import LM
from repro.training.optim import adamw_init as j_adamw_init
from repro.training.trainer import make_train_step as j_make_train_step
from repro_torch import bridge
from repro_torch.checkpoint import load_checkpoint
from repro_torch.models.lm import LM as TLM
from repro_torch.training.optim import adamw_init

torch.set_num_threads(2)

WORLD_LIMIT_S = 150
LOSS_RTOL, NORM_RTOL, GRAD_FRAC = 1e-5, 1e-4, 1e-5
# the int8 dispatch quantizes every row that crosses `data` (1 / 254 of
# its largest element at most) against a one rank that exchanges nothing
INT8_DISPATCH = dict(loss=1e-3, grad=2e-2)


def _mesh(cfg):
    if cfg.moe.n_experts:
        return MeshCtx(jax.make_mesh((1, 1), ("data", "model"),
                                     axis_types=(AxisType.Auto,) * 2))
    return local_mesh_ctx()


def _jax_model(arch, **kw):
    cfg = reduced_config(arch).with_updates(**W.F32, **kw)
    if cfg.moe.n_experts:
        cfg = cfg.with_updates(moe=replace(
            cfg.moe, capacity_factor=W.moe_cfg().moe.capacity_factor))
    lm = LM.build(cfg, _mesh(cfg))
    return lm, lm.init(jax.random.PRNGKey(0))


def _bridged(lm, params):
    tcfg = W.moe_cfg() if lm.cfg.moe.n_experts else \
        W.cfg_of(lm.cfg.arch_id)
    plan = TLM.build(tcfg, device="cpu").plan
    p = bridge.params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                 plan, device="cpu")
    o = bridge.opt_from_numpy(jax.tree.map(np.asarray,
                                           j_adamw_init(params)),
                              tcfg, plan, device="cpu")
    return p, o, plan


def _jax_run(lm, params, batches, steps, int8=False, grads_of=0):
    """The reference's jitted step on one device → {"hist", "grads",
    "params", "opt"} as _the worker's train_run."""
    tables = lm.default_tables()
    out = {}
    if grads_of is not None:
        def loss_fn(p, b):
            return lm.train_loss(p, b, tables=tables)[0]
        jb = jax.tree.map(jnp.asarray, batches[grads_of])
        loss, g = jax.jit(jax.value_and_grad(loss_fn))(params, jb)
        out["grads"] = (float(loss), g)
    step = jax.jit(j_make_train_step(lm, lr=W.LR, grad_compress_int8=int8))
    opt = j_adamw_init(params)
    hist = []
    for s in range(steps):
        params, opt, m = step(params, opt,
                              jax.tree.map(jnp.asarray, batches[s]), tables)
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    out.update(hist=hist, params=params, opt=opt)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_world")
    qlm, qparams = _jax_model("qwen2-1.5b")
    mlm, mparams = _jax_model("qwen2-moe-a2.7b", grad_accum=2)
    qp, qo, qplan = _bridged(qlm, qparams)
    mp_, mo, mplan = _bridged(mlm, mparams)
    V = qlm.cfg.vocab_size
    qb = [W.batch_np(V, 100 + s) for s in range(W.STEPS)]
    masked = [W.batch_np(V, 200, masked=True)]
    mb = [W.batch_np(mlm.cfg.vocab_size, 300 + s) for s in range(W.STEPS)]
    inputs = {"qwen2": qp, "qwen2_opt": qo, "qwen2_batches": qb,
              "qwen2_masked": masked, "moe": mp_, "moe_opt": mo,
              "moe_batches": mb, "batches_by_vocab": {V: qb}}
    torch.save(inputs, d / "inputs.pt")
    t0 = time.monotonic()
    procs = mp.start_processes(
        W.child, args=(str(d / "store"), str(d / "inputs.pt"), str(d)),
        nprocs=W.WORLD, join=False, start_method="spawn")
    # the JAX references, while the ranks run
    refs = {"a": _jax_run(qlm, qparams, qb, W.STEPS),
            "a_mask": _jax_run(qlm, qparams, masked, 1),
            "e": _jax_run(qlm, qparams, qb, 1, int8=True, grads_of=None),
            "b": _jax_run(mlm, mparams, mb, W.STEPS)}
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
    ranks = [torch.load(d / f"train_rank{r}.pt", weights_only=False)
             for r in range(W.WORLD)]
    for r, res in enumerate(ranks):
        assert "error" not in res, f"rank {r}: {res['error']}"
    return {"ranks": ranks, "refs": refs, "plans": {"qwen2": qplan,
                                                    "moe": mplan},
            "ckpt": d / "ckpt"}


def _leaves(tree, plan):
    return jax.tree.leaves(bridge.params_to_numpy(tree, plan))


def _close_to_max(got, want, frac, what):
    err = float(np.abs(got - want).max()) if got.size else 0.0
    lim = frac * float(np.abs(want).max()) + 1e-12
    assert err <= lim, f"{what}: max |diff| {err:.3g} > {lim:.3g}"


def _params_close(got, want, lr, steps):
    """tests/test_torch_training.py's rule: every element within 1e-5 but
    for at most 1e-4 of them, and those within steps · lr."""
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        d = np.abs(g - w)
        assert float(d.max()) <= steps * lr * 1.05
        assert (d > 1e-5).mean() <= 1e-4


def _same_on_every_rank(world, key):
    runs = [r[key] for r in world["ranks"]]
    for run in runs[1:]:
        assert run["hist"] == runs[0]["hist"]
    return runs[0]


# ---- the transposes ------------------------------------------------------
@pytest.mark.parametrize("name", [
    "psum_model", "enter_model", "rms_norm_over_model", "all_gather_model",
    "all_to_all_data", "all_to_all_rows", "all_gather_data", "psum_batch",
    "share_over_data"])
def test_collective_transpose(world, name):
    for r, res in enumerate(world["ranks"]):
        got, want = res["transposes"][name]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6,
                                   msg=f"rank {r} {name}")
        if name == "rms_norm_over_model":
            wrong = res["transposes"]["rms_norm_identity_transpose"]
            assert (wrong - want).abs().max() > 1e-3, \
                "an identity transpose of the sum of squares went unseen"


# ---- (a), (b), (e): against the JAX one-device step -----------------------
@pytest.mark.parametrize("case,plan", [("a", "qwen2"), ("a_mask", "qwen2"),
                                       ("b", "moe"), ("e", "qwen2")])
def test_steps_match_jax(world, case, plan):
    run, ref = _same_on_every_rank(world, case), world["refs"][case]
    plan = world["plans"][plan]
    for (tl, tn), (jl, jn) in zip(run["hist"], ref["hist"]):
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
        np.testing.assert_allclose(tn, jn, rtol=1e-3 if case == "e"
                                   else NORM_RTOL)
    steps = len(ref["hist"])
    got, want = _leaves(run["params"], plan), jax.tree.leaves(ref["params"])
    if case == "e":
        # an int8 level taken the other way moves an element by one step
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                       atol=1.1e-3)
    else:
        _params_close(got, want, W.LR, steps)
    assert int(run["opt"]["step"]) == int(ref["opt"]["step"]) == steps
    # one int8 level of |g| ≤ max|g| moves m = 0.1 g by 1 / 127 of its
    # largest and v = 0.05 g² by 2 / 127 of its largest
    frac = {"m": 1.01 / 127, "v": 2.02 / 127} if case == "e" else \
        {"m": 2e-3, "v": 2e-3}
    for name in ("m", "v"):
        for g, w in zip(_leaves(run["opt"][name], plan),
                        jax.tree.leaves(ref["opt"][name])):
            _close_to_max(g, np.asarray(w), frac[name], f"{case} {name}")


@pytest.mark.parametrize("case,plan", [("a", "qwen2"), ("b", "moe")])
def test_gradients_match_jax(world, case, plan):
    plan = world["plans"][plan]
    jloss, jg = world["refs"][case]["grads"]
    for res in world["ranks"]:
        loss, g = res[case]["grads"]
        np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
        got = jax.tree_util.tree_leaves_with_path(
            bridge.params_to_numpy(g, plan))
        want = jax.tree.leaves(jg)
        assert len(got) == len(want)
        for (path, a), b in zip(got, want):
            _close_to_max(a, np.asarray(b, np.float32), GRAD_FRAC,
                          f"{case} {jax.tree_util.keystr(path)}")


def test_train_loss_takes_the_ranks_rows(world):
    """`train_loss(local_rows=True)` on the rank's rows of the batch gives
    the loss of the global batch (the rows cut by `batch_rows`)."""
    for res in world["ranks"]:
        local, cut = res["a_local_rows"]
        assert local == cut


def test_mask_counts_differ_across_data_ranks(world):
    mask = W.batch_np(512, 200, masked=True)["mask"]
    half = W.B // 2
    assert mask[:half].sum() != mask[half:].sum()


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_over_ranks_bit_equal(world, policy):
    for res in world["ranks"]:
        want = res["a"]["grads"][1]
        got = res[f"remat_{policy}"]
        for a, b in zip(jax.tree.leaves(bridge.params_to_numpy(
                got, world["plans"]["qwen2"])),
                jax.tree.leaves(bridge.params_to_numpy(
                    want, world["plans"]["qwen2"]))):
            np.testing.assert_array_equal(a, b)


def test_moe_no_drops(world):
    """(b)'s capacity cut dropped nothing on any rank (the reference's one
    device and the ranks then route alike)."""
    assert all(r["b_drops"] == 0 for r in world["ranks"])


# ---- (b) int8 dispatch, (c), (d): against the port's one rank --------------
def _against_one_rank(world, case, loss_tol, grad_frac):
    one = world["ranks"][0][case + "_one"]
    plan = TLM.build(W.cfg_of({"b_int8": "qwen2-moe-a2.7b",
                               "c_granite": "granite-34b",
                               "c_qwen2": "qwen2-1.5b",
                               "d": "mamba2-130m"}[case]),
                     device="cpu").plan
    for res in world["ranks"]:
        run = res[case]
        (l, n), (ol, on) = run["hist"][0], one["hist"][0]
        np.testing.assert_allclose(l, ol, rtol=loss_tol)
        np.testing.assert_allclose(run["grads"][0], one["grads"][0],
                                   rtol=loss_tol)
        np.testing.assert_allclose(n, on, rtol=max(loss_tol, NORM_RTOL))
        got = jax.tree_util.tree_leaves_with_path(
            bridge.params_to_numpy(run["grads"][1], plan))
        want = _leaves(one["grads"][1], plan)
        for (path, a), b in zip(got, want):
            _close_to_max(a, b, grad_frac,
                          f"{case} {jax.tree_util.keystr(path)}")
    return one, plan


@pytest.mark.parametrize("case", ["c_granite", "c_qwen2", "d"])
def test_layouts_match_one_rank(world, case):
    one, plan = _against_one_rank(world, case, LOSS_RTOL, GRAD_FRAC)
    run = world["ranks"][0][case]
    _params_close(_leaves(run["params"], plan), _leaves(one["params"], plan),
                  W.LR, 1)


def test_wseq_shared_kv_head_gradient(world):
    """Under 'wseq' at tp 4 a KV head is read by several ranks: its wk / wv
    gradient is their sum (granite's one head over all four, qwen2's two
    heads each over a pair), equal to the one rank's."""
    for case in ("c_granite", "c_qwen2"):
        one = world["ranks"][0][case + "_one"]["grads"][1]
        run = world["ranks"][0][case]["grads"][1]
        for lo, lr_ in zip(one["layers"], run["layers"]):
            for k in ("wk", "wv", "bk", "bv"):
                if k in lo:
                    _close_to_max(lr_[k].numpy(), lo[k].numpy(), GRAD_FRAC,
                                  f"{case} {k}")


def test_replica_slots_keep_their_own_gradients(world):
    """Two replicas of an expert on two `data` ranks each take their
    tokens' gradient; summed over the replicas every expert's gradient
    equals the one rank's (reduced qwen3-moe-235b-a22b, one redundant slot
    a rank, experts 0 and 4 replicated)."""
    for res in world["ranks"]:
        rep = res["b_replicas"]
        np.testing.assert_allclose(rep["loss"], rep["one_loss"],
                                   rtol=LOSS_RTOL)
        assert all(rep["replicas_fed"])
        for got, want in zip(rep["experts"], rep["one_experts"]):
            assert got.keys() == want.keys() and got
            for k in got:
                _close_to_max(got[k].numpy(), want[k].numpy(), GRAD_FRAC,
                              f"replicas {k}")


def test_moe_int8_dispatch_against_one_rank(world):
    _against_one_rank(world, "b_int8", INT8_DISPATCH["loss"],
                      INT8_DISPATCH["grad"])


# ---- (f) a sharded save → an elastic restore ------------------------------
def _bit_equal(a, b):
    ta = jax.tree.leaves(jax.tree.map(np.asarray, a))
    tb = jax.tree.leaves(jax.tree.map(np.asarray, b))
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", ["a", "b"])
def test_sharded_save_restores_on_one_rank(world, case):
    """Each rank writes its own parts (a part several ranks hold, once);
    the one-rank restore assembles them: (a)'s state and (b)'s, whose
    expert slots land at their experts' one-rank slots."""
    cfg = W.cfg_of("qwen2-1.5b") if case == "a" else W.moe_cfg()
    one = TLM.build(cfg, device="cpu")
    shapes = one.shapes()
    d = world["ckpt"] if case == "a" else f"{world['ckpt']}_moe"
    state, step, extra = load_checkpoint(
        d, template={"params": shapes, "opt": adamw_init(shapes)})
    assert step == W.STEPS and extra == {"saved_tp": 2, "saved_ep": 2}
    saved = world["ranks"][0][case]
    plan = one.plan
    _bit_equal(bridge.params_to_numpy(state["params"], plan),
               bridge.params_to_numpy(saved["params"], plan))
    for k in ("m", "v"):
        _bit_equal(bridge.params_to_numpy(state["opt"][k], plan),
                   bridge.params_to_numpy(saved["opt"][k], plan))
    assert int(state["opt"]["step"]) == W.STEPS


def test_sharded_save_restores_on_tp4(world):
    plan = TLM.build(W.cfg_of("qwen2-1.5b"), device="cpu").plan
    for res in world["ranks"]:
        got, saved = res["f_restore41"], res["a"]
        assert got["step"] == W.STEPS
        # the rank holds its (tp 4, ep 1) part: one 'wseq' KV head
        assert got["shapes"]["wk"] == (128, 32)
        _bit_equal(bridge.params_to_numpy(got["params"], plan),
                   bridge.params_to_numpy(saved["params"], plan))
        for k in ("m", "v"):
            _bit_equal(bridge.params_to_numpy(got["opt"][k], plan),
                       bridge.params_to_numpy(saved["opt"][k], plan))


def test_launcher_preempts_and_resumes_over_ranks(tmp_path, capfd):
    from repro_torch.launch import train
    argv = ["--arch", "qwen2-1.5b", "--reduced", "--tp", "2", "--ep", "2",
            "--backend", "gloo", "--device", "cpu", "--batch", "4", "--seq",
            "32", "--steps", "4", "--log-every", "1", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2"]
    with pytest.raises(SystemExit) as exc:
        train.main(argv + ["--preempt-at", "2"])
    assert exc.value.code == 42
    assert (tmp_path / "step_00000002" / "manifest.json").exists()
    loss = train.main(argv)
    out = capfd.readouterr().out
    assert "simulated preemption at step 2" in out
    assert "resumed from step 2" in out
    assert out.count("step 3 loss") == 1       # rank 0 logs, once
    assert np.isfinite(loss)
