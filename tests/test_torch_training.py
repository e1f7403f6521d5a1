"""Training slice of the PyTorch port against the JAX reference, on the CPU.

- `cross_entropy` with and without a mask, and `chunked_attention` causal,
  windowed, sink+window and bidirectional with a GQA group of 2, equal the
  reference's within 1e-5 (float32; the reference goes blockwise with an
  online softmax, the port through the whole score matrix);
- `adamw_update` (in place) equals the reference's on random trees,
  float32 and bfloat16 moments, clip on and off: parameters and moments
  within 1e-6
  relative (float32; the bfloat16 moments within one bfloat16 step, 2^-8
  relative, where a float32 difference in the last bit can round either
  way);
- `synth_tokens` and `make_batch` equal the reference's element for
  element;
- `LM.train_loss` and every parameter's gradient equal `jax.value_and_grad`
  of the reference's on the bridged `LM.init(PRNGKey(0))` weights, float32,
  at the reduced configs of qwen2-1.5b, gemma3-4b (32-token windows under
  64-token sequences), qwen2-moe-a2.7b, mamba2-130m and jamba-1.5-large-398b
  (cut to its first period, 8 layers: one attention, four MoE and seven
  Mamba-2 layers; the MoE references on an Auto-axis mesh, ROADMAP C1):
  the loss within
  1e-5 relative, each gradient leaf within 2e-3 of its largest magnitude
  (two frameworks summing in different orders through a whole stack); the
  port's gradients with remat on ("nothing" and "dots") equal remat off
  bit for bit; the expert counts equal the reference's;
- three `make_train_step` steps follow the reference's jitted step: loss
  and gradient norm per step within 1e-4 relative, parameters after the
  steps within 1e-5 absolute but for at most 1e-4 of the elements, which
  stay within steps · lr (`_params_close`);
- grad accumulation (`grad_accum=2` against 1) within the reference's own
  `test_grad_accum_equivalent` tolerances, and int8 gradient compression
  against the reference's step and training as in its
  `test_int8_grad_compression_trains`;
- a train step over all ten architectures the port models (the
  reference's `test_train_step_smoke`), and an audio model's `train_loss`
  on frames against the reference's;
- train mode calls no kernel wrapper: every launch counter stays put and
  no `*_plain` twin runs.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest tests/test_torch_training.py -q
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import reduced_config
from repro.distributed.ctx import MeshCtx, local_mesh_ctx
from repro.models import LM
from repro.models import attention as jattn
from repro.models.common import cross_entropy as j_cross_entropy
from repro.training import data as jdata
from repro.training.optim import adamw_init as j_adamw_init
from repro.training.optim import adamw_update as j_adamw_update
from repro.training.trainer import make_train_step as j_make_train_step
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.kernels import _common as kcommon
from repro_torch.models import attention as tattn
from repro_torch.models.common import cross_entropy
from repro_torch.models.lm import LM as TLM
from repro_torch.training import data as tdata
from repro_torch.training.optim import adamw_init, adamw_update
from repro_torch.training.trainer import make_train_step, quantize_int8
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

torch.set_num_threads(2)

ARCHS = ("qwen2-1.5b", "gemma3-4b", "qwen2-moe-a2.7b", "mamba2-130m",
         "jamba-1.5-large-398b")
F32 = dict(compute_dtype="float32", param_dtype="float32")


def _mesh(cfg):
    if cfg.moe.n_experts:
        return MeshCtx(jax.make_mesh((1, 1), ("data", "model"),
                                     axis_types=(AxisType.Auto,) * 2))
    return local_mesh_ctx()


def _models(arch, **kw):
    """(reference LM, its params, port LM, bridged params)."""
    cfg = reduced_config(arch).with_updates(**kw)
    lm = LM.build(cfg, _mesh(cfg))
    params = lm.init(jax.random.PRNGKey(0))
    tlm = TLM.build(t_reduced_config(arch).with_updates(**kw), device="cpu")
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       tlm.cfg, tlm.plan, device="cpu")
    return lm, params, tlm, tparams


def _batches(cfg, seq, batch, step):
    dcfg = jdata.DataConfig(cfg.vocab_size, seq, batch)
    tdcfg = tdata.DataConfig(cfg.vocab_size, seq, batch)
    return (jdata.make_batch(cfg, dcfg, step),
            tdata.make_batch(cfg, tdcfg, step, device="cpu"))


def _close_to_max(got, want, frac, what):
    err = float(np.abs(got - want).max()) if got.size else 0.0
    lim = frac * float(np.abs(want).max()) + 1e-12
    assert err <= lim, f"{what}: max |diff| {err:.3g} > {lim:.3g}"


def _params_close(got, want, lr, steps):
    """Parameters after `steps` AdamW steps: every element within 1e-5 but
    for at most 1e-4 of them, and those within steps · lr — an element
    whose gradient is float32 cancellation noise (~1e-9) has an m / sqrt(v)
    of order one in either framework, of either sign, and Adam moves a
    parameter by at most ~lr a step."""
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w, np.float32)
        d = np.abs(g - w)
        assert float(d.max()) <= steps * lr * 1.05
        assert (d > 1e-5).mean() <= 1e-4


# ---- loss and attention ----------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (3, 7))
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = j_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                           None if mask is None else jnp.asarray(mask))
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_cross_entropy_all_masked_denominator():
    """max(sum(mask), 1): an all-zero mask gives 0, not NaN."""
    got = cross_entropy(torch.zeros(2, 3, 5), torch.zeros(2, 3,
                                                          dtype=torch.long),
                        torch.zeros(2, 3))
    assert float(got) == 0.0


@pytest.mark.parametrize("causal,window,sink", [
    (True, 0, 0), (True, 24, 0), (True, 16, 4), (False, 0, 0)])
def test_chunked_attention_matches_reference(causal, window, sink):
    rng = np.random.default_rng(window * 7 + sink + causal)
    B, S, H, K, h = 2, 64, 4, 2, 32
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, h), (B, S, K, h), (B, S, K, h)))
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   window=window, sink=sink, q_chunk=16,
                                   kv_chunk=16)
    got = tattn.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal,
                                  window=window, sink=sink)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---- AdamW -----------------------------------------------------------
@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_update_matches_reference(mdt, clip):
    rng = np.random.default_rng(5)
    shapes = {"a": (8, 16), "b": {"c": (5,), "d": (3, 4, 2)}}

    def tree(scale):
        return jax.tree.map(
            lambda s: rng.standard_normal(s).astype(np.float32) * scale,
            shapes, is_leaf=lambda s: isinstance(s, tuple))
    params, grads = tree(1.0), tree(3.0)
    as_j = lambda t: jax.tree.map(jnp.asarray, t)
    as_t = lambda t: jax.tree.map(lambda a: torch.from_numpy(a.copy()), t)
    jopt = j_adamw_init(as_j(params), mdt)
    topt = adamw_init(as_t(params), mdt)
    jp, tp = as_j(params), as_t(params)
    for step in range(3):
        g = tree(3.0) if step else grads
        jp, jopt, jn = j_adamw_update(as_j(g), jopt, jp, lr=1e-2,
                                      grad_clip=clip)
        got = adamw_update(as_t(g), topt, tp, lr=1e-2, grad_clip=clip)
        # in place: the same trees come back
        assert got[0] is tp and got[1] is topt
        np.testing.assert_allclose(float(got[2]), float(jn), rtol=1e-6)
    assert int(topt["step"]) == int(jopt["step"]) == 3
    for got, want in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    mom_tol = dict(rtol=1e-6, atol=1e-9) if mdt == "float32" else \
        dict(rtol=2 ** -8, atol=0)
    for name in ("m", "v"):
        for got, want in zip(tree_leaves(topt[name]),
                             jax.tree.leaves(jopt[name])):
            assert str(got.dtype).endswith(mdt)
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       **mom_tol)


# ---- data ------------------------------------------------------------
@pytest.mark.parametrize("copy_dist", [0, 8])
def test_synth_tokens_and_make_batch_match_reference(copy_dist):
    kw = dict(seed=3, copy_dist=copy_dist)
    jd = jdata.DataConfig(512, 48, 4, **kw)
    td = tdata.DataConfig(512, 48, 4, **kw)
    for step in (0, 17):
        np.testing.assert_array_equal(tdata.synth_tokens(td, step),
                                      jdata.synth_tokens(jd, step))
    cfg = reduced_config("qwen2-1.5b")
    want = jdata.make_batch(cfg, jd, 5)
    got = tdata.make_batch(t_reduced_config("qwen2-1.5b"), td, 5,
                           device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    it = tdata.batches(t_reduced_config("qwen2-1.5b"), td, 5, device="cpu")
    step, b = next(it)
    assert step == 5 and torch.equal(b["tokens"], got["tokens"])


# ---- LM.train_loss and its gradients ---------------------------------
@pytest.fixture(scope="module", params=ARCHS)
def grads(request):
    """The reference's loss, gradients and counts, and the port's with remat
    off, "nothing" and "dots", on one batch of 2 x 64 tokens."""
    arch = request.param
    # jamba's one period of 8 layers (attention, MoE and Mamba-2 layers)
    kw = dict(n_layers=8) if arch.startswith("jamba") else {}
    lm, params, tlm, tparams = _models(arch, **F32, **kw)
    jb, tb = _batches(lm.cfg, 64, 2, 0)
    tables = lm.default_tables()

    def loss_fn(p):
        return lm.train_loss(p, jb, tables=tables)
    (jloss, jaux), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    out = {"arch": arch, "jloss": float(jloss), "jgrads": jg, "jaux": jaux,
           "lm": lm, "port": {}}
    ttables = tlm.default_tables()
    for remat in ("off", "nothing", "dots"):
        cfg = tlm.cfg.with_updates(remat=remat != "off",
                                   remat_policy=remat)
        plm = TLM.build(cfg, device="cpu")
        req = [p.detach().clone().requires_grad_(True)
               for p in tree_leaves(tparams)]
        loss, aux = plm.train_loss(tree_unflatten(tparams, req), tb,
                                   tables=ttables)
        g = torch.autograd.grad(loss, req)
        out["port"][remat] = (float(loss.detach()), tree_unflatten(tparams, list(g)),
                              aux)
    out["plan"] = tlm.plan
    return out


def test_train_loss_matches_reference(grads):
    loss = grads["port"]["off"][0]
    np.testing.assert_allclose(loss, grads["jloss"], rtol=1e-5)
    assert 0 < loss < 50


def test_train_grads_match_reference(grads):
    got = bridge.params_to_numpy(grads["port"]["off"][1], grads["plan"])
    want = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        grads["jgrads"])
    gl = jax.tree_util.tree_leaves_with_path(got)
    wl = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        assert g.shape == w.shape, path
        _close_to_max(g, w, 2e-3, f"{grads['arch']} {jax.tree_util.keystr(path)}")
    # the router, the experts and the shared experts receive gradients
    # (none is cut off by a kernel)
    for layer in grads["port"]["off"][1]["layers"]:
        for k in ("router", "moe_w1", "moe_w2", "moe_w3", "shared_w1"):
            if k in layer:
                assert float(layer[k].abs().max()) > 0, k


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_gradients_bit_equal(grads, policy):
    off_loss, off_g, _ = grads["port"]["off"]
    loss, g, _ = grads["port"][policy]
    assert loss == off_loss
    for a, b in zip(tree_leaves(g), tree_leaves(off_g)):
        assert torch.equal(a, b)


def test_train_moe_counts_match_reference(grads):
    counts = grads["port"]["off"][2]["moe_counts"]
    jaux = grads["jaux"]
    if grads["lm"].cfg.moe.n_experts == 0:
        assert counts == []
        return
    # the reference's counts are period-position major ([n_rep, E] per
    # MoE position of the period), the port's in layer order
    plan = grads["plan"]
    moe_pos = [i for i, s in enumerate(plan.period) if s.use_moe]
    want = []
    for r in range(plan.n_rep):
        for j, _ in enumerate(moe_pos):
            want.append(np.asarray(jaux["period_counts"][j][r]))
    want += [np.asarray(c) for c in jaux["rem_counts"]]
    assert len(counts) == len(want)
    for got, w in zip(counts, want):
        np.testing.assert_array_equal(got.numpy(), w)


# ---- the train step --------------------------------------------------
def _step_pair(arch, lr, steps, int8=False, **kw):
    lm, params, tlm, tparams = _models(arch, **F32, **kw)
    jstep = jax.jit(j_make_train_step(lm, lr=lr, grad_compress_int8=int8))
    tstep = make_train_step(tlm, lr=lr, grad_compress_int8=int8)
    jopt = j_adamw_init(params, "float32")
    topt = bridge.opt_from_numpy(jax.tree.map(np.asarray, jopt), tlm.cfg,
                                 tlm.plan, device="cpu")
    tables, ttables = lm.default_tables(), tlm.default_tables()
    hist = []
    for s in range(steps):
        jb, tb = _batches(lm.cfg, 32, 4, s)
        params, jopt, jm = jstep(params, jopt, jb, tables)
        tparams, topt, tm = tstep(tparams, topt, tb, ttables)
        hist.append((float(tm["loss"]), float(jm["loss"]),
                     float(tm["grad_norm"]), float(jm["grad_norm"])))
    return params, jopt, tparams, topt, tlm, hist


def test_three_train_steps_follow_reference():
    params, jopt, tparams, topt, tlm, hist = _step_pair("qwen2-1.5b", 1e-3,
                                                        3)
    for tl, jl, tn, jn in hist:
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        np.testing.assert_allclose(tn, jn, rtol=1e-4)
    assert hist[-1][0] < hist[0][0]
    _params_close(bridge.params_to_numpy(tparams, tlm.plan), params, 1e-3, 3)
    assert int(topt["step"]) == int(jopt["step"]) == 3
    gm = bridge.params_to_numpy(topt["m"], tlm.plan)
    for g, w in zip(jax.tree.leaves(gm), jax.tree.leaves(jopt["m"])):
        _close_to_max(g, np.asarray(w), 2e-3, "m")


def test_grad_accum_equivalent():
    """The reference's test_grad_accum_equivalent on the port: accum 2
    against 1 on one batch, float32, remat off."""
    cfg = t_reduced_config("qwen2-1.5b").with_updates(remat=False, **F32)
    lm1 = TLM.build(cfg, device="cpu")
    lm2 = TLM.build(cfg.with_updates(grad_accum=2), device="cpu")
    params = lm1.init(0)
    p1 = tree_map(torch.clone, params)
    p2 = tree_map(torch.clone, params)
    batch = tdata.make_batch(cfg, tdata.DataConfig(cfg.vocab_size, 32, 4), 0,
                             device="cpu")
    p1, _, m1 = make_train_step(lm1)(p1, adamw_init(p1), batch)
    p2, _, m2 = make_train_step(lm2)(p2, adamw_init(p2), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=2e-5)


def test_grad_accum_matches_reference():
    """grad_accum=2 against the reference's scan over microbatches."""
    params, jopt, tparams, topt, tlm, hist = _step_pair(
        "qwen2-1.5b", 1e-3, 2, grad_accum=2)
    for tl, jl, tn, jn in hist:
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        np.testing.assert_allclose(tn, jn, rtol=1e-4)
    _params_close(bridge.params_to_numpy(tparams, tlm.plan), params, 1e-3, 2)


def test_int8_compression_matches_reference():
    """One int8-compressed step against the reference's: the loss before
    the update is equal; a gradient element whose g / scale lands within
    float32 noise of a rounding midpoint can take the other int8 level, so
    the gradient norm is held to 1e-3 and the parameters to one step of
    lr."""
    params, _, tparams, _, tlm, hist = _step_pair("qwen2-1.5b", 1e-3, 1,
                                                  int8=True)
    tl, jl, tn, jn = hist[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tn, jn, rtol=1e-3)
    got = bridge.params_to_numpy(tparams, tlm.plan)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1.1e-3)


def test_quantize_int8_matches_reference_formula():
    """The reference's quantize (max-abs scale / 127, round half to even,
    clip at ±127), evaluated eagerly, bit for bit, float32 and bfloat16."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, 33)).astype(np.float32) * 1e-2
    x[0, :4] = [0.5, -0.5, 1.5, 2.5]
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        g = jnp.asarray(x, jdt)
        scale = jnp.maximum(jnp.max(jnp.abs(g)), 1e-9) / 127.0
        q = jnp.clip(jnp.round(g / scale), -127, 127).astype(jnp.int8)
        want = q.astype(jnp.float32) * scale
        got = quantize_int8(torch.from_numpy(x).to(tdt))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_grad_compression_trains():
    """The reference's test_int8_grad_compression_trains on the port."""
    cfg = t_reduced_config("qwen2-1.5b")
    lm = TLM.build(cfg, device="cpu")
    params = lm.init(0)
    opt = adamw_init(params, cfg.optimizer_dtype)
    step = make_train_step(lm, lr=1e-3, grad_compress_int8=True)
    dcfg = tdata.DataConfig(cfg.vocab_size, 32, 4)
    losses = []
    for i in range(8):
        params, opt, m = step(params, opt, tdata.make_batch(cfg, dcfg, i,
                                                            device="cpu"))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_smoke(arch):
    """The reference's test_train_step_smoke on the port's ten
    architectures, at their reduced configs (bfloat16 as registered)."""
    cfg = t_reduced_config(arch)
    lm = TLM.build(cfg, device="cpu")
    params = lm.init(0)
    before = [p.clone() for p in tree_leaves(params)]
    batch = tdata.make_batch(cfg, tdata.DataConfig(cfg.vocab_size, 64, 2), 0,
                             device="cpu")
    step = make_train_step(lm, lr=1e-3)
    params, _, m = step(params, adamw_init(params, cfg.optimizer_dtype),
                        batch, lm.default_tables())
    loss = float(m["loss"])
    assert np.isfinite(loss) and 0 < loss < 50
    moved = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(tree_leaves(params), before))
    assert moved > 0


def test_train_mode_calls_no_kernel(monkeypatch):
    """A train step with attention, MoE and Mamba-2 layers (reduced jamba)
    reaches no kernel wrapper: the launch counters stay put and no plain
    twin runs (every `*_plain` and the MoE's `moe_gmm` raise here)."""
    import importlib

    def boom(*a, **k):
        raise AssertionError("a kernel path ran in train mode")
    for m, _, _ in kcommon.LAUNCH_COUNTERS:
        mod = importlib.import_module(f"repro_torch.kernels.{m}")
        for name in dir(mod):
            if name.endswith("_plain"):
                monkeypatch.setattr(mod, name, boom)
    from repro_torch.models import moe as tmoe
    monkeypatch.setattr(tmoe, "moe_gmm", boom)
    before = kcommon.launch_counts()
    for arch in ("jamba-1.5-large-398b", "gemma3-4b"):
        cfg = t_reduced_config(arch).with_updates(remat=True)
        lm = TLM.build(cfg, device="cpu")
        params = lm.init(0)
        batch = tdata.make_batch(cfg, tdata.DataConfig(cfg.vocab_size, 48,
                                                       2), 0, device="cpu")
        _, _, m = make_train_step(lm)(params, adamw_init(params), batch,
                                      lm.default_tables())
        assert np.isfinite(float(m["loss"]))
    assert kcommon.launch_counts() == before


def test_frontend_batches_refused():
    """Frames are no longer refused: an audio model's `train_loss` on the
    reference's frames batch equals the reference's (float32, 1e-5
    relative; every gradient in tests/test_torch_frontends_train.py)."""
    lm, params, tlm, tparams = _models("hubert-xlarge", **F32)
    jb, tb = _batches(lm.cfg, 32, 2, 0)
    assert "frames" in tb and "tokens" not in tb
    jloss, _ = lm.train_loss(params, jb)
    loss, _ = tlm.train_loss(tparams, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
