"""Mamba-2 SSD layers in the PyTorch port (the SSM and hybrid stacks),
against the JAX reference.

- the registry holds the reference's mamba2-130m and jamba-1.5-large-398b,
  full and reduced, and both build on the CPU;
- `segsum`, `ssd_chunked` (with and without an initial state, S a multiple
  of the chunk and not), `ssd_decode_step` and `causal_conv` (with and
  without a cache) equal `repro.models.ssd` on the same numpy-seeded
  inputs within 1e-4 (float32);
- `mamba_sublayer` in a padded prefill, a padded prefill continued from a
  cache and a decode step equals the reference's within 1e-4, its new
  entry too;
- the parameter schema is the reference's `mamba_defs`, and the bridge
  carries those leaves unchanged;
- `LM` logits of chunked paged prefill (a chunk ending mid-block, full
  chunks, a padded tail) and paged decode, and of whole-prompt prefill and
  slot-dense decode, equal the JAX `LM`'s within TOL (2e-3) on the bridged
  `LM.init(PRNGKey(0))` weights — reduced mamba2-130m, reduced jamba with
  every attention layer full and, whole-prompt, under its default pattern
  (the attention layers compressed to sink+recent rings);
- QuantPlane degrades to off on mamba2 in both packages and quantizes
  jamba's attention layer.
Jamba's reference is built on an Auto-axis mesh (its MoE decode needs one on
this jax; ROADMAP C1).

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest tests/test_torch_ssm.py -q
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_config, reduced_config
from repro.distributed.ctx import MeshCtx, local_mesh_ctx
from repro.models import LM
from repro.models import ssd as jssd
from repro.models import stack as jstack
from repro.serving.quant import QuantConfig, QuantController
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.models import ssd as tssd
from repro_torch.models import stack as tstack
from repro_torch.models.lm import LM as TLM
from repro_torch.serving.quant import QuantConfig as TQuantConfig
from repro_torch.serving.quant import QuantController as TQuantController

torch.set_num_threads(2)

TOL = dict(rtol=2e-3, atol=2e-3)
SSD_TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("mamba2-130m", "jamba-1.5-large-398b")


def _mesh(cfg):
    if cfg.moe.n_experts:
        return MeshCtx(jax.make_mesh((1, 1), ("data", "model"),
                                     axis_types=(AxisType.Auto,) * 2))
    return local_mesh_ctx()


def _cfgs(arch):
    kw = dict(compute_dtype="float32", param_dtype="float32")
    return (reduced_config(arch).with_updates(**kw),
            t_reduced_config(arch).with_updates(**kw))


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_holds_reference_config(arch):
    assert dataclasses.asdict(t_get_config(arch)) == \
        dataclasses.asdict(get_config(arch))
    assert dataclasses.asdict(t_reduced_config(arch)) == \
        dataclasses.asdict(reduced_config(arch))
    for cfg in (t_get_config(arch), t_reduced_config(arch)):
        for pattern in (None, [0] * cfg.n_layers):
            tlm = TLM.build(cfg, pattern=pattern, device="cpu")
            jplan = jstack.StackPlan.from_config(cfg, pattern)
            assert tlm.plan.all_specs() == jplan.all_specs()


# ---- the SSD functions -------------------------------------------------
def _ssd_inputs(S, seed, B=2, H=3, P=4, N=5):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(x=rng.standard_normal((B, S, H, P)).astype(f),
                dt=(0.3 * np.abs(rng.standard_normal((B, S, H)))).astype(f),
                A=-np.abs(rng.standard_normal(H)).astype(f) - 0.1,
                Bm=rng.standard_normal((B, S, N)).astype(f),
                Cm=rng.standard_normal((B, S, N)).astype(f),
                init=rng.standard_normal((B, H, P, N)).astype(f))


def test_segsum_matches_reference():
    a = np.random.default_rng(1).standard_normal((2, 3, 7)).astype(
        np.float32)
    want = np.asarray(jssd.segsum(jnp.asarray(a)))
    got = tssd.segsum(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **SSD_TOL)


@pytest.mark.parametrize("S,chunk", [(64, 16), (40, 16), (24, 32), (7, 4)],
                         ids=["multiple", "halved", "one_chunk", "odd"])
@pytest.mark.parametrize("initial", [False, True], ids=["zero", "state"])
def test_ssd_chunked_matches_reference(S, chunk, initial):
    d = _ssd_inputs(S, seed=S + chunk)
    init = d["init"] if initial else None
    args = [d[k] for k in ("x", "dt", "A", "Bm", "Cm")]
    jy, js = jssd.ssd_chunked(*map(jnp.asarray, args), chunk,
                              None if init is None else jnp.asarray(init))
    ty, ts = tssd.ssd_chunked(*map(torch.from_numpy, args), chunk,
                              None if init is None else
                              torch.from_numpy(init))
    assert ty.dtype == torch.float32 and ts.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SSD_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **SSD_TOL)
    assert tssd.chunk_size(S, chunk) == {64: 16, 40: 8, 24: 24, 7: 1}[S]


def test_ssd_decode_step_matches_reference():
    d = _ssd_inputs(1, seed=3)
    args = (d["init"], d["x"][:, 0], d["dt"][:, 0], d["A"], d["Bm"][:, 0],
            d["Cm"][:, 0])
    jy, js = jssd.ssd_decode_step(*map(jnp.asarray, args))
    ty, ts = tssd.ssd_decode_step(*map(torch.from_numpy, args))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SSD_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **SSD_TOL)
    # a chunked call over one token from the same state is the same step
    cy, cs = tssd.ssd_chunked(*map(torch.from_numpy, (
        d["x"], d["dt"], d["A"], d["Bm"], d["Cm"])), 4,
        torch.from_numpy(d["init"]))
    np.testing.assert_allclose(cy[:, 0].numpy(), ty.numpy(), **SSD_TOL)
    np.testing.assert_allclose(cs.numpy(), ts.numpy(), **SSD_TOL)


@pytest.mark.parametrize("cached", [False, True], ids=["zeros", "cache"])
def test_causal_conv_matches_reference(cached):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    cache = rng.standard_normal((2, 3, 6)).astype(np.float32) \
        if cached else None
    jy, jc = jssd.causal_conv(jnp.asarray(x), jnp.asarray(w),
                              None if cache is None else jnp.asarray(cache))
    ty, tc = tssd.causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                              None if cache is None else
                              torch.from_numpy(cache))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SSD_TOL)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


# ---- the Mamba sublayer and its parameters ------------------------------
def _layer_params(cfg, seed):
    """One mamba layer's parameters from the port's schema, every leaf
    random (A_log, D_skip, dt_bias too), as numpy."""
    tlm = TLM.build(cfg, pattern=None, device="cpu")
    rng = np.random.default_rng(seed)
    defs = tlm.param_defs()["layers"][0]
    out = {}
    for name in ("ln_attn", "w_z", "w_x", "w_bc", "w_dt", "dt_bias",
                 "conv_x", "conv_bc", "A_log", "D_skip", "ssm_norm",
                 "out_proj"):
        shp = defs[name][0]
        scale = 0.3 if name in ("w_z", "w_x", "w_bc", "w_dt", "conv_x",
                                "conv_bc") else 0.1
        base = 1.0 if name in ("ln_attn", "ssm_norm", "A_log",
                               "D_skip") else 0.0
        out[name] = (base + scale * rng.standard_normal(shp)).astype(
            np.float32)
    return out


def _mamba_cache(cfg, B, seed):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal(shp).astype(np.float32)
            for n, (shp, _) in tstack.mamba_cache_shapes(cfg, B).items()}


@pytest.mark.parametrize("case", ["prefill_padded", "resume_padded",
                                  "resume_full", "decode"])
def test_mamba_sublayer_matches_reference(case):
    cfg, tcfg = _cfgs("mamba2-130m")
    p = _layer_params(tcfg, seed=7)
    B, S, tl, mode = {"prefill_padded": (1, 40, 29, "prefill"),
                      "resume_padded": (1, 16, 11, "prefill"),
                      "resume_full": (1, 16, 16, "prefill"),
                      "decode": (3, 1, None, "decode")}[case]
    rng = np.random.default_rng(len(case))
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    cache = None if case == "prefill_padded" else _mamba_cache(tcfg, B, 9)
    jx, jc = jstack.mamba_sublayer(
        cfg, local_mesh_ctx(), jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        mode=mode, cache=None if cache is None else
        jax.tree.map(jnp.asarray, cache), batch_part=None,
        true_len=None if tl is None else jnp.int32(tl))
    tcache = None if cache is None else \
        {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tx, entry = tstack.mamba_sublayer(
        tcfg, {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(x), mode=mode, cache=tcache,
        true_len=None if tl is None else torch.tensor(tl))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **SSD_TOL)
    if cache is None:
        assert tcache is None and entry is not None
        tcache = entry
    else:
        assert entry is None                # updated in place
    np.testing.assert_allclose(tcache["state"].numpy(),
                               np.asarray(jc["state"]), **SSD_TOL)
    for name in ("conv_x", "conv_bc"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jc[name]), **SSD_TOL,
                                   err_msg=name)
    with pytest.raises(NotImplementedError):
        tstack.mamba_sublayer(tcfg, {k: torch.from_numpy(v)
                                     for k, v in p.items()},
                              torch.from_numpy(x), mode="verify",
                              cache=tcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_defs_match_reference(arch):
    """The port's schema is the reference's: mamba layers carry
    `mamba_defs` (same shapes, dtypes and init kinds), jamba's MoE layers
    the experts and the other layers the dense FFN."""
    for full in (True, False):
        cfg = (t_get_config if full else t_reduced_config)(arch)
        tlm = TLM.build(cfg, pattern=None, device="cpu")
        plan = jstack.StackPlan.from_config(cfg, None)
        mesh = _mesh(cfg)
        for spec, tdefs in zip(plan.all_specs(),
                               tlm.param_defs()["layers"]):
            jdefs = jstack.layer_defs(cfg, mesh, spec)
            assert tdefs.keys() == jdefs.keys(), spec
            for name, jd in jdefs.items():
                shp, init, dt = tdefs[name]
                assert tuple(shp) == tuple(jd.shape), name
                assert dt == jd.dtype, name
                want = "ones" if jd.ones else (
                    "zeros" if jd.scale == 0.0 else f"normal:{jd.scale}")
                assert init == want, name


_MODELS: dict = {}


def _models(arch, pattern="full"):
    """(JAX LM, its params, port LM, bridged params), once per arch and
    pattern ("full": every attention layer full; None: the default)."""
    key = (arch, pattern)
    if key not in _MODELS:
        cfg, tcfg = _cfgs(arch)
        pat = [0] * cfg.n_layers if pattern == "full" else None
        lm = LM.build(cfg, _mesh(cfg), pattern=pat)
        params = lm.init(jax.random.PRNGKey(0))
        tlm = TLM.build(tcfg, pattern=pat, device="cpu")
        tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                           tcfg, tlm.plan, device="cpu")
        _MODELS[key] = lm, params, tlm, tparams
    return _MODELS[key]


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_mamba_leaves(arch):
    lm, params, tlm, tparams = _models(arch)
    specs = tlm.plan.all_specs()
    assert len(tparams["layers"]) == len(specs)
    jlayers = jstack.unstack_params(lm.plan, params["stack"])
    for spec, tl, jl in zip(specs, tparams["layers"], jlayers):
        assert tl.keys() == jl.keys()
        if spec.kind == "mamba":
            assert "w_z" in tl and "wq" not in tl
        for name, v in jl.items():
            np.testing.assert_array_equal(tl[name].numpy(), np.asarray(v))


def _layer_entries(plan, jcache):
    """The reference's cache entries in layer order (period entries are
    stacked [n_rep, ...])."""
    out = []
    for r in range(plan.n_rep):
        for e in jcache["period"]:
            out.append(None if e is None else
                       {k: np.asarray(v)[r] for k, v in e.items()})
    return out + [None if e is None else
                  {k: np.asarray(v) for k, v in e.items()}
                  for e in jcache["rem"]]


def layer_order(counts, plan):
    """The reference's per-MoE-layer counts [L_moe, E] — period positions
    major (each position's n_rep repeats together), then the remainder — in
    layer order, the port's (repeat major)."""
    n_pos = sum(1 for sp in plan.period if sp.use_moe)
    idx = [j * plan.n_rep + r for r in range(plan.n_rep)
           for j in range(n_pos)]
    return np.concatenate([counts[idx], counts[n_pos * plan.n_rep:]])


def _counts(jaux, plan):
    return layer_order(np.concatenate(
        [np.asarray(c).reshape(-1, c.shape[-1])
         for c in jaux["period_counts"]]
        + [np.asarray(c)[None] for c in jaux["rem_counts"]]), plan)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_prefill_and_decode_logits_match(arch):
    lm, params, tlm, tparams = _models(arch)
    cfg, tcfg = lm.cfg, tlm.cfg
    max_len, N, bs, chunk = 96, 32, 8, 16
    nb = max_len // bs
    rng = np.random.default_rng(len(arch))
    prompt = rng.integers(0, cfg.vocab_size, 5 + 2 * chunk + 3).tolist()
    row = np.zeros((1, nb), np.int32)
    row[0] = rng.permutation(np.arange(1, N))[:nb]
    tbl_j, tbl_t = jnp.asarray(row), torch.from_numpy(row)
    jtab, ttab = lm.default_tables(), tlm.default_tables()
    jcache = jstack.merge_arena_cache(
        cfg, lm.plan,
        jstack.alloc_prefill_private_cache(cfg, lm.mesh, lm.plan, max_len),
        jstack.alloc_arena_kv(cfg, lm.mesh, lm.plan, N, bs))
    tcache = tstack.merge_arena_cache(
        tcfg, tlm.plan,
        tstack.alloc_prefill_private_cache(tcfg, tlm.plan, max_len, "cpu"),
        tstack.alloc_arena_kv(tcfg, tlm.plan, N, bs, "cpu"))
    jprefill = jax.jit(lambda p, t, c, cl, bt, tb: lm.prefill_resume(
        p, {"tokens": t}, c, max_len=max_len, chunk_len=cl,
        block_tables=bt, tables=tb)[:2])
    cur = 0
    for cl in (5, chunk, chunk, 3):
        toks = prompt[cur:cur + cl] + [0] * (chunk - cl)
        jcache, jl = jprefill(params, jnp.asarray([toks], jnp.int32), jcache,
                              jnp.int32(cl), tbl_j, jtab)
        tcache, tl, _ = tlm.prefill_resume(
            tparams, torch.tensor([toks], dtype=torch.int32), tcache,
            chunk_len=cl, block_tables=tbl_t, tables=ttab)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        cur += cl
    assert tcache["pos"] == cur == int(jcache["pos"])
    jdecode = jax.jit(lambda p, c, t, pos, bt, tb: lm.decode(
        p, c, t, pos, block_tables=bt, tables=tb,
        token_mask=jnp.ones((1,), bool)))
    tok = int(np.argmax(np.asarray(jl)[0]))
    for _ in range(3):
        jcache, jl, jaux = jdecode(params, jcache,
                                   jnp.asarray([[tok]], jnp.int32),
                                   jnp.asarray([[cur]], jnp.int32), tbl_j,
                                   jtab)
        tcache, tl, aux = tlm.decode(
            tparams, tcache, torch.tensor([[tok]], dtype=torch.int32),
            torch.tensor([[cur]], dtype=torch.int32), block_tables=tbl_t,
            tables=ttab, token_mask=torch.ones(1, dtype=torch.bool))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        if cfg.moe.n_experts:
            np.testing.assert_array_equal(
                torch.stack(aux["moe_counts"]).numpy(),
                _counts(jaux, lm.plan))
        tok = int(np.argmax(np.asarray(jl)[0]))
        cur += 1
    # the recurrent entries the chunks and steps left, layer by layer
    for spec, te, je in zip(tlm.plan.all_specs(), tcache["layers"],
                            _layer_entries(lm.plan, jcache)):
        if spec.kind != "mamba":
            continue
        assert te["state"].dtype == torch.float32
        for name in ("state", "conv_x", "conv_bc"):
            np.testing.assert_allclose(te[name].numpy(), np.asarray(je[name]),
                                       **TOL, err_msg=name)


@pytest.mark.parametrize("arch,pattern", [
    ("mamba2-130m", "full"), ("jamba-1.5-large-398b", "full"),
    ("jamba-1.5-large-398b", None)], ids=["mamba2", "jamba_full",
                                          "jamba_default"])
def test_whole_prompt_prefill_and_dense_decode_logits_match(arch, pattern):
    """Whole-prompt prefill (a padded prompt: the state frozen across the
    padding) into dense caches, then slot-dense decode steps — under
    jamba's default pattern through its sink+recent rings."""
    lm, params, tlm, tparams = _models(arch, pattern)
    cfg = lm.cfg
    max_len, n = 64, 37
    rng = np.random.default_rng(len(arch) + 1)
    toks = rng.integers(0, cfg.vocab_size, n).tolist() + [0] * 3
    jtab, ttab = lm.default_tables(), tlm.default_tables()
    jcache, jl, _ = jax.jit(lambda p, t, tb: lm.prefill(
        p, {"tokens": t}, max_len=max_len, tables=tb, true_len=n))(
        params, jnp.asarray([toks], jnp.int32), jtab)
    tcache, tl, _ = tlm.prefill(tparams, torch.tensor([toks],
                                                      dtype=torch.int32),
                                max_len=max_len, true_len=n, tables=ttab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    tok, cur = int(np.argmax(np.asarray(jl)[0])), n
    jdecode = jax.jit(lambda p, c, t, pos, tb: lm.decode(
        p, c, t, pos, tables=tb, token_mask=jnp.ones((1,), bool)))
    for _ in range(3):
        jcache, jl, jaux = jdecode(params, jcache,
                                   jnp.asarray([[tok]], jnp.int32),
                                   jnp.asarray([[cur]], jnp.int32), jtab)
        tcache, tl, aux = tlm.decode(
            tparams, tcache, torch.tensor([[tok]], dtype=torch.int32),
            torch.tensor([[cur]], dtype=torch.int32), tables=ttab,
            token_mask=torch.ones(1, dtype=torch.bool))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        if cfg.moe.n_experts:
            np.testing.assert_array_equal(
                torch.stack(aux["moe_counts"]).numpy(),
                _counts(jaux, lm.plan))
        tok = int(np.argmax(np.asarray(jl)[0]))
        cur += 1


@pytest.mark.parametrize("arch", ARCHS)
def test_quant_controller_matches_reference(arch):
    """int8 arenas quantize the full-attention layers only: none on mamba2
    (quant off, in both packages), jamba's one attention layer in every
    eight."""
    cfg, tcfg = _cfgs(arch)
    pat = [0] * cfg.n_layers
    jq = QuantController.from_model(
        cfg, jstack.StackPlan.from_config(cfg, pat), QuantConfig(), 8)
    tq = TQuantController.from_model(
        tcfg, tstack.StackPlan.from_config(tcfg, pat), TQuantConfig(), 8)
    if arch == "mamba2-130m":
        assert jq is None and tq is None
    else:
        assert dataclasses.asdict(tq.plan) == dataclasses.asdict(jq.plan)
        assert tq.plan.n_quant_layers == cfg.n_layers // cfg.attn_period
