"""MoE slice of the PyTorch port against the JAX reference: the moe_gmm
kernel's plain version, the router, the one-device `moe_ffn` dispatch and
whole-model logits of reduced qwen2-moe, on the same inputs (numpy from a
seed, or the reference's `LM.init` weights bridged through numpy). The
reference is built on an Auto-axis mesh (its MoE decode needs one on this
jax; ROADMAP C1)."""
import dataclasses
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import reduced_config
from repro.distributed.ctx import MeshCtx
from repro.kernels import ref as jref
from repro.kernels.moe_gmm import moe_gmm as pallas_moe_gmm
from repro.models import LM
from repro.models import moe as jmoe
from repro.models import stack as jstack
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_plain
from repro_torch.models import moe as tmoe
from repro_torch.models import stack as tstack
from repro_torch.models.lm import LM as TLM

torch.set_num_threads(2)

# f32 logits through two stacks summing in different orders
# (tests/test_consistency.py:40)
TOL = dict(rtol=2e-3, atol=2e-3)
ARCHS = ("qwen3-moe-235b-a22b", "qwen2-moe-a2.7b")


def auto_mesh():
    return MeshCtx(jax.make_mesh((1, 1), ("data", "model"),
                                 axis_types=(AxisType.Auto,) * 2))


def _to_port(cfg):
    """The reference's config as the port's dataclasses (the port registers
    only the architectures it serves at full size)."""
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = getattr(tbase, type(v).__name__)(**dataclasses.asdict(v))
        kw[f.name] = v
    return tbase.ModelConfig(**kw)


def _cfgs(arch, **kw):
    cfg = reduced_config(arch).with_updates(
        compute_dtype="float32", param_dtype="float32", **kw)
    return cfg, _to_port(cfg)


# ---- moe_gmm ---------------------------------------------------------
@pytest.mark.parametrize("s,C,D,F", [(2, 32, 64, 48), (4, 64, 128, 96),
                                     (1, 16, 32, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gmm_plain_matches_reference_and_pallas(s, C, D, F, dtype):
    """The tests/test_kernels.py sweep, n_valid edges 0 and C included."""
    rng = np.random.default_rng(s * C)
    x = rng.standard_normal((s, C, D)).astype(np.float32)
    w = rng.standard_normal((s, D, F)).astype(np.float32)
    nv = rng.integers(0, C + 1, s).astype(np.int32)
    nv[0] = 0
    nv[-1] = C if s > 1 else nv[-1]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    got = moe_gmm(tx, tw, torch.from_numpy(nv))
    assert got.dtype == tdt and got.shape == (s, C, F)
    got = got.float().numpy()
    tol = 1e-4 if dtype == "float32" else 3e-2
    want = np.asarray(jref.moe_gmm_ref(jx, jw, jnp.asarray(nv)), np.float32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    interp = np.asarray(pallas_moe_gmm(jx, jw, jnp.asarray(nv), block_c=16,
                                       block_f=16, block_d=32,
                                       interpret=True), np.float32)
    np.testing.assert_allclose(got, interp, rtol=tol, atol=tol)
    for i in range(s):
        assert not got[i, nv[i]:].any()       # invalid rows exactly zero


def test_moe_gmm_invalid_rows_masked():
    got = moe_gmm(torch.ones((1, 8, 16)), torch.ones((1, 16, 8)),
                  torch.tensor([3]))
    assert float(got[0, 2].sum()) == 16 * 8
    assert float(got[0, 3:].abs().sum()) == 0.0
    np.testing.assert_array_equal(
        moe_gmm_plain(torch.ones((1, 8, 16)), torch.ones((1, 16, 8)),
                      torch.tensor([3])).numpy(), got.numpy())


# ---- router ----------------------------------------------------------
def _router_inputs(cfg, seed, ties):
    rng = np.random.default_rng(seed)
    D, E = cfg.d_model, cfg.moe.n_experts
    x = rng.standard_normal((16, D)).astype(np.float32)
    rw = (rng.standard_normal((D, E)) * 0.1).astype(np.float32)
    if ties:
        # experts 1, 3 and 5 score exactly 0 for the positive rows, every
        # other expert below 0: their probabilities tie at the top
        x[:8] = np.abs(x[:8])
        rw = -np.abs(rw)
        rw[:, [1, 3, 5]] = 0.0
    return x, rw


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("ties", [False, True])
def test_router_matches_reference(arch, ties):
    cfg, tcfg = _cfgs(arch)
    x, rw = _router_inputs(cfg, 3, ties)
    jg, ji, jp = jmoe.router(cfg, jnp.asarray(x), jnp.asarray(rw))
    tg, ti, tp = tmoe.router(tcfg, torch.from_numpy(x), torch.from_numpy(rw))
    probs = np.asarray(jp)
    srt = -np.sort(-probs, axis=-1)
    k = cfg.moe.top_k
    margin = float((srt[:, k - 1] - srt[:, k]).min())
    np.testing.assert_array_equal(
        ti.numpy(), np.asarray(ji),
        err_msg=f"routed experts differ; smallest top-k margin {margin:.3g}")
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tp.numpy(), probs, rtol=1e-6, atol=1e-6)
    if ties:
        assert (ti.numpy()[:8] == [1, 3][:k]).all()


# ---- moe_ffn ---------------------------------------------------------
def _ffn_inputs(cfg, seed, T, shared):
    rng = np.random.default_rng(seed)
    E, Fe, D = cfg.moe.n_experts, cfg.moe.d_ff_expert, cfg.d_model
    x = rng.standard_normal((T, D)).astype(np.float32)
    rw = (rng.standard_normal((D, E)) * 0.1).astype(np.float32)
    cw = [(rng.standard_normal(shp) * 0.05).astype(np.float32)
          for shp in ((E, D, Fe), (E, D, Fe), (E, Fe, D))]
    sh = None
    if shared:
        Fsh = cfg.moe.n_shared_experts * Fe
        sh = [(rng.standard_normal(shp) * 0.05).astype(np.float32)
              for shp in ((D, Fsh), (D, Fsh), (Fsh, D))]
    mask = rng.random(T) < 0.7
    return x, rw, cw, sh, mask


@pytest.mark.parametrize("arch,cf,chunk", [
    ("qwen3-moe-235b-a22b", 8.0, 256),
    ("qwen2-moe-a2.7b", 8.0, 256),
    ("qwen3-moe-235b-a22b", 0.25, 256),        # capacity drops
    ("qwen2-moe-a2.7b", 0.5, 32)])             # drops, 3 chunks of 16
def test_moe_ffn_matches_reference(arch, cf, chunk):
    cfg, tcfg = _cfgs(arch, moe_token_chunk=chunk)
    cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=cf))
    tcfg = replace(tcfg, moe=replace(tcfg.moe, capacity_factor=cf))
    mesh = auto_mesh()
    shared = bool(cfg.moe.n_shared_experts)
    x, rw, cw, sh, mask = _ffn_inputs(cfg, 5, 48, shared)
    E = cfg.moe.n_experts
    s = jmoe.default_slot_count(cfg, 1)
    place = jmoe.round_robin_placement(E, 1, s)
    jt = jmoe.tables_from_placement(place, s)
    tt = tmoe.tables_from_placement(place, s)
    for k in jt:
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]))
    jslots = [jmoe.slots_from_canonical(jnp.asarray(c), jt["slot_expert"])
              for c in cw]
    tslots = [tmoe.slots_from_canonical(torch.from_numpy(c),
                                        tt["slot_expert"]) for c in cw]
    for a, b in zip(jslots, tslots):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jsh = tuple(jnp.asarray(a) for a in sh) if shared else None
    tsh = tuple(torch.from_numpy(a) for a in sh) if shared else None
    jy, jc = jmoe.moe_ffn(mesh, cfg, jnp.asarray(x), jnp.asarray(rw),
                          *jslots, jt, jsh, batch_part="data",
                          token_mask=jnp.asarray(mask))
    ty, tc = tmoe.moe_ffn(tcfg, torch.from_numpy(x), torch.from_numpy(rw),
                          *tslots, tt, tsh,
                          token_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert float(tc.sum()) == mask.sum() * cfg.moe.top_k
    if cf >= 8.0:      # no drops: the dense oracle agrees as well
        jd = jmoe.moe_ffn_dense(cfg, jnp.asarray(x), jnp.asarray(rw),
                                *[jnp.asarray(c) for c in cw], jsh)
        td = tmoe.moe_ffn_dense(tcfg, torch.from_numpy(x),
                                torch.from_numpy(rw),
                                *[torch.from_numpy(c) for c in cw], tsh)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(ty.numpy(), td.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_moe_ffn_with_replicas_matches_reference():
    """Redundant slots hosting a second replica of two experts: the
    round-robin replica choice over (token, choice) must match."""
    cfg, tcfg = _cfgs("qwen2-moe-a2.7b")
    mesh = auto_mesh()
    x, rw, cw, sh, mask = _ffn_inputs(cfg, 9, 32, False)
    E = cfg.moe.n_experts
    se = np.array([list(range(E)) + [2, 5]], np.int32)  # 10 slots, 2 replicas
    from repro.core.placement.migration import \
        tables_from_placement_from_slots as j_tables
    from repro_torch.core.placement.migration import \
        tables_from_placement_from_slots as t_tables
    jt, tt = j_tables(se), t_tables(se)
    for k in jt:
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]))
    jslots = [jmoe.slots_from_canonical(jnp.asarray(c), se) for c in cw]
    tslots = [tmoe.slots_from_canonical(torch.from_numpy(c), se) for c in cw]
    jy, jc = jmoe.moe_ffn(mesh, cfg, jnp.asarray(x), jnp.asarray(rw),
                          *jslots, jt, None, batch_part="data")
    ty, tc = tmoe.moe_ffn(tcfg, torch.from_numpy(x), torch.from_numpy(rw),
                          *tslots, tt)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


# ---- whole model -----------------------------------------------------
@pytest.fixture(scope="module")
def models():
    cfg, tcfg = _cfgs("qwen2-moe-a2.7b")
    lm = LM.build(cfg, auto_mesh(), pattern=[0, 0])
    params = lm.init(jax.random.PRNGKey(0))
    tlm = TLM.build(tcfg, pattern=[0, 0], device="cpu")
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       tcfg, tlm.plan, device="cpu")
    return lm, params, tlm, tparams


def test_bridge_and_init_carry_moe_layers(models):
    lm, params, tlm, tparams = models
    jl = params["stack"]["period"][0]
    for r in range(2):
        for k in ("moe_w1", "moe_w2", "router", "shared_w1"):
            np.testing.assert_array_equal(tparams["layers"][r][k].numpy(),
                                          np.asarray(jl[k][r]))
    assert tparams["layers"][0]["moe_w1"].shape == (1, 8, 128, 64)
    bf = tlm.cfg.with_updates(param_dtype="bfloat16")
    fresh = TLM.build(bf, pattern=[0, 0], device="cpu").init(seed=1)
    assert fresh["layers"][0]["router"].dtype == torch.float32
    assert fresh["layers"][0]["moe_w1"].dtype == torch.bfloat16
    assert {k: tuple(v.shape) for k, v in fresh["layers"][1].items()} == \
        {k: tuple(v.shape) for k, v in tparams["layers"][1].items()}
    assert float(fresh["layers"][0]["moe_w2"].float().std()) == \
        pytest.approx(0.02, rel=0.1)


def test_paged_prefill_and_decode_logits_match(models):
    """Chunked paged prefill (a chunk ending mid-block, a full one, a
    padded tail), then paged decode, with MoE counts equal per step."""
    lm, params, tlm, tparams = models
    cfg, tcfg = lm.cfg, tlm.cfg
    max_len, N, bs, chunk = 96, 32, 8, 16
    nb = max_len // bs
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab_size, 5 + chunk + 3).tolist()
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
    jdecode = jax.jit(lambda p, c, t, pos, bt, tb: lm.decode(
        p, c, t, pos, block_tables=bt, tables=tb,
        token_mask=jnp.ones((1,), bool)))
    cur = 0
    for cl in (5, chunk, 3):
        toks = prompt[cur:cur + cl] + [0] * (chunk - cl)
        jcache, jl = jprefill(params, jnp.asarray([toks], jnp.int32), jcache,
                              jnp.int32(cl), tbl_j, jtab)
        tcache, tl, aux = tlm.prefill_resume(
            tparams, torch.tensor([toks], dtype=torch.int32), tcache,
            chunk_len=cl, block_tables=tbl_t, tables=ttab)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert len(aux["moe_counts"]) == 2
        cur += cl
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
        jcnt = np.asarray(jaux["period_counts"][0])        # [n_rep, E]
        np.testing.assert_array_equal(torch.stack(aux["moe_counts"]).numpy(),
                                      jcnt)
        tok = int(np.argmax(np.asarray(jl)[0]))
        cur += 1


def test_whole_prompt_prefill_and_dense_decode_logits_match(models):
    """The other path an MoE layer meets: whole-prompt prefill into dense
    caches, then slot-dense decode, through the same ffn_sublayer."""
    lm, params, tlm, tparams = models
    cfg = lm.cfg
    max_len, n = 32, 11
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, n).tolist() + [0] * 5
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
        p, c, t, pos, tables=tb)[:2])
    for _ in range(2):
        jcache, jl = jdecode(params, jcache, jnp.asarray([[tok]], jnp.int32),
                             jnp.asarray([[cur]], jnp.int32), jtab)
        tcache, tl, _ = tlm.decode(tparams, tcache,
                                   torch.tensor([[tok]], dtype=torch.int32),
                                   torch.tensor([[cur]], dtype=torch.int32),
                                   tables=ttab)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok = int(np.argmax(np.asarray(jl)[0]))
        cur += 1


def test_verify_logits_and_counts_match(models):
    """The speculative verify forward meets the MoE layers through the same
    ffn_sublayer: a read-only S = 4 window over two paged slots, logits
    within 2e-3 and the MoE counts equal, with the second slot masked out
    of the counts."""
    lm, params, tlm, tparams = models
    cfg, tcfg = lm.cfg, tlm.cfg
    B, bs, nb, N, max_len, S = 2, 8, 6, 30, 48, 4
    rng = np.random.default_rng(9)
    tables = rng.permutation(np.arange(1, N))[:B * nb].reshape(B, nb) \
        .astype(np.int32)
    jtab, ttab = lm.default_tables(), tlm.default_tables()
    jcache = jstack.merge_arena_cache(
        cfg, lm.plan, jstack.alloc_prefill_private_cache(
            cfg, lm.mesh, lm.plan, max_len),
        jstack.alloc_arena_kv(cfg, lm.mesh, lm.plan, N, bs))
    tarena = tstack.alloc_arena_kv(tcfg, tlm.plan, N, bs, "cpu")
    jprefill = jax.jit(lambda p, t, c, bt, tb: lm.prefill_resume(
        p, {"tokens": t}, c, max_len=max_len, block_tables=bt,
        tables=tb)[:2])
    lens = [13, 22]
    for b, n in enumerate(lens):
        toks = rng.integers(0, cfg.vocab_size, (1, n)).astype(np.int32)
        jc, _ = jprefill(params, jnp.asarray(toks),
                         dict(jcache, pos=jnp.int32(0)),
                         jnp.asarray(tables[b:b + 1]), jtab)
        jcache = dict(jc, pos=jcache["pos"])
        tlm.prefill_resume(tparams, torch.from_numpy(toks),
                           {"layers": tarena, "pos": 0},
                           block_tables=torch.from_numpy(tables[b:b + 1]),
                           tables=ttab)
    window = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pos = np.array(lens, np.int32)
    mask = np.array([True, False])
    jl, _, jaux = jax.jit(lambda p, c, t, ps, bt, tb, m: lm.verify(
        p, c, t, ps, tables=tb, token_mask=m, block_tables=bt))(
        params, jcache, jnp.asarray(window), jnp.asarray(pos),
        jnp.asarray(tables), jtab, jnp.asarray(mask))
    tl, _, aux = tlm.verify(tparams, {"layers": tarena, "pos": 0},
                            torch.from_numpy(window), torch.from_numpy(pos),
                            block_tables=torch.from_numpy(tables),
                            tables=ttab, token_mask=torch.from_numpy(mask))
    assert tl.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    tcnt = torch.stack(aux["moe_counts"]).numpy()
    np.testing.assert_array_equal(tcnt,
                                  np.asarray(jaux["period_counts"][0]))
    # the masked slot's window adds nothing: S rows x top_k per layer
    assert (tcnt.sum(axis=1) == S * cfg.moe.top_k).all()
