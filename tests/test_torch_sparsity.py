"""OmniAttn online top-k block sparsity of the PyTorch port against the JAX
reference.

On the CPU the block-topk wrapper runs its plain version; it is held
against `repro.kernels.ref.block_topk_scores_ref` and the Pallas kernel in
interpret mode on the sweep of tests/test_kernels.py (bs {8,16}, nb
{3,4,8}, G {1,3}, float32/bfloat16) and the non-resident case. The
selection (`select_kv_blocks`, planted ties, absolute and fractional
budgets), the fused select's plain version (`block_topk_select_plain`:
scores then selection, held exactly against the Pallas kernel in interpret
mode followed by the reference's selection, on integer-valued inputs whose
scores both frameworks compute exactly), the attention mass, `LM.decode`
with absolute and fractional top-k budgets, and the `Server` of
both packages (a full-attention stack and a mixed full/window/compressed
one, on the same bridged weights) must agree: streams and block counts
exactly, logits within 2e-3 (the tolerance of tests/test_consistency.py:40:
float32, two stacks summing in different orders), scores within 1e-5 in
float32 and 2e-2 in bfloat16 (the reference sweep's own).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config
from repro.core.proxy import OASConfig
from repro.distributed.ctx import local_mesh_ctx
from repro.kernels import ref
from repro.kernels.block_topk import block_topk_scores as j_block_topk
from repro.models import LM
from repro.models import attention as j_attn
from repro.models import stack as jstack
from repro.serving import SamplingParams, Server, ServerConfig
from repro.serving.sparsity import SparsityController as JSparsityController
from repro_torch import bridge
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.core.proxy import OASConfig as TOASConfig
from repro_torch.core.proxy import SamplingParams as TSamplingParams
from repro_torch.kernels import ops
from repro_torch.kernels.block_topk import (block_topk_scores,
                                            block_topk_scores_plain,
                                            block_topk_select,
                                            block_topk_select_plain,
                                            select_kv_blocks)
from repro_torch.models import attention as t_attn
from repro_torch.models import stack as tstack
from repro_torch.models.lm import LM as TLM
from repro_torch.serving import Server as TServer
from repro_torch.serving import ServerConfig as TServerConfig
from repro_torch.serving.sparsity import SparsityController

torch.set_num_threads(2)

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
LOGIT_TOL = dict(rtol=2e-3, atol=2e-3)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BT_REF = jax.jit(ref.block_topk_scores_ref, static_argnames=("block_size",))


def _np(rng, shape, dtype="float32"):
    """numpy inputs rounded to `dtype` once, so both frameworks see the
    same values."""
    x = rng.standard_normal(shape).astype(np.float32)
    return np.asarray(jnp.asarray(x, JDT[dtype]).astype(jnp.float32))


# ---- the block-topk kernel's plain version -----------------------------
@pytest.mark.parametrize("bs,nb", [(8, 4), (16, 3), (8, 8)])
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_topk_plain_matches_ref_and_pallas(bs, nb, G, dtype):
    rng = np.random.default_rng(3 * bs + nb + G)
    B, K, h, N = 3, 2, 32, 10
    q = _np(rng, (B, K, G, h), dtype)
    kmin = _np(rng, (N, K, h))
    kmax = kmin + np.maximum(_np(rng, (N, K, h)), 0)
    tables = rng.integers(1, N, (B, nb)).astype(np.int32)
    lens = np.array([1, nb * bs - bs // 2, nb * bs], np.int32)
    jq = jnp.asarray(q, JDT[dtype])
    want = np.asarray(BT_REF(jq, kmin, kmax, tables, lens, block_size=bs))
    pallas = np.asarray(j_block_topk(jq, kmin, kmax, tables, lens,
                                     block_size=bs, interpret=True))
    n0 = block_topk_scores.launches
    got = block_topk_scores(torch.tensor(q).to(TDT[dtype]),
                            torch.tensor(kmin), torch.tensor(kmax),
                            torch.tensor(tables), torch.tensor(lens),
                            block_size=bs)
    assert block_topk_scores.launches == n0      # the CPU runs no kernel
    assert got.dtype == torch.float32 and got.shape == (B, nb)
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])
    np.testing.assert_allclose(got.numpy(), pallas, **TOL[dtype])
    # NEG_INF past the residency, exactly
    res = np.arange(nb)[None] * bs < lens[:, None]
    assert np.all(got.numpy()[~res] == np.float32(-1e30))


def test_block_topk_non_resident_masked():
    """A poisoned summary behind a non-resident table entry (the null-block
    alias) never outranks a real block; the model-layout adapter agrees."""
    B, K, G, h, N, bs, nb = 1, 1, 1, 16, 6, 8, 3
    kmin = torch.zeros((N, K, h))
    kmax = torch.ones((N, K, h))
    kmin[0] = kmax[0] = 1e4
    tables = torch.tensor([[3, 0, 0]], dtype=torch.int32)
    lens = torch.tensor([5], dtype=torch.int32)
    out = block_topk_scores_plain(torch.ones((B, K, G, h)), kmin, kmax,
                                  tables, lens, block_size=bs)
    assert out[0, 0].item() == pytest.approx(h, rel=1e-5)
    assert out[0, 1].item() == out[0, 2].item() == np.float32(-1e30)
    via_op = ops.block_topk_select_op(torch.ones((B, K * G, h)), kmin, kmax,
                                      tables, lens, block_size=bs, k_static=1,
                                      frac=0.0, sink_blocks=0,
                                      recent_blocks=1)[0]
    torch.testing.assert_close(via_op, out, rtol=0, atol=0)


# ---- the fused select's plain version against the JAX composition -----
# (k_static, frac, sink, recent): absolute budgets, fractional ones, a
# budget at the table width (>= every n_res: the table comes back as it
# was), every resident block forced (sink 2 + recent nb)
SELECT_BUDGETS = [(4, 0.0, 1, 2), (6, 0.0, 0, 1), (5, 0.25, 1, 2),
                  (8, 0.5, 2, 2), (12, 0.3, 1, 2), (16, 0.0, 1, 2),
                  (5, 0.0, 2, 16)]


@pytest.mark.parametrize("k_static,frac,sink,recent", SELECT_BUDGETS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_topk_select_plain_matches_jax(k_static, frac, sink, recent,
                                             dtype):
    """Integer-valued q and summaries in [-3, 3]: every product and sum is
    exact in float32 (and q exact in bfloat16), so both frameworks score
    bit for bit and the selections must agree exactly; the scores' ties
    are many (small integers) and planted (a third of each row's summary
    rows copied). Slots hold one block (n_res = 1), a mid-block tail, 12
    blocks and the full table."""
    rng = np.random.default_rng(k_static + 10 * sink + recent)
    B, K, G, h, bs, nb = 4, 2, 3, 32, 8, 16
    N = B * nb + 1
    q = rng.integers(-3, 4, (B, K, G, h)).astype(np.float32)
    kmin = rng.integers(-3, 4, (N, K, h)).astype(np.float32)
    kmax = kmin + rng.integers(0, 3, (N, K, h)).astype(np.float32)
    tables = rng.permutation(np.arange(1, N))[:B * nb].reshape(B, nb) \
        .astype(np.int32)
    lens = np.array([1, 5 * bs + 3, 12 * bs, nb * bs], np.int32)
    for b in range(B):
        res = -(-lens[b] // bs)
        src, dst = tables[b, 0:res:3], tables[b, 1:res:3]
        k = min(len(src), len(dst))
        kmin[dst[:k]], kmax[dst[:k]] = kmin[src[:k]], kmax[src[:k]]
        tables[b, res:] = 0
    kmin[0] = kmax[0] = 1e4                         # poisoned null block
    kw = dict(block_size=bs, k_static=k_static, frac=frac, sink_blocks=sink,
              recent_blocks=recent)
    jq = jnp.asarray(q, JDT[dtype])
    jscores = j_block_topk(jq, kmin, kmax, tables, lens, block_size=bs,
                           interpret=True)
    jout = j_attn.select_kv_blocks(jscores, jnp.asarray(tables),
                                   jnp.asarray(lens), **kw)
    n0 = block_topk_scores.launches
    tout = block_topk_select(torch.tensor(q).to(TDT[dtype]),
                             torch.tensor(kmin), torch.tensor(kmax),
                             torch.tensor(tables), torch.tensor(lens), **kw)
    assert block_topk_scores.launches == n0       # the CPU runs no kernel
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jscores),
                               **TOL[dtype])
    for name, t, j in zip(("tables", "lens", "m", "selected"), tout[1:],
                          jout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    assert tout[1].dtype == tout[2].dtype == tout[3].dtype == torch.int32
    assert tout[4].dtype == torch.bool
    n_res = -(-lens // bs)
    m = tout[3].numpy()
    if k_static >= nb:                             # degrade: table as given
        np.testing.assert_array_equal(tout[1].numpy(), tables)
        np.testing.assert_array_equal(tout[2].numpy(), lens)
    if recent >= nb:                               # all forced: the lowest
        for b in range(B):
            keep = np.arange(min(k_static, n_res[b]))
            np.testing.assert_array_equal(tout[1].numpy()[b, :m[b]],
                                          tables[b, keep])
    assert m[0] == 1 and tout[1].numpy()[0, 0] == tables[0, 0]


def test_block_topk_select_op_matches_plain():
    """The model-layout adapter of the fused select ([B, H, h] queries)
    gives the plain composition's outputs exactly."""
    rng = np.random.default_rng(17)
    B, K, G, h, bs, nb, N = 3, 2, 2, 32, 8, 6, 20
    q = torch.tensor(_np(rng, (B, K * G, h)))
    kmin = torch.tensor(_np(rng, (N, K, h)))
    kmax = kmin + torch.tensor(_np(rng, (N, K, h))).relu()
    tables = torch.tensor(rng.integers(1, N, (B, nb)).astype(np.int32))
    lens = torch.tensor([3, 20, 48], dtype=torch.int32)
    kw = dict(block_size=bs, k_static=3, frac=0.0, sink_blocks=1,
              recent_blocks=1)
    got = ops.block_topk_select_op(q, kmin, kmax, tables, lens, **kw)
    want = block_topk_select_plain(q.reshape(B, K, G, h), kmin, kmax, tables,
                                   lens, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


# ---- selection and attention mass -------------------------------------
@pytest.mark.parametrize("k_static,frac", [(4, 0.0), (6, 0.0), (8, 0.5),
                                           (16, 0.0), (12, 0.3)])
def test_select_kv_blocks_matches_jax(k_static, frac):
    """Planted ties (equal scores across blocks and inside the forced
    keeps), absolute and fractional budgets, a slot with one resident block
    and budgets at or above the resident count (the table comes back equal
    to the input)."""
    rng = np.random.default_rng(k_static)
    B, nb, bs = 4, 16, 8
    scores = rng.integers(0, 4, (B, nb)).astype(np.float32)   # many ties
    tables = rng.integers(1, 100, (B, nb)).astype(np.int32)
    lens = np.array([1, 5 * bs + 3, 12 * bs, nb * bs], np.int32)
    scores[np.arange(nb)[None] * bs >= lens[:, None]] = -1e30
    kw = dict(block_size=bs, k_static=k_static, frac=frac, sink_blocks=1,
              recent_blocks=2)
    jout = j_attn.select_kv_blocks(jnp.asarray(scores), jnp.asarray(tables),
                                   jnp.asarray(lens), **kw)
    tout = select_kv_blocks(torch.tensor(scores), torch.tensor(tables),
                            torch.tensor(lens), **kw)
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    new_tables, new_lens = tout[0].numpy(), tout[1].numpy()
    n_res = -(-lens // bs)
    for b in range(B):
        if tout[2][b] == n_res[b]:       # every resident block kept
            np.testing.assert_array_equal(new_tables[b, :n_res[b]],
                                          tables[b, :n_res[b]])
            assert new_lens[b] == lens[b]


def test_selected_attention_mass_matches_jax():
    rng = np.random.default_rng(5)
    B, H, K, h, N, bs, nb = 3, 4, 2, 16, 20, 8, 5
    q = _np(rng, (B, H, h))
    kp = _np(rng, (N, K, bs, h))
    tables = rng.integers(1, N, (B, nb)).astype(np.int32)
    lens = np.array([3, 20, 40], np.int32)
    selected = rng.random((B, nb)) < 0.5
    want = j_attn.selected_attention_mass(jnp.asarray(q), jnp.asarray(kp),
                                          jnp.asarray(tables),
                                          jnp.asarray(lens),
                                          jnp.asarray(selected))
    got = t_attn.selected_attention_mass(torch.tensor(q), torch.tensor(kp),
                                         torch.tensor(tables),
                                         torch.tensor(lens),
                                         torch.tensor(selected))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert np.all((got.numpy() >= 0) & (got.numpy() <= 1 + 1e-6))


# ---- the model step ----------------------------------------------------
def test_lm_decode_with_topk_matches_jax(monkeypatch):
    """Paged chunked prefill of three slots of different lengths, then
    decode steps with a 3-block budget (below every slot's resident count
    at the end): logits within 2e-3 and the per-layer aux vectors equal."""
    _lm_decode_topk(monkeypatch, dict(omniattn_topk_blocks=3,
                                      omniattn_topk_measure_mass=True))


def test_lm_decode_with_topk_frac_matches_jax(monkeypatch):
    """The same with a fractional budget (ceil(0.25 · n_res) per slot,
    floored at sink 1 + recent 2), the mass unmeasured: `_select_blocks`
    goes through the fused select op, and logits and aux vectors agree."""
    _lm_decode_topk(monkeypatch, dict(omniattn_topk_frac=0.25,
                                      omniattn_topk_sink_blocks=1,
                                      omniattn_topk_recent_blocks=2))


def _lm_decode_topk(monkeypatch, topk):
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return block_topk_select_op(*a, **k)
    block_topk_select_op = ops.block_topk_select_op
    monkeypatch.setattr(ops, "block_topk_select_op", counted)
    kw = dict(compute_dtype="float32", param_dtype="float32", n_layers=2,
              vocab_size=128, **topk)
    cfg = reduced_config("qwen2-1.5b").with_updates(**kw)
    lm = LM.build(cfg, local_mesh_ctx(), pattern=[0, 0])
    params = lm.init(jax.random.PRNGKey(0))
    tcfg = t_reduced_config("qwen2-1.5b").with_updates(**kw)
    tlm = TLM.build(tcfg, pattern=[0, 0], device="cpu")
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       tcfg, tlm.plan, device="cpu")
    B, bs, nb, N, max_len = 3, 8, 8, 40, 64
    rng = np.random.default_rng(9)
    tables = rng.permutation(np.arange(1, N))[:B * nb].reshape(B, nb) \
        .astype(np.int32)
    jarena = jstack.alloc_arena_kv(cfg, lm.mesh, lm.plan, N, bs)
    jcache = jstack.merge_arena_cache(
        cfg, lm.plan, jstack.alloc_prefill_private_cache(
            cfg, lm.mesh, lm.plan, max_len), jarena)
    tarena = tstack.alloc_arena_kv(tcfg, tlm.plan, N, bs, "cpu")
    tcache = {"layers": tarena, "pos": 0}
    jprefill = jax.jit(lambda p, t, c, bt: lm.prefill_resume(
        p, {"tokens": t}, c, max_len=max_len, block_tables=bt)[:2])
    lens = [30, 17, 41]
    for b, n in enumerate(lens):
        toks = rng.integers(0, cfg.vocab_size, (1, n)).astype(np.int32)
        jc = dict(jcache, pos=jnp.int32(0))
        jc, _ = jprefill(params, jnp.asarray(toks), jc,
                         jnp.asarray(tables[b:b + 1]))
        jcache = dict(jc, pos=jcache["pos"])
        tlm.prefill_resume(tparams, torch.from_numpy(toks),
                           {"layers": tarena, "pos": 0},
                           block_tables=torch.from_numpy(tables[b:b + 1]))
    jdecode = jax.jit(lambda p, c, t, pos, bt, m: lm.decode(
        p, c, t, pos, token_mask=m, block_tables=bt))
    pos = np.array(lens, np.int32)[:, None]
    tok = np.array([[1], [2], [3]], np.int32)
    mask = np.array([True, True, False])
    for _ in range(3):
        jcache, jl, jaux = jdecode(params, jcache, jnp.asarray(tok),
                                   jnp.asarray(pos), jnp.asarray(tables),
                                   jnp.asarray(mask))
        tcache, tl, taux = tlm.decode(
            tparams, tcache, torch.from_numpy(tok), torch.from_numpy(pos),
            block_tables=torch.from_numpy(tables),
            token_mask=torch.from_numpy(mask))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        jsp = np.asarray(jaux["period_sparsity"][0])          # [n_rep, 4]
        tsp = torch.stack(taux["sparsity"]).numpy()
        np.testing.assert_array_equal(tsp[:, :2], jsp[:, :2])
        np.testing.assert_allclose(tsp[:, 2:], jsp[:, 2:], rtol=1e-5)
        assert (tsp[:, 1] < tsp[:, 0]).all()       # the budget bit
        tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        pos = pos + 1
    assert len(calls) == 3 * 2                     # each step, each layer


# ---- serving -------------------------------------------------------------
SCFG = dict(n_prefill=1, n_decode=1, decode_slots=3, max_len=128,
            chunk_tokens=16, prefill_tick_budget=32, kv_blocks=60,
            kv_block_size=8)
STACKS = {
    # every layer full attention, chunked paged prefill
    "full": (dict(n_layers=2), [0, 0], True),
    # window / full / window / compressed (sink 8 + recent 24): whole-prompt
    # prefill, top-k on the two full layers only
    "mixed": (dict(n_layers=4, local_per_global=1, local_window=16,
                   omniattn_sink_tokens=8, omniattn_recent_tokens=24),
              [0, 0, 0, 1], False),
}


def _servers(stack, topk, jsrv=None):
    extra, pattern, chunked = STACKS[stack]
    kw = dict(compute_dtype="float32", param_dtype="float32",
              vocab_size=128, **extra, **topk)
    cfg = reduced_config("qwen2-1.5b").with_updates(**kw)
    tcfg = t_reduced_config("qwen2-1.5b").with_updates(**kw)
    sk = dict(SCFG, chunked_prefill=chunked)
    j = Server(cfg, ServerConfig(**sk, oas=OASConfig(defer_window=0.0)),
               pattern=pattern, params=None if jsrv is None else jsrv.params)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, j.params),
                                       tcfg, j.lm.plan, device="cpu")
    t = TServer(tcfg, TServerConfig(**sk, oas=TOASConfig(defer_window=0.0)),
                pattern=pattern, params=tparams, device="cpu")
    return j, t


def _prompts(vocab):
    rng = np.random.default_rng(11)
    return [tuple(int(x) for x in rng.integers(0, vocab, n))
            for n in (50, 70, 33, 90)]


def _run(srv, prompts, params_cls):
    s = srv.run([(p, params_cls(max_tokens=8)) for p in prompts],
                max_wall_s=600)
    return {r.rid: tuple(r.output_tokens) for r in srv.metrics.done}, s


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_server_topk_matches_jax_server(stack):
    """Budget below the resident count: the streams and the sparsity
    summary (blocks scored / attended, attention mass kept) equal the JAX
    server's; one host fetch per step; pool and summary invariants hold."""
    topk = dict(omniattn_topk_blocks=3, omniattn_topk_measure_mass=True)
    jsrv, tsrv = _servers(stack, topk)
    prompts = _prompts(128)
    jout, js = _run(jsrv, prompts, SamplingParams)
    tout, ts = _run(tsrv, prompts, TSamplingParams)
    assert len(tout) == len(prompts) and tout == jout
    for k in ("blocks_scored", "blocks_attended"):
        assert ts[k] == js[k] > 0, k
    assert ts["blocks_attended"] < ts["blocks_scored"]
    assert ts["attn_mass_kept"] == pytest.approx(js["attn_mass_kept"],
                                                 rel=1e-5)
    assert 0 < ts["attn_mass_kept"] <= 1
    ds = ts["decode_stats"][0]
    assert ds["host_fetches"] == ds["steps"] > 0
    tsrv.kv_arena.pool.check_invariants(arena=tsrv.kv_arena)


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_server_full_budget_equals_exact(stack):
    """Prompts of 9-13 blocks keep the decode table at its 16-wide bucket;
    a budget of 15 blocks is below the table width, so selection runs every
    step, and above every resident count, so it keeps every block: the
    streams equal top-k off exactly."""
    jsrv, tsrv = _servers(stack, dict(omniattn_topk_blocks=15))
    _, exact = _servers(stack, {}, jsrv=jsrv)
    rng = np.random.default_rng(12)
    prompts = [tuple(int(x) for x in rng.integers(0, 128, n))
               for n in (72, 90, 81, 99)]
    sel, s = _run(tsrv, prompts, TSamplingParams)
    ref_out, _ = _run(exact, prompts, TSamplingParams)
    assert sel == ref_out and len(sel) == len(prompts)
    assert s["blocks_attended"] == s["blocks_scored"] > 0


def test_sparsity_controller_validation_matches_reference():
    """The same configurations are refused with the same messages; an
    all-ring stack or no budget gives no controller."""
    for kw in (dict(omniattn_topk_blocks=2, omniattn_topk_frac=0.5),
               dict(omniattn_topk_frac=1.5)):
        cfg = reduced_config("qwen2-1.5b").with_updates(n_layers=2, **kw)
        tcfg = t_reduced_config("qwen2-1.5b").with_updates(n_layers=2, **kw)
        jplan = jstack.StackPlan.from_config(cfg, [0, 0])
        tplan = tstack.StackPlan.from_config(tcfg, [0, 0])
        with pytest.raises(ValueError) as jerr:
            JSparsityController.from_model(cfg, jplan, 8, 16)
        with pytest.raises(ValueError) as terr:
            SparsityController.from_model(tcfg, tplan, 8, 16)
        assert str(terr.value) == str(jerr.value)
    tcfg = t_reduced_config("qwen2-1.5b").with_updates(n_layers=2)
    plan = tstack.StackPlan.from_config(tcfg, [0, 0])
    assert SparsityController.from_model(tcfg, plan, 8, 16) is None
    ring = tstack.StackPlan.from_config(
        tcfg.with_updates(omniattn_topk_blocks=4), [1, 1])
    assert SparsityController.from_model(
        tcfg.with_updates(omniattn_topk_blocks=4), ring, 8, 16) is None
    c = SparsityController.from_model(
        tcfg.with_updates(omniattn_topk_frac=0.25), plan, 8, 16)
    j = JSparsityController.from_model(
        reduced_config("qwen2-1.5b").with_updates(n_layers=2,
                                                  omniattn_topk_frac=0.25),
        jstack.StackPlan.from_config(
            reduced_config("qwen2-1.5b").with_updates(n_layers=2), [0, 0]),
        8, 16)
    assert dataclasses.asdict(c.plan) == dataclasses.asdict(j.plan)
    for kw in ({}, dict(omniattn_topk_blocks=1), dict(omniattn_topk_blocks=5),
               dict(omniattn_topk_frac=0.3)):
        joa = reduced_config("qwen2-1.5b").with_updates(**kw).omniattn
        toa = t_reduced_config("qwen2-1.5b").with_updates(**kw).omniattn
        for nb in (2, 8, 64):
            assert tstack.topk_block_budget(toa, nb) == \
                jstack.topk_block_budget(joa, nb), (kw, nb)
