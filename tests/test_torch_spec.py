"""SpecPlane speculative decoding of the PyTorch port against the JAX
reference.

The draft sources and the controller's refusals are held against the
reference's on the same inputs. On the CPU the spec-verify wrapper runs its
plain version; it is held against `repro.kernels.ref.spec_verify_ref` and
the Pallas kernel in interpret mode on the sweep of tests/test_kernels.py
(bs {8,16} x S {2,4,5}, G {1,4}, float32/bfloat16) and the null-block case:
float32 within 1e-5, bfloat16 within 2e-2 (the reference sweep's own).
`LM.verify` logits match the reference within 2e-3 (tests/
test_consistency.py:40: float32, two stacks summing in different orders).
Served end to end (a full-attention stack with chunked prefill, and a
full/window stack with whole-prompt prefill, so the masked ring commit
runs), the port's spec-on streams equal its spec-off streams and the JAX
server's, with the same speculation stats; an adversarial draft source
rolls every window back without changing a stream, and a sampled request
rides the verify window as a single-token row.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import reduced_config
from repro.core.proxy import OASConfig
from repro.core.proxy.radix import RadixTree as JRadixTree
from repro.distributed.ctx import MeshCtx, local_mesh_ctx
from repro.kernels import ref
from repro.kernels.spec_verify import spec_verify as j_spec_verify
from repro.models import LM
from repro.models import stack as jstack
from repro.serving import SamplingParams, Server, ServerConfig
from repro.serving import spec as jspec
from repro_torch import bridge
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.core.proxy import OASConfig as TOASConfig
from repro_torch.core.proxy import SamplingParams as TSamplingParams
from repro_torch.core.proxy.radix import RadixTree
from repro_torch.kernels import ops
from repro_torch.kernels.spec_verify import spec_verify, spec_verify_plain
from repro_torch.models import stack as tstack
from repro_torch.models.lm import LM as TLM
from repro_torch.serving import Server as TServer
from repro_torch.serving import ServerConfig as TServerConfig
from repro_torch.serving import spec as tspec

torch.set_num_threads(2)

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
LOGIT_TOL = dict(rtol=2e-3, atol=2e-3)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SV_REF = jax.jit(ref.spec_verify_ref)


def _np(rng, shape, dtype="float32"):
    x = rng.standard_normal(shape).astype(np.float32)
    return np.asarray(jnp.asarray(x, JDT[dtype]).astype(jnp.float32))


# ---- draft sources and controller --------------------------------------
def _histories(seed):
    rng = np.random.default_rng(seed)
    gram = [int(t) for t in rng.integers(0, 8, 5)]
    return [gram * 3 + [int(t) for t in rng.integers(0, 8, 4)] + gram[:2],
            [int(t) for t in rng.integers(0, 6, 40)],
            [1, 2, 3, 9, 8, 1, 2, 3], [5, 6, 1, 5, 6, 2, 5, 6]]


@pytest.mark.parametrize("ngram", [1, 2, 3])
def test_prompt_lookup_source_matches_reference(ngram):
    js, ts = jspec.PromptLookupSource(ngram), tspec.PromptLookupSource(ngram)
    for rid, h in enumerate(_histories(ngram)):
        js.on_admit(rid, h[:-3])
        ts.on_admit(rid, h[:-3])
        js.on_tokens(rid, h, 3)
        ts.on_tokens(rid, h, 3)
        for k in (1, 4, 9):
            assert ts.draft(rid, h, k) == js.draft(rid, h, k)
        ts.on_release(rid, h)
        assert ts.draft(rid, h, 4) == []


def test_radix_and_suffix_sources_match_reference():
    hs = _histories(7)
    jt, tt = JRadixTree(), RadixTree()
    for h in hs:
        jt.insert(tuple(h), now=1.0)
        tt.insert(tuple(h), now=1.0)
    jr, tr = jspec.RadixDraftSource(jt), tspec.RadixDraftSource(tt)
    jsuf = jspec.SuffixTableSource(3, max_entries=12, cont_len=4)
    tsuf = tspec.SuffixTableSource(3, max_entries=12, cont_len=4)
    for rid, h in enumerate(hs):
        for cut in (3, 6, len(h) - 1):
            assert tr.draft(rid, h[:cut], 4) == jr.draft(rid, h[:cut], 4)
        jsuf.on_release(rid, h)
        tsuf.on_release(rid, h)
    assert list(tsuf.table.items()) == list(jsuf.table.items())
    for h in hs:
        for cut in (3, 5, len(h)):
            assert tsuf.draft(0, h[:cut], 4) == jsuf.draft(0, h[:cut], 4)


@pytest.fixture(scope="module")
def small():
    """tests/test_spec.py::small: 2 layers, vocab 128, float32."""
    kw = dict(compute_dtype="float32", param_dtype="float32", n_layers=2,
              vocab_size=128)
    cfg = reduced_config("qwen2-1.5b").with_updates(**kw)
    lm = LM.build(cfg, local_mesh_ctx(), pattern=[0, 0])
    params = lm.init(jax.random.PRNGKey(0))
    tcfg = t_reduced_config("qwen2-1.5b").with_updates(**kw)
    tlm = TLM.build(tcfg, pattern=[0, 0], device="cpu")
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       tcfg, tlm.plan, device="cpu")
    return lm, params, tlm, tparams


def test_controller_refusals_match_reference(small):
    lm, _, tlm, _ = small
    # speculation off
    assert tspec.SpecController.from_model(tlm, None) is None
    assert tspec.SpecController.from_model(
        tlm, tspec.SpecConfig(k=0)) is None
    # online top-k
    with pytest.raises(ValueError) as jerr:
        jspec.SpecController.from_model(lm, jspec.SpecConfig(),
                                        sparsity=object())
    with pytest.raises(ValueError) as terr:
        tspec.SpecController.from_model(tlm, tspec.SpecConfig(),
                                        sparsity=object())
    assert str(terr.value) == str(jerr.value)

    # SSM layers: a stand-in plan, and the real mamba2 and jamba stacks
    # (every attention layer full, and jamba's default pattern)
    class _SSM:
        def __init__(self, lm):
            self.cfg, self.plan = lm.cfg, self

        def all_specs(self):
            return [type("S", (), {"kind": "mamba"})()]
    cases = [(_SSM(lm), _SSM(tlm))]
    for arch in ("mamba2-130m", "jamba-1.5-large-398b"):
        jc, tc = reduced_config(arch), t_reduced_config(arch)
        for pattern in ([0] * jc.n_layers, None):
            mesh = local_mesh_ctx() if not jc.moe.n_experts else MeshCtx(
                jax.make_mesh((1, 1), ("data", "model"),
                              axis_types=(AxisType.Auto,) * 2))
            cases.append((LM.build(jc, mesh, pattern=pattern),
                          TLM.build(tc, pattern=pattern, device="cpu")))
    for jl, tl in cases:
        with pytest.raises(ValueError) as jerr:
            jspec.SpecController.from_model(jl, jspec.SpecConfig())
        with pytest.raises(ValueError) as terr:
            tspec.SpecController.from_model(tl, tspec.SpecConfig())
        assert str(terr.value) == str(jerr.value)
    # the ring caps the window: k + 1 <= the smallest recent width, and a
    # ring too small for one draft turns speculation off; a compressed
    # layer without prefill_sparse refuses multi-position verify
    for kw, pattern in ((dict(local_per_global=1, local_window=4), [0, 0]),
                        (dict(local_per_global=1, local_window=1), [0, 0]),
                        ({}, [1, 0])):
        jl = LM.build(lm.cfg.with_updates(**kw), local_mesh_ctx(),
                      pattern=pattern)
        tl = TLM.build(tlm.cfg.with_updates(**kw), pattern=pattern,
                       device="cpu")
        try:
            jc = jspec.SpecController.from_model(jl, jspec.SpecConfig(k=6))
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                tspec.SpecController.from_model(tl, tspec.SpecConfig(k=6))
            continue
        tc = tspec.SpecController.from_model(tl, tspec.SpecConfig(k=6))
        assert (tc is None) == (jc is None)
        if tc is not None:
            assert tc.k == jc.k == 3
            assert [s.name for s in tc.sources] == \
                [s.name for s in jc.sources]


# ---- the spec-verify kernel's plain version -----------------------------
def _verify_case(rng, B, K, S, G, h, bs, N, nb, dtype):
    return (_np(rng, (B, K, S * G, h), dtype), _np(rng, (B, K, S, h), dtype),
            _np(rng, (B, K, S, h), dtype), _np(rng, (N, K, bs, h), dtype),
            _np(rng, (N, K, bs, h), dtype),
            rng.integers(1, N, (B, nb)).astype(np.int32))


@pytest.mark.parametrize("bs,S", [(8, 4), (16, 5), (8, 2)])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spec_verify_plain_matches_ref_and_pallas(bs, S, G, dtype):
    """Per-slot history offsets covering empty, mid-block and fully
    resident histories; padded window rows compared on real rows only."""
    rng = np.random.default_rng(bs * S + G)
    B, K, h, N, nb = 3, 2, 32, 20, 4
    q, kn, vn, kp, vp, tables = _verify_case(rng, B, K, S, G, h, bs, N, nb,
                                             dtype)
    off = np.array([0, bs + bs // 2 - 1, nb * bs], np.int32)
    cl = np.array([S, max(S - 2, 1), 1], np.int32)
    jargs = [jnp.asarray(x, JDT[dtype]) for x in (q, kn, vn, kp, vp)]
    want = np.asarray(SV_REF(*jargs, tables, off, cl), np.float32)
    pallas = np.asarray(j_spec_verify(*jargs, tables, off, cl,
                                      interpret=True), np.float32)
    targs = [torch.tensor(x).to(TDT[dtype]) for x in (q, kn, vn, kp, vp)]
    n0 = spec_verify.launches
    got = spec_verify(*targs, torch.tensor(tables), torch.tensor(off),
                      torch.tensor(cl))
    assert spec_verify.launches == n0             # the CPU runs no kernel
    assert got.dtype == TDT[dtype]
    got = got.float().numpy()
    for b in range(B):
        real = int(cl[b]) * G
        np.testing.assert_allclose(got[b, :, :real], want[b, :, :real],
                                   **TOL[dtype])
        np.testing.assert_allclose(got[b, :, :real], pallas[b, :, :real],
                                   **TOL[dtype])
    assert np.isfinite(got).all()


def test_spec_verify_null_blocks_masked_and_adapter():
    """Poisoned null-block entries past the residency never leak; the
    model-layout adapter (GQA regroup) agrees with the kernel layout."""
    rng = np.random.default_rng(4)
    B, K, G, h, bs, N, S = 1, 1, 2, 16, 8, 6, 3
    q, kn, vn, kp, vp, _ = _verify_case(rng, B, K, S, G, h, bs, N, 3,
                                        "float32")
    kp, vp = kp.copy(), vp.copy()
    kp[0] = vp[0] = 1e4
    tables = np.array([[3, 0, 0]], np.int32)
    off, cl = np.array([bs], np.int32), np.array([S], np.int32)
    want = np.asarray(SV_REF(q, kn, vn, kp, vp, tables, off, cl))
    got = spec_verify_plain(*(torch.tensor(x) for x in (q, kn, vn, kp, vp)),
                            torch.tensor(tables), torch.tensor(off),
                            torch.tensor(cl)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.isfinite(got).all()
    # adapter: q [B,S,H,h], keys [B,S,K,h]
    rng = np.random.default_rng(21)
    B, S, K, G, h, bs, N, nb = 2, 4, 2, 3, 16, 8, 12, 3
    qm, knm, vnm = (_np(rng, s) for s in ((B, S, K * G, h), (B, S, K, h),
                                          (B, S, K, h)))
    kp, vp = _np(rng, (N, K, bs, h)), _np(rng, (N, K, bs, h))
    tables = rng.integers(1, N, (B, nb)).astype(np.int32)
    off, cl = np.array([0, 13], np.int32), np.array([S, 3], np.int32)
    from repro.kernels import ops as j_ops
    want = np.asarray(j_ops.spec_verify_op(qm, knm, vnm, kp, vp, tables,
                                           off, cl))
    got = ops.spec_verify_op(*(torch.tensor(x) for x in (qm, knm, vnm, kp,
                                                         vp)),
                             torch.tensor(tables), torch.tensor(off),
                             torch.tensor(cl)).numpy()
    for b in range(B):
        np.testing.assert_allclose(got[b, :cl[b]], want[b, :cl[b]],
                                   rtol=2e-5, atol=2e-5)


# ---- the model's verify forward ------------------------------------------
def test_lm_verify_logits_match_jax(small):
    """Paged chunked prefill of two slots, then one read-only verify window
    of S = 4 rows per slot: logits within 2e-3, and the caches untouched
    until the commit, after which both packages' arenas agree."""
    lm, params, tlm, tparams = small
    cfg, tcfg = lm.cfg, tlm.cfg
    B, bs, nb, N, max_len, S = 2, 8, 6, 30, 48, 4
    rng = np.random.default_rng(3)
    tables = rng.permutation(np.arange(1, N))[:B * nb].reshape(B, nb) \
        .astype(np.int32)
    jcache = jstack.merge_arena_cache(
        cfg, lm.plan, jstack.alloc_prefill_private_cache(
            cfg, lm.mesh, lm.plan, max_len),
        jstack.alloc_arena_kv(cfg, lm.mesh, lm.plan, N, bs))
    tarena = tstack.alloc_arena_kv(tcfg, tlm.plan, N, bs, "cpu")
    tcache = {"layers": tarena, "pos": 0}
    jprefill = jax.jit(lambda p, t, c, bt: lm.prefill_resume(
        p, {"tokens": t}, c, max_len=max_len, block_tables=bt)[:2])
    lens = [13, 22]
    for b, n in enumerate(lens):
        toks = rng.integers(0, cfg.vocab_size, (1, n)).astype(np.int32)
        jc, _ = jprefill(params, jnp.asarray(toks),
                         dict(jcache, pos=jnp.int32(0)),
                         jnp.asarray(tables[b:b + 1]))
        jcache = dict(jc, pos=jcache["pos"])
        tlm.prefill_resume(tparams, torch.from_numpy(toks),
                           {"layers": tarena, "pos": 0},
                           block_tables=torch.from_numpy(tables[b:b + 1]))
    window = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pos = np.array(lens, np.int32)
    jl, jstaged, _ = jax.jit(lambda p, c, t, ps, bt: lm.verify(
        p, c, t, ps, block_tables=bt))(params, jcache, jnp.asarray(window),
                                       jnp.asarray(pos), jnp.asarray(tables))
    before = [e["k"].clone() for e in tarena]
    tl, tstaged, _ = tlm.verify(tparams, tcache, torch.from_numpy(window),
                                torch.from_numpy(pos),
                                block_tables=torch.from_numpy(tables))
    assert tl.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for e, k0 in zip(tarena, before):             # read-only
        assert torch.equal(e["k"], k0)
    n_write = np.array([2, 4], np.int32)
    jcache = lm.verify_commit(jcache, jstaged, jnp.asarray(pos),
                              jnp.asarray(n_write), jnp.asarray(tables))
    tlm.verify_commit(tcache, tstaged, torch.from_numpy(pos),
                      torch.from_numpy(n_write), torch.from_numpy(tables))
    jent = jcache["period"][0]
    for li in range(2):
        for name in ("k", "v", "kmin", "kmax"):
            np.testing.assert_allclose(
                tarena[li][name].numpy()[1:], np.asarray(jent[name])[li, 1:],
                rtol=1e-4, atol=1e-4, err_msg=name)


# ---- serving -------------------------------------------------------------
SCFG = dict(n_prefill=1, n_decode=1, decode_slots=3, max_len=128,
            chunk_tokens=16, prefill_tick_budget=32, kv_blocks=60,
            kv_block_size=8)
STACKS = {
    # every layer full attention, chunked paged prefill
    "full": (dict(n_layers=2), True),
    # window 16 / full, twice: whole-prompt prefill; the verify window runs
    # the ring attention and the masked ring commit on the window layers
    "mixed": (dict(n_layers=4, local_per_global=1, local_window=16), False),
}


def _servers(stack, k=4):
    extra, chunked = STACKS[stack]
    kw = dict(compute_dtype="float32", param_dtype="float32",
              vocab_size=128, **extra)
    cfg = reduced_config("qwen2-1.5b").with_updates(**kw)
    tcfg = t_reduced_config("qwen2-1.5b").with_updates(**kw)
    pattern = [0] * cfg.n_layers
    sk = dict(SCFG, chunked_prefill=chunked)
    j = Server(cfg, ServerConfig(**sk, spec=jspec.SpecConfig(k=k),
                                 oas=OASConfig(defer_window=0.0)),
               pattern=pattern)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, j.params),
                                       tcfg, j.lm.plan, device="cpu")

    def port(spec):
        return TServer(tcfg, TServerConfig(**sk, spec=spec,
                                           oas=TOASConfig(defer_window=0.0)),
                       pattern=pattern, params=tparams, device="cpu")
    return j, port(tspec.SpecConfig(k=k)), port(None)


def _prompts():
    rng = np.random.default_rng(0)
    gram = tuple(int(t) for t in rng.integers(0, 32, 6))
    return [gram * 4, tuple(int(t) for t in rng.integers(0, 128, 11)),
            gram * 3 + (5,), tuple(int(t) for t in rng.integers(0, 128, 40))]


def _run(srv, reqs):
    s = srv.run(reqs, max_wall_s=600)
    return {r.rid: tuple(r.output_tokens) for r in srv.metrics.done}, s


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_spec_streams_equal_spec_off_and_jax(stack):
    jsrv, on, off = _servers(stack)
    prompts = _prompts()
    jout, js = _run(jsrv, [(p, SamplingParams(max_tokens=16))
                           for p in prompts])
    treqs = [(p, TSamplingParams(max_tokens=16)) for p in prompts]
    tout, ts = _run(on, treqs)
    base, bs = _run(off, treqs)
    assert len(tout) == len(prompts) and tout == base == jout
    for key in ("spec_drafted", "spec_accepted", "spec_verifies"):
        assert ts[key] == js[key], key
    assert ts["spec_accepted"] > 0
    assert ts["tokens_per_verify"] == pytest.approx(js["tokens_per_verify"])
    ds = ts["decode_stats"][0]
    assert ds["host_fetches"] == ds["steps"] < \
        bs["decode_stats"][0]["steps"]
    on.kv_arena.pool.check_invariants(arena=on.kv_arena)


class _WrongSource(tspec.DraftSource):
    """Always proposes an out-of-band token: every window rolls back."""
    name = "wrong"

    def draft(self, rid, h, k):
        return [127] * k


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_all_rejected_rollback_keeps_streams(stack):
    """Every draft is rejected: the streams still equal spec off, every
    emitted token is a window's position-0 token, and the pool and summary
    invariants hold at every quiescent point (the over-extended tail
    blocks are back on the free list)."""
    _, on, off = _servers(stack, k=3)
    on.decodes[0].spec_ctl.sources = [_WrongSource()]
    prompts = _prompts()[:3]
    params = TSamplingParams(max_tokens=10)
    got = {}
    for rid, p in enumerate(prompts):
        on.add_request(p, params)
    while on.proxy.inflight:
        for o in on.step():
            got.setdefault(o.rid, []).extend(o.new_tokens)
        on.kv_arena.pool.check_invariants(arena=on.kv_arena)
    base, _ = _run(off, [(p, params) for p in prompts])
    assert {r: tuple(t) for r, t in got.items()} == base
    de = on.decodes[0]
    v = de.take_spec_stats()
    assert v is not None and de.stats["spec_drafted"] > 0
    assert de.stats["spec_accepted"] == 0
    assert de.stats["spec_emitted"] == de.stats["tokens"]
    assert de.stats["spec_verifies"] == de.stats["steps"]


def test_sampled_slot_rides_the_verify_window():
    """A seeded sampled request shares the batch with greedy ones: it never
    drafts, its stream equals spec off (a draw is a pure function of seed
    and position), and every stream, the sampled one included (the draw is
    the reference's), equals the JAX server's."""
    jsrv, on, off = _servers("full")
    prompts = _prompts()[:3]
    jout, _ = _run(jsrv, [(p, SamplingParams(max_tokens=12))
                          for p in prompts[:2]] + [
        (prompts[2], SamplingParams(temperature=0.8, seed=7,
                                    max_tokens=12))])
    treqs = [(p, TSamplingParams(max_tokens=12)) for p in prompts[:2]] + [
        (prompts[2], TSamplingParams(temperature=0.8, seed=7,
                                     max_tokens=12))]
    tout, ts = _run(on, treqs)
    base, _ = _run(off, treqs)
    assert tout == base and len(tout) == 3
    assert tout == jout
    assert ts["spec_accepted"] > 0
