"""OmniAttn-compressed serving of the PyTorch port against the JAX reference.

Reduced qwen2-1.5b (4 layers) with OmniAttnConfig(sink_tokens=8,
recent_tokens=24), so prompts of 9/21/33/70 tokens fill, wrap and re-wrap
the 32-slot rings. The default pattern (`pattern=None`: three compressed
layers, one full) and a mixed stack (sliding-window, full and compressed
layers, as tests/test_serving.py:377) go through whole-prompt prefill, then
slot-dense and paged decode, on the same bridged weights; the servers of
both packages give the same greedy streams in both KV layouts, with prefix
reuse on and off and under preemption. Logit tolerance 2e-3: the one of
tests/test_consistency.py:40 (f32, two stacks summing in different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config
from repro.core.proxy import OASConfig
from repro.distributed.ctx import local_mesh_ctx
from repro.models import LM
from repro.models import stack as jstack
from repro.serving import SamplingParams, Server, ServerConfig
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.core.proxy import OASConfig as TOASConfig
from repro_torch.core.proxy import SamplingParams as TSamplingParams
from repro_torch.models import stack as tstack
from repro_torch.models.lm import LM as TLM
from repro_torch.serving import Server as TServer
from repro_torch.serving import ServerConfig as TServerConfig
from repro_torch.serving.arena import blocks_to_dense_kv, dense_kv_to_blocks

torch.set_num_threads(2)

TOL = dict(rtol=2e-3, atol=2e-3)
MAX_LEN = 128
LENS = (9, 21, 33, 70)
BASE = dict(compute_dtype="float32", param_dtype="float32", n_layers=4,
            omniattn_sink_tokens=8, omniattn_recent_tokens=24)
VARIANTS = {"default": (dict(), None),
            "mixed": (dict(local_per_global=1, local_window=16),
                      [0, 0, 0, 1])}


def _bucket(n, lo=8):
    b = lo
    while b < n:
        b *= 2
    return min(b, MAX_LEN)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def models(request):
    extra, pattern = VARIANTS[request.param]
    cfg = reduced_config("qwen2-1.5b").with_updates(**BASE, **extra)
    lm = LM.build(cfg, local_mesh_ctx(), pattern=pattern)
    params = lm.init(jax.random.PRNGKey(0))
    tcfg = t_reduced_config("qwen2-1.5b").with_updates(**BASE, **extra)
    tlm = TLM.build(tcfg, pattern=pattern, device="cpu")
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       tcfg, tlm.plan, device="cpu")
    return request.param, lm, params, tlm, tparams


def _j_layers(plan, cache):
    """The reference's period/rem cache → one numpy dict per layer."""
    P = len(plan.period)
    out = []
    for r in range(plan.n_rep):
        for i in range(P):
            out.append({k: np.asarray(x)[r]
                        for k, x in cache["period"][i].items()})
    out += [{k: np.asarray(x) for k, x in e.items()} for e in cache["rem"]]
    return out


def _j_restack(plan, layers):
    """One dict per layer → the reference's period/rem layout."""
    P = len(plan.period)
    per = tuple({k: jnp.asarray(np.stack([layers[r * P + i][k]
                                          for r in range(plan.n_rep)]))
                 for k in layers[i]} for i in range(P))
    rem = tuple({k: jnp.asarray(v) for k, v in e.items()}
                for e in layers[plan.n_rep * P:])
    return per, rem


def _specs(specs):
    return [(s.kind, s.window, s.use_moe, s.compressed) for s in specs]


def _prompts(vocab, seed=7):
    rng = np.random.default_rng(seed)
    return [tuple(int(t) for t in rng.integers(0, vocab, n)) for n in LENS]


def test_ring_layers_in_the_plan(models):
    name, lm, _, tlm, _ = models
    specs = tlm.plan.all_specs()
    assert _specs(specs) == _specs(lm.plan.all_specs())
    assert sum(s.compressed for s in specs) == (3 if name == "default" else 1)
    assert tlm.chunked_prefill_support == lm.chunked_prefill_support
    if name == "default":
        assert tlm.chunked_prefill_support == (False, 0)


@pytest.mark.parametrize("n", LENS)
def test_prefill_then_decode_logits_match(models, n):
    """LM.prefill on a right-padded prompt: logits and every layer's cache
    (rings compressed slot for slot, full layers padded to max_len); then
    four slot-dense decode steps through cache_write + sink decode."""
    _, lm, params, tlm, tparams = models
    cfg = lm.cfg
    toks = list(_prompts(cfg.vocab_size, seed=n)[LENS.index(n)])
    S = _bucket(n)
    padded = toks + [0] * (S - n)
    jcache, jl, _ = jax.jit(lambda p, t, tl: lm.prefill(
        p, {"tokens": t}, max_len=MAX_LEN, true_len=tl))(
        params, jnp.asarray([padded], jnp.int32), jnp.int32(n))
    tcache, tl, _ = tlm.prefill(tparams,
                                torch.tensor([padded], dtype=torch.int32),
                                max_len=MAX_LEN, true_len=n)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tcache["pos"] == n == int(jcache["pos"])
    for jl_, tl_ in zip(_j_layers(lm.plan, jcache), tcache["layers"]):
        for name in ("k", "v"):
            assert tl_[name].shape == jl_[name].shape
            np.testing.assert_allclose(tl_[name].numpy(), jl_[name], **TOL)

    jdecode = jax.jit(lambda p, c, t, pos: lm.decode(p, c, t, pos)[:2])
    tok, pos = int(np.argmax(np.asarray(jl)[0])), n
    for _ in range(4):
        jcache, jl = jdecode(params, jcache, jnp.asarray([[tok]], jnp.int32),
                             jnp.asarray([[pos]], jnp.int32))
        tcache, tl, _ = tlm.decode(tparams, tcache,
                                torch.tensor([[tok]], dtype=torch.int32),
                                torch.tensor([[pos]], dtype=torch.int32))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        tok, pos = int(np.argmax(np.asarray(jl)[0])), pos + 1


def test_paged_decode_over_rings_matches(models):
    """Two sequences (33 and 70 tokens) prefilled, scattered into paged
    caches — full layers through scrambled block tables, ring layers into
    each slot's own block run — then decoded together: logits, and the
    ring runs read back slot for slot."""
    _, lm, params, tlm, tparams = models
    cfg, tcfg, plan = lm.cfg, tlm.cfg, lm.plan
    bs, N = 8, 40
    nb = MAX_LEN // bs
    rng = np.random.default_rng(1)
    rows = rng.permutation(np.arange(1, N))[:2 * nb].reshape(2, nb)
    rows = rows.astype(np.int32)
    seqs = [list(_prompts(cfg.vocab_size, seed=s)[i])
            for s, i in ((33, 2), (70, 3))]
    dense, first = [], []
    for toks in seqs:
        n = len(toks)
        c, lg, _ = tlm.prefill(tparams, torch.tensor(
            [toks + [0] * (_bucket(n) - n)], dtype=torch.int32),
            max_len=MAX_LEN, true_len=n)
        dense.append(c)
        first.append(int(lg.argmax()))
    layers = []
    for i, spec in enumerate(plan.all_specs()):
        sink, recent = jstack.cache_window(cfg, spec)
        ent = {}
        for name in ("k", "v"):
            xs = [d["layers"][i][name][0] for d in dense]       # [L, K, h]
            if sink or recent:
                bpw = jstack.ring_block_count(sink, recent, bs)
                ent[name] = torch.cat([dense_kv_to_blocks(x, bpw, bs)
                                       for x in xs]).numpy()
            else:
                a = np.zeros((N, cfg.n_kv_heads, bs, cfg.head_dim),
                             np.float32)
                for b, x in enumerate(xs):
                    a[rows[b]] = dense_kv_to_blocks(x, nb, bs).numpy()
                ent[name] = a
        if not (sink or recent):
            for sname in ("kmin", "kmax", "kmean"):
                ent[sname] = np.zeros((N, cfg.n_kv_heads, cfg.head_dim),
                                      np.float32)
        layers.append(ent)
    per, rem = _j_restack(plan, layers)
    jcache = {"period": per, "rem": rem, "pos": jnp.int32(0)}
    tcache = {"layers": [{k: torch.from_numpy(v.copy()) for k, v in e.items()}
                         for e in layers], "pos": 0}
    jdecode = jax.jit(lambda p, c, t, pos, bt: lm.decode(
        p, c, t, pos, block_tables=bt)[:2])
    toks = np.array([[first[0]], [first[1]]], np.int32)
    pos = np.array([[len(s)] for s in seqs], np.int32)
    for _ in range(4):
        jcache, jl = jdecode(params, jcache, jnp.asarray(toks),
                             jnp.asarray(pos), jnp.asarray(rows))
        tcache, tl, _ = tlm.decode(tparams, tcache, torch.from_numpy(toks),
                                torch.from_numpy(pos),
                                block_tables=torch.from_numpy(rows))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        toks = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        pos = pos + 1
    for i, (spec, jl_) in enumerate(zip(plan.all_specs(),
                                        _j_layers(plan, jcache))):
        sink, recent = jstack.cache_window(cfg, spec)
        if not (sink or recent):
            continue
        bpw = jstack.ring_block_count(sink, recent, bs)
        for b in range(2):
            got = blocks_to_dense_kv(tcache["layers"][i]["k"][
                b * bpw:(b + 1) * bpw], sink + recent)
            want = blocks_to_dense_kv(torch.from_numpy(
                jl_["k"][b * bpw:(b + 1) * bpw].copy()), sink + recent)
            np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_chunked_prefill_over_rings_raises(models):
    """Chunked prefill over ring layers serves (it raised before the
    reference's prefill_resume_attention was ported): a 70-token prompt in
    chunks of 16 (the last padded, 6 real rows of 8) through
    LM.prefill_resume, full layers paged through a block table and rings
    dense, against the reference's chunks over its dense cache — logits of
    every chunk, the rings slot for slot and the full layers' KV."""
    _, lm, params, tlm, tparams = models
    cfg = tlm.cfg
    n, bs = LENS[3], 8
    toks = list(_prompts(cfg.vocab_size, seed=n)[3])
    nb = MAX_LEN // bs
    priv = tstack.alloc_prefill_private_cache(cfg, tlm.plan, MAX_LEN, "cpu")
    arena = tstack.alloc_arena_kv(cfg, tlm.plan, nb + 1, bs, "cpu")
    tcache = tstack.merge_arena_cache(cfg, tlm.plan, priv, arena)
    row = torch.arange(1, nb + 1, dtype=torch.int32)[None]
    jcache = jstack.alloc_cache(cfg, local_mesh_ctx(), lm.plan, 1, MAX_LEN)
    jresume = jax.jit(lambda p, t, c, cl: lm.prefill_resume(
        p, {"tokens": t}, c, max_len=MAX_LEN, chunk_len=cl)[:2])
    cur = 0
    while cur < n:
        cl = min(16, n - cur)
        S = _bucket(cl)
        chunk = toks[cur:cur + cl] + [0] * (S - cl)
        jcache, jl = jresume(params, jnp.asarray([chunk], jnp.int32), jcache,
                             jnp.int32(cl))
        tcache, tl, _ = tlm.prefill_resume(
            tparams, torch.tensor([chunk], dtype=torch.int32), tcache,
            chunk_len=cl, block_tables=row)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        cur += cl
    assert tcache["pos"] == n == int(jcache["pos"])
    for spec, jl_, tl_ in zip(tlm.plan.all_specs(),
                              _j_layers(lm.plan, jcache), tcache["layers"]):
        for name in ("k", "v"):
            if tstack.full_attn_layer(cfg, spec):
                got = blocks_to_dense_kv(tl_[name][1:], MAX_LEN)[:n]
                want = jl_[name][0, :n]
            else:
                got, want = tl_[name][0], jl_[name][0]
            np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_bridge_under_the_default_pattern_plan():
    """Full-width qwen2-1.5b under pattern=None periodizes into the 4-layer
    OmniAttn period (3 compressed + 1 full) repeated 7 times; the bridge
    unstacks it in layer order. Checked on the plan and on a tree of tiny
    stand-in leaves (no full-width weights are made here)."""
    jcfg, tcfg = j_get_config("qwen2-1.5b"), t_get_config("qwen2-1.5b")
    jplan = jstack.StackPlan.from_config(jcfg, None)
    tplan = tstack.StackPlan.from_config(tcfg, None)
    assert (tplan.n_rep, len(tplan.period), len(tplan.rem)) == (7, 4, 0)
    assert (jplan.n_rep, _specs(jplan.period), _specs(jplan.rem)) == \
        (tplan.n_rep, _specs(tplan.period), _specs(tplan.rem))
    assert [s.compressed for s in tplan.period] == [True, True, True, False]
    tree = {"stack": {"period": tuple(
        {"wq": np.arange(7, dtype=np.float32)[:, None] * 10 + i}
        for i in range(4)), "rem": ()},
        "embed": np.zeros((2, 2), np.float32),
        "final_norm": np.ones(2, np.float32)}
    out = bridge.params_from_numpy(tree, tcfg, tplan, device="cpu")
    assert [float(p["wq"][0]) for p in out["layers"]] == \
        [r * 10.0 + i for r in range(7) for i in range(4)]


# ----------------------------------------------------------------------
# Servers
SCFG = dict(n_prefill=1, n_decode=1, decode_slots=3, max_len=MAX_LEN,
            chunk_tokens=16, prefill_tick_budget=32, kv_block_size=8)


def _workload(vocab):
    """Prompts of 9/21/33/70 tokens, an exact repeat of the 70-token one
    (whole-prompt adoption from the prefix store) and a second 21-token
    prompt; 5 greedy tokens each."""
    ps = _prompts(vocab)
    rng = np.random.default_rng(19)
    return ps + [ps[3], tuple(int(t) for t in rng.integers(0, vocab, 21))]


@pytest.fixture(scope="module")
def servers():
    cfg = reduced_config("qwen2-1.5b").with_updates(**BASE)
    tcfg = t_reduced_config("qwen2-1.5b").with_updates(**BASE)
    ref = {}

    def build(paged, reuse, kv_blocks=None):
        kw = dict(SCFG, paged_kv=paged, prefix_reuse=reuse,
                  kv_blocks=kv_blocks)
        jsrv = Server(cfg, ServerConfig(**kw, oas=OASConfig(
            defer_window=0.0)))
        tparams = bridge.params_from_numpy(
            jax.tree.map(np.asarray, jsrv.params), tcfg, jsrv.lm.plan,
            device="cpu")
        tsrv = TServer(tcfg, TServerConfig(**kw, oas=TOASConfig(
            defer_window=0.0)), params=tparams, device="cpu")
        return jsrv, tsrv

    def jax_streams(paged, kv_blocks=None):
        """The reference's streams, once per layout and pool (the JAX
        server compiles anew for every instance)."""
        key = (paged, kv_blocks)
        if key not in ref:
            jsrv, _ = build(paged, True, kv_blocks)
            ref[key] = _greedy_streams(jsrv, _workload(cfg.vocab_size),
                                       SamplingParams)[0]
        return ref[key]
    return cfg, build, jax_streams


def _greedy_streams(srv, prompts, params_cls):
    reqs = [(p, params_cls(max_tokens=5)) for p in prompts]
    s = srv.run(reqs, max_wall_s=600)
    return {r.rid: tuple(r.output_tokens) for r in srv.metrics.done}, s


def _check_pools(tsrv):
    for e in tsrv.decodes:
        e.pool.check_invariants(arena=tsrv.kv_arena)


@pytest.mark.parametrize("reuse", [True, False], ids=["reuse", "no_reuse"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_default_pattern_server_matches_jax(servers, paged, reuse):
    cfg, build, jax_streams = servers
    _, tsrv = build(paged, reuse)
    assert not tsrv.prefills[0].chunked and (tsrv.kv_arena is None) != paged
    prompts = _workload(cfg.vocab_size)
    tout, s = _greedy_streams(tsrv, prompts, TSamplingParams)
    assert len(tout) == len(prompts)
    assert tout == jax_streams(paged)
    ps, ds = s["prefill_stats"][0], s["decode_stats"][0]
    assert ds["host_fetches"] == ds["steps"] > 0
    # whole-prompt mode adopts an exact repeat with reuse on or off (partial
    # reuse needs chunks), as the reference does
    assert ps["cache_hits"] == 1 and ps["prefix_hits"] == 0
    assert ps["prefills"] == len(prompts) - ps["cache_hits"]
    _check_pools(tsrv)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_default_pattern_preemption_keeps_streams(servers, paged):
    """A pool too small for every slot preempts (ring and full KV gathered
    out and scattered back in); the streams still equal the reference's
    on the same pool."""
    cfg, build, jax_streams = servers
    _, tsrv = build(paged, True, kv_blocks=10)
    tout, s = _greedy_streams(tsrv, _workload(cfg.vocab_size),
                              TSamplingParams)
    assert s["decode_stats"][0]["preemptions"] > 0
    assert tout == jax_streams(paged, 10)
    _check_pools(tsrv)


def test_whole_prompt_prefill_of_a_full_attention_stack_matches_jax():
    """chunked_prefill=False on an all-full-attention stack: whole-prompt
    prefill into dense caches, then dense-scatter admission into the paged
    arenas (block summaries recomputed) — the reference's compat path."""
    cfg = reduced_config("qwen2-1.5b").with_updates(**BASE)
    tcfg = t_reduced_config("qwen2-1.5b").with_updates(**BASE)
    kw = dict(SCFG, chunked_prefill=False)
    jsrv = Server(cfg, ServerConfig(**kw, oas=OASConfig(defer_window=0.0)),
                  pattern=[0] * 4)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jsrv.params),
                                       tcfg, jsrv.lm.plan, device="cpu")
    tsrv = TServer(tcfg, TServerConfig(**kw, oas=TOASConfig(
        defer_window=0.0)), pattern=[0] * 4, params=tparams, device="cpu")
    prompts = _workload(cfg.vocab_size)
    jout, _ = _greedy_streams(jsrv, prompts, SamplingParams)
    tout, s = _greedy_streams(tsrv, prompts, TSamplingParams)
    assert tout == jout and len(tout) == len(prompts)
    assert s["prefill_stats"][0]["chunks"] == 0
    assert s["decode_stats"][0]["handoff_copy_bytes"] > 0
    _check_pools(tsrv)
    tsrv.kv_arena.check_summaries()
