"""The reference's other four decoders in the PyTorch port: qwen3-32b
(qk_norm, GQA 64/8), granite-34b (MQA: 48 query heads over one kv head),
gemma3-4b (head_dim 256, 5 local : 1 global, 1,024-token windows, tied)
and qwen3-moe-235b-a22b (128 experts top-8, norm_topk_prob, qk_norm).

For each, at its `reduced_config` in float32 (the reference's own smoke
sizes: gemma3's 12 layers with 32-token windows, so its rings wrap and its
chunked prefill goes through the ring path):
- the port's registry holds the reference's configuration field for field;
- `LM` logits of chunked paged prefill (a chunk ending mid-block, full
  chunks, a padded tail), then of paged decode steps (slot-dense decode
  after whole-prompt prefill where ring layers live in a prefill task's
  dense ring caches: gemma3), equal the JAX `LM`'s on the same weights
  (`LM.init(PRNGKey(0))`, bridged through numpy), and so do the MoE
  counts of every decode step;
- the port's `Server` gives the JAX `Server`'s greedy streams with prefix
  reuse on and off, chunked, with the pool invariants green.
The MoE reference is built on an Auto-axis mesh (its MoE decode needs one
on this jax; ROADMAP C1). Tolerance: TOL of tests/test_torch_model.py
(float32 logits through two stacks summing in different orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_config, reduced_config
from repro.core.proxy import OASConfig
from repro.distributed.ctx import MeshCtx, local_mesh_ctx
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

torch.set_num_threads(2)

TOL = dict(rtol=2e-3, atol=2e-3)
ARCHS = ("qwen3-32b", "granite-34b", "gemma3-4b", "qwen3-moe-235b-a22b")
SCFG = dict(n_prefill=1, n_decode=1, decode_slots=3, max_len=96,
            chunk_tokens=16, prefill_tick_budget=32, kv_blocks=40,
            kv_block_size=8)


def _mesh(cfg):
    if cfg.moe.n_experts:
        return MeshCtx(jax.make_mesh((1, 1), ("data", "model"),
                                     axis_types=(AxisType.Auto,) * 2))
    return local_mesh_ctx()


def _cfgs(arch):
    kw = dict(compute_dtype="float32", param_dtype="float32")
    return (reduced_config(arch).with_updates(**kw),
            t_reduced_config(arch).with_updates(**kw))


def _pattern(cfg):
    return [0] * cfg.n_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_holds_reference_config(arch):
    ref, port = get_config(arch), t_get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(t_reduced_config(arch)) == \
        dataclasses.asdict(reduced_config(arch))
    # every configuration the port registers builds on the CPU
    TLM.build(t_reduced_config(arch), pattern=None, device="cpu")


_MODELS: dict = {}


def _models(arch):
    """(JAX LM, its params, port LM, bridged params), once per arch."""
    if arch not in _MODELS:
        cfg, tcfg = _cfgs(arch)
        pattern = _pattern(cfg)
        lm = LM.build(cfg, _mesh(cfg), pattern=pattern)
        params = lm.init(jax.random.PRNGKey(0))
        tlm = TLM.build(tcfg, pattern=pattern, device="cpu")
        tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                           tcfg, tlm.plan, device="cpu")
        _MODELS[arch] = lm, params, tlm, tparams
    return _MODELS[arch]


def _counts(jaux):
    """The reference's per-layer expert counts [L_moe, E] in layer order."""
    return np.concatenate(
        [np.asarray(c).reshape(-1, c.shape[-1])
         for c in jaux["period_counts"]]
        + [np.asarray(c)[None] for c in jaux["rem_counts"]])


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
    # 40 tokens: past the 32-token windows of reduced gemma3
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
    if any(not tstack.full_attn_layer(tcfg, s) for s in tlm.plan.all_specs()):
        return       # ring layers decode paged from an engine's ring runs
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
                torch.stack(aux["moe_counts"]).numpy(), _counts(jaux))
        tok = int(np.argmax(np.asarray(jl)[0]))
        cur += 1


@pytest.mark.parametrize("arch", ARCHS)
def test_whole_prompt_prefill_and_dense_decode_logits_match(arch):
    """Whole-prompt prefill (flash_prefill's plain version, gemma3's local
    layers under their window) into dense caches, then slot-dense decode
    steps (sink_decode's plain version over rings that wrap)."""
    lm, params, tlm, tparams = _models(arch)
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
                torch.stack(aux["moe_counts"]).numpy(), _counts(jaux))
        tok = int(np.argmax(np.asarray(jl)[0]))
        cur += 1


def _workload(vocab, n=5, prefix=40):
    """Two of three prompts share a `prefix`-token system prefix plus 8
    distinct tokens (48 tokens: reduced gemma3's rings wrap); the rest
    are short."""
    rng = np.random.default_rng(23)
    base = tuple(int(t) for t in rng.integers(0, vocab, prefix))
    return [base + tuple(int(t) for t in rng.integers(0, vocab, 8))
            if i % 3 != 2 else
            tuple(int(t) for t in rng.integers(0, vocab, 6))
            for i in range(n)]


@pytest.mark.parametrize("reuse", [True, False], ids=["reuse", "no_reuse"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_identical_to_jax_server(arch, reuse):
    cfg, tcfg = _cfgs(arch)
    pattern = _pattern(cfg)
    kw = dict(SCFG, prefix_reuse=reuse)
    jsrv = Server(cfg, ServerConfig(**kw, oas=OASConfig(defer_window=0.0)),
                  mesh=_mesh(cfg), pattern=pattern)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jsrv.params),
                                       tcfg, jsrv.lm.plan, device="cpu")
    tsrv = TServer(tcfg, TServerConfig(**kw, oas=TOASConfig(
        defer_window=0.0)), pattern=pattern, params=tparams, device="cpu")
    assert tsrv.prefills[0].chunked and jsrv.prefills[0].chunked
    prompts = _workload(cfg.vocab_size)
    jsrv.run([(p, SamplingParams(max_tokens=4)) for p in prompts],
             max_wall_s=600)
    ts = tsrv.run([(p, TSamplingParams(max_tokens=4)) for p in prompts],
                  max_wall_s=600)
    jout = {r.rid: tuple(r.output_tokens) for r in jsrv.metrics.done}
    tout = {r.rid: tuple(r.output_tokens) for r in tsrv.metrics.done}
    assert len(tout) == len(prompts) and tout == jout
    ps, ds = ts["prefill_stats"][0], ts["decode_stats"][0]
    assert ds["host_fetches"] == ds["steps"] > 0
    assert ds["handoff_copy_bytes"] == 0
    assert (ps["reused_tokens"] > 0) == reuse
    tsrv.kv_arena.pool.check_invariants(arena=tsrv.kv_arena)
    if cfg.moe.n_experts:
        np.testing.assert_array_equal(tsrv.decodes[0].take_moe_counts(),
                                      jsrv.decodes[0].take_moe_counts())
