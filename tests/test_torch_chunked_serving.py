"""Chunked-prefill servers of the PyTorch port over ring layers and dense KV,
against the JAX `Server` on the same bridged weights.

Two reduced qwen2-1.5b stacks (4 layers, OmniAttnConfig(sink_tokens=8,
recent_tokens=24), prefill_sparse so chunked prefill is exact): the mixed
stack of tests/test_paged_prefill.py (sliding-window 16, compressed and
full layers, pattern [0, 0, 0, 1]) and the default pattern (three
compressed layers, one full). Each is served with `chunked_prefill=True` in
both KV layouts (paged: full layers in the arenas, rings per task and then
in the slot's ring block runs; dense: a B=1 max_len cache per task), with
prefix reuse on (prompts sharing a 40-token prefix resume from its
snapshot) and off. Greedy streams equal the reference server's, every
chunk runs through the "prefill.chunk" entry, and the pools' invariants
hold.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest tests/test_torch_chunked_serving.py -q
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config
from repro.configs.base import OmniAttnConfig
from repro.core.proxy import OASConfig
from repro.serving import SamplingParams, Server, ServerConfig
from repro_torch import bridge
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.configs.base import OmniAttnConfig as TOmniAttnConfig
from repro_torch.core.proxy import OASConfig as TOASConfig
from repro_torch.core.proxy import SamplingParams as TSamplingParams
from repro_torch.serving import Server as TServer
from repro_torch.serving import ServerConfig as TServerConfig

torch.set_num_threads(2)

BASE = dict(compute_dtype="float32", param_dtype="float32", n_layers=4,
            prefill_sparse=True)
STACKS = {"mixed": (dict(local_per_global=1, local_window=16),
                    [0, 0, 0, 1]),
          "default_pattern": ({}, None)}
SCFG = dict(n_prefill=1, n_decode=1, decode_slots=3, max_len=128,
            chunk_tokens=16, prefill_tick_budget=32, kv_block_size=8)


def _workload(vocab):
    """Prompts of 9, 33 and 70 tokens (the last two past the 32-slot
    rings), four prompts sharing a 40-token prefix with 8 to 30 distinct
    tokens (with reuse on, a sharer snapshots the prefix and later ones
    resume from it), and an exact repeat of the 70-token prompt."""
    rng = np.random.default_rng(23)

    def toks(n):
        return tuple(int(t) for t in rng.integers(0, vocab, n))
    base = toks(40)
    ps = [toks(9), toks(33), toks(70)]
    return ps + [base + toks(n) for n in (8, 30, 20, 12)] + [ps[2]]


@pytest.fixture(scope="module", params=sorted(STACKS))
def stack(request):
    extra, pattern = STACKS[request.param]
    cfg = reduced_config("qwen2-1.5b").with_updates(
        **BASE, **extra,
        omniattn=OmniAttnConfig(sink_tokens=8, recent_tokens=24))
    tcfg = t_reduced_config("qwen2-1.5b").with_updates(
        **BASE, **extra,
        omniattn=TOmniAttnConfig(sink_tokens=8, recent_tokens=24))
    return request.param, cfg, tcfg, pattern


def _streams(srv, prompts, params_cls):
    reqs = [(p, params_cls(max_tokens=5)) for p in prompts]
    s = srv.run(reqs, max_wall_s=600)
    return {r.rid: tuple(r.output_tokens) for r in srv.metrics.done}, s


@pytest.mark.parametrize("reuse", [True, False], ids=["reuse", "no_reuse"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_chunked_server_matches_jax(stack, paged, reuse):
    name, cfg, tcfg, pattern = stack
    kw = dict(SCFG, paged_kv=paged, prefix_reuse=reuse)
    jsrv = Server(cfg, ServerConfig(**kw, oas=OASConfig(defer_window=0.0)),
                  pattern=pattern)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jsrv.params),
                                       tcfg, jsrv.lm.plan, device="cpu")
    tsrv = TServer(tcfg, TServerConfig(**kw, oas=TOASConfig(
        defer_window=0.0)), pattern=pattern, params=tparams, device="cpu")
    eng = tsrv.prefills[0]
    assert eng.chunked and eng.paged == paged
    assert jsrv.prefills[0].chunked and jsrv.prefills[0].paged == paged
    prompts = _workload(cfg.vocab_size)
    jout, _ = _streams(jsrv, prompts, SamplingParams)
    tout, s = _streams(tsrv, prompts, TSamplingParams)
    assert len(tout) == len(prompts)
    assert tout == jout
    ps, ds = s["prefill_stats"][0], s["decode_stats"][0]
    assert ds["host_fetches"] == ds["steps"] > 0
    assert ps["cache_hits"] == 1                   # the exact repeat
    if reuse:
        assert ps["prefix_hits"] > 0 and ps["reused_tokens"] >= 40
    else:
        assert ps["prefix_hits"] == 0
    if paged:
        assert ds["handoff_copy_bytes"] == 0
        tsrv.kv_arena.pool.check_invariants(arena=tsrv.kv_arena)
        tsrv.kv_arena.check_summaries()
    for e in tsrv.decodes:
        e.pool.check_invariants(arena=tsrv.kv_arena)
    chunk = tsrv.placement.hot_loops.summary()["prefill.chunk"]
    layout = "paged" if paged else "dense"
    assert chunk["eager"] == ps["chunks"] > 0
    assert chunk["keys"] and all(k[1] == layout for k in chunk["keys"])
