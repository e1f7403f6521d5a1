"""Compositions the reference serves and the port once refused, each held to
the JAX `Server` on the same bridged weights (speculation with MoE layers is
held in tests/test_torch_placement.py, beside the MoE servers):

- online top-k with MoE layers: reduced qwen2-moe-a2.7b and
  qwen3-moe-235b-a22b (norm_topk_prob) with a budget below the resident
  count: the greedy streams, the sparsity summary (blocks scored /
  attended, attention mass kept) and the run's expert counts equal the JAX
  server's; a budget that keeps every block equals top-k off;
- top-k knobs on the slot-dense layout: ignored, as the reference ignores
  them (it builds the selection controller in its paged branch only): the
  streams equal the JAX server's with the same knobs and top-k off's, and
  nothing is reported as selected.

The MoE references are built on an Auto-axis mesh (their MoE decode needs
one on this jax; ROADMAP C1). Streams, block counts and expert counts
are compared exactly; the attention mass kept to 1e-4 relative.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import reduced_config
from repro.core.proxy import OASConfig
from repro.distributed.ctx import MeshCtx
from repro.serving import SamplingParams, Server, ServerConfig
from repro_torch import bridge
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.core.proxy import OASConfig as TOASConfig
from repro_torch.core.proxy import SamplingParams as TSamplingParams
from repro_torch.serving import Server as TServer
from repro_torch.serving import ServerConfig as TServerConfig

torch.set_num_threads(2)

SCFG = dict(n_prefill=1, n_decode=1, decode_slots=3, max_len=128,
            chunk_tokens=16, prefill_tick_budget=32, kv_blocks=60,
            kv_block_size=8, placement_interval=2)


def _mesh():
    return MeshCtx(jax.make_mesh((1, 1), ("data", "model"),
                                 axis_types=(AxisType.Auto,) * 2))


def _pair(arch, scfg, jparams=None, **over):
    """A JAX server and the port's on the same weights (the JAX server's
    own, or `jparams`)."""
    kw = dict(compute_dtype="float32", param_dtype="float32", **over)
    cfg = reduced_config(arch).with_updates(**kw)
    tcfg = t_reduced_config(arch).with_updates(**kw)
    pattern = [0] * cfg.n_layers
    j = Server(cfg, ServerConfig(**scfg, oas=OASConfig(defer_window=0.0)),
               mesh=_mesh() if cfg.moe.n_experts else None, pattern=pattern,
               params=jparams)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, j.params),
                                       tcfg, j.lm.plan, device="cpu")
    t = TServer(tcfg, TServerConfig(**scfg, oas=TOASConfig(
        defer_window=0.0)), pattern=pattern, params=tparams, device="cpu")
    return j, t


def _run(srv, prompts, params_cls, n=8):
    s = srv.run([(p, params_cls(max_tokens=n)) for p in prompts],
                max_wall_s=600)
    return {r.rid: tuple(r.output_tokens) for r in srv.metrics.done}, s


def _window(srv):
    return [np.asarray(w) for w in srv.placement_sched._window]


def _prompts(vocab, lens=(50, 70, 33, 90), seed=11):
    rng = np.random.default_rng(seed)
    return [tuple(int(x) for x in rng.integers(0, vocab, n)) for n in lens]


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"])
def test_topk_with_moe_layers_matches_jax_server(arch):
    """A budget below the resident count on every MoE layer's attention:
    streams, sparsity summary and the run's expert counts equal the JAX
    server's."""
    jsrv, tsrv = _pair(arch, SCFG, omniattn_topk_blocks=3,
                       omniattn_topk_measure_mass=True)
    prompts = _prompts(jsrv.cfg.vocab_size)
    jout, js = _run(jsrv, prompts, SamplingParams)
    tout, ts = _run(tsrv, prompts, TSamplingParams)
    assert len(tout) == len(prompts) and tout == jout
    for k in ("blocks_scored", "blocks_attended"):
        assert ts[k] == js[k] > 0, k
    assert ts["blocks_attended"] < ts["blocks_scored"]
    # the mass is a float32 softmax sum over the selected keys, whose
    # inputs pass through MoE layers (a routed sum over experts, added in
    # another order than the reference's): equal to 1e-4 relative
    assert ts["attn_mass_kept"] == pytest.approx(js["attn_mass_kept"],
                                                 rel=1e-4)
    # the run's expert counts: every monitor tick's drained window plus
    # what is left. Per tick the windows follow which round each request
    # joins decode in, and the port prefills whole chunks where the
    # reference's round budget cuts one (ROADMAP C4): 18 chunks against
    # 19 here, so requests join a round apart while the totals agree
    jw, tw = _window(jsrv), _window(tsrv)
    assert len(tw) == len(jw) >= 2
    np.testing.assert_array_equal(
        sum(tw) + tsrv.decodes[0].take_moe_counts(),
        sum(jw) + jsrv.decodes[0].take_moe_counts())
    ds = ts["decode_stats"][0]
    assert ds["host_fetches"] == ds["steps"] > 0
    tsrv.kv_arena.pool.check_invariants(arena=tsrv.kv_arena)


def test_topk_with_moe_full_budget_equals_exact():
    """Prompts of 9-13 blocks keep the decode table at its 16-wide bucket;
    a budget of 15 blocks runs selection every step and keeps every block:
    the streams equal top-k off exactly (qwen3-moe, both servers)."""
    arch = "qwen3-moe-235b-a22b"
    jsrv, tsrv = _pair(arch, SCFG, omniattn_topk_blocks=15)
    _, exact = _pair(arch, SCFG, jparams=jsrv.params)
    prompts = _prompts(jsrv.cfg.vocab_size, (72, 90, 81, 99), seed=12)
    sel, s = _run(tsrv, prompts, TSamplingParams)
    ref_out, _ = _run(exact, prompts, TSamplingParams)
    jout, _ = _run(jsrv, prompts, SamplingParams)
    assert sel == ref_out == jout and len(sel) == len(prompts)
    assert s["blocks_attended"] == s["blocks_scored"] > 0


@pytest.mark.parametrize("chunked", [True, False], ids=["chunked", "whole"])
def test_topk_knobs_on_slot_dense_layout_are_ignored(chunked):
    """The slot-dense layout with top-k knobs serves top-k off's streams,
    the JAX server's with the same knobs, and reports no selection."""
    scfg = dict(SCFG, paged_kv=False, chunked_prefill=chunked)
    topk = dict(omniattn_topk_blocks=3, vocab_size=128, n_layers=2)
    jsrv, tsrv = _pair("qwen2-1.5b", scfg, **topk)
    _, off = _pair("qwen2-1.5b", scfg, jparams=jsrv.params, vocab_size=128,
                   n_layers=2)
    assert tsrv.decodes[0].sparsity is None and not tsrv.decodes[0].paged
    prompts = _prompts(128)
    jout, js = _run(jsrv, prompts, SamplingParams)
    tout, ts = _run(tsrv, prompts, TSamplingParams)
    base, _ = _run(off, prompts, TSamplingParams)
    assert len(tout) == len(prompts) and tout == jout == base
    assert not ts.get("blocks_scored") and not js.get("blocks_scored")
    ds = ts["decode_stats"][0]
    assert ds["host_fetches"] == ds["steps"] > 0
    tsrv.decodes[0].pool.check_invariants()
