"""Serving slice of the PyTorch port against the JAX reference: the JAX
`Server` and the port's `Server`, on the same bridged weights and a small
shared-prefix workload, give identical greedy streams, and identical
seeded sampled streams (chunked over paged and dense KV, whole-prompt
under the default OmniAttn pattern); the port's pool invariants hold at
quiescence and a decode step does one host fetch."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config
from repro.configs.base import OmniAttnConfig
from repro.core.proxy import OASConfig
from repro.serving import SamplingParams, Server, ServerConfig
from repro.serving.kvpool import KVPool
from repro_torch import bridge
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.configs.base import OmniAttnConfig as TOmniAttnConfig
from repro_torch.core.proxy import OASConfig as TOASConfig
from repro_torch.core.proxy import SamplingParams as TSamplingParams
from repro_torch.serving import FaultConfig as TFaultConfig
from repro_torch.serving import FaultPlane as TFaultPlane
from repro_torch.serving import Server as TServer
from repro_torch.serving import ServerConfig as TServerConfig
from repro_torch.serving.kvpool import KVPool as TKVPool
from repro_torch.serving.quant import QuantConfig as TQuantConfig
from repro_torch.serving.spec import SpecConfig as TSpecConfig
from jax_preempt_repair import jax_preempt_repaired  # noqa: F401 (C7)

torch.set_num_threads(2)

SCFG = dict(n_prefill=1, n_decode=1, decode_slots=3, max_len=96,
            chunk_tokens=16, prefill_tick_budget=32, kv_blocks=40,
            kv_block_size=8)


def _workload(vocab, n=7, prefix=40):
    """bench_serving._workload in miniature: two of three prompts share a
    `prefix`-token system prefix plus 8 distinct tokens; the rest are
    short. Greedy, 4 new tokens each."""
    rng = np.random.default_rng(7)
    base = tuple(int(t) for t in rng.integers(0, vocab, prefix))
    out = []
    for i in range(n):
        if i % 3 != 2:
            out.append(base + tuple(int(t) for t in
                                    rng.integers(0, vocab, 8)))
        else:
            out.append(tuple(int(t) for t in rng.integers(0, vocab, 6)))
    return out


@pytest.fixture(scope="module")
def servers():
    cfg = reduced_config("qwen2-1.5b").with_updates(
        compute_dtype="float32", param_dtype="float32", n_layers=2)
    tcfg = t_reduced_config("qwen2-1.5b").with_updates(
        compute_dtype="float32", param_dtype="float32", n_layers=2)

    def build(reuse, kv_blocks=SCFG["kv_blocks"]):
        kw = dict(SCFG, prefix_reuse=reuse, kv_blocks=kv_blocks)
        jsrv = Server(cfg, ServerConfig(**kw, oas=OASConfig(
            defer_window=0.0)), pattern=[0, 0])
        tparams = bridge.params_from_numpy(
            jax.tree.map(np.asarray, jsrv.params), tcfg, jsrv.lm.plan,
            device="cpu")
        tsrv = TServer(tcfg, TServerConfig(**kw, oas=TOASConfig(
            defer_window=0.0)), pattern=[0, 0], params=tparams,
            device="cpu")
        return jsrv, tsrv
    return cfg, build


def _greedy_streams(srv, prompts, params_cls):
    reqs = [(p, params_cls(max_tokens=4)) for p in prompts]
    s = srv.run(reqs, max_wall_s=600)
    return {r.rid: tuple(r.output_tokens) for r in srv.metrics.done}, s


@pytest.mark.parametrize("reuse", [True, False])
def test_greedy_streams_identical_to_jax_server(servers, reuse):
    cfg, build = servers
    jsrv, tsrv = build(reuse)
    prompts = _workload(cfg.vocab_size)
    jout, _ = _greedy_streams(jsrv, prompts, SamplingParams)
    tout, s = _greedy_streams(tsrv, prompts, TSamplingParams)
    assert len(tout) == len(prompts)
    assert tout == jout
    ps, ds = s["prefill_stats"][0], s["decode_stats"][0]
    assert ds["host_fetches"] == ds["steps"] > 0
    assert ds["handoff_copy_bytes"] == 0
    if reuse:
        assert ps["reused_tokens"] > 0 and ps["prefix_hits"] > 0
    tsrv.kv_arena.pool.check_invariants(arena=tsrv.kv_arena)


def test_preemption_under_a_small_pool_keeps_streams(servers):
    """A pool too small for every slot forces reclaim/defer/preemption;
    the streams still equal the JAX server's on the same pool (12 blocks:
    with whole-chunk prefill rounds, 14 no longer forces a preemption)."""
    cfg, build = servers
    jsrv, tsrv = build(True, kv_blocks=12)
    prompts = _workload(cfg.vocab_size, n=5)
    jout, _ = _greedy_streams(jsrv, prompts, SamplingParams)
    tout, s = _greedy_streams(tsrv, prompts, TSamplingParams)
    assert tout == jout and len(tout) == len(prompts)
    assert s["decode_stats"][0]["preemptions"] > 0
    assert s["prefill_stats"][0]["defers"] > 0
    tsrv.kv_arena.pool.check_invariants(arena=tsrv.kv_arena)


def test_streaming_api_and_abort(servers):
    cfg, build = servers
    _, tsrv = build(True)
    prompts = _workload(cfg.vocab_size, n=3)
    outs = list(tsrv.generate(prompts[:2], TSamplingParams(max_tokens=3)))
    done = [o for o in outs if o.finished]
    assert sorted(o.rid for o in done) == [0, 1]
    assert all(o.finish_reason == "length" and o.n_generated == 3
               for o in done)
    # a stop token ends the stream where it first appears
    first = tuple(t for o in outs if o.rid == 0 for t in o.new_tokens)
    stop = list(tsrv.generate(prompts[0], TSamplingParams(
        max_tokens=3, stop_token_ids=(first[1],))))
    end = [o for o in stop if o.finished][0]
    assert end.finish_reason == "stop"
    assert end.n_generated == first.index(first[1]) + 1
    rid = tsrv.add_request(prompts[2], TSamplingParams(max_tokens=50))
    tsrv.step()
    assert tsrv.abort(rid)
    out = tsrv.step()
    assert any(o.rid == rid and o.finish_reason == "abort" for o in out)
    assert rid not in tsrv.kv_arena.pool
    tsrv.kv_arena.pool.check_invariants(arena=tsrv.kv_arena)


def test_sampled_requests_are_reproducible(servers):
    """Seeded sampled streams depend only on (seed, position): the same
    request alone and beside other traffic gives the same tokens."""
    cfg, build = servers
    prompts = _workload(cfg.vocab_size, n=3)
    sp = TSamplingParams(temperature=0.9, top_k=64, top_p=0.95, seed=901,
                         max_tokens=5)
    _, a = build(True)
    alone = [o for o in a.generate([prompts[0]], [sp])]
    _, b = build(True)
    mixed = list(b.generate(prompts, [sp, TSamplingParams(max_tokens=5),
                                      sp]))

    def stream(outs, rid):
        return tuple(t for o in outs if o.rid == rid for t in o.new_tokens)
    assert stream(alone, 0) == stream(mixed, 0)
    assert len(stream(alone, 0)) == 5


def _sampled_params(cls, n, max_tokens=6):
    """Seeded sampled requests over temperatures 0.8-1.5 with top-k and
    top-p on and off; every fourth request greedy."""
    out = []
    for i in range(n):
        if i % 4 == 3:
            out.append(cls(max_tokens=max_tokens))
            continue
        out.append(cls(temperature=(0.8, 1.0, 1.5)[i % 3],
                       top_k=(64, 0, 20)[i % 3], top_p=(0.95, 0.9, 1.0)[i % 3],
                       seed=900 + 7 * i, max_tokens=max_tokens))
    return out


# (paged_kv, chunked_prefill, pattern): the default pattern (three
# compressed layers of four, sink 8 + recent 24) has no chunked prefill
SAMPLED_SETTINGS = {"chunked_paged": (True, True, [0, 0]),
                    "chunked_dense": (False, True, [0, 0]),
                    "whole_prompt": (True, False, None)}


@pytest.mark.parametrize("setting", sorted(SAMPLED_SETTINGS))
def test_sampled_streams_identical_to_jax_server(setting):
    """The draw is the reference's (threefry fold_in of the base key with
    the context length, Gumbel categorical), so seeded sampled streams
    equal the JAX server's token for token, first tokens included."""
    paged, chunked, pattern = SAMPLED_SETTINGS[setting]
    kw = dict(compute_dtype="float32", param_dtype="float32",
              n_layers=2 if pattern else 4)
    cfg = reduced_config("qwen2-1.5b").with_updates(
        **kw, omniattn=OmniAttnConfig(sink_tokens=8, recent_tokens=24))
    tcfg = t_reduced_config("qwen2-1.5b").with_updates(
        **kw, omniattn=TOmniAttnConfig(sink_tokens=8, recent_tokens=24))
    sk = dict(SCFG, paged_kv=paged, chunked_prefill=chunked)
    jsrv = Server(cfg, ServerConfig(**sk, oas=OASConfig(defer_window=0.0)),
                  pattern=pattern)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jsrv.params),
                                       tcfg, jsrv.lm.plan, device="cpu")
    tsrv = TServer(tcfg, TServerConfig(**sk, oas=TOASConfig(
        defer_window=0.0)), pattern=pattern, params=tparams, device="cpu")
    assert tsrv.prefills[0].chunked == chunked
    prompts = _workload(cfg.vocab_size, n=8)
    prompts[2] = prompts[2] * 6                 # past the 32-slot rings
    jout = jsrv.run(list(zip(prompts, _sampled_params(SamplingParams, 8))),
                    max_wall_s=600)
    s = tsrv.run(list(zip(prompts, _sampled_params(TSamplingParams, 8))),
                 max_wall_s=600)
    jstreams = {r.rid: tuple(r.output_tokens) for r in jsrv.metrics.done}
    tstreams = {r.rid: tuple(r.output_tokens) for r in tsrv.metrics.done}
    assert jout["n_done"] == s["n_done"] == len(prompts)
    assert tstreams == jstreams
    assert len({tstreams[r] for r in (0, 1, 4)}) == 3
    ds = s["decode_stats"][0]
    assert ds["host_fetches"] == ds["steps"] > 0
    first = tsrv.placement.hot_loops.summary()["prefill.first"]
    assert first["eager"] == s["prefill_stats"][0]["host_fetches"] > 0
    assert any(not k[1] for k in first["keys"])
    if not chunked:
        full = tsrv.placement.hot_loops.summary()["prefill.full"]
        assert full["eager"] == s["prefill_stats"][0]["prefills"] > 0
    for e in tsrv.decodes:
        e.pool.check_invariants(arena=tsrv.kv_arena)


def test_kvpool_replay_matches_reference():
    """One alloc/extend/transfer/share/shrink/release sequence replayed on
    both pools gives the same block lists and passes both invariants."""
    ops = [("allocate", 1, 40), ("allocate", ("prefill", 2), 20),
           ("extend", 1, 40, 70), ("transfer", ("prefill", 2), 2),
           ("adopt", ("store", 0), 1), ("release", 1),
           ("allocate_shared", 3, 50, ("store", 0), 2),
           ("shrink", 3, 50, 33), ("extend", 2, 20, 64), ("release", 2),
           ("release", ("store", 0)), ("allocate", 4, 90), ("release", 3)]
    pools = [KVPool(n_blocks=24, block_size=8),
             TKVPool(n_blocks=24, block_size=8)]
    for op in ops:
        res = []
        for pool in pools:
            kind = op[0]
            if kind == "allocate":
                r = pool.allocate(op[1], op[2])
            elif kind == "extend":
                r = pool.extend(op[1], op[2], op[3])
            elif kind == "transfer":
                r = pool.transfer(op[1], op[2])
            elif kind == "adopt":
                r = pool.adopt(op[1], pool.owned(op[2]))
            elif kind == "allocate_shared":
                r = pool.allocate(op[1], op[2],
                                  shared=pool.owned(op[3])[:op[4]])
            elif kind == "shrink":
                r = pool.shrink(op[1], op[2], op[3])
            else:
                r = pool.release(op[1])
            assert r is not None or kind == "release", op
            res.append((r, dict(pool.per_request), list(pool._free)))
            pool.check_invariants()
        assert res[0] == res[1], op


def test_later_slice_options_raise():
    tcfg = t_reduced_config("qwen2-1.5b").with_updates(n_layers=2)
    # QuantPlane serves int8 paged arenas only: quant over the slot-dense
    # layout and a width other than 8 bits are refused, as the reference
    # refuses them
    dense = dict(paged_kv=False, chunked_prefill=False)
    with pytest.raises(ValueError):
        TServer(tcfg, TServerConfig(quant=TQuantConfig(), **dense),
                pattern=[0, 0], device="cpu")
    with pytest.raises(ValueError):
        TServer(tcfg, TServerConfig(quant=TQuantConfig(bits=4)),
                pattern=[0, 0], device="cpu")
    with pytest.raises(TypeError):
        TServer(tcfg, TServerConfig(quant=object()), pattern=[0, 0],
                device="cpu")
    # speculation serves on paged KV only (the reference refuses it on the
    # slot-dense layout too); online top-k knobs on the slot-dense layout
    # are ignored, as the reference ignores them (no controller: it selects
    # arena blocks) — tests/test_torch_compositions.py holds the streams
    with pytest.raises(ValueError):
        TServer(tcfg, TServerConfig(spec=TSpecConfig(k=2), **dense),
                pattern=[0, 0], device="cpu")
    jcfg = reduced_config("qwen2-1.5b").with_updates(n_layers=2)
    topk_dense = [
        TServer(tcfg.with_updates(omniattn_topk_blocks=2),
                TServerConfig(**dense), pattern=[0, 0], device="cpu"),
        Server(jcfg.with_updates(omniattn_topk_blocks=2),
               ServerConfig(**dense), pattern=[0, 0])]
    assert all(s.decodes[0].sparsity is None for s in topk_dense)
    with pytest.raises(TypeError):
        TServer(tcfg, TServerConfig(spec=object()), pattern=[0, 0],
                device="cpu")
    # FaultPlane: Server(faults=...) takes a FaultPlane (anything else is a
    # TypeError, as for spec and quant), and the recovery knobs serve
    with pytest.raises(TypeError):
        TServer(tcfg, TServerConfig(), pattern=[0, 0], device="cpu",
                faults=object())
    plane = TFaultPlane(TFaultConfig(seed=1, horizon=8))
    srv = TServer(tcfg, TServerConfig(**dict(
        SCFG, watchdog_steps=200, watchdog_wall_s=600.0,
        admission_queue_cap=8, oas=TOASConfig(defer_window=0.0,
                                              max_retries=10))),
        pattern=[0, 0], device="cpu", faults=plane)
    assert srv.faults is plane
    rng = np.random.default_rng(2)
    s = srv.run([(tuple(int(t) for t in rng.integers(0, tcfg.vocab_size,
                                                      20)), 3)
                 for _ in range(3)], max_wall_s=600)
    assert s["n_done"] == 3 and s["faults_injected"] == plane.injected
    assert "n_handoffs_swept" in s
    # chunked prefill over dense KV and over ring layers (compressed under
    # prefill_sparse, sliding window) serves: the reference's
    # prefill_resume_attention. Each of these servers chunks and finishes
    # a request whose prompt wraps its rings (streams against the JAX
    # server: tests/test_torch_chunked_serving.py)
    rng = np.random.default_rng(3)
    prompt = tuple(int(t) for t in rng.integers(0, tcfg.vocab_size, 45))
    for cfg, kw, pattern, paged in (
            (tcfg, dict(paged_kv=False), [0, 0], False),
            (tcfg.with_updates(prefill_sparse=True), {}, None, True),
            (tcfg.with_updates(local_per_global=1, local_window=16), {},
             [0, 0], True)):
        srv = TServer(cfg, TServerConfig(**dict(SCFG, **kw)),
                      pattern=pattern, device="cpu")
        eng = srv.prefills[0]
        assert eng.chunked and eng.paged == paged
        outs = list(srv.generate([prompt], TSamplingParams(max_tokens=3)))
        assert [o.finish_reason for o in outs if o.finished] == ["length"]
        assert eng.stats["chunks"] >= 3
        if paged:
            srv.kv_arena.pool.check_invariants(arena=srv.kv_arena)
