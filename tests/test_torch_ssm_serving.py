"""The SSM and hybrid stacks served by the PyTorch port's `Server`, against
the JAX `Server` on the same bridged weights.

Reduced mamba2-130m (2 Mamba-2 layers, no attention: its arena holds no
full-attention entry) and reduced jamba-1.5-large-398b (16 layers: Mamba-2
layers, an attention layer in every eight, MoE on every second layer), in
float32 at the reference's own smoke sizes:
- greedy streams equal the JAX `Server`'s with prefix reuse on and off, the
  pool invariants green: mamba2 chunked over paged and over dense KV and
  whole-prompt slot-dense, jamba with every attention layer full chunked
  paged (float and int8 arenas) and under its default pattern (attention
  compressed, so whole-prompt) on both layouts;
- the stats that count the bounded leaves (the transfer bytes of each
  admission, the arena's block bytes) equal the reference's, and the MoE
  counts of jamba's decode steps equal them layer by layer;
- a pool cut until a slot is preempted and resumed carries its Mamba-2
  state and convolution rows through the preemption interchange;
- a stack without full-attention layers: the arena's corruption scan finds
  nothing, speculation is refused as the reference refuses it.
The jamba reference is built on an Auto-axis mesh (ROADMAP C1).

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest tests/test_torch_ssm_serving.py -q
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import reduced_config
from repro.core.proxy import OASConfig
from repro.distributed.ctx import MeshCtx, local_mesh_ctx
from repro.serving import SamplingParams, Server, ServerConfig
from repro.serving.quant import QuantConfig
from repro.serving.spec import SpecConfig
from repro_torch import bridge
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.core.proxy import OASConfig as TOASConfig
from repro_torch.core.proxy import SamplingParams as TSamplingParams
from repro_torch.serving import Server as TServer
from repro_torch.serving import ServerConfig as TServerConfig
from repro_torch.serving.quant import QuantConfig as TQuantConfig
from repro_torch.serving.spec import SpecConfig as TSpecConfig
from jax_preempt_repair import jax_preempt_repaired  # noqa: F401 (C7)

torch.set_num_threads(2)

SCFG = dict(n_prefill=1, n_decode=1, decode_slots=3, max_len=96,
            chunk_tokens=16, prefill_tick_budget=32, kv_blocks=40,
            kv_block_size=8)
MAMBA2, JAMBA = "mamba2-130m", "jamba-1.5-large-398b"


def _mesh(cfg):
    if cfg.moe.n_experts:
        return MeshCtx(jax.make_mesh((1, 1), ("data", "model"),
                                     axis_types=(AxisType.Auto,) * 2))
    return local_mesh_ctx()


def _workload(vocab, n=5, prefix=40):
    """Two of three prompts share a `prefix`-token system prefix plus 8
    distinct tokens; the rest are 6 tokens."""
    rng = np.random.default_rng(29)
    base = tuple(int(t) for t in rng.integers(0, vocab, prefix))
    return [base + tuple(int(t) for t in rng.integers(0, vocab, 8))
            if i % 3 != 2 else
            tuple(int(t) for t in rng.integers(0, vocab, 6))
            for i in range(n)]


def _servers(arch, pattern="full", quant=False, **knobs):
    """(JAX Server, port Server) of `arch` at its reduced config in float32
    on the same weights; pattern "full" is every attention layer full, None
    the default."""
    kw = dict(compute_dtype="float32", param_dtype="float32")
    cfg = reduced_config(arch).with_updates(**kw)
    tcfg = t_reduced_config(arch).with_updates(**kw)
    pat = [0] * cfg.n_layers if pattern == "full" else None
    scfg = dict(SCFG, **knobs)
    jsrv = Server(cfg, ServerConfig(**scfg, oas=OASConfig(defer_window=0.0),
                                    quant=QuantConfig() if quant else None),
                  mesh=_mesh(cfg), pattern=pat)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jsrv.params),
                                       tcfg, jsrv.lm.plan, device="cpu")
    tsrv = TServer(tcfg, TServerConfig(
        **scfg, oas=TOASConfig(defer_window=0.0),
        quant=TQuantConfig() if quant else None), pattern=pat,
        params=tparams, device="cpu")
    return jsrv, tsrv


def _run(jsrv, tsrv, prompts, new=4):
    jsrv.run([(p, SamplingParams(max_tokens=new)) for p in prompts],
             max_wall_s=600)
    ts = tsrv.run([(p, TSamplingParams(max_tokens=new)) for p in prompts],
                  max_wall_s=600)
    jout = {r.rid: tuple(r.output_tokens) for r in jsrv.metrics.done}
    tout = {r.rid: tuple(r.output_tokens) for r in tsrv.metrics.done}
    assert len(tout) == len(prompts) and tout == jout
    return ts


def _layer_order(counts, plan):
    """The reference engine's [L_moe, E] counts (period positions major) in
    the port's layer order."""
    n_pos = sum(1 for sp in plan.period if sp.use_moe)
    idx = [j * plan.n_rep + r for r in range(plan.n_rep)
           for j in range(n_pos)]
    return np.concatenate([counts[idx], counts[n_pos * plan.n_rep:]])


def _check_common(jsrv, tsrv, ts, chunked, paged, same_schedule=True):
    """Checks every served case shares; `same_schedule` False where the two
    servers may admit differently (a pool under pressure: the port prefills
    whole chunks, the reference cuts the last one of a round, so deferrals
    and preemptions fall on other steps)."""
    ps, ds = ts["prefill_stats"][0], ts["decode_stats"][0]
    jds = jsrv.decodes[0].stats
    assert tsrv.prefills[0].chunked == jsrv.prefills[0].chunked == chunked
    assert tsrv.prefills[0].paged == jsrv.prefills[0].paged == paged
    assert ds["host_fetches"] == ds["steps"] > 0
    # the bounded leaves (ring KV, mamba state and rows) are counted as the
    # reference counts them
    for key in ("kv_transfer_bytes", "kv_transfer_bytes_padded", "admits"):
        assert ds[key] == jds[key] or not same_schedule, key
    if not same_schedule:
        per = ds["kv_transfer_bytes_padded"] // ds["admits"]
        assert per == jds["kv_transfer_bytes_padded"] // jds["admits"]
    if paged and chunked:
        assert ds["handoff_copy_bytes"] == 0
    if tsrv.kv_arena is not None:
        assert tsrv.kv_arena.block_nbytes == jsrv.kv_arena.block_nbytes
        tsrv.kv_arena.pool.check_invariants(arena=tsrv.kv_arena)
    else:
        tsrv.decodes[0].pool.check_invariants()
    if tsrv.cfg.moe.n_experts:
        np.testing.assert_array_equal(
            tsrv.decodes[0].take_moe_counts(),
            _layer_order(jsrv.decodes[0].take_moe_counts(), jsrv.lm.plan))
    return ps, ds


@pytest.mark.parametrize("reuse", [True, False], ids=["reuse", "no_reuse"])
@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_mamba2_chunked_streams_identical(layout, reuse):
    jsrv, tsrv = _servers(MAMBA2, prefix_reuse=reuse,
                          paged_kv=layout == "paged")
    assert all(e is None for e in (tsrv.kv_arena.kv if tsrv.kv_arena
                                   else []))
    ts = _run(jsrv, tsrv, _workload(tsrv.cfg.vocab_size))
    ps, _ = _check_common(jsrv, tsrv, ts, chunked=True,
                          paged=layout == "paged")
    assert (ps["reused_tokens"] > 0) == reuse
    if layout == "paged":
        # no full-attention layer: the arena pins no byte, the scan finds
        # nothing
        assert tsrv.kv_arena.block_nbytes == 0
        assert tsrv.kv_arena.find_corrupt_blocks() == [] == \
            jsrv.kv_arena.find_corrupt_blocks()


def test_mamba2_whole_prompt_slot_dense_streams_identical():
    jsrv, tsrv = _servers(MAMBA2, paged_kv=False, chunked_prefill=False)
    ts = _run(jsrv, tsrv, _workload(tsrv.cfg.vocab_size))
    _check_common(jsrv, tsrv, ts, chunked=False, paged=False)


@pytest.mark.parametrize("reuse", [True, False], ids=["reuse", "no_reuse"])
def test_jamba_chunked_paged_streams_identical(reuse):
    jsrv, tsrv = _servers(JAMBA, prefix_reuse=reuse)
    ts = _run(jsrv, tsrv, _workload(tsrv.cfg.vocab_size))
    ps, ds = _check_common(jsrv, tsrv, ts, chunked=True, paged=True)
    assert (ps["reused_tokens"] > 0) == reuse


def test_jamba_int8_arenas_streams_identical():
    """QuantPlane on jamba: its attention layers' arenas are int8 (with the
    scale plane), the Mamba-2 leaves stay float."""
    jsrv, tsrv = _servers(JAMBA, quant=True)
    assert tsrv.kv_arena.quant and tsrv.quant_ctl.plan.n_quant_layers == 2
    ts = _run(jsrv, tsrv, _workload(tsrv.cfg.vocab_size))
    _check_common(jsrv, tsrv, ts, chunked=True, paged=True)


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_jamba_default_pattern_whole_prompt_streams_identical(layout):
    """The default pattern compresses jamba's attention layers to
    sink+recent rings without prefill_sparse: whole-prompt prefill, decode
    over the paged ring runs or the slot-dense rings."""
    jsrv, tsrv = _servers(JAMBA, pattern=None, paged_kv=layout == "paged")
    ts = _run(jsrv, tsrv, _workload(tsrv.cfg.vocab_size))
    _check_common(jsrv, tsrv, ts, chunked=False, paged=False)


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_mamba2_preemption_carries_the_state(layout):
    """A pool cut until a slot is preempted: the slot's Mamba-2 state and
    convolution rows leave through `_extract_dense` and come back at
    re-admission, and the streams still equal the JAX server's on the same
    pool."""
    jsrv, tsrv = _servers(MAMBA2, kv_blocks=12 if layout == "paged" else 9,
                          paged_kv=layout == "paged")
    de = tsrv.decodes[0]
    records = []
    orig = de._preempt

    def spy(rid):
        slot = de.rid_slot[rid]
        rec = orig(rid)
        records.append((slot, rec))
        return rec
    de._preempt = spy
    ts = _run(jsrv, tsrv, _workload(tsrv.cfg.vocab_size, n=5), new=12)
    assert ts["decode_stats"][0]["preemptions"] > 0 and records
    for _, (_, one, _, _) in records:
        ents = [e for e in one["layers"] if e is not None]
        assert len(ents) == tsrv.cfg.n_layers
        for e in ents:
            assert set(e) == {"state", "conv_x", "conv_bc"}
            assert e["state"].dtype == torch.float32
            assert e["state"].shape[0] == 1 and e["state"].abs().sum() > 0
    _check_common(jsrv, tsrv, ts, chunked=True, paged=layout == "paged",
                  same_schedule=False)


@pytest.mark.parametrize("arch", [MAMBA2, JAMBA])
def test_speculation_refused_as_the_reference(arch):
    kw = dict(compute_dtype="float32", param_dtype="float32")
    cfg = reduced_config(arch).with_updates(**kw)
    tcfg = t_reduced_config(arch).with_updates(**kw)
    pat = [0] * cfg.n_layers
    with pytest.raises(ValueError) as jerr:
        Server(cfg, ServerConfig(**SCFG, spec=SpecConfig(k=2)),
               mesh=_mesh(cfg), pattern=pat)
    with pytest.raises(ValueError) as terr:
        TServer(tcfg, TServerConfig(**SCFG, spec=TSpecConfig(k=2)),
                pattern=pat, device="cpu")
    assert str(terr.value) == str(jerr.value)
