"""FaultPlane on the SSM and hybrid stacks of the PyTorch port, against the
JAX reference, on the CPU.

Reduced mamba2-130m (2 Mamba-2 layers, no attention) and reduced
jamba-1.5-large-398b cut to one period (`n_layers=8`: Mamba-2 layers, one
attention layer, MoE on every second layer), float32, every attention
layer full, on the reference's soak server (`tests/test_torch_faults.py`'s
SOAK: two prefill and two decode instances, so that kills can fire) and
its workload, with weights made once by the port's `LM.init(0)` and
carried into the JAX `Server` through `bridge.params_to_numpy`:

  · each fault-free run (mamba2, jamba, jamba on int8 arenas) equals the
    JAX `Server`'s streams on the same weights and knobs (SOAK on one
    prefill and one decode instance: the reference's engines compile per
    instance, and which instance serves a request does not change what it
    computes);
  · each chaos run under `FaultConfig(seed, horizon=20)`, seeds 1, 2 and 5,
    equals its fault-free run: no streamed delta replayed or lost, no
    error or timeout, one host fetch a decode step, the pool invariants
    hold and nothing leaks. The faults that move a slot's Mamba-2 `state`,
    `conv_x` and `conv_bc` (kill_decode, kv_lost, handoff_drop, the
    preemptions of alloc_fail, the restart after a corruption) must have
    fired: a restarted request re-prefills and rebuilds that state;
  · jamba's MoE layers run at capacity factor 16 in both packages, where
    no bucket drops an assignment (a restart changes which rows share a
    capacity cut, so at the serving factor chaos could move a drop, C5);
    the drops are counted (`moe.drop_tally`) and must be 0.

`kv_corrupt` needs a summary plane: mamba2's arena has no full-attention
entry, so the plane skips every corruption there, as the reference does
(`src/repro/serving/faults.py:174-181`); on jamba it fires in the
attention layer, beside Mamba-2 layers whose state the restart rebuilds.
The jamba reference runs on an Auto-axis mesh (ROADMAP C1). Every seed
run is printed with what its plane injected and skipped.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest tests/test_torch_faults_ssm.py -q -s
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config
from repro.core.proxy import OASConfig
from repro.serving import SamplingParams, Server, ServerConfig
from repro.serving.quant import QuantConfig
from repro_torch import bridge
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.core.proxy import OASConfig as TOASConfig
from repro_torch.core.proxy import SamplingParams as TSamplingParams
from repro_torch.models import moe as tmoe
from repro_torch.models.lm import LM as TLM
from repro_torch.serving import FaultConfig as TFaultConfig
from repro_torch.serving import FaultPlane as TFaultPlane
from repro_torch.serving import Server as TServer
from repro_torch.serving import ServerConfig as TServerConfig
from repro_torch.serving.quant import QuantConfig as TQuantConfig
from test_torch_faults import SOAK, _assert_no_leaks, _drive, _outs, \
    _soak_workload
from test_torch_ssm_serving import JAMBA, MAMBA2, _mesh

torch.set_num_threads(2)

SEEDS = (1, 2, 5)
# capacity factor of jamba's MoE layers in both packages: a bucket of 8
# experts, top-2, holds every row at 16 (>= E / top_k)
NODROP_CF = 16.0
# soak → (arch, int8 arenas)
SOAKS = {"mamba2": (MAMBA2, False), "jamba": (JAMBA, False),
         "jamba_int8": (JAMBA, True)}
# the JAX reference's soak server: SOAK on one prefill and one decode
# instance. Its engines jit per instance, so a second instance of a kind
# compiles every shape again; which instance serves a request does not
# change what it computes (one slot-padded decode batch, one task a chunk)
JAX_SOAK = dict(SOAK, n_prefill=1, n_decode=1)
# the kinds every arch's plane must have injected, summed over SEEDS
MUST_FIRE = ("kill_decode", "kv_lost", "handoff_drop")


def _updates(arch) -> dict:
    kw = dict(compute_dtype="float32", param_dtype="float32")
    if arch == JAMBA:
        kw.update(n_layers=8, moe_capacity_factor=NODROP_CF)
    return kw


def _oas(port: bool):
    return (TOASConfig if port else OASConfig)(defer_window=0.0,
                                               max_retries=10)


@pytest.fixture(scope="module")
def weights():
    """arch → (torch config, the port's one-rank `LM.init(0)` parameters,
    the same parameters in the reference's tree of jax arrays)."""
    out = {}
    for arch in (MAMBA2, JAMBA):
        tcfg = t_reduced_config(arch).with_updates(**_updates(arch))
        lm = TLM.build(tcfg, pattern=[0] * tcfg.n_layers, device="cpu")
        params = lm.init(0)
        out[arch] = (tcfg, params, jax.tree.map(
            jnp.asarray, bridge.params_to_numpy(params, lm.plan)))
    return out


def _server(weights, soak, faults=None):
    arch, quant = SOAKS[soak]
    tcfg, params, _ = weights[arch]
    return TServer(tcfg, TServerConfig(
        **SOAK, oas=_oas(True), quant=TQuantConfig() if quant else None),
        pattern=[0] * tcfg.n_layers, params=params, device="cpu",
        faults=faults)


def _drops_run(srv, reqs):
    """`_drive` with the capacity cut's drops counted over the run."""
    drops = tmoe.drop_tally("cpu")
    drops.zero_()
    out = _drive(srv, reqs)
    return out, float(drops)


@pytest.fixture(scope="module")
def fault_free(weights):
    """soak → (requests, the port's fault-free streams, the JAX Server's,
    the port's capacity drops, its prefill chunks)."""
    out = {}
    for soak, (arch, quant) in SOAKS.items():
        tcfg, _, jparams = weights[arch]
        cfg = reduced_config(arch).with_updates(**_updates(arch))
        reqs = _soak_workload(tcfg.vocab_size)
        jsrv = Server(cfg, ServerConfig(
            **JAX_SOAK, oas=_oas(False),
            quant=QuantConfig() if quant else None),
            mesh=_mesh(cfg), pattern=[0] * cfg.n_layers, params=jparams)
        jsrv.run([(p, SamplingParams(max_tokens=m)) for p, m in reqs],
                 max_wall_s=600)
        base = _server(weights, soak)
        _, drops = _drops_run(base, reqs)
        _assert_no_leaks(base)
        out[soak] = (reqs, _outs(base), _outs(jsrv), drops,
                     sum(e.stats["chunks"] for e in base.prefills))
    return out


@pytest.fixture(scope="module")
def chaos(weights, fault_free):
    """(soak, seed) → the record of one chaos run on a new server."""
    out = {}
    for soak in SOAKS:
        reqs = fault_free[soak][0]
        for seed in SEEDS:
            plane = TFaultPlane(TFaultConfig(seed=seed, horizon=20))
            srv = _server(weights, soak, faults=plane)
            (_, deltas, finishes), drops = _drops_run(srv, reqs)
            s = srv.metrics.summary(1.0)
            out[soak, seed] = {
                "outs": _outs(srv), "deltas": deltas, "finishes": finishes,
                "plane": plane, "drops": drops, "summary": s,
                "quarantined": len(srv.kv_arena.pool.quarantined),
                "preemptions": sum(e.stats["preemptions"]
                                   for e in srv.decodes),
                "chunks": sum(e.stats["chunks"] for e in srv.prefills),
                "fetches": [(e.stats["host_fetches"], e.stats["steps"])
                            for e in srv.decodes]}
            _assert_no_leaks(srv)
            print(f"{soak} seed {seed}: injected "
                  f"{ {k: v for k, v in plane.injected.items() if v} }, "
                  f"skipped { {k: v for k, v in plane.skipped.items() if v} }"
                  f"; retries {s['n_retries']}, quarantined "
                  f"{s['blocks_quarantined']}, preemptions "
                  f"{out[soak, seed]['preemptions']}, chunks "
                  f"{out[soak, seed]['chunks']} (fault-free "
                  f"{fault_free[soak][4]}), drops {drops}")
    return out


@pytest.mark.parametrize("soak", list(SOAKS))
def test_fault_free_soak_equals_jax_server(fault_free, soak):
    """The port's fault-free soak equals the JAX `Server`'s streams on the
    same weights; at capacity factor 16 jamba's buckets drop nothing."""
    reqs, ref, jref, drops, _ = fault_free[soak]
    print(f"{soak}: fault-free capacity drops {drops}")
    assert len(ref) == len(reqs) == 8
    assert ref == jref
    assert drops == 0.0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("soak", list(SOAKS))
def test_chaos_soak_bit_identical(fault_free, chaos, soak, seed):
    """Under a full seeded schedule over two prefill and two decode
    instances every request completes with the fault-free run's output,
    no streamed delta is replayed or lost, nothing errors or times out,
    each decode step fetches once, nothing drops at capacity factor 16 and
    the quiescent pool passes its invariants with nothing leaked (checked
    in the fixture). A corruption, where one fires, condemns exactly its
    block."""
    ref = fault_free[soak][1]
    run = chaos[soak, seed]
    outs, plane, s = run["outs"], run["plane"], run["summary"]
    assert len(outs) == 8, f"incomplete: {run['finishes']}"
    assert outs == ref, "outputs diverged from the fault-free run"
    for rid, toks in outs.items():
        assert tuple(run["deltas"][rid]) == toks, \
            f"rid {rid}: deltas replayed/lost"
    assert sum(plane.injected.values()) > 0, "chaos run injected nothing"
    for _, k, target in plane.fired:
        if k == "kv_corrupt":
            assert target[1] == (target[0],), target
    assert run["quarantined"] == s["blocks_quarantined"]
    assert s["n_errors"] == 0 and s["n_timeouts"] == 0
    assert all(f == st for f, st in run["fetches"])
    assert run["drops"] == 0.0


@pytest.mark.parametrize("soak", list(SOAKS))
def test_soak_fired_the_state_moving_faults(chaos, soak):
    """Summed over the seeds, the plane injected kill_decode, kv_lost and
    handoff_drop on every stack (each moves or drops a slot's Mamba-2
    state, which a re-prefill must rebuild), and requests were retried.
    jamba's plane injected kv_corrupt (its attention layer carries the
    summary plane). mamba2's arena has no full-attention entry, so no
    corruption could be detected there: every scheduled kv_corrupt is
    counted in `skipped`, none in `injected`, as in the reference."""
    runs = [chaos[soak, seed] for seed in SEEDS]
    injected = {k: sum(r["plane"].injected[k] for r in runs)
                for k in runs[0]["plane"].injected}
    skipped = {k: sum(r["plane"].skipped[k] for r in runs)
               for k in runs[0]["plane"].skipped}
    print(f"{soak} over seeds {SEEDS}: injected {injected}, skipped "
          f"{skipped}")
    for k in MUST_FIRE:
        assert injected[k] > 0, (soak, k, injected)
    assert sum(r["summary"]["n_retries"] for r in runs) > 0
    if SOAKS[soak][0] == MAMBA2:
        assert injected["kv_corrupt"] == 0
        assert skipped["kv_corrupt"] == \
            len(SEEDS) * TFaultConfig().n_kv_corrupt
    else:
        assert injected["kv_corrupt"] > 0


def _restart_after_seal(weights, fault_free):
    """The jamba int8 soak fault-free, except that each request, once its
    decode appends have filled and sealed the arena block its prompt ends
    in, loses its KV (`inject_kv_lost`) one time: it restarts, adopts its
    own prompt's prefix-store entry and decodes again. → (the requests so
    restarted, the streams, the fault-free streams)."""
    reqs, ref = fault_free["jamba_int8"][:2]
    srv = _server(weights, "jamba_int8")
    bs = srv.kv_arena.pool.block_size
    for p, m in reqs:
        srv.add_request(p, TSamplingParams(max_tokens=m))
    lost = set()
    for _ in range(3000):
        for eng in srv.decodes:
            for rid, slot in sorted(eng.rid_slot.items()):
                n = len(reqs[rid][0])
                if rid not in lost and n % bs and \
                        eng.pos_h[slot] >= -(-n // bs) * bs:
                    lost.add(rid)
                    srv.inject_kv_lost(rid)
        srv.step()
        if not srv.proxy.inflight:
            break
    return lost, _outs(srv), ref


def test_int8_restart_after_its_tail_sealed_keeps_the_stream(weights,
                                                             fault_free):
    """ROADMAP C6, the fault the jamba int8 soak found (seed 2): a prefix
    store entry shares its prompt's partial tail block with the request
    that wrote it; that request's decode appends fill the block and the
    seal re-quantizes every token in it per channel. A request restarted
    after that adopted its own entry and read other KV for its prompt's
    last tokens than its prefill wrote, and on jamba (the Mamba-2 state
    carries the difference on) its stream could leave the fault-free
    run's. The entry now keeps the tail's published rows: every request
    restarted so keeps its stream."""
    lost, outs, ref = _restart_after_seal(weights, fault_free)
    assert len(lost) == len(ref), f"only {sorted(lost)} restarted"
    assert outs == ref, [r for r in ref if outs[r] != ref[r]]


def test_int8_store_entry_keeps_its_published_tail(weights):
    """After its writer's decode sealed the shared tail block, a stored
    int8 prompt's entry still holds the tail rows its prefill wrote (the
    per-token payload and scales, no seal scale) while the block itself
    carries the seal; an exact repeat of the prompt adopts those rows into
    its own block and emits the writer's stream."""
    tcfg = weights[JAMBA][0]
    srv = _server(weights, "jamba_int8")
    prompt = _soak_workload(tcfg.vocab_size)[0][0]       # 24 tokens
    _, first, _ = _drive(srv, [(prompt, 12)])            # decodes to 36
    ent = next(e.store.lookup_entry(prompt) for e in srv.prefills
               if e.store.lookup_entry(prompt) is not None)
    bs = srv.kv_arena.pool.block_size
    n = ent.n % bs
    assert ent.n == len(prompt) and n and ent.tail is not None
    shared = ent.blocks[ent.n // bs]
    quant = [i for i, e in enumerate(srv.kv_arena.kv)
             if e is not None and "kscale" in e]
    assert quant
    for i in quant:
        rows, e = ent.tail[i], srv.kv_arena.kv[i]
        assert not rows["kscale"].any() and rows["ktok"][:, :n].all()
        assert e["kscale"][shared].any(), "the writer's appends did not seal"
    adopted = []
    write = srv.kv_arena.write_block
    srv.kv_arena.write_block = lambda rows, dst: (
        adopted.append((rows, dst)), write(rows, dst))
    _, again, _ = _drive(srv, [(prompt, 12)])
    assert [r for r, _ in adopted] == [ent.tail]
    assert list(again.values()) == list(first.values())
