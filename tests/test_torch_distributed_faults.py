"""FaultPlane served over ranks by the PyTorch port, on the CPU: one (tp 2,
ep 2) world of four gloo ranks (`torch.multiprocessing` spawn, a FileStore
under tmp_path; the rank side is tests/torch_dist_worker.py's
`faults_child`, which imports no jax) runs every case once with
`check_lockstep=True` on every rank, while this process runs the
references on the same weights: the port's one-rank `Server` and the JAX
one-device `Server` (weights made by the port's `LM.init(0)` and carried
into the reference through `bridge.params_to_numpy`).

The cases, on tests/test_torch_faults.py's soak server (two prefill and
two decode instances) and workloads, every attention layer full, each run
fault-free and under FaultPlane(FaultConfig(seed, horizon=20)):
- reduced qwen2-moe-a2.7b (the mesh-parity case), float32, seed 1 (its
  second seed, 2, is left out for the suite's time: the two new FaultPlane
  files run past their 90 s share);
- the same on int8 arenas, seed 1;
- the same with `SpecConfig(k=4)`, seed 1;
- reduced jamba-1.5-large-398b cut to one period (Mamba-2 at tp 2, MoE over
  ep 2, attention under 'kv'), seed 1.
Every MoE layer runs at capacity factor 16 in both packages, where no
bucket drops an assignment (a restart changes which rows share a capacity
cut, C5); the drops are reported.

Gates: each chaos run's streams equal its fault-free run's on every rank;
each fault-free run equals the one-rank port's and the JAX `Server`'s (for
jamba through tests/test_torch_faults_ssm.py, which holds the one-rank
port's jamba soak on the same config, weights and workload equal to the
JAX `Server`'s: this file does not compile jamba in JAX again); the
planes' `fired` lists are equal on every rank, and lockstep never raised
(a rank's error would surface here). A corruption on one rank only (case
1, `add_request` / `step`: one mapped block's keys corrupted on rank 3's
KV heads alone, then `recover_corruption` on every rank at the same step)
is condemned, quarantined and scrubbed on all four ranks, and the streams
equal the fault-free run's: without the world max-reduction of the scan's
mask (`RankCtx.pmax_world`) only rank 3 would condemn it and the ranks
would part. Every process group has a 60 s timeout and the world joins
within WORLD_LIMIT_S.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest tests/test_torch_distributed_faults.py -q -s
"""
import time
from dataclasses import replace

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.multiprocessing as mp

import test_torch_faults_ssm as ssm
import torch_dist_worker as W
from repro.serving import Server
from repro_torch import bridge
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.models.lm import LM as TLM
from repro_torch.serving import DevicePlacement
from test_torch_distributed import auto_mesh
from test_torch_distributed_planes import INT8_NEAR_TIE

torch.set_num_threads(2)

WORLD_LIMIT_S = 150
ARCHS = sorted({c[0] for c in W.FAULT_CASES.values()})
CHAOS = [(case, seed) for case, (*_, seeds) in W.FAULT_CASES.items()
         for seed in seeds]


def _arch_case(arch):
    return next(c for c, v in W.FAULT_CASES.items() if v[0] == arch)


def _jax_references(jparams) -> dict:
    """The qwen2-moe cases' fault-free runs on the JAX one-device Server
    (an Auto-axis mesh, ROADMAP C1), on the soak knobs with one prefill
    and one decode instance (its engines compile per instance; which
    instance serves a request does not change what it computes, as
    tests/test_torch_faults_ssm.py's references): one float32 server
    serves the soak workload, then the speculation workload without
    speculation (at capacity factor 16 a verify emits what decode does, as
    tests/test_torch_faults.py's spec soak is held); one server on int8
    arenas serves the soak workload. → case → streams."""
    out = {}
    for case in ("moe", "moe_int8"):
        cfg = W.faults_cfg(case, port=False)
        srv = Server(cfg, replace(W.faults_server_config(case, port=False),
                                  n_prefill=1, n_decode=1),
                     mesh=auto_mesh(), pattern=[0] * cfg.n_layers,
                     params=jparams)
        for c in (case, "moe_spec") if case == "moe" else (case,):
            before = len(srv.metrics.done)
            reqs = W.faults_requests(c, cfg.vocab_size)
            srv.run(reqs, max_wall_s=300)
            out[c] = {r.rid: tuple(r.output_tokens)
                      for r in srv.metrics.done[before:]}
            assert len(out[c]) == len(reqs)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("faults_world")
    params, plans = {}, {}
    for arch in ARCHS:
        cfg = W.faults_cfg(_arch_case(arch))
        lm = TLM.build(cfg, pattern=[0] * cfg.n_layers, device="cpu")
        params[arch], plans[arch] = lm.init(0), lm.plan
    inputs = {"params": params}
    torch.save(inputs, d / "inputs.pt")
    t0 = time.monotonic()
    procs = mp.start_processes(
        W.faults_child, args=(str(d / "store"), str(d / "inputs.pt"),
                              str(d)),
        nprocs=W.WORLD, join=False, start_method="spawn")
    # the references, while the ranks run
    cpu = DevicePlacement.of("cpu")
    one = {case: W.fault_run(case, params[arch], cpu)
           for case, (arch, *_) in W.FAULT_CASES.items()}
    moe = "qwen2-moe-a2.7b"
    refs = _jax_references(jax.tree.map(
        jnp.asarray, bridge.params_to_numpy(params[moe], plans[moe])))
    try:
        while not procs.join(timeout=max(1.0, WORLD_LIMIT_S
                                         - (time.monotonic() - t0))):
            if time.monotonic() - t0 > WORLD_LIMIT_S:
                raise TimeoutError(f"the world did not finish within "
                                   f"{WORLD_LIMIT_S} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
    ranks = [torch.load(d / f"faults_rank{r}.pt", weights_only=False)
             for r in range(W.WORLD)]
    for r, res in enumerate(ranks):
        assert "error" not in res, f"rank {r}: {res['error']}"
    print(f"faults world: {time.monotonic() - t0:.1f} s")
    return {"ranks": ranks, "one": one, "refs": refs, "params": params}


def _margin(world, case):
    cfg = W.faults_cfg(case)
    params = world["params"][W.FAULT_CASES[case][0]]
    reqs = W.faults_requests(case, cfg.vocab_size)
    return lambda rid, stream, i: W.top2_margin(cfg, params, reqs[rid][0],
                                                stream, i,
                                                [0] * cfg.n_layers)


def _assert_streams(world, case, got, want, what) -> list:
    """Equal streams; on int8 arenas a stream may leave `want` at a
    near-tie (one-rank top-2 margin below INT8_NEAR_TIE), returned."""
    margin = _margin(world, case)
    if "q" not in W.FAULT_CASES[case][3]:
        W.assert_streams(got, want, f"{case} vs {what}",
                         lambda rid, i: margin(rid, want[rid], i))
        return []
    assert got.keys() == want.keys(), (case, what)
    notes = []
    for rid in sorted(want):
        if got[rid] == want[rid]:
            continue
        i = W.first_diff(got[rid], want[rid])
        m = margin(rid, want[rid], i)
        assert m < INT8_NEAR_TIE, (
            f"{case} vs {what}: request {rid} differs at token {i} with a "
            f"one-rank top-2 logit margin of {m:.3g}: {got[rid]} vs "
            f"{want[rid]}")
        notes.append((rid, i, m))
    return notes


def test_pmax_world_over_four_ranks(world):
    """`RankCtx.pmax_world` over the four gloo ranks: the elementwise max
    of every rank's values, a bool tensor's as a bool (it travels as
    int32)."""
    for res in world["ranks"]:
        got = res["pmax_world"]
        assert got["bool"].dtype == torch.bool
        assert got["bool"].tolist() == [True] * W.WORLD + [False]
        assert got["int"].tolist() == [W.WORLD - 1, 0, 7]
        assert got["float"].tolist() == [0.5 * (W.WORLD - 1), -1.0]


@pytest.mark.parametrize("case", list(W.FAULT_CASES))
def test_fault_free_over_ranks_matches_one_rank_and_jax(world, case):
    """Every rank's fault-free soak streams equal the port's one-rank
    Server's and the JAX one-device Server's (int8: up to a near-tie), no
    stream delta replayed or lost, nothing dropped at capacity factor
    16."""
    recs = [res[case][None] for res in world["ranks"]]
    streams = recs[0]["streams"]
    assert len(streams) == 8
    for r, rec in enumerate(recs):
        assert rec["streams"] == streams, (case, r)
        for rid, toks in rec["streams"].items():
            assert rec["deltas"][rid] == toks, (case, r, rid)
    notes = _assert_streams(world, case, streams,
                            world["one"][case]["streams"], "one rank")
    if case in world["refs"]:
        notes += _assert_streams(world, case, streams, world["refs"][case],
                                 "JAX Server")
    else:
        # jamba: this config, these weights (`LM.init(0)`), these knobs and
        # this workload are tests/test_torch_faults_ssm.py's jamba soak,
        # whose one-rank fault-free streams that file holds equal to the JAX
        # Server's (`test_fault_free_soak_equals_jax_server[jamba]`): equal
        # to the one-rank port's here, they equal the JAX Server's
        cfg = W.faults_cfg(case)
        assert cfg == t_reduced_config(ssm.JAMBA).with_updates(
            **ssm._updates(ssm.JAMBA))
        assert W.FAULT_SOAK == ssm.SOAK
        assert W.faults_requests(case, cfg.vocab_size) == \
            ssm._soak_workload(cfg.vocab_size)
    print(f"{case}: int8 near-ties (request, token, margin) {notes}")
    drops = [rec["drops"] for rec in recs] + [world["one"][case]["drops"]]
    print(f"{case}: capacity drops ranks + one rank {drops}")
    assert drops == [0.0] * (W.WORLD + 1)


@pytest.mark.parametrize("case,seed", CHAOS)
def test_chaos_over_ranks_equals_fault_free(world, case, seed):
    """Under the seeded schedule every rank completes every request with
    its fault-free stream, no streamed delta is replayed or lost, nothing
    errors or times out, the planes fired the same faults at the same
    steps on every rank (their `fired` lists are equal), and every rank
    quarantined the same blocks; a corruption condemned exactly its
    block. Pool invariants, no leak and one host fetch a decode step are
    checked on every rank, and the lockstep digest every round."""
    recs = [res[case][seed] for res in world["ranks"]]
    free = world["ranks"][0][case][None]["streams"]
    for r, rec in enumerate(recs):
        assert rec["streams"] == free, (case, seed, r)
        for rid, toks in rec["streams"].items():
            assert rec["deltas"][rid] == toks, (case, seed, r, rid)
        assert rec["n_errors"] == rec["n_timeouts"] == 0
        assert rec["fired"] == recs[0]["fired"], (case, seed, r)
        for key in ("injected", "skipped", "quarantined", "handoffs_swept",
                    "n_retries", "preemptions"):
            assert rec[key] == recs[0][key], (case, seed, r, key)
        assert len(rec["quarantined"]) == rec["blocks_quarantined"]
        assert rec["drops"] == 0.0
    rec = recs[0]
    assert sum(rec["injected"].values()) > 0
    for _, kind, target in rec["fired"]:
        if kind == "kv_corrupt":
            assert target[1] == (target[0],), target
    print(f"{case} seed {seed}: injected "
          f"{ {k: v for k, v in rec['injected'].items() if v} }, skipped "
          f"{ {k: v for k, v in rec['skipped'].items() if v} }; retries "
          f"{rec['n_retries']}, quarantined {rec['quarantined']}, handoffs "
          f"swept {rec['handoffs_swept']}, preemptions {rec['preemptions']};"
          f" recover_corruption ms per rank "
          f"{[[round(x, 2) for x in r['recover_ms']] for r in recs]}")


def test_corruption_on_one_rank_is_condemned_on_every_rank(world):
    """A block corrupted on rank 3's KV heads alone: before the recovery
    only rank 3's own scan sees it; `recover_corruption` on every rank at
    the same step condemns it on all four (the scan's mask max-reduced over
    the world), each quarantines and scrubs its shard of it, the ranks stay
    in lockstep, and the streams equal the fault-free run's."""
    recs = [res["corrupt_one_rank"] for res in world["ranks"]]
    b = recs[0]["block"]
    free = world["ranks"][0]["moe"][None]["streams"]
    assert b > 0
    for r, rec in enumerate(recs):
        assert rec["block"] == b and rec["at_step"] == recs[0]["at_step"]
        assert rec["local_scan"] == ([b] if r == W.CORRUPT_RANK else []), r
        assert rec["condemned"] == [b], (r, rec["condemned"])
        assert rec["left_circulation"] and rec["scrubbed"], r
        assert rec["quarantined"] == [b] and rec["blocks_quarantined"] == 1
        assert rec["n_retries"] >= 1
        assert rec["streams"] == free, r
        for rid, toks in rec["streams"].items():
            assert rec["deltas"][rid] == toks, (r, rid)
