"""QuantPlane and SpecPlane served over ranks by the PyTorch port, against
the JAX one-device `Server` and the port's one-rank `Server` on the CPU:
one (tp 2, ep 2) world of four gloo ranks (`torch.multiprocessing` spawn, a
FileStore under tmp_path; the rank side is tests/torch_dist_worker.py's
`planes_child`, which imports no jax) runs every case once, while this
process runs the references on the same weights (`LM.init(PRNGKey(0))`
bridged through numpy).

- reduced qwen2-moe-a2.7b with every layer full (the mesh-parity case,
  block 16) on int8 arenas: each rank's arena holds its one KV head of
  two, and its residency figures are its own (half the one-rank figure);
  again with a pool cut until it preempts (int8 extraction and
  re-admission on a rank's shard);
- the same model with `SpecConfig(k=4)` on prompts that draft plus one
  sampled request, and with both planes together: the verify window's
  rows go through the EP all_to_all, every rank takes the same accept
  decision, and the speculation counters are equal on every rank and
  equal the JAX `Server`'s;
- speculation over the default pattern's sink 4 + recent 16 rings;
- reduced granite-34b under 'wseq' (one KV head, whole on both `model`
  ranks) served by each pair of ranks that shares e, int8 at [0, 0] and
  speculating at [0, 1].

Both packages run at the config's capacity factor. The capacity cut's
drops are reported (`moe.drop_tally`): a rank routes its half of a split
batch at a capacity reckoned from that half (ROADMAP C5). An int8 stream
that differs is accepted only as a near-tie: its first differing token's
one-rank top-2 logit margin must be below INT8_NEAR_TIE (ROADMAP C,
"cross-device int8 bytes"); float32 streams must be equal. The JAX MoE
references run on an Auto-axis mesh (ROADMAP C1), with the reference's
preemption repaired in the harness (ROADMAP C7:
tests/jax_preempt_repair.py). Every process group has a 60 s timeout and
the world joins within WORLD_LIMIT_S."""
import time

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dist_worker as W
from repro.serving import Server
from repro_torch import bridge
from repro_torch.serving import DevicePlacement
from jax_preempt_repair import jax_preempt_repaired  # noqa: F401 (C7)
from test_torch_distributed import auto_mesh

torch.set_num_threads(2)

WORLD_LIMIT_S = 150
# the largest one-rank top-2 logit margin at which an int8 stream may
# leave the reference's: a rounding boundary of the int8 grid crossed by a
# sum taken in another order
INT8_NEAR_TIE = 1e-2


def _jax_server(case):
    """The case's JAX one-device Server on its own `LM.init(PRNGKey(0))`
    weights (their tree follows the pattern)."""
    cfg = W.planes_cfg(case, port=False)
    return Server(cfg, W.planes_server_config(case, port=False),
                  mesh=auto_mesh(), pattern=W.PLANES_CASES[case][2])


def _jax_run(srv, case):
    reqs = W.planes_requests(case, srv.cfg.vocab_size, port=False)
    s = srv.run(reqs, max_wall_s=300)
    assert s["n_done"] == len(reqs)
    ds = s["decode_stats"][0]
    return {"streams": {r.rid: tuple(r.output_tokens)
                        for r in srv.metrics.done},
            "summary": {k: s[k] for k in ("spec_drafted", "spec_accepted",
                                          "spec_verifies") if k in s},
            "decode_stats": {k: ds[k] for k in ("quant_block_bytes",
                                                "quant_block_bytes_f32")
                             if k in ds}}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("planes_world")
    jsrvs = {c: _jax_server(c) for c in W.PLANES_CASES}
    params = {c: bridge.params_from_numpy(
                  jax.tree.map(np.asarray, srv.params), W.planes_cfg(c),
                  srv.lm.plan, device="cpu") for c, srv in jsrvs.items()}
    inputs = {"params": params}
    torch.save(inputs, d / "inputs.pt")
    t0 = time.monotonic()
    procs = mp.start_processes(
        W.planes_child, args=(str(d / "store"), str(d / "inputs.pt"),
                              str(d)),
        nprocs=W.WORLD, join=False, start_method="spawn")
    refs, one = {}, {}
    cpu = DevicePlacement.of("cpu")
    for case, srv in jsrvs.items():
        refs[case] = _jax_run(srv, case)
        one[case] = W.serve_planes(case, params[case], cpu)
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
    ranks = [torch.load(d / f"planes_rank{r}.pt", weights_only=False)
             for r in range(W.WORLD)]
    for r, res in enumerate(ranks):
        assert "error" not in res, f"rank {r}: {res['error']}"
    return {"ranks": ranks, "refs": refs, "one": one, "inputs": inputs}


def _records(world, case):
    """Every rank's record of the case, their streams identical."""
    recs = [res["servers"][case] for res in world["ranks"]]
    for r, rec in enumerate(recs):
        assert rec["streams"] == recs[0]["streams"], (case, r)
        assert rec["n_done"] == len(recs[0]["streams"]) > 0, case
    return recs


def _margin(world, case):
    pattern = W.PLANES_CASES[case][2]
    cfg, params = W.planes_cfg(case), world["inputs"]["params"][case]
    reqs = W.planes_requests(case, cfg.vocab_size)
    return lambda rid, stream, i: W.top2_margin(cfg, params, reqs[rid][0],
                                                stream, i, pattern)


def _assert_streams(world, case, got, want, what):
    """Equal streams; where the case runs int8 arenas, a stream may leave
    `want` at a near-tie (one-rank top-2 margin below INT8_NEAR_TIE), named
    in the returned notes."""
    if "q" not in W.PLANES_CASES[case][5]:
        margin = _margin(world, case)
        W.assert_streams(got, want, f"{case} vs {what}",
                         lambda rid, i: margin(rid, want[rid], i))
        return []
    assert got.keys() == want.keys(), (case, what)
    margin, notes = _margin(world, case), []
    for rid in sorted(want):
        a, b = got[rid], want[rid]
        if a == b:
            continue
        i = W.first_diff(a, b)
        m = margin(rid, b, i)
        assert m < INT8_NEAR_TIE, (
            f"{case} vs {what}: request {rid} differs at token {i} with a "
            f"one-rank top-2 logit margin of {m:.3g} (>= {INT8_NEAR_TIE}): "
            f"{a} vs {b}")
        notes.append((rid, i, m))
    return notes


def _assert_all_streams(world, case):
    """The ranks' streams equal the port's one-rank Server's and the JAX
    one-device Server's (both at the config's capacity factor)."""
    streams = _records(world, case)[0]["streams"]
    notes = _assert_streams(world, case, streams,
                            world["one"][case]["streams"], "one rank")
    notes += _assert_streams(world, case, streams,
                             world["refs"][case]["streams"], "JAX Server")
    return notes


@pytest.mark.parametrize("case", ["quant", "quant_preempt"])
def test_quant_over_ranks_matches_one_rank_and_jax(world, case):
    """int8 arenas of each rank's one KV head of two: greedy streams equal
    the one-rank Servers' on every rank (pool invariants and one host
    fetch a decode step checked in each rank); the residency figures are
    the rank's — half the one-rank and the JAX Server's — and equal the
    bytes of its own arena's blocks."""
    recs = _records(world, case)
    print(case, "int8 near-ties (request, token, margin):",
          _assert_all_streams(world, case))
    one, ref = world["one"][case], world["refs"][case]
    assert one["decode_stats"]["quant_block_bytes"] == \
        ref["decode_stats"]["quant_block_bytes"]
    assert one["decode_stats"]["quant_block_bytes"] == one["block_bytes"]
    for rec in recs:
        assert all(rec["arena_int8"]) and rec["arena_heads"]
        for (n, k, *_), (n1, k1, *_) in zip(rec["arena_heads"],
                                            one["arena_heads"]):
            assert k * 2 == k1 == 2 and n == n1
        for key in ("quant_block_bytes", "quant_block_bytes_f32"):
            assert 2 * rec["decode_stats"][key] == \
                one["decode_stats"][key] > 0, key
        assert rec["decode_stats"]["quant_block_bytes"] == \
            rec["block_bytes"]
    if case == "quant_preempt":
        assert all(r["decode_stats"]["preemptions"] >= 1 for r in recs)
        assert one["decode_stats"]["preemptions"] >= 1


@pytest.mark.parametrize("case", ["spec", "both", "ring_spec"])
def test_spec_over_ranks_matches_one_rank_and_jax(world, case):
    """SpecPlane at k 4 over (tp 2, ep 2): drafting prompts, a sampled
    request riding the window and a repeat that drafts from the suffix
    table. Streams equal the one-rank Servers'; the speculation counters
    — the metrics' and the decode engine's drained stats — are equal on
    every rank (never summed over ranks), equal the port's one-rank
    Server's and the JAX Server's, and some drafts were accepted."""
    recs = _records(world, case)
    _assert_all_streams(world, case)
    one, ref = world["one"][case], world["refs"][case]
    assert ref["summary"]["spec_accepted"] > 0
    for rec in recs:
        assert rec["summary"] == one["summary"] == ref["summary"], (
            rec["summary"], one["summary"], ref["summary"])
        assert rec["decode_stats"] == recs[0]["decode_stats"]
        for k in ("spec_drafted", "spec_accepted", "spec_verifies"):
            assert rec["decode_stats"][k] == ref["summary"][k], k
    if "q" in W.PLANES_CASES[case][5]:
        assert recs[0]["decode_stats"]["quant_block_bytes"] * 2 == \
            one["decode_stats"]["quant_block_bytes"]


@pytest.mark.parametrize("case", ["granite_quant", "granite_spec"])
def test_wseq_planes_over_pairs(world, case):
    """Reduced granite-34b at (tp 2, ep 1), each pair of ranks that shares
    e a world of its own: under 'wseq' both `model` ranks hold the one KV
    head whole, so each seals the same int8 scales and its residency
    figures equal one rank's; speculation over a full and a ring layer.
    Streams equal the one-rank Servers'."""
    recs = _records(world, case)
    print(case, "int8 near-ties (request, token, margin):",
          _assert_all_streams(world, case))
    one = world["one"][case]
    for rec in recs:
        assert rec["decode_stats"] == recs[0]["decode_stats"]
        if case == "granite_quant":
            assert rec["decode_stats"]["quant_block_bytes"] == \
                one["decode_stats"]["quant_block_bytes"] == \
                rec["block_bytes"] > 0
            assert rec["arena_heads"] == one["arena_heads"]
        else:
            assert rec["summary"] == one["summary"] == \
                world["refs"][case]["summary"]


def test_capacity_drops_reported(world):
    """The capacity cut's drops of every case, per rank and one rank. A
    prefill chunk's rows are routed whole on every rank, and a 4-slot
    decode step fills no bucket past its floor of 8 rows either way, so
    without speculation every rank drops exactly what one rank drops. A
    verify window is another matter: one rank routes its 20 rows in one
    cut, a rank its half at a capacity reckoned from that half, so the
    counts differ (ROADMAP C5) while the streams above agree; they are
    reported, not held. A dense model drops nothing."""
    table = {c: ([r["servers"][c]["drops"] for r in world["ranks"]],
                 world["one"][c]["drops"]) for c in W.PLANES_CASES}
    print("capacity drops (ranks, one rank):", table)
    for case, (ranks, one) in table.items():
        arch, planes = W.PLANES_CASES[case][0], W.PLANES_CASES[case][5]
        if arch == "granite-34b":
            assert ranks == [0.0] * W.WORLD and one == 0.0, case
        elif "s" not in planes:
            assert ranks == [one] * W.WORLD, case


def test_hot_loop_audit_over_ranks(world):
    """The live hot-loop audit of W.AUDITED_CASE (int8 arenas and
    SpecConfig(k=4)) on every rank and on one rank: every registered entry
    observed, no finding; on the ranks the rank-local layout check ran on
    every observed call that holds an arena (each arena leaf at this
    rank's `head_layout(cfg, tp).nk` KV heads), and the int8 upcast check
    on the same calls."""
    case = W.AUDITED_CASE
    recs = [res["servers"][case]["audit"] for res in world["ranks"]]
    one = world["one"][case]["audit"]
    for r, a in enumerate(recs + [one]):
        assert not a["findings"], (r, a["findings"])
        assert a["audited"] == one["audited"] and "decode.verify" in \
            a["audited"], (r, a["audited"])
        assert 0 < a["checks"]["quant-upcast"] < a["checks"]["purity"], \
            (r, a["checks"])
    for r, a in enumerate(recs):
        assert a["world"] > 1 and a["checks"]["rank-local"] == \
            a["checks"]["quant-upcast"], (r, a["checks"])
    assert "rank-local" not in one["checks"] and one["world"] == 1
    # the other cases ran unwatched
    assert not any(res["servers"][c]["audit"]["checks"]
                   for res in world["ranks"] for c in W.PLANES_CASES
                   if c != case)
