"""OmniAttn's compressed layers served over ranks by the PyTorch port,
against the JAX reference on the CPU: one (tp 2, ep 2) world of four gloo
ranks (`torch.multiprocessing` spawn, a FileStore under tmp_path; the rank
side is tests/torch_dist_worker.py's `omni_child`, which imports no jax)
runs every case once, while this process builds the JAX references on the
same bridged weights.

- tests/test_mesh_parity.py's cases at the DEFAULT pattern (no `pattern`:
  reduced qwen2-moe-a2.7b's two layers are sink 4 + recent 16 rings in
  paged ring runs, prefilled whole): block sizes 8 and 16, a forced
  preemption, a live expert migration mid-decode (which moves expert rows
  and leaves every ring leaf as it was);
- the same rings prefilled in chunks (`prefill_sparse`), and slot-dense
  (`paged_kv=False`, the sink-decode path);
- online top-k over two paged full layers with a budget below the resident
  count: streams, blocks scored and attended equal the JAX Server's, the
  attention mass kept within 1e-6;
- reduced gemma3-4b (sliding windows of 32 beside compressed global
  layers, K 2 → one KV head a rank) at (tp 2, ep 1): each pair of ranks
  that shares e serves it as a world of its own;
- `stack._select_blocks` at tp 2 against one rank's, on inputs where each
  rank's own ranking keeps other blocks than the max over all heads, and
  the scores-given selection (`block_topk_select_scores`, plain on the
  CPU) on the max of two head halves' score passes against the
  reference's scores (Pallas interpret) and `select_kv_blocks`.

Each four-rank greedy stream equals the JAX one-device `Server`'s, with
`KVPool.check_invariants` on every rank, one host fetch per decode step
and the lockstep digest checked every round. The JAX MoE references run
on an Auto-axis mesh (ROADMAP C1). Every process group has a 60 s timeout
and the world joins within WORLD_LIMIT_S."""
import time
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dist_worker as W
from repro.configs import reduced_config
from repro.kernels.block_topk import block_topk_scores as j_block_topk
from repro.models import LM
from repro.models import attention as j_attn
from repro.serving import Server
from repro_torch import bridge
from repro_torch.distributed import RankCtx
from repro_torch.kernels.block_topk import (block_topk_scores_plain,
                                            block_topk_select_scores,
                                            block_topk_select_scores_plain)
from repro_torch.models.lm import LM as TLM
from test_torch_distributed import auto_mesh

torch.set_num_threads(2)

WORLD_LIMIT_S = 150


def jax_cfg(case):
    upd = dict(W.OMNI_CASES[case][3])
    knobs = upd.pop("omniattn", None)
    cfg = reduced_config("qwen2-moe-a2.7b").with_updates(
        compute_dtype="float32", param_dtype="float32", **upd)
    if knobs:
        cfg = cfg.with_updates(omniattn=replace(cfg.omniattn, **knobs))
    return cfg


def _jax_run(srv, reqs):
    s = srv.run(reqs, max_wall_s=300)
    assert s["n_done"] == len(reqs)
    return {"streams": {r.rid: tuple(r.output_tokens)
                        for r in srv.metrics.done},
            "sparsity": {k: s[k] for k in ("blocks_scored", "blocks_attended",
                                           "attn_mass_kept") if k in s}}


def _jax_case(case, jparams):
    _, kind, pattern, _ = W.OMNI_CASES[case]
    cfg = jax_cfg(case)
    # the preemption case's reference runs with a free pool, the migration
    # case's with placement off (tests/test_mesh_parity.py)
    scfg = W.omni_server_config(case, port=False, placement_on=False)
    if case == "preempt":
        scfg = replace(scfg, kv_blocks=None)
    srv = Server(cfg, scfg, mesh=auto_mesh(), pattern=pattern,
                 params=jax.tree.map(jnp.copy, jparams))
    return _jax_run(srv, W.omni_requests(kind, cfg.vocab_size))


def _jax_gemma3():
    cfg = reduced_config("gemma3-4b").with_updates(
        compute_dtype="float32", param_dtype="float32")
    srv = Server(cfg, W.server_config_kw(W.G3_SCFG, port=False))
    tcfg = W.g3_cfg()
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, srv.params),
                                      tcfg, srv.lm.plan, device="cpu")
    return params, _jax_run(srv, W.g3_requests(cfg.vocab_size))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("omni_world")
    cfg = jax_cfg("bs8")
    jlm = LM.build(cfg, auto_mesh())
    jparams = jlm.init(jax.random.PRNGKey(0))
    tcfg = W.moe_cfg()
    g3_params, g3_ref = _jax_gemma3()
    inputs = {"moe_params": bridge.params_from_numpy(
                  jax.tree.map(np.asarray, jparams), tcfg, jlm.plan,
                  device="cpu"),
              "g3_params": g3_params, "select": W.select_inputs()}
    torch.save(inputs, d / "inputs.pt")
    t0 = time.monotonic()
    procs = mp.start_processes(
        W.omni_child, args=(str(d / "store"), str(d / "inputs.pt"), str(d)),
        nprocs=W.WORLD, join=False, start_method="spawn")
    refs = {c: _jax_case(c, jparams) for c in W.OMNI_CASES}
    refs["gemma3"] = g3_ref
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
    ranks = [torch.load(d / f"omni_rank{r}.pt", weights_only=False)
             for r in range(W.WORLD)]
    for r, res in enumerate(ranks):
        assert "error" not in res, f"rank {r}: {res['error']}"
    return {"ranks": ranks, "refs": refs, "inputs": inputs}


def _streams(world, case):
    """Every rank's streams (they must be identical) and rank 0's record."""
    recs = [res["servers"][case] for res in world["ranks"]]
    for rec in recs[1:]:
        assert rec["streams"] == recs[0]["streams"], case
    return recs[0]["streams"], recs[0]


def _assert_streams(world, case, streams):
    """The case's streams equal the JAX Server's; a mismatch names the
    first differing token and the one-rank port's top-2 logit margin
    there."""
    ref = world["refs"][case]["streams"]
    if case == "gemma3":
        cfg, params, pattern = W.g3_cfg(), world["inputs"]["g3_params"], None
        reqs = W.g3_requests(cfg.vocab_size)
    else:
        cfg, params = W.omni_cfg(case), world["inputs"]["moe_params"]
        pattern, kind = W.OMNI_CASES[case][2], W.OMNI_CASES[case][1]
        reqs = W.omni_requests(kind, cfg.vocab_size)
    W.assert_streams(streams, ref, case, lambda rid, i: W.top2_margin(
        cfg, params, reqs[rid][0], ref[rid], i, pattern))


# ---- tests/test_mesh_parity.py at the default pattern -------------------
@pytest.mark.parametrize("case", ["bs8", "bs16"])
def test_default_pattern_parity_with_jax_server(world, case):
    """Ring layers in paged ring runs, whole-prompt prefill (prefill_sparse
    off), prefix reuse on, block sizes 8 and 16: the (tp 2, ep 2) greedy
    streams equal the JAX one-device Server's; the longest requests' rings
    (sink + recent = 20) wrap."""
    streams, rec = _streams(world, case)
    assert rec["n_done"] == 4 and not rec["prefill_chunked"]
    _assert_streams(world, case, streams)
    assert all(len(v) == 8 for v in streams.values())
    oa = W.moe_cfg().omniattn
    assert max(len(p) + n for p, n in W.parity_requests(512)) > \
        oa.sink_tokens + oa.recent_tokens


def test_default_pattern_parity_under_forced_preemption(world):
    """A five-block pool forces preemption mid-stream: each preempted
    slot's ring leaves go out with it (after their wrap) and come back;
    the four ranks recover to the JAX Server's tokens with a free pool."""
    streams, rec = _streams(world, "preempt")
    assert rec["preemptions"] >= 1
    _assert_streams(world, "preempt", streams)


def test_default_pattern_live_migration_parity(world):
    """An aggressive DynamicScheduler migrates experts between the EP ranks
    while ring slots are live: expert rows move, every ring leaf of every
    rank stays bit for bit as it was, and the streams equal the
    never-migrating JAX Server's."""
    streams, rec = _streams(world, "migrate")
    assert rec["n_migrations"] >= 1 and rec["migration_bytes"] > 0
    for res in world["ranks"]:
        kept = res["servers"]["migrate"]["ring_kept"]
        assert kept and all(kept), kept
    _assert_streams(world, "migrate", streams)


def test_ring_chunks_parity(world):
    """prefill_sparse: prompts prefill in 16-token chunks over the rings
    (`prefill_resume_attention` with the sink + recent mask) at K / tp
    heads; streams equal the JAX Server's."""
    streams, rec = _streams(world, "sparse")
    assert rec["prefill_chunked"]
    _assert_streams(world, "sparse", streams)


def test_slot_dense_whole_prompt_parity(world):
    """paged_kv=False: whole prompts compressed into slot-dense rings and
    decoded through sink_decode's plain version at K / tp heads."""
    streams, _ = _streams(world, "dense")
    _assert_streams(world, "dense", streams)


def test_topk_over_ranks_matches_jax_server(world):
    """A budget of 3 blocks against up to 13 resident ones on two paged
    full layers: streams, blocks scored and attended equal the JAX
    Server's on every rank (the counts are not summed over ranks: each rank
    attends the same blocks), and the attention mass kept — a mean over
    each rank's heads, averaged over `model` — is within 1e-6."""
    streams, rec = _streams(world, "topk")
    ref = world["refs"]["topk"]
    _assert_streams(world, "topk", streams)
    for res in world["ranks"]:
        sp = res["servers"]["topk"]["sparsity"]
        for k in ("blocks_scored", "blocks_attended"):
            assert sp[k] == ref["sparsity"][k] > 0, k
        assert sp["blocks_attended"] < sp["blocks_scored"]
        assert abs(sp["attn_mass_kept"]
                   - ref["sparsity"]["attn_mass_kept"]) <= 1e-6


def test_gemma3_windows_over_tp(world):
    """Reduced gemma3-4b at (tp 2, ep 1): ten sliding-window layers of 32
    beside two compressed global layers, one KV head a rank; greedy
    streams equal the JAX Server's on all four ranks (two pairs)."""
    streams, rec = _streams(world, "gemma3")
    assert rec["n_done"] == 4
    _assert_streams(world, "gemma3", streams)


def test_select_blocks_reduces_scores_over_model(world):
    """`_select_blocks` at tp 2: each rank scores its own heads, the scores
    are max-reduced over `model`, then ranked — so every rank's table and
    stats equal one rank's over all heads, exactly. On these inputs each
    rank's own ranking keeps other blocks, so a rank that skipped the
    reduction would fail here."""
    cfg = W.moe_cfg()
    want = W.run_select(cfg, world["inputs"]["select"])
    for res in world["ranks"]:
        for a, b in zip(res["select"], want):
            assert torch.equal(a, b)
    assert any(not torch.equal(res["select_local"][0], want[0])
               for res in world["ranks"])


@pytest.mark.parametrize("kind", ["ring", "window", "topk"])
def test_omniattn_layers_build_over_ranks(kind):
    """The default pattern's rings, sliding windows and online top-k lay
    out over (tp 2, ep 2) (they raised A16b before); the 'wseq' and
    replicated layouts and Mamba-2 at tp > 1 are
    test_torch_distributed_layouts.py's."""
    fake = RankCtx(ep=2, tp=2)
    if kind == "window":
        cfg = W.g3_cfg()
        lm = TLM.build(cfg, device="cpu", ctx=RankCtx(ep=1, tp=2))
        assert any(s.window for s in lm.plan.all_specs())
        return
    cfg = W.moe_cfg() if kind == "ring" else W.omni_cfg("topk")
    lm = TLM.build(cfg, pattern=None if kind == "ring" else [0, 0],
                   device="cpu", ctx=fake)
    assert lm.ctx.world == 4


@pytest.mark.parametrize("k_static,frac", [(4, 0.0), (6, 0.25), (16, 0.0)])
def test_select_scores_on_max_of_head_halves_matches_reference(k_static,
                                                               frac):
    """Integer-valued q and summaries (every product and sum exact in
    float32): the max of two ranks' score passes, each over half the kv
    heads, equals the reference's scores over all heads (Pallas interpret)
    bit for bit, and the scores-given selection on it equals the
    reference's `select_kv_blocks` — tables, lens, counts, mask — with the
    step's stats over the live slots."""
    rng = np.random.default_rng(k_static)
    B, K, G, h, bs, nb = 4, 2, 3, 32, 8, 16
    N = B * nb + 1
    q = rng.integers(-3, 4, (B, K, G, h)).astype(np.float32)
    kmin = rng.integers(-3, 4, (N, K, h)).astype(np.float32)
    kmax = kmin + rng.integers(0, 3, (N, K, h)).astype(np.float32)
    tables = rng.permutation(np.arange(1, N))[:B * nb].reshape(B, nb) \
        .astype(np.int32)
    lens = np.array([1, 5 * bs + 3, 12 * bs, nb * bs], np.int32)
    for b in range(B):
        tables[b, -(-lens[b] // bs):] = 0
    kw = dict(block_size=bs, k_static=k_static, frac=frac, sink_blocks=1,
              recent_blocks=2)
    jscores = j_block_topk(jnp.asarray(q), kmin, kmax, tables, lens,
                           block_size=bs, interpret=True)
    jout = j_attn.select_kv_blocks(jscores, jnp.asarray(tables),
                                   jnp.asarray(lens), **kw)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    halves = [block_topk_scores_plain(t(q[:, r:r + 1]), t(kmin[:, r:r + 1]),
                                      t(kmax[:, r:r + 1]), t(tables),
                                      t(lens), block_size=bs)
              for r in range(K)]
    scores = torch.maximum(*halves)
    np.testing.assert_array_equal(scores.numpy(), np.asarray(jscores))
    mask = torch.tensor([True, False, True, True])
    got = block_topk_select_scores(scores, t(tables), t(lens),
                                   token_mask=mask, **kw)
    for name, g, j in zip(("tables", "lens", "m", "selected"), got, jout):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j),
                                      err_msg=name)
    n_res = -(-lens // bs)
    m = np.asarray(jout[2])
    act = mask.numpy()
    np.testing.assert_array_equal(
        got[4].numpy(), np.array([(act * n_res).sum(), (act * m).sum(), 0, 0],
                                 np.float32))
    plain = block_topk_select_scores_plain(scores, t(tables), t(lens),
                                           token_mask=mask, **kw)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
