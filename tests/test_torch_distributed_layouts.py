"""Every servable architecture laid out over (tp, ep) ranks by the PyTorch
port, against the JAX reference on the CPU: one (tp 2, ep 2) world of four
gloo ranks (`torch.multiprocessing` spawn, a FileStore under tmp_path; the
rank side is tests/torch_dist_worker.py's `layout_child`, which imports no
jax) runs every case once, while this process runs the JAX one-device
`Server` on the same weights (`LM.init(PRNGKey(0))` bridged through numpy).

- reduced granite-34b (H 4 over K 1, the 'wseq' layout: two query heads a
  rank over the one KV head, every cache holding that head) at its default
  pattern (both layers sink 4 + recent 16 rings) prefilled whole and in
  chunks, at pattern [0, 1] (a shared arena holds the one head), and with
  an absolute top-k budget of 3 blocks (`block_topk` over a KV head both
  `model` ranks hold: blocks scored, attended and the mass equal);
- reduced qwen2-1.5b at H 3 over K 1 (H % tp != 0: the attention
  sublayer replicated, no psum);
- reduced mamba2-130m on a shared-prefix mix (each rank half the SSD heads
  and channels, `ssm_norm` summing its squares over `model`), once with a
  pool cut until it preempts;
- reduced jamba-1.5-large-398b cut to one period (8 layers, the attention
  layer at offset 4) at its default pattern: Mamba-2 at tp 2, MoE over
  ep 2, attention under 'kv'.

Each four-rank greedy stream equals the JAX one-device `Server`'s, with
`KVPool.check_invariants` on every rank, one host fetch a decode step and
the lockstep digest checked every round. Without spawning: `mamba_sublayer`
on two ranks (threads whose `model` collectives meet at a barrier) against
one rank, with the `ssm_norm` reduction dropped as a mutation that must
fail; every servable config's reduced form built, cut and run at tp 2 and
4 against one rank; `stack.head_layout` on the full configs. The JAX
references run on an Auto-axis mesh (ROADMAP C1). Every process group has
a 60 s timeout and the world joins within WORLD_LIMIT_S."""
import functools
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dist_worker as W
from repro.serving import Server
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.distributed import RankCtx
from repro_torch.models import stack as tstack
from repro_torch.models.common import rms_norm
from repro_torch.models.lm import LM as TLM
from repro_torch.serving import DevicePlacement
from repro_torch.serving.server import check_servable
from test_torch_distributed import auto_mesh

torch.set_num_threads(2)

WORLD_LIMIT_S = 150
TOL = dict(rtol=1e-5, atol=1e-5)
SERVABLE = ("qwen2-1.5b", "qwen3-32b", "gemma3-4b", "granite-34b",
            "jamba-1.5-large-398b", "qwen2-moe-a2.7b", "qwen3-moe-235b-a22b",
            "mamba2-130m")


def _jax_server(case):
    _, _, pattern, _, _ = W.LAYOUT_CASES[case]
    return Server(W.layout_cfg(case, port=False),
                  W.layout_server_config(case, port=False),
                  mesh=auto_mesh(), pattern=pattern)


def _bridged(jsrvs, cases) -> dict:
    """{case: the port's parameters bridged from its JAX Server's}."""
    return {c: bridge.params_from_numpy(
                jax.tree.map(np.asarray, jsrvs[W.LAYOUT_REF.get(c, c)]
                             .params), W.layout_cfg(c),
                jsrvs[W.LAYOUT_REF.get(c, c)].lm.plan, device="cpu")
            for c in cases}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("layout_world")
    early = [c for c in W.LAYOUT_CASES if c not in W.LAYOUT_LATE]
    jsrvs = {c: _jax_server(c) for c in early if c not in W.LAYOUT_REF}
    params = _bridged(jsrvs, early)
    inputs = {"params": params}
    torch.save(inputs, d / "inputs.pt")
    t0 = time.monotonic()
    procs = mp.start_processes(
        W.layout_child, args=(str(d / "store"), str(d / "inputs.pt"),
                              str(d)),
        nprocs=W.WORLD, join=False, start_method="spawn")
    # the late cases' weights while the ranks serve the others
    jsrvs.update({c: _jax_server(c) for c in W.LAYOUT_LATE})
    late = _bridged(jsrvs, W.LAYOUT_LATE)
    params.update(late)
    torch.save({"params": late}, d / "late.tmp")
    (d / "late.tmp").rename(d / "inputs.pt.late")
    refs = {}
    for case, srv in jsrvs.items():
        reqs = W.layout_requests(W.LAYOUT_CASES[case][4],
                                 srv.cfg.vocab_size)
        s = srv.run(reqs, max_wall_s=300)
        assert s["n_done"] == len(reqs)
        refs[case] = {"streams": {r.rid: tuple(r.output_tokens)
                                  for r in srv.metrics.done},
                      "sparsity": {k: s[k] for k in (
                          "blocks_scored", "blocks_attended",
                          "attn_mass_kept") if k in s}}
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
    ranks = [torch.load(d / f"layout_rank{r}.pt", weights_only=False)
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
    ref = world["refs"][W.LAYOUT_REF.get(case, case)]["streams"]
    cfg = W.layout_cfg(case)
    _, _, pattern, _, kind = W.LAYOUT_CASES[case]
    reqs = W.layout_requests(kind, cfg.vocab_size)
    W.assert_streams(streams, ref, case, lambda rid, i: W.top2_margin(
        cfg, world["inputs"]["params"][case], reqs[rid][0], ref[rid], i,
        pattern))


# ---- the spawned world ------------------------------------------------
@pytest.mark.parametrize("case,chunked", [("granite_whole", False),
                                          ("granite_chunks", True),
                                          ("granite_arena", True)])
def test_wseq_granite_parity_with_jax_server(world, case, chunked):
    """MQA at tp 2: each rank's two query heads read the one KV head, which
    every rank's rings (and at [0, 1] the shared arena) hold whole; whole
    prompts and chunks over the rings give the JAX Server's streams."""
    streams, rec = _streams(world, case)
    assert rec["n_done"] == 4 and rec["prefill_chunked"] == chunked
    _assert_streams(world, case, streams)
    assert all(len(v) == 8 for v in streams.values())
    # the rank's ring runs [slots · blocks, K, bs, h] hold the one KV head
    assert rec["private_shapes"]["k"][1] == 1


def test_wseq_topk_over_a_shared_kv_head(world):
    """A budget of 3 blocks on two paged full layers of reduced granite at
    tp 2: both `model` ranks score the one KV head with their own query
    heads, the max over `model` ranks the blocks, and the streams, blocks
    scored and attended equal the JAX Server's on every rank; the mass, a
    mean over each rank's query heads averaged over `model`, within
    1e-6."""
    streams, rec = _streams(world, "granite_topk")
    ref = world["refs"]["granite_topk"]
    _assert_streams(world, "granite_topk", streams)
    for res in world["ranks"]:
        sp = res["servers"]["granite_topk"]["sparsity"]
        for k in ("blocks_scored", "blocks_attended"):
            assert sp[k] == ref["sparsity"][k] > 0, k
        assert sp["blocks_attended"] < sp["blocks_scored"]
        assert abs(sp["attn_mass_kept"]
                   - ref["sparsity"]["attn_mass_kept"]) <= 1e-6


def test_replicated_attention_parity_with_jax_server(world):
    """H 3 over K 1 at tp 2 (the reference's 'qseq'): every rank holds and
    computes all three heads, full arena and ring alike, and sums nothing
    over `model`; chunked streams equal the JAX Server's."""
    streams, rec = _streams(world, "qwen2_h3")
    assert rec["prefill_chunked"]
    _assert_streams(world, "qwen2_h3", streams)
    assert rec["private_shapes"]["k"][1] == 1


@pytest.mark.parametrize("case", ["mamba2", "mamba2_preempt"])
def test_mamba2_over_tp_parity_with_jax_server(world, case):
    """Reduced mamba2-130m at tp 2: each rank's state holds 8 of the 16 SSD
    heads and its `conv_x` rows 128 of the 256 channels, `conv_bc` whole;
    prefix reuse on a shared prefix, and a pool cut until a slot is
    preempted and re-prefilled (its share of the state rebuilt exactly):
    the streams equal the JAX Server's on a free pool."""
    streams, rec = _streams(world, case)
    assert rec["n_done"] == 5 and rec["prefill_chunked"]
    if case == "mamba2_preempt":
        assert rec["preemptions"] >= 1
    _assert_streams(world, case, streams)
    cfg = W.layout_cfg(case)
    d_in = cfg.ssm.expand * cfg.d_model
    shp = rec["private_shapes"]
    assert shp["state"][1] == d_in // cfg.ssm.head_dim // W.TP
    assert shp["conv_x"][2] == d_in // W.TP
    assert shp["conv_bc"][2] == 2 * cfg.ssm.d_state


def test_jamba_period_over_tp_and_ep(world):
    """One period of reduced jamba (seven Mamba-2 layers split over tp 2,
    the attention layer at offset 4 under 'kv', MoE on every second layer
    over ep 2) at its default pattern: whole-prompt streams equal the JAX
    Server's on all four ranks."""
    streams, rec = _streams(world, "jamba")
    assert rec["n_done"] == 4 and not rec["prefill_chunked"]
    _assert_streams(world, "jamba", streams)


# ---- two ranks as threads: the layers without a process group ---------
def thread_ctxs(tp):
    """`tp` contexts of one `model` group whose collectives meet at a
    barrier: run each rank's work in its own thread."""
    bar = threading.Barrier(tp, timeout=60)
    slots = [None] * tp

    def meet(t, x, combine):
        slots[t] = x.clone()
        bar.wait()
        out = combine(slots)
        bar.wait()
        return out

    class ThreadCtx(RankCtx):
        def psum_model(self, x):
            return meet(self.t, x, lambda xs: functools.reduce(torch.add, xs))

        def pmax_model(self, x):
            return meet(self.t, x,
                        lambda xs: functools.reduce(torch.maximum, xs))

        def all_gather_model(self, x, dim=-1):
            return meet(self.t, x, lambda xs: torch.cat(xs, dim))

    return [ThreadCtx(ep=1, tp=tp, rank=t) for t in range(tp)]


def on_ranks(tp, fn):
    """fn(ctx) on every rank of a `tp`-thread `model` group → results in
    rank order."""
    with ThreadPoolExecutor(tp) as ex:
        return list(ex.map(fn, thread_ctxs(tp)))


def _mamba_run(cfg, p, xs, ctx=None):
    """A padded prefill (true_len 19 of 24 rows), a padded chunk continued
    from its entry (11 of 16) and two decode steps of one mamba layer →
    (outputs, the entry)."""
    kw = dict(ctx=ctx)
    y0, ent = tstack.mamba_sublayer(cfg, p, xs[0], mode="prefill",
                                    cache=None, true_len=19, **kw)
    y1, _ = tstack.mamba_sublayer(cfg, p, xs[1], mode="prefill", cache=ent,
                                  true_len=torch.tensor(11), **kw)
    outs = [y0, y1]
    for x in xs[2:]:
        outs.append(tstack.mamba_sublayer(cfg, p, x, mode="decode",
                                          cache=ent, **kw)[0])
    return outs, ent


def _mamba_case(tp=2):
    cfg = t_reduced("mamba2-130m").with_updates(compute_dtype="float32",
                                                param_dtype="float32")
    one = TLM.build(cfg, device="cpu")
    params = one.init(seed=5)
    g = torch.Generator().manual_seed(6)
    xs = [torch.randn((1, n, cfg.d_model), generator=g)
          for n in (24, 16, 1, 1)]
    want = _mamba_run(cfg, params["layers"][0], xs)

    def rank(ctx):
        lm = TLM.build(cfg, device="cpu", ctx=ctx)
        p = DevicePlacement(torch.device("cpu"), ctx=ctx).transfer_params(
            one, params, lm)["layers"][0]
        return _mamba_run(cfg, p, xs, ctx), tstack.mamba_layout(cfg, tp,
                                                                ctx.t)
    return cfg, want, on_ranks(tp, rank)


def test_mamba_sublayer_two_ranks_match_one(monkeypatch):
    """`mamba_sublayer` at tp 2 — a padded prefill, a padded chunk continued
    from its entry, two decode steps — equals one rank's: every output
    within 1e-5, each rank's state and `conv_x` rows its share of the
    one-rank entry's, `conv_bc` whole. With `ssm_norm`'s sum of squares
    kept rank-local (the reduction over `model` dropped) the outputs
    differ: the mutation fails."""
    cfg, (want, went), got = _mamba_case()
    for (outs, ent), lay in got:
        for a, b in zip(outs, want):
            torch.testing.assert_close(a, b, **TOL)
        torch.testing.assert_close(
            ent["state"], went["state"][:, lay.h0:lay.h0 + lay.nh], **TOL)
        torch.testing.assert_close(
            ent["conv_x"], went["conv_x"][..., lay.c0:lay.c0 + lay.nc],
            **TOL)
        torch.testing.assert_close(ent["conv_bc"], went["conv_bc"], **TOL)
    monkeypatch.setattr(tstack, "rms_norm_over_model",
                        lambda x, scale, eps, ctx, width: rms_norm(x, scale,
                                                                   eps))
    _, (want, _), got = _mamba_case()
    worst = max(float((a - b).abs().max())
                for (outs, _), _ in got for a, b in zip(outs, want))
    assert worst > 100 * TOL["atol"], worst


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", SERVABLE)
def test_reduced_config_lays_out_over_tp(arch, tp):
    """Every servable config's reduced form builds at tp 2 and 4 (ep 1),
    as the reference's launcher lays it out: one-rank parameters carried
    into each rank's whole-head cut (`param_cuts`: wq by its query heads,
    wk by its KV heads, the Mamba-2 mixer by its SSD heads), and a
    whole-prompt prefill and one decode step on the ranks (threads) give
    one rank's logits."""
    cfg = t_reduced(arch).with_updates(compute_dtype="float32",
                                       param_dtype="float32")
    check_servable(cfg)
    one = TLM.build(cfg, device="cpu")
    params = one.init(seed=9)
    toks = torch.randint(0, cfg.vocab_size, (1, 12),
                         generator=torch.Generator().manual_seed(9))
    tables = one.default_tables()
    cache, want, _ = one.prefill(params, toks, max_len=16, tables=tables)
    nxt, pos = want.argmax(-1)[:, None], torch.tensor([[12]])
    want2 = one.decode(params, cache, nxt, pos, tables=tables)[1]

    def rank(ctx):
        lm = TLM.build(cfg, device="cpu", ctx=ctx)
        p = DevicePlacement(torch.device("cpu"), ctx=ctx).place_params(
            params, lm)
        c, lg, _ = lm.prefill(p, toks, max_len=16, tables=tables)
        return p, lg, lm.decode(p, c, nxt, pos, tables=tables)[1]

    h = cfg.head_dim
    for t, (p, lg, lg2) in enumerate(on_ranks(tp, rank)):
        torch.testing.assert_close(lg, want, **TOL)
        torch.testing.assert_close(lg2, want2, **TOL)
        for spec, lay, whole in zip(one.plan.all_specs(), p["layers"],
                                    params["layers"]):
            if spec.kind == "attn":
                hl = tstack.head_layout(cfg, tp, t)
                assert torch.equal(lay["wq"], whole["wq"][
                    :, hl.q0 * h:(hl.q0 + hl.nq) * h])
                assert torch.equal(lay["wk"], whole["wk"][
                    :, hl.k0 * h:(hl.k0 + hl.nk) * h])
            else:
                ml = tstack.mamba_layout(cfg, tp, t)
                assert not ml.replicated
                assert torch.equal(lay["A_log"],
                                   whole["A_log"][ml.h0:ml.h0 + ml.nh])
                assert torch.equal(lay["w_bc"], whole["w_bc"])


@pytest.mark.parametrize("arch,tp,kind,nq,kv_of", [
    ("granite-34b", 4, "wseq", 12, lambda t: 0),
    ("granite-34b", 8, "wseq", 6, lambda t: 0),
    ("qwen2-1.5b", 2, "kv", 6, lambda t: t),
    ("qwen2-1.5b", 4, "wseq", 3, lambda t: t // 2),
    ("qwen2-1.5b", 8, "replicated", 12, lambda t: 0),
    ("gemma3-4b", 8, "wseq", 1, lambda t: t // 2),
])
def test_head_layout_of_full_configs(arch, tp, kind, nq, kv_of):
    """`stack.head_layout` on the published configs: granite-34b's 48
    query heads over its one KV head give 12 a rank at tp 4, all reading
    KV head 0; qwen2-1.5b's 12 over 2 give 3 a rank at tp 4 over KV head
    t // 2, and are replicated at tp 8 (12 % 8 != 0). Every query head is
    on exactly one rank unless the sublayer is replicated."""
    cfg = get_config(arch)
    lays = [tstack.head_layout(cfg, tp, t) for t in range(tp)]
    seen = []
    for t, hl in enumerate(lays):
        assert hl.kind == kind and hl.nq == nq
        assert hl.k0 == kv_of(t)
        if kind != "replicated":
            G = cfg.n_heads // cfg.n_kv_heads
            assert hl.q0 // G <= hl.k0 and (hl.q0 + hl.nq - 1) // G < \
                hl.k0 + hl.nk        # the query heads read the rank's KV
        seen += range(hl.q0, hl.q0 + hl.nq)
    if kind == "replicated":
        assert all(hl.nk == cfg.n_kv_heads for hl in lays)
    else:
        assert sorted(seen) == list(range(cfg.n_heads))
