"""CUDA-graph capture of the port's decode and verify steps, on the card.

Marked `gpu`: they skip without a CUDA device. Each serving test runs the
same reduced-width server (2 layers, seed-0 weights) twice on the same
traffic through `add_request`/`step`: once with the hot-loop entries
captured and replayed (the default on `cuda`) and once eagerly
(`DevicePlacement.of("cuda", capture=False)`). Greedy and sampled streams,
every slot-state tensor (tokens, positions, the sparsity, speculation and
MoE-count accumulators), the metrics' drained stats, the arenas outside
the null block 0 (int8 payload and scale plane too), the ring runs or
dense caches, and the kernels' launch counts must be equal, exactly. The
five decode paths (paged float32, paged int8, online top-k, MoE with a
forced migration, slot-dense) and the verify step are covered, and so is
the prefill engine's "prefill.chunk" entry on six paths (float32, int8,
MoE, a resume after prefix reuse, ring layers over paged KV, dense KV),
its static private leaves equal across the two modes too; and the SSM
stacks: reduced mamba2-130m's decode step and chunks (its state and
convolution rows updated in place), reduced jamba in bfloat16; and the
whole-prompt "prefill.full" and first-token "prefill.first" entries
(default OmniAttn pattern paged and slot-dense, MoE, mamba2), their static
cache and logits equal across the modes too. Also: the card's threefry
bits and uniforms equal the CPU's bit for bit at V = 151,936; the
fused top-k launch (a cluster launch) replayed from a graph equals its
eager launch, and an exception inside a capture propagates (no fallback).
This file imports neither jax nor the JAX package:

    PYTHONPATH=src python -m pytest --noconftest -o markers=gpu -q tests/test_torch_capture_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.core.placement.migration import MigrationPlan
from repro_torch.core.proxy import OASConfig, SamplingParams
from repro_torch.kernels._common import count_delta, launch_counts
from repro_torch.kernels.block_topk import block_topk_select
from repro_torch.serving import DevicePlacement, Server, ServerConfig
from repro_torch.serving.quant import QuantConfig
from repro_torch.serving.spec import SpecConfig

pytestmark = pytest.mark.gpu

SCFG = dict(n_prefill=1, n_decode=1, decode_slots=4, max_len=128,
            chunk_tokens=32, prefill_tick_budget=64, kv_blocks=64,
            kv_block_size=8, oas=OASConfig(defer_window=0.0))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs)")
    return torch.device("cuda")


def _cfg(arch="qwen2-1.5b", **kw):
    return reduced_config(arch).with_updates(**dict(dict(
        compute_dtype="float32", param_dtype="float32", n_layers=2), **kw))


def _traffic(vocab, n=6, seed=7, long=40, phrase=False):
    """Two of three prompts share a prefix (`long` tokens plus 8), the rest
    are short; one sampled request. `phrase` repeats a 6-token phrase so
    speculation has drafts."""
    rng = np.random.default_rng(seed)
    if phrase:
        ph = [tuple(int(t) for t in rng.integers(0, vocab, 6))
              for _ in range(n)]
        prompts = [p * 6 for p in ph]
    else:
        base = tuple(int(t) for t in rng.integers(0, vocab, long))
        prompts = [base + tuple(int(t) for t in rng.integers(0, vocab, 8))
                   if i % 3 != 2 else
                   tuple(int(t) for t in rng.integers(0, vocab, 6))
                   for i in range(n)]
    params = [SamplingParams(max_tokens=10)] * (n - 1) + [SamplingParams(
        temperature=0.9, top_k=16, top_p=0.9, seed=3, max_tokens=10)]
    return prompts, params


def _serve(cfg, capture, traffic, migrate_at=None, pattern=None,
           on_build=None, **kw):
    pl = DevicePlacement.of("cuda", capture=capture)
    srv = Server(cfg, ServerConfig(**dict(SCFG, **kw)),
                 pattern=pattern or [0] * cfg.n_layers, seed=0, placement=pl)
    if on_build is not None:
        on_build(srv)
    before = launch_counts()
    prompts, params = traffic
    for p, sp in zip(prompts, params):
        srv.add_request(p, sp)
    out, steps = {}, 0
    while srv.proxy.inflight:
        for o in srv.step():
            out.setdefault(o.rid, []).extend(o.new_tokens)
        steps += 1
        if steps == migrate_at:
            se = srv.tables["slot_expert"].cpu().numpy()
            new = se[:, ::-1].copy()
            srv._apply_migration(MigrationPlan(se, new, tuple(
                (0, i, int(new[0, i])) for i in range(new.shape[1])),
                new.shape[1]))
    torch.cuda.synchronize()
    counts = count_delta(before, launch_counts())
    return srv, [out[r] for r in sorted(out)], counts


def _no_kernels(cfg):
    """A stack that launches no kernel of the port: Mamba-2 layers only,
    without MoE (mamba2-130m)."""
    return all(s.kind == "mamba" and not s.use_moe
               for s in cfg.layer_specs([0] * cfg.n_layers))


def _equal_trees(a, b, what, skip_null=False):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _equal_trees(a[k], b[k], f"{what}.{k}", skip_null)
        return
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_trees(x, y, f"{what}[{i}]", skip_null)
        return
    if isinstance(a, torch.Tensor):
        x, y = (a[1:], b[1:]) if skip_null else (a, b)
        assert torch.equal(x, y), what
        return
    assert a == b, what


def _check_modes(cfg, traffic, verify=False, **kw):
    """Serve captured and eager; everything equal; → the captured server's
    hot-loop summary."""
    cap, s_cap, n_cap = _serve(cfg, True, traffic, **kw)
    eag, s_eag, n_eag = _serve(cfg, False, traffic, **kw)
    assert s_cap == s_eag and len(s_cap) == len(traffic[0])
    assert n_cap == n_eag and (n_cap or _no_kernels(cfg))
    e_cap, e_eag = cap.decodes[0], eag.decodes[0]
    _equal_trees(e_cap.state, e_eag.state, "state")
    cap.drain_decode_stats()
    eag.drain_decode_stats()
    for k in ("blocks_scored", "blocks_attended", "spec_drafted",
              "spec_accepted", "spec_verifies"):
        assert e_cap.stats.get(k) == e_eag.stats.get(k), k
    if cap.kv_arena is not None:
        _equal_trees(cap.kv_arena.kv, eag.kv_arena.kv, "arena",
                     skip_null=True)
        cap.kv_arena.pool.check_invariants(arena=cap.kv_arena)
    _equal_trees(e_cap.cache["layers"], e_eag.cache["layers"], "private")
    if cap.tables is not None:
        _equal_trees(cap.tables, eag.tables, "tables")
    summ = cap.placement.hot_loops.summary()
    assert summ["decode.step"]["replays"] > 0, summ
    # a key met once runs only its eager call
    assert 0 < summ["decode.step"]["captures"] <= \
        len(summ["decode.step"]["keys"]), summ
    if verify:
        assert summ["decode.verify"]["replays"] > 0, summ
    eager = eag.placement.hot_loops.summary()
    assert all(v["captures"] == v["replays"] == 0 for v in eager.values())
    assert cap.placement.graph_pool_bytes() > 0
    assert e_cap.stats["host_fetches"] == e_cap.stats["steps"]
    return summ


def test_capture_paged_float32(cuda):
    cfg = _cfg()
    _check_modes(cfg, _traffic(cfg.vocab_size))


def test_capture_paged_int8(cuda):
    cfg = _cfg()
    _check_modes(cfg, _traffic(cfg.vocab_size, seed=8, long=56),
                 quant=QuantConfig())


def test_capture_online_topk(cuda):
    """~100-token contexts in blocks of 8: the table bucket is 16 and a
    budget of 0.25 keeps 4 of its blocks, so the fused launch ranks and
    compacts."""
    cfg = _cfg(omniattn_topk_frac=0.25, omniattn_topk_sink_blocks=1,
               omniattn_topk_recent_blocks=2)
    summ = _check_modes(cfg, _traffic(cfg.vocab_size, seed=9, long=90))
    assert any(k[0] == 16 for k in summ["decode.step"]["keys"])


def test_capture_moe_with_forced_migration(cuda):
    cfg = reduced_config("qwen2-moe-a2.7b").with_updates(
        compute_dtype="float32", param_dtype="float32")
    _check_modes(cfg, _traffic(cfg.vocab_size, seed=10), migrate_at=6,
                 enable_placement=True, placement_interval=2)


def test_capture_slot_dense(cuda):
    cfg = _cfg()
    _check_modes(cfg, _traffic(cfg.vocab_size, seed=11), paged_kv=False,
                 chunked_prefill=False)


def test_capture_verify(cuda):
    cfg = _cfg()
    _check_modes(cfg, _traffic(cfg.vocab_size, seed=12, phrase=True),
                 verify=True, spec=SpecConfig(k=3))


# ---- the prefill engine's "prefill.chunk" entry --------------------------
def _check_prefill(cfg, traffic, **kw):
    """`_check_modes` over a chunked prefill path, and the chunk entry
    replayed, its static private leaves equal across the two modes, and,
    with `reused`, a prefix resumed from the store."""
    reused = kw.pop("reused", False)
    admitted = {True: [], False: []}

    def record(capture):
        """Keep the ring KV each zero-copy admission writes (the handoff's
        private leaves)."""
        def on_build(srv):
            eng = srv.decodes[0]
            insert = eng._insert_private

            def recorded(one, slot):
                insert(one, slot)
                admitted[capture].append((slot, [
                    None if e is None else {n: x.clone()
                                            for n, x in e.items()}
                    for e in one["layers"]]))
            eng._insert_private = recorded
        return on_build

    cap, s_cap, n_cap = _serve(cfg, True, traffic, on_build=record(True),
                               **kw)
    eag, s_eag, n_eag = _serve(cfg, False, traffic, on_build=record(False),
                               **kw)
    assert s_cap == s_eag and len(s_cap) == len(traffic[0])
    assert n_cap == n_eag and (n_cap or _no_kernels(cfg))
    p_cap, p_eag = cap.prefills[0], eag.prefills[0]
    assert p_cap.stats["chunks"] == p_eag.stats["chunks"]
    assert p_cap.chunked and p_cap.layout == p_eag.layout
    _equal_trees(p_cap._priv, p_eag._priv, "prefill private")
    _equal_trees(admitted[True], admitted[False], "admitted rings")
    rings = any(e is not None for e in cap.decodes[0].cache["layers"])
    if p_cap.paged and rings:
        # a paged ring run's last content is written by decode steps the
        # slot took while idle, which attend the null block: compare what
        # admission wrote instead
        assert admitted[True]
    else:
        _equal_trees(cap.decodes[0].cache["layers"],
                     eag.decodes[0].cache["layers"], "decode private")
    _equal_trees(cap.decodes[0].state, eag.decodes[0].state, "state")
    if cap.kv_arena is not None:
        _equal_trees(cap.kv_arena.kv, eag.kv_arena.kv, "arena",
                     skip_null=True)
        cap.kv_arena.pool.check_invariants(arena=cap.kv_arena)
    if reused:
        assert p_cap.stats["prefix_hits"] > 0
    summ = cap.placement.hot_loops.summary()
    chunk = summ["prefill.chunk"]
    assert chunk["replays"] > 0 and 0 < chunk["captures"] <= len(
        chunk["keys"]), summ
    assert chunk["eager"] + chunk["replays"] == p_cap.stats["chunks"]
    assert all(k[1] == p_cap.layout for k in chunk["keys"])
    eager = eag.placement.hot_loops.summary()
    assert all(v["captures"] == v["replays"] == 0 for v in eager.values())
    return summ


def test_prefill_chunk_capture_float32(cuda):
    cfg = _cfg()
    _check_prefill(cfg, _traffic(cfg.vocab_size, seed=13, long=70),
                   prefix_reuse=False)


def test_prefill_chunk_capture_int8(cuda):
    cfg = _cfg()
    _check_prefill(cfg, _traffic(cfg.vocab_size, seed=14, long=70),
                   prefix_reuse=False, quant=QuantConfig())


def test_prefill_chunk_capture_moe(cuda):
    cfg = reduced_config("qwen2-moe-a2.7b").with_updates(
        compute_dtype="float32", param_dtype="float32")
    _check_prefill(cfg, _traffic(cfg.vocab_size, seed=15, long=70),
                   enable_placement=False)


def test_prefill_chunk_capture_after_prefix_reuse(cuda):
    """Sharers of a 70-token prefix resume from its snapshot at another
    offset than the chunk grid's: their chunks replay the same keys."""
    cfg = _cfg()
    _check_prefill(cfg, _traffic(cfg.vocab_size, n=9, seed=16, long=70),
                   reused=True)


RING = dict(n_layers=4, local_per_global=1, local_window=16,
            prefill_sparse=True, omniattn_sink_tokens=8,
            omniattn_recent_tokens=24)


def test_prefill_chunk_capture_ring_paged(cuda):
    """The mixed stack (sliding window, compressed under prefill_sparse,
    full): full layers in the arenas, the rings copied into the static
    private leaves before each replay and back out after."""
    cfg = _cfg(**RING)
    _check_prefill(cfg, _traffic(cfg.vocab_size, seed=17, long=70),
                   pattern=[0, 0, 0, 1])


def test_prefill_chunk_capture_dense(cuda):
    """paged_kv=False: every layer's dense B=1 cache is a static private
    leaf of the chunk; decode over the slot-dense caches."""
    cfg = _cfg(**RING)
    _check_prefill(cfg, _traffic(cfg.vocab_size, seed=18, long=70),
                   pattern=[0, 0, 0, 1], paged_kv=False)


def test_capture_mamba2(cuda):
    """Reduced mamba2-130m (2 Mamba-2 layers, no attention): the decode
    step updates every slot's state and convolution rows in place in the
    static buffers; captured equals eager, the private rows too."""
    cfg = _cfg("mamba2-130m")
    _check_modes(cfg, _traffic(cfg.vocab_size, seed=19, long=70))


def test_prefill_chunk_capture_mamba2(cuda):
    """The chunk's padding mask and the convolution rows' gather read the
    real length from the device; sharers resume from the prefix store's
    cloned state."""
    cfg = _cfg("mamba2-130m")
    _check_prefill(cfg, _traffic(cfg.vocab_size, n=9, seed=20, long=70),
                   reused=True)


def test_capture_jamba_bfloat16(cuda):
    """Reduced jamba in its published bfloat16: Mamba-2, MoE and one full
    attention layer in eight; decode and chunks captured equal eager."""
    cfg = _cfg("jamba-1.5-large-398b", n_layers=8,
               compute_dtype="bfloat16", param_dtype="bfloat16")
    _check_prefill(cfg, _traffic(cfg.vocab_size, seed=21, long=70),
                   enable_placement=False)


# ---- whole-prompt prefill and first tokens: "prefill.full", "prefill.first"
def _check_full(cfg, traffic, **kw):
    """`_check_modes` over whole-prompt prefill: the "prefill.full" and
    "prefill.first" entries replayed, every whole prefill one call of the
    former, the static cache and logits equal across the two modes."""
    cap, s_cap, n_cap = _serve(cfg, True, traffic, chunked_prefill=False,
                               **kw)
    eag, s_eag, n_eag = _serve(cfg, False, traffic, chunked_prefill=False,
                               **kw)
    assert s_cap == s_eag and len(s_cap) == len(traffic[0])
    assert n_cap == n_eag and (n_cap or _no_kernels(cfg))
    p_cap, p_eag = cap.prefills[0], eag.prefills[0]
    assert not p_cap.chunked
    assert p_cap.stats["prefills"] == p_eag.stats["prefills"] > 0
    _equal_trees(p_cap._cache, p_eag._cache, "prefill static cache")
    assert torch.equal(p_cap._logits, p_eag._logits)
    _equal_trees(cap.decodes[0].state, eag.decodes[0].state, "state")
    if cap.kv_arena is not None:
        _equal_trees(cap.kv_arena.kv, eag.kv_arena.kv, "arena",
                     skip_null=True)
        cap.kv_arena.pool.check_invariants(arena=cap.kv_arena)
    summ = cap.placement.hot_loops.summary()
    full, first = summ["prefill.full"], summ["prefill.first"]
    assert full["replays"] > 0 and 0 < full["captures"] <= len(
        full["keys"]), summ
    assert full["eager"] + full["replays"] == p_cap.stats["prefills"]
    assert first["replays"] > 0, summ
    assert first["eager"] + first["replays"] == \
        p_cap.stats["host_fetches"]
    eager = eag.placement.hot_loops.summary()
    assert all(v["captures"] == v["replays"] == 0 for v in eager.values())
    return summ


DEFAULT = dict(n_layers=4, omniattn_sink_tokens=8, omniattn_recent_tokens=24)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_prefill_full_capture_default_pattern(cuda, paged):
    """The default OmniAttn pattern (three compressed layers of four, sink
    8 + recent 24): whole-prompt prefill through the flash-prefill kernel,
    the rings compressed at the true length read on the device, then
    paged or slot-dense decode."""
    cfg = _cfg(**DEFAULT)
    _check_full(cfg, _traffic(cfg.vocab_size, n=9, seed=22, long=70),
                pattern=None, paged_kv=paged)


def test_prefill_full_capture_moe(cuda):
    cfg = reduced_config("qwen2-moe-a2.7b").with_updates(
        compute_dtype="float32", param_dtype="float32")
    _check_full(cfg, _traffic(cfg.vocab_size, n=9, seed=23, long=70),
                enable_placement=False)


def test_prefill_full_capture_mamba2(cuda):
    """Mamba-2 layers prefilled whole from a zero state: the padding mask
    and the convolution rows' gather read the true length on the device."""
    cfg = _cfg("mamba2-130m")
    _check_full(cfg, _traffic(cfg.vocab_size, n=9, seed=24, long=70),
                paged_kv=False)


def test_random_bits_on_the_card_equal_the_cpu(cuda):
    """The draw's integer bits and uniforms are exact on any device: the
    card's equal the CPU's bit for bit at qwen2's vocabulary; the Gumbel
    noise (CUDA's logf against torch's CPU log) within 2 ulp at
    max(|g|, 1)."""
    from repro_torch.core.proxy.params import seed_key
    from repro_torch.serving import prng
    V = 151936
    keys = torch.from_numpy(np.stack(
        [seed_key(s) for s in (0, 5, 901, 1 << 40, -7, 123456789)])
        .astype(np.int64))
    fold = torch.tensor([0, 1, 17, 4400, 151935, 2 ** 31 - 1],
                        dtype=torch.int32)
    want = prng.random_bits32(prng.fold_in(keys, fold), V)
    got_keys = prng.fold_in(keys.to(cuda), fold.to(cuda))
    got = prng.random_bits32(got_keys, V)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(prng.uniform(got).cpu(), prng.uniform(want))
    g, w = prng.gumbel(got_keys, V).cpu(), prng.gumbel(
        prng.fold_in(keys, fold), V)
    ulp = torch.from_numpy(np.spacing(np.maximum(w.abs().numpy(),
                                                 np.float32(1.0))))
    assert ((g - w).abs() <= 2 * ulp).all()


def test_block_topk_select_replayed_equals_eager(cuda):
    """The fused top-k launch (a cluster per slot through
    cudaLaunchKernelEx) captured in a graph: a replay writes the scores,
    compacted tables, lens, counts, mask and stats of an eager launch on
    the same inputs, bit for bit."""
    rng = np.random.default_rng(0)
    B, K, G, h, bs, nb, N = 6, 2, 6, 128, 16, 256, 6 * 256 + 1
    q = torch.from_numpy(rng.standard_normal((B, K, G, h)).astype(
        np.float32)).to(cuda)
    lo = torch.from_numpy(rng.standard_normal((N, K, h)).astype(
        np.float32)).to(cuda)
    hi = lo + torch.from_numpy(rng.random((N, K, h)).astype(
        np.float32)).to(cuda)
    tables = torch.from_numpy(rng.permutation(N - 1)[:B * nb].reshape(
        B, nb).astype(np.int32) + 1).to(cuda)
    lens = torch.tensor([3968, 3970, 1, 17, 4096, 2000], dtype=torch.int32,
                        device=cuda)
    mask = torch.tensor([1, 1, 0, 1, 1, 1], dtype=torch.bool, device=cuda)
    kw = dict(block_size=bs, k_static=64, frac=0.25, sink_blocks=1,
              recent_blocks=2, token_mask=mask)
    want = block_topk_select(q, lo, hi, tables, lens, **kw)
    outs = tuple(torch.empty_like(t) for t in want)

    def fn(key, *static):
        got = block_topk_select(q, lo, hi, tables, lens, **kw)
        for o, g in zip(static, got):
            o.copy_(g)
        return static

    entry = DevicePlacement.of(cuda).hot_loop(fn, name="check.topk")
    for o in outs:
        o.zero_()
    entry((nb,), outs)                      # eager
    for o in outs:
        o.zero_()
    before = launch_counts()
    entry((nb,), outs)                      # capture, then one replay
    entry((nb,), outs)                      # replay
    torch.cuda.synchronize()
    assert entry.captures[(nb,)] == 1 and entry.replays[(nb,)] == 2
    assert count_delta(before, launch_counts()) == {
        "block_topk_scores.launches": 2}
    for o, w in zip(outs, want):
        assert torch.equal(o, w)


def test_failed_capture_raises(cuda):
    """An error inside the capture propagates; the key gets no graph and
    the next call captures again (never an eager fallback)."""
    x = torch.ones(8, device=cuda)
    calls = []

    def fn(key, out):
        calls.append(key)
        if len(calls) == 2:
            raise RuntimeError("boom inside the capture")
        return out.copy_(x * 2)

    entry = DevicePlacement.of(cuda).hot_loop(fn, name="check.fail")
    out = torch.zeros(8, device=cuda)
    entry(("k",), (out,))
    with pytest.raises(RuntimeError, match="boom"):
        entry(("k",), (out,))
    assert ("k",) not in entry.graphs and entry.eager[("k",)] == 1
    entry(("k",), (out,))
    torch.cuda.synchronize()
    assert entry.captures[("k",)] == 1 and entry.eager[("k",)] == 1
    assert torch.equal(out, x * 2)
