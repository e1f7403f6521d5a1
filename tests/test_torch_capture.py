"""The port's hot-loop choke point on the CPU: `DevicePlacement.hot_loop`
entries (the counterpart of the reference's `donate_jit` /
`HotLoopRegistry`) count their calls per key and hold their static inputs
to the storage of each key's first call; the decode engine's table buffers
and slot state keep their storage across steps and bucket changes, with
the new contents visible; a migration rewrites the MoE tables every engine
holds in place; the launch-counter arithmetic the entries apply at each
replay; the prefill engine's "prefill.chunk" entry, one key per (chunk
bucket, layout) shared by every task and offset, its static buffers kept
across chunks and tasks; its "prefill.full" entry, one key per prompt
bucket over one static cache that each task clones; its "prefill.first"
entry, keyed by the batch padded to a power of two and all_greedy.
Capture itself needs a card (tests/test_torch_capture_gpu.py);
`capture=True` on the CPU raises.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest tests/test_torch_capture.py -q
"""
import importlib
import pkgutil

import numpy as np
import pytest
import torch

import repro_torch.kernels as kpkg
from repro_torch.configs import reduced_config
from repro_torch.core.placement.migration import MigrationPlan
from repro_torch.core.proxy import OASConfig, SamplingParams
from repro_torch.kernels import _common
from repro_torch.serving import DevicePlacement, Server, ServerConfig
from repro_torch.serving.spec import SpecConfig

torch.set_num_threads(2)

SCFG = dict(n_prefill=1, n_decode=1, decode_slots=3, max_len=96,
            chunk_tokens=16, prefill_tick_budget=32, kv_blocks=40,
            kv_block_size=8, oas=OASConfig(defer_window=0.0))


def _cfg(arch="qwen2-1.5b"):
    return reduced_config(arch).with_updates(
        compute_dtype="float32", param_dtype="float32", n_layers=2)


def _server(cfg=None, **kw):
    cfg = cfg or _cfg()
    return Server(cfg, ServerConfig(**dict(SCFG, **kw)),
                  pattern=[0] * cfg.n_layers, seed=0, device="cpu")


# ---- the placement and its entries ------------------------------------
def test_capture_is_off_on_the_cpu_and_cannot_be_asked_for():
    pl = DevicePlacement.of("cpu")
    assert pl.capture is False
    assert DevicePlacement.of(pl) is pl
    assert DevicePlacement.of(pl, capture=False) is pl
    with pytest.raises(ValueError, match="CUDA"):
        DevicePlacement.of("cpu", capture=True)
    with pytest.raises(ValueError, match="CUDA"):
        DevicePlacement(torch.device("cpu"), capture=True)
    with pytest.raises(ValueError, match="capture"):
        DevicePlacement.of(pl, capture=True)
    assert pl.graph_pool_bytes() == 0


def test_entry_counts_calls_per_key_and_holds_static_inputs():
    pl = DevicePlacement.of("cpu")
    seen = []

    def fn(key, x, out):
        seen.append(key)
        return out.copy_(x * key[0])

    entry = pl.hot_loop(fn, name="t.step")
    x, out = torch.arange(4.0), torch.zeros(4)
    for key in [(2, True), (2, True), (3, False), (2, True)]:
        res = entry(key, (x, out))
        assert res is out and torch.equal(out, x * key[0])
    assert seen == [(2, True), (2, True), (3, False), (2, True)]
    assert entry.keys == [(2, True), (3, False)]
    assert entry.eager == {(2, True): 3, (3, False): 1}
    assert not entry.captures and not entry.replays and not entry.graphs
    other = torch.zeros(4)
    with pytest.raises(RuntimeError, match="static inputs"):
        entry((2, True), (x, other))
    with pytest.raises(RuntimeError, match="static inputs"):
        entry((3, False), (x, torch.zeros(5)))
    assert pl.hot_loops.names() == ["t.step"]
    assert pl.hot_loops.called() == [entry]
    assert pl.hot_loops.summary() == {"t.step": {
        "keys": [(2, True), (3, False)], "eager": 4, "captures": 0,
        "replays": 0, "replays_each": [0]}}


# ---- launch counters ---------------------------------------------------
def test_count_delta_arithmetic():
    before = {"a.launches": 3, "b.launches": 7, "c.launches": 0}
    after = {"a.launches": 5, "b.launches": 7, "c.launches": 28}
    assert _common.count_delta(before, after) == {"a.launches": 2,
                                                  "c.launches": 28}
    assert _common.count_delta(after, after) == {}
    snap = _common.launch_counts()
    delta = {"paged_decode.launches": 28, "paged_decode.int8_launches": 28,
             "moe_gmm.launches": 72}
    try:
        _common.add_launch_counts(delta)
        now = _common.launch_counts()
        assert _common.count_delta(snap, now) == delta
        # a capture's own increments taken back, then three replays
        _common.add_launch_counts(delta, sign=-1)
        assert _common.launch_counts() == snap
        for _ in range(3):
            _common.add_launch_counts(delta)
        assert _common.count_delta(snap, _common.launch_counts()) == {
            k: 3 * v for k, v in delta.items()}
    finally:
        _common.add_launch_counts(_common.count_delta(
            _common.launch_counts(), snap))
    assert _common.launch_counts() == snap


def test_every_launch_counter_is_listed():
    """Each `launches` / `int8_launches` attribute of a kernel wrapper is in
    LAUNCH_COUNTERS, so a replay advances it."""
    listed = {(m, n, a) for m, n, a in _common.LAUNCH_COUNTERS}
    found = set()
    for info in pkgutil.iter_modules(kpkg.__path__):
        mod = importlib.import_module(f"repro_torch.kernels.{info.name}")
        for name, obj in vars(mod).items():
            if callable(obj) and getattr(obj, "__module__", None) == \
                    mod.__name__:
                for attr in ("launches", "int8_launches"):
                    if hasattr(obj, attr):
                        found.add((info.name, name, attr))
    assert found == listed
    assert set(_common.launch_counts()) == {f"{n}.{a}"
                                            for _, n, a in listed}


# ---- the decode engine's static buffers ---------------------------------
def _drive(srv, prompts, params, on_step=None):
    for p, sp in zip(prompts, params):
        srv.add_request(p, sp)
    out = {}
    while srv.proxy.inflight:
        for o in srv.step():
            out.setdefault(o.rid, []).extend(o.new_tokens)
        if on_step is not None:
            on_step()
    return [out[r] for r in sorted(out)]


def test_decode_buffers_keep_storage_across_steps_and_buckets():
    """A 60-token prompt decoding 12 tokens crosses 64 (8 blocks of 8): the
    table bucket goes 8 → 12 (16 capped at max_len's 12 blocks); once it
    finishes the short requests take the bucket back to 8. Each bucket's
    table buffer and the slot state keep their storage, and after each
    step's refresh the buffer holds the host tables. Keys: (bucket,
    all_greedy)."""
    cfg = _cfg()
    srv = _server(cfg)
    eng = srv.decodes[0]
    rng = np.random.default_rng(3)
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab_size, n))
               for n in (60, 10, 12, 9)]
    params = [SamplingParams(max_tokens=12), SamplingParams(max_tokens=20),
              SamplingParams(max_tokens=20),
              SamplingParams(temperature=0.8, seed=5, max_tokens=6)]
    st_ptrs = {k: v.data_ptr() for k, v in eng.state.items()}
    next_ptr = eng._next.data_ptr()
    trace = []

    def check():
        if eng._tbl_bucket is None:
            return
        nb = eng._tbl_bucket
        buf = eng._tbl_bufs[nb][0]
        assert eng._tbl_dev is buf
        trace.append((nb, buf.data_ptr()))
        # the step's refresh wrote the host tables into the buffer
        if not eng._tbl_dirty:
            np.testing.assert_array_equal(buf.numpy(), eng.tables_h[:, :nb])

    streams = _drive(srv, prompts, params, on_step=check)
    assert [len(s) for s in streams] == [12, 20, 20, 6]
    assert {k: v.data_ptr() for k, v in eng.state.items()} == st_ptrs
    assert eng._next.data_ptr() == next_ptr
    buckets = [nb for nb, _ in trace]
    assert eng.max_blocks == 12
    assert 12 in buckets and buckets[-1] == 8
    i12 = buckets.index(12)
    assert 8 in buckets[:i12] and 8 in buckets[i12:]     # a bucket return
    ptr_of = {}
    for nb, ptr in trace:
        assert ptr_of.setdefault(nb, ptr) == ptr
    assert set(eng._tbl_bufs) == {8, 12}
    summ = srv.placement.hot_loops.summary()
    assert set(summ) == {"decode.step", "prefill.chunk", "prefill.first"}
    s = summ["decode.step"]
    assert {(8, True), (8, False), (12, True)} <= set(s["keys"])
    assert all(k[0] in (8, 12) for k in s["keys"])
    assert s["eager"] == eng.stats["steps"] == eng.stats["host_fetches"]
    assert s["captures"] == s["replays"] == 0


def test_slot_dense_step_key_has_no_bucket():
    cfg = _cfg()
    srv = _server(cfg, paged_kv=False, chunked_prefill=False)
    rng = np.random.default_rng(4)
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab_size, 9))
               for _ in range(2)]
    _drive(srv, prompts, [SamplingParams(max_tokens=4)] * 2)
    s = srv.placement.hot_loops.summary()["decode.step"]
    assert s["keys"] == [(None, True)]
    assert s["eager"] == srv.decodes[0].stats["steps"]


def test_verify_entry_serves_the_speculative_steps():
    """With speculation the verify window goes through "decode.verify" and
    the single-token fallback through "decode.step"; the draft buffers and
    the packed output keep their storage."""
    cfg = _cfg()
    srv = _server(cfg, spec=SpecConfig(k=3))
    eng = srv.decodes[0]
    ptrs = [t.data_ptr() for t in (eng._drafts[0], eng._dlen[0],
                                   eng._packed)]
    rng = np.random.default_rng(5)
    phrase = tuple(int(t) for t in rng.integers(0, cfg.vocab_size, 6))
    prompts = [phrase * 5, phrase[::-1] * 5]
    _drive(srv, prompts, [SamplingParams(max_tokens=16)] * 2)
    srv.drain_decode_stats()
    summ = srv.placement.hot_loops.summary()
    ds = eng.stats
    assert summ["decode.verify"]["eager"] == ds["spec_verifies"] > 0
    assert summ["decode.step"]["eager"] == ds["steps"] - ds["spec_verifies"]
    assert [t.data_ptr() for t in (eng._drafts[0], eng._dlen[0],
                                   eng._packed)] == ptrs


# ---- migration ---------------------------------------------------------
def test_apply_migration_rewrites_tables_in_place():
    cfg = reduced_config("qwen2-moe-a2.7b").with_updates(
        compute_dtype="float32", param_dtype="float32")
    srv = _server(cfg, enable_placement=False)
    tables = srv.tables
    ids = {k: (id(t), t.data_ptr(), tuple(t.shape)) for k, t in
           tables.items()}
    old = {k: t.clone() for k, t in tables.items()}
    se = old["slot_expert"].numpy()
    new = se[:, ::-1].copy()
    srv._apply_migration(MigrationPlan(se, new, tuple(
        (0, i, int(new[0, i])) for i in range(new.shape[1])), new.shape[1]))
    for eng in srv.prefills + srv.decodes:
        assert eng.tables is tables
    assert srv.tables is tables
    assert {k: (id(t), t.data_ptr(), tuple(t.shape)) for k, t in
            tables.items()} == ids
    np.testing.assert_array_equal(tables["slot_expert"].numpy(), new)
    assert not torch.equal(tables["rep_slot"], old["rep_slot"])
    # the first replica of each expert now points at its reversed slot
    s = new.shape[1]
    for e in range(cfg.moe.n_experts):
        j = int(old["rep_slot"][e, 0])
        assert int(tables["rep_slot"][e, 0]) == s - 1 - j


# ---- the prefill engine's chunk entry ----------------------------------
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_prefill_chunk_entry_keys_and_static_buffers(paged):
    """Every chunk goes through "prefill.chunk", keyed (bucket S, layout):
    prompts of 40, 20 and 33 tokens in chunks of 16 meet the keys (16,
    layout) and (8, layout) only, chunks at other offsets and of other
    tasks reusing them. Each call finds the bucket's token buffer, the
    table row, the (off, chunk_len) buffer, the logits and the private
    leaves at their first storage, holding that chunk's tokens, offset and
    length (and, paged, the task's blocks)."""
    cfg = _cfg()
    srv = _server(cfg, paged_kv=paged)
    eng = srv.prefills[0]
    entry = eng._chunk_step
    assert eng.chunked and eng.paged == paged and eng.layout == (
        "paged" if paged else "dense")
    assert "prefill.chunk" in srv.placement.hot_loops.names()
    rng = np.random.default_rng(6)
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab_size, n))
               for n in (40, 20, 33)]
    calls, fn = [], entry.fn

    def watched(key, tokens, row, ctl, logits, *leaves):
        off, cl = (int(x) for x in ctl)
        S = key[0]
        assert tokens.shape == (1, S) and cl <= S
        got = tuple(int(t) for t in tokens[0, :cl])
        owners = [i for i, p in enumerate(prompts) if p[off:off + cl] == got]
        assert len(owners) == 1
        assert not tokens[0, cl:].any()
        if paged:
            n_real = int((row[0] != 0).sum())
            assert n_real == -(-(off + cl) // eng.block_size)
        else:
            assert row is None
        calls.append((key, (owners[0], off), tokens.data_ptr(),
                      tuple(t.data_ptr() for t in (ctl, logits) + leaves
                            + ((row,) if paged else ()))))
        return fn(key, tokens, row, ctl, logits, *leaves)

    entry.fn = watched
    streams = _drive(srv, prompts, [SamplingParams(max_tokens=3)] * 3)
    assert [len(s) for s in streams] == [3, 3, 3]
    layout = eng.layout
    assert sorted(entry.keys) == [(8, layout), (16, layout)]
    assert len(calls) == eng.stats["chunks"] >= 3 + 2 + 3
    assert {c[3] for c in calls} == {calls[0][3]}
    tok_ptr = {}
    for key, _, ptr, _ in calls:
        assert tok_ptr.setdefault(key, ptr) == ptr
    at16 = [where for key, where, _, _ in calls if key[0] == 16]
    assert len({task for task, _ in at16}) > 1      # tasks share a key
    assert len({off for _, off in at16}) > 1        # so do offsets
    assert entry.eager == {k: n for k, n in
                           ((k, sum(c[0] == k for c in calls))
                            for k in entry.keys)}
    summ = srv.placement.hot_loops.summary()["prefill.chunk"]
    assert summ["captures"] == summ["replays"] == 0
    # the logits each task kept are clones, not the static buffer
    assert srv.prefills[0]._logits.data_ptr() == calls[0][3][1]
    if paged:
        srv.kv_arena.pool.check_invariants(arena=srv.kv_arena)


# ---- the prefill engine's whole-prompt and first-token entries -----------
def test_prefill_full_entry_keys_and_static_buffers():
    """Whole-prompt prefill runs through "prefill.full", keyed by the
    prompt bucket S = min(pow2 bucket >= 8, max_len): prompts of 40, 20,
    9, 5 and 90 tokens meet the keys 64, 32, 16, 8 and 96. Each call finds
    the bucket's token buffer, the true length, the logits and the static
    cache's leaves at their first storage (one cache for every bucket),
    holding the prompt's tokens, zeros past them, and its length. Each
    task keeps clones that alias nothing static and equal one eager
    `LM.prefill` of its padded prompt."""
    from repro_torch.serving.prefill import PrefillTask
    cfg = _cfg()
    srv = _server(cfg, chunked_prefill=False)
    eng = srv.prefills[0]
    entry = eng._full_step
    assert not eng.chunked and "prefill.full" in srv.placement.hot_loops.names()
    rng = np.random.default_rng(8)
    lens = (40, 20, 9, 5, 90)
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab_size, n))
               for n in lens]
    calls, fn = [], entry.fn

    def watched(key, tokens, ctl, logits, *leaves):
        L = int(ctl[0])
        assert tokens.shape == (1, key) and L <= key
        assert tuple(int(t) for t in tokens[0, :L]) in prompts
        assert not tokens[0, L:].any()
        calls.append((key, L, tokens.data_ptr(),
                      tuple(t.data_ptr() for t in (ctl, logits) + leaves)))
        return fn(key, tokens, ctl, logits, *leaves)

    kept, run_full = [], eng._run_full

    def recorded(task: PrefillTask) -> int:
        n = run_full(task)
        kept.append((task.prompt, task.cache, task.logits))
        return n

    entry.fn, eng._run_full = watched, recorded
    streams = _drive(srv, prompts, [SamplingParams(max_tokens=3)] * 5)
    assert [len(s) for s in streams] == [3] * 5
    assert sorted(entry.keys) == [8, 16, 32, 64, 96]
    assert sorted(c[:2] for c in calls) == [(8, 5), (16, 9), (32, 20),
                                            (64, 40), (96, 90)]
    assert {c[3] for c in calls} == {calls[0][3]}
    assert len({c[2] for c in calls}) == 1          # views of one buffer
    assert entry.eager == {k: 1 for k in entry.keys}
    static = {t.data_ptr() for t in eng._leaves + (eng._logits,)}
    for prompt, cache, logits in kept:
        L = len(prompt)
        S = min(1 << max(L - 1, 7).bit_length(), 96)
        toks = torch.tensor([list(prompt) + [0] * (S - L)],
                            dtype=torch.int32)
        want, wl, _ = srv.lm.prefill(srv.params, toks, max_len=96,
                                     true_len=L, tables=srv.tables)
        assert cache["pos"] == L and torch.equal(logits, wl)
        assert logits.data_ptr() not in static
        for e, w in zip(cache["layers"], want["layers"]):
            for name, x in e.items():
                assert x.data_ptr() not in static
                assert torch.equal(x, w[name]), name
    summ = srv.placement.hot_loops.summary()["prefill.full"]
    assert summ["captures"] == summ["replays"] == 0


def test_prefill_first_entry_pads_to_a_power_of_two():
    """First tokens go through "prefill.first", keyed (npad, all_greedy):
    batches of 1, 3, 5, 2 and 3 rows run at npad 1, 4, 8, 2 and 4, the
    padding repeating the last row (its logits and parameters), and the
    padded rows dropped. The tokens equal `sample_tokens` on the unpadded
    rows; each call is one host fetch and keeps its npad's buffers."""
    from repro_torch.core.proxy.params import device_row
    from repro_torch.serving.sampling import sample_tokens
    cfg = _cfg()
    srv = _server(cfg)
    eng = srv.prefills[0]
    entry = eng._first_step
    V = cfg.vocab_size
    rng = np.random.default_rng(9)
    logits = [torch.from_numpy(rng.standard_normal((1, V))
                               .astype(np.float32) * 3) for _ in range(5)]
    params = [SamplingParams(max_tokens=2) if i in (0, 3) else
              SamplingParams(temperature=0.7 + 0.2 * i, top_k=(0, 20)[i % 2],
                             top_p=0.9, seed=40 + i, max_tokens=2)
              for i in range(5)]
    rids, folds = [10, 11, 12, 13, 14], [17, 9, 33, 5, 60]
    calls, fn = [], entry.fn

    def watched(key, up, lg, out):
        npad, _ = key
        u = up.view(6, npad)
        calls.append((key, tuple(t.data_ptr() for t in (up, lg, out)),
                      lg.clone(), u.clone()))
        return fn(key, up, lg, out)

    entry.fn = watched
    for n in (1, 3, 5, 2, 3):
        before = eng.stats["host_fetches"]
        got = eng.sample_first(logits[:n], params[:n], rids[:n], folds[:n])
        assert eng.stats["host_fetches"] == before + 1
        rows = [device_row(p, r) for p, r in zip(params[:n], rids[:n])]
        want = sample_tokens(
            torch.cat(logits[:n]),
            torch.tensor([r[0] for r in rows], dtype=torch.float32),
            torch.tensor([r[1] for r in rows], dtype=torch.int32),
            torch.tensor([r[2] for r in rows], dtype=torch.float32),
            torch.from_numpy(np.stack([r[3] for r in rows])
                             .astype(np.int64)),
            torch.tensor(folds[:n], dtype=torch.int32),
            all_greedy=all(r[0] <= 0 for r in rows))
        np.testing.assert_array_equal(got, want.numpy())
        key, _, lg, u = calls[-1]
        npad = key[0]
        assert key == (npad, n == 1) and npad == 1 << (n - 1).bit_length()
        for i in range(npad):
            assert torch.equal(lg[i], logits[min(i, n - 1)][0])
            j = min(i, n - 1)
            assert int(u[5, i]) == folds[j] and int(u[1, i]) == rows[j][1]
            assert float(u[0, i].view(torch.float32)) == np.float32(
                rows[j][0])
            assert (u[3:5, i].numpy().view(np.uint32) == rows[j][3]).all()
    assert sorted(entry.keys) == [(1, True), (2, False), (4, False),
                                  (8, False)]
    assert entry.eager[(4, False)] == 2
    ptrs = [c[1] for c in calls if c[0] == (4, False)]
    assert ptrs[0] == ptrs[1]
