"""FaultPlane on the card: chaos under CUDA-graph capture, and the arena
edits of corruption recovery read by captured graphs.

Marked `gpu`: they skip without a CUDA device. The soak runs the reduced
soak server of `tests/test_torch_faults.py` (2 layers, seed-0 weights, two
prefill and two decode instances over one arena) on `cuda`, captured and
with `capture=False`: every chaos run's streams equal its fault-free run's,
and the two modes' fault-free streams equal each other. The arena test
checks that `corrupt_block` and `scrub_block` keep every arena tensor's
storage and that a captured decode step over the arena reads the edited
values: its logits equal an eager step's on the same state. This file
imports neither jax nor the JAX package:

    PYTHONPATH=src python -m pytest --noconftest -o markers=gpu -q tests/test_torch_faults_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.core.proxy import OASConfig, SamplingParams
from repro_torch.serving import (DevicePlacement, FaultConfig, FaultPlane,
                                 Server, ServerConfig)
from repro_torch.serving.faults import corrupt_block
from repro_torch.serving.quant import QuantConfig

pytestmark = pytest.mark.gpu

SOAK = dict(n_prefill=2, n_decode=2, decode_slots=4, max_len=128,
            chunk_tokens=32, prefill_tick_budget=64, kv_blocks=96,
            watchdog_steps=200, oas=OASConfig(defer_window=0.0,
                                              max_retries=10))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs, the CUDA kernels)")
    return torch.device("cuda")


def _cfg():
    return reduced_config("qwen2-1.5b").with_updates(
        compute_dtype="float32", param_dtype="float32", n_layers=2)


def _traffic(vocab):
    """The CPU soak's eight 24-token greedy prompts plus one sampled."""
    rng = np.random.default_rng(42)
    prompts = [tuple(int(t) for t in rng.integers(0, vocab, 24))
               for _ in range(9)]
    params = [SamplingParams(max_tokens=12)] * 8 + [SamplingParams(
        temperature=0.9, top_k=16, top_p=0.9, seed=3, max_tokens=12)]
    return prompts, params


def _soak(cfg, capture, plane=None, quant=None):
    srv = Server(cfg, ServerConfig(**SOAK, quant=quant), pattern=[0, 0],
                 seed=0, placement=DevicePlacement.of("cuda",
                                                      capture=capture),
                 faults=plane)
    prompts, params = _traffic(cfg.vocab_size)
    out = {}
    for o in srv.generate(prompts, params, max_wall_s=600):
        out.setdefault(o.rid, []).extend(o.new_tokens)
    torch.cuda.synchronize()
    assert not srv.proxy.inflight
    done = {r.rid: list(r.output_tokens) for r in srv.metrics.done}
    assert done == out and len(done) == len(prompts)
    pool = srv.kv_arena.pool
    pool.check_invariants(arena=srv.kv_arena)
    assert len(pool.quarantined) == srv.metrics.blocks_quarantined
    assert all(k[0] == "store" for k in pool.per_request)
    for e in srv.decodes:
        assert e.stats["host_fetches"] == e.stats["steps"]
    return srv, [out[r] for r in sorted(out)]


@pytest.mark.parametrize("quant", [False, True], ids=["float32", "int8"])
@pytest.mark.parametrize("capture", [True, False], ids=["captured", "eager"])
def test_chaos_soak_on_the_card(cuda, capture, quant):
    cfg = _cfg()
    q = QuantConfig() if quant else None
    base, ref = _soak(cfg, capture, quant=q)
    if capture:
        summ = base.placement.hot_loops.summary()
        for name in ("decode.step", "prefill.chunk"):
            assert len(summ[name]["replays_each"]) == 2, summ
            assert summ[name]["replays"] > 0, summ
        _, other = _soak(cfg, False, quant=q)
        assert other == ref, "captured and eager fault-free streams differ"
    for seed in (1, 2):
        plane = FaultPlane(FaultConfig(seed=seed, horizon=20))
        _, got = _soak(cfg, capture, plane=plane, quant=q)
        assert sum(plane.injected.values()) > 0
        assert got == ref, f"seed {seed}: chaos streams differ"
        for _, kind, target in plane.fired:
            if kind == "kv_corrupt":
                assert target[1] == (target[0],), target


@pytest.mark.parametrize("quant", [False, True], ids=["float32", "int8"])
def test_captured_step_reads_corruption_and_scrub_in_place(cuda, quant):
    """A captured decode step over the server's arena, replayed after
    `corrupt_block` and after `recover_corruption` (quarantine + scrub),
    gives the logits of an eager step on the same state each time; the
    corruption changes them; no arena tensor moves."""
    cfg = _cfg()
    srv = Server(cfg, ServerConfig(**dict(SOAK, n_prefill=1, n_decode=1),
                                   quant=QuantConfig() if quant else None),
                 pattern=[0, 0], seed=0, device=cuda)
    rng = np.random.default_rng(3)
    srv.run([(tuple(int(t) for t in rng.integers(0, cfg.vocab_size, 70)),
              4) for _ in range(2)], max_wall_s=600)
    arena, eng = srv.kv_arena, srv.decodes[0]
    pool = arena.pool
    live = sorted(pool.refcount)             # the prefix store's blocks
    assert len(live) >= 3
    free = next(b for b in range(1, pool.n_blocks + 1)
                if b not in pool.refcount)
    bs, nb = arena.block_size, 4
    tables = torch.tensor([live[:nb - 1] + [free]], dtype=torch.int32,
                          device=cuda)
    # mid-block in an unmapped block: the step's own write lands the same
    # bytes every call, in a block no tabled prefix shares, and opens or
    # seals no other block
    pos = torch.tensor([[nb * bs - bs // 2]], dtype=torch.int32, device=cuda)
    tok = torch.tensor([[7]], dtype=torch.int32, device=cuda)
    out = torch.empty((1, cfg.vocab_size), dtype=torch.float32, device=cuda)

    def step(key, out):
        logits = srv.lm.decode(srv.params, eng._full_cache(), tok, pos,
                               block_tables=tables)[1]
        return out.copy_(logits)

    entry = srv.placement.hot_loop(step, name="check.logits")
    key = (nb, True)

    def replay_and_eager():
        entry(key, (out,))
        torch.cuda.synchronize()
        replayed = out.clone()
        eager = step(key, torch.empty_like(out))
        torch.cuda.synchronize()
        return replayed, eager

    entry(key, (out,))                      # eager
    entry(key, (out,))                      # capture, then one replay
    assert entry.captures[key] == 1
    ptrs = [t.data_ptr() for e in arena.kv for t in e.values()]
    r0, e0 = replay_and_eager()
    assert torch.equal(r0, e0)
    b = live[1]
    corrupt_block(arena, b, offset=0.75)
    r1, e1 = replay_and_eager()
    assert torch.equal(r1, e1) and not torch.equal(r1, r0)
    assert srv.recover_corruption() == [b]
    assert all(not t[b].any() for e in arena.kv for t in e.values())
    r2, e2 = replay_and_eager()
    assert torch.equal(r2, e2)
    assert [t.data_ptr() for e in arena.kv for t in e.values()] == ptrs
    assert entry.replays[key] == 4
    arena.pool.check_invariants(arena=arena)
