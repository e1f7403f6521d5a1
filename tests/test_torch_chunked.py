"""Chunked prefill over ring layers and dense KV in the PyTorch port,
against the JAX reference.

`prefill_resume_attention` (the reference's jnp continuation attention; no
TPU kernel) on the same numpy-seeded inputs: linear and ring caches, the
sliding-window and sink+window masks, a padded chunk and a padded chunk
running past a linear cache. Real rows agree within 1e-5 (float32) and the
caches the chunk is scattered into are equal exactly. Then the prefill
engine: a paged chunked prefill of the mixed stack (full, sliding-window
and compressed layers under prefill_sparse), handed off zero-copy, fills
the decode slot's ring block runs with the reference's chunked ring cache,
and decode from there follows the reference's decode over its dense cache.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest tests/test_torch_chunked.py -q
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config
from repro.configs.base import OmniAttnConfig
from repro.distributed.ctx import local_mesh_ctx
from repro.models import LM
from repro.models import attention as jattn
from repro.models import stack as jstack
from repro_torch import bridge
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.configs.base import OmniAttnConfig as TOmniAttnConfig
from repro_torch.models import attention as tattn
from repro_torch.models.lm import LM as TLM
from repro_torch.serving import DecodeEngine, KVArena, PrefillEngine
from repro_torch.serving.arena import BlockHandoff, blocks_to_dense_kv

torch.set_num_threads(2)

# (W, off, S, chunk_len, sink, recent, mask_window, mask_sink)
ATTN_CASES = {
    "linear": (64, 20, 16, 16, 0, 0, 0, 0),
    "ring_wrap": (32, 45, 16, 16, 8, 24, 24, 8),
    "window": (16, 30, 16, 16, 0, 16, 16, 0),
    "ring_padded": (32, 50, 16, 9, 8, 24, 24, 8),
    "linear_padded_past_end": (64, 52, 16, 10, 0, 0, 0, 0),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_prefill_resume_attention_matches_reference(case):
    W, off, S, cl, sink, recent, mw, ms = ATTN_CASES[case]
    B, H, K, h = 1, 4, 2, 32
    rng = np.random.default_rng(len(case))

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    q, k, v = rnd(B, S, H, h), rnd(B, S, K, h), rnd(B, S, K, h)
    kc, vc = rnd(B, W, K, h), rnd(B, W, K, h)
    pos = np.arange(off, off + S, dtype=np.int32)
    jout, jk, jv = jattn.prefill_resume_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(pos), chunk_len=jnp.int32(cl),
        sink=sink, recent=recent, mask_window=mw, mask_sink=ms)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tout = tattn.prefill_resume_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tk,
        tv, torch.from_numpy(pos), chunk_len=torch.tensor(cl), sink=sink,
        recent=recent, mask_window=mw, mask_sink=ms)
    np.testing.assert_allclose(tout[:, :cl].numpy(),
                               np.asarray(jout)[:, :cl], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the resident map the mask reads
    jt, jr = jattn.resident_token_positions(W, jnp.int32(off), sink=sink,
                                            recent=recent)
    tt, tr = tattn.resident_token_positions(W, torch.tensor(off), sink=sink,
                                            recent=recent)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


# ----------------------------------------------------------------------
MAX_LEN, BS = 128, 8
MIXED = dict(compute_dtype="float32", param_dtype="float32", n_layers=4,
             local_per_global=1, local_window=16, prefill_sparse=True)


def test_handoff_fills_ring_runs_and_decode_follows_reference():
    """A 70-token prompt (past the 32-slot sink+recent ring and the
    16-slot window) in 16-token chunks through the port's paged
    PrefillEngine, admitted through its BlockHandoff into slot 1 of a
    paged DecodeEngine: the slot's ring block runs hold the reference's
    chunked ring caches, and four decode steps give the reference's
    logits over its dense cache."""
    cfg = reduced_config("qwen2-1.5b").with_updates(
        **MIXED, omniattn=OmniAttnConfig(sink_tokens=8, recent_tokens=24))
    tcfg = t_reduced_config("qwen2-1.5b").with_updates(
        **MIXED, omniattn=TOmniAttnConfig(sink_tokens=8, recent_tokens=24))
    pattern = [0, 0, 0, 1]
    lm = LM.build(cfg, local_mesh_ctx(), pattern=pattern)
    params = lm.init(jax.random.PRNGKey(1))
    tlm = TLM.build(tcfg, pattern=pattern, device="cpu")
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       tcfg, tlm.plan, device="cpu")
    rng = np.random.default_rng(5)
    prompt = tuple(int(t) for t in rng.integers(0, cfg.vocab_size, 70))

    # the reference: the same chunks over its dense B=1 cache
    jcache = jstack.alloc_cache(cfg, local_mesh_ctx(), lm.plan, 1, MAX_LEN)
    jresume = jax.jit(lambda p, t, c, cl: lm.prefill_resume(
        p, {"tokens": t}, c, max_len=MAX_LEN, chunk_len=cl)[:2])
    cur = 0
    while cur < len(prompt):
        cl = min(16, len(prompt) - cur)
        S = max(8, 1 << (cl - 1).bit_length())
        chunk = list(prompt[cur:cur + cl]) + [0] * (S - cl)
        jcache, jl = jresume(params, jnp.asarray([chunk], jnp.int32), jcache,
                             jnp.int32(cl))
        cur += cl

    arena = KVArena.build(tlm, 2 * (MAX_LEN // BS) + 4, BS)
    pe = PrefillEngine(tlm, tparams, MAX_LEN, arena=arena, chunk_tokens=16)
    de = DecodeEngine(tlm, tparams, 3, MAX_LEN, arena=arena)
    assert pe.chunked and pe.paged
    pe.start(0, prompt)
    recs = []
    while not recs:
        recs = pe.step()
    (rec,) = recs
    assert isinstance(rec.cache, BlockHandoff)
    assert pe.stats["chunks"] == 5
    assert rec.first_token == int(np.argmax(np.asarray(jl)[0]))
    de.free = [0, 2, 1]                     # admit into slot 1
    assert de.admit_batch([(0, rec.cache, rec.first_token, len(prompt), 0,
                            prompt)]) == {0: True}
    slot = de.rid_slot[0]
    assert slot == 1
    jlayers = [{k: np.asarray(x)[r] for k, x in jcache["period"][i].items()}
               for r in range(lm.plan.n_rep)
               for i in range(len(lm.plan.period))] + [
        {k: np.asarray(x) for k, x in e.items()} for e in jcache["rem"]]
    n_ring = 0
    for spec, priv, jl_ in zip(tlm.plan.all_specs(), de.cache["layers"],
                               jlayers):
        if priv is None:
            continue
        b0, bpw, W = de._ring_run(spec, slot)
        for name in ("k", "v"):
            got = blocks_to_dense_kv(priv[name][b0:b0 + bpw], W)
            np.testing.assert_allclose(got.numpy(), jl_[name][0], rtol=1e-5,
                                       atol=1e-5)
        n_ring += 1
    assert n_ring == 3

    jdecode = jax.jit(lambda p, c, t, pos: lm.decode(p, c, t, pos)[:2])
    tok, pos = rec.first_token, len(prompt)
    for _ in range(4):
        jcache, jl = jdecode(params, jcache, jnp.asarray([[tok]], jnp.int32),
                             jnp.asarray([[pos]], jnp.int32))
        de._refresh_tables()
        _, tl, _ = tlm.decode(tparams, de._full_cache(),
                              de.state["tok"][:, None],
                              de.state["pos"][:, None],
                              block_tables=de._tbl_dev)
        np.testing.assert_allclose(tl[slot].numpy(), np.asarray(jl)[0],
                                   rtol=2e-3, atol=2e-3)
        tok = int(np.argmax(np.asarray(jl)[0]))
        de.state["tok"][slot] = tok
        de.state["pos"][slot] = pos + 1
        de.tokens_h[slot] = pos + 2
        de.pool.extend(0, pos + 1, pos + 2)
        de.tables_h[slot, :len(de.pool.owned(0))] = de.pool.owned(0)
        de._tbl_dirty = True
        pos += 1
    de.pool.check_invariants(arena=arena)
