"""Kernel-bearing modules of the PyTorch port against the JAX reference.

On the CPU the wrappers run their plain PyTorch versions; those are held
against `repro.kernels.ref` and the Pallas kernels in interpret mode, on
sweep shapes of tests/test_kernels.py (paged: bs {8,16}, G {1,4}, with the
null-block and lens=1 cases; flash_prefill and sink_decode: the reference's
own sweep grids). Tolerances: float32 1e-5 for the paged kernels and 2e-5
for flash/sink (the reference sweep's own; the same math, sums in another
order), bfloat16 2e-2 (one bf16 rounding of the output). The CUDA kernels
themselves are compared with the plain versions on the card in
tests/test_torch_kernels_gpu.py and by `chip_smoke.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels import ref
from repro.kernels.flash_prefill import flash_prefill as j_flash_prefill
from repro.kernels.paged_decode import paged_decode as j_paged_decode
from repro.kernels.paged_prefill import paged_prefill as j_paged_prefill
from repro.kernels.sink_decode import sink_decode as j_sink_decode
from repro.models import attention as j_attn
from repro_torch.kernels import ops
from repro_torch.kernels.flash_prefill import (flash_prefill,
                                               flash_prefill_plain)
from repro_torch.kernels.paged_decode import paged_decode, paged_decode_plain
from repro_torch.kernels.paged_prefill import (paged_prefill,
                                               paged_prefill_plain)
from repro_torch.kernels.sink_decode import sink_decode, sink_decode_plain
from repro_torch.models import attention as t_attn

torch.set_num_threads(2)

# the oracles run jitted, as the engines run them (and 4x faster than eager)
PD_REF = jax.jit(ref.paged_decode_ref)
PP_REF = jax.jit(ref.paged_prefill_ref, static_argnames=("window", "sink"))
J_PP_ATTN = jax.jit(j_attn.paged_prefill_attention)
J_PD_ATTN = jax.jit(j_attn.paged_decode_attention)
J_PP_WRITE = jax.jit(j_attn.paged_prefill_write)
J_PC_WRITE = jax.jit(j_attn.paged_cache_write)
J_SUMMARIES = jax.jit(j_attn.update_block_summaries)
FP_REF = jax.jit(ref.flash_prefill_ref,
                 static_argnames=("causal", "window", "sink"))
SD_REF = jax.jit(ref.sink_decode_ref)

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TOL_DENSE = {"float32": dict(rtol=2e-5, atol=2e-5),
             "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(rng, shape, dtype):
    """Inputs made with numpy, rounded to `dtype` once so both frameworks
    see the same values."""
    x = rng.standard_normal(shape).astype(np.float32)
    return np.asarray(jnp.asarray(x, JDT[dtype]).astype(jnp.float32))


def _both(x, dtype):
    return jnp.asarray(x, JDT[dtype]), torch.tensor(x).to(TDT[dtype])


def _decode_case(bs, nb, G, dtype, seed):
    rng = np.random.default_rng(seed)
    B, K, h, N = 3, 2, 32, 24
    q = _np(rng, (B, K, G, h), dtype)
    kp = _np(rng, (N, K, bs, h), dtype)
    vp = _np(rng, (N, K, bs, h), dtype)
    tables = rng.integers(1, N, (B, nb)).astype(np.int32)
    lens = np.array([1, max(nb * bs // 2 - 3, 1), nb * bs], np.int32)
    return q, kp, vp, tables, lens


@pytest.mark.parametrize("bs,nb", [(8, 6), (16, 4)])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_plain_matches_reference(bs, nb, G, dtype):
    q, kp, vp, tables, lens = _decode_case(bs, nb, G, dtype, bs * nb + G)
    jq, tq = _both(q, dtype)
    jk, tk = _both(kp, dtype)
    jv, tv = _both(vp, dtype)
    want = PD_REF(jq, jk, jv, jnp.asarray(tables), jnp.asarray(lens))
    got = paged_decode(tq, tk, tv, torch.from_numpy(tables),
                       torch.from_numpy(lens))
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])
    if bs == 8 and G == 4:
        pallas = j_paged_decode(jq, jk, jv, jnp.asarray(tables),
                                jnp.asarray(lens), interpret=True)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(pallas, np.float32),
                                   **TOL[dtype])


def test_paged_decode_null_block_never_leaks():
    rng = np.random.default_rng(1)
    B, K, G, h, bs, N = 1, 1, 2, 16, 8, 6
    q = rng.standard_normal((B, K, G, h)).astype(np.float32)
    kp = rng.standard_normal((N, K, bs, h)).astype(np.float32)
    vp = rng.standard_normal((N, K, bs, h)).astype(np.float32)
    kp[0] = 1e4
    vp[0] = 1e4
    tables = np.array([[3, 0, 0]], np.int32)
    lens = np.array([bs], np.int32)
    got = paged_decode_plain(torch.from_numpy(q), torch.from_numpy(kp),
                             torch.from_numpy(vp), torch.from_numpy(tables),
                             torch.from_numpy(lens)).numpy()
    want = ref.sink_decode_ref(jnp.asarray(q), jnp.asarray(kp[[3]]),
                               jnp.asarray(vp[[3]]), jnp.asarray(lens))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    assert np.all(np.isfinite(got))
    # lens = 1 attends exactly the first slot of the first block
    one = paged_decode_plain(torch.from_numpy(q), torch.from_numpy(kp),
                             torch.from_numpy(vp), torch.from_numpy(tables),
                             torch.tensor([1], dtype=torch.int32)).numpy()
    np.testing.assert_allclose(one[0, 0], np.repeat(vp[3, 0, :1], G, 0),
                               rtol=1e-5, atol=1e-5)


def _prefill_case(bs, S, G, dtype, seed):
    rng = np.random.default_rng(seed)
    B, K, h, N, nb = 2, 2, 32, 24, 5
    q = _np(rng, (B, K, S * G, h), dtype)
    kn = _np(rng, (B, K, S, h), dtype)
    vn = _np(rng, (B, K, S, h), dtype)
    kp = _np(rng, (N, K, bs, h), dtype)
    vp = _np(rng, (N, K, bs, h), dtype)
    tables = rng.integers(1, N, (B, nb)).astype(np.int32)
    off = np.array([0, nb * bs // 2 - 3], np.int32)
    cl = np.array([S, max(S - 3, 1)], np.int32)
    return q, kn, vn, kp, vp, tables, off, cl


PREFILL_CASES = [(bs, S, G, dtype, {}) for bs, S in ((8, 8), (16, 8))
                 for G in (1, 4) for dtype in ("float32", "bfloat16")] + [
    (8, 32, 4, "float32", dict(window=24)),
    (16, 8, 4, "float32", dict(window=24, sink=8))]


@pytest.mark.parametrize("bs,S,G,dtype,kw", PREFILL_CASES)
def test_paged_prefill_plain_matches_reference(bs, S, G, dtype, kw):
    q, kn, vn, kp, vp, tables, off, cl = _prefill_case(bs, S, G, dtype,
                                                       bs + S * G)
    jt = [_both(x, dtype) for x in (q, kn, vn, kp, vp)]
    want = PP_REF(*[a for a, _ in jt], jnp.asarray(tables),
                  jnp.asarray(off), jnp.asarray(cl), **kw)
    got = paged_prefill(*[b for _, b in jt], torch.from_numpy(tables),
                        torch.from_numpy(off), torch.from_numpy(cl), **kw)
    got, exp = got.float().numpy(), np.asarray(want, np.float32)
    pallas = None
    if bs == 8 and S == 8 and G == 4:
        pallas = np.asarray(j_paged_prefill(
            *[a for a, _ in jt], jnp.asarray(tables), jnp.asarray(off),
            jnp.asarray(cl), interpret=True, **kw), np.float32)
    # padded chunk rows (token >= chunk_len) are padding on both sides
    for b in range(2):
        real = int(cl[b]) * G
        np.testing.assert_allclose(got[b, :, :real], exp[b, :, :real],
                                   **TOL[dtype])
        if pallas is not None:
            np.testing.assert_allclose(got[b, :, :real],
                                       pallas[b, :, :real], **TOL[dtype])
    assert np.all(np.isfinite(got))


def test_model_layout_paths_and_adapters_match_reference():
    """attention.py's plain paths and the ops adapters (GQA row regroup)
    against the reference's jnp paths, in the model layout."""
    rng = np.random.default_rng(5)
    B, S, H, K, h, bs, N, nb = 1, 8, 4, 2, 16, 8, 12, 4
    q = rng.standard_normal((B, S, H, h)).astype(np.float32)
    kn = rng.standard_normal((B, S, K, h)).astype(np.float32)
    vn = rng.standard_normal((B, S, K, h)).astype(np.float32)
    kp = rng.standard_normal((N, K, bs, h)).astype(np.float32)
    vp = rng.standard_normal((N, K, bs, h)).astype(np.float32)
    tables = np.array([[5, 2, 9, 0]], np.int32)
    off, cl = 13, 6
    J = [jnp.asarray(x) for x in (q, kn, vn, kp, vp, tables)]
    T = [torch.from_numpy(x) for x in (q, kn, vn, kp, vp, tables)]
    want = np.asarray(J_PP_ATTN(*J, off, cl))
    for got in (t_attn.paged_prefill_attention(*T, off, cl),
                ops.attention_paged_prefill_op(*T, off, cl)):
        np.testing.assert_allclose(got.numpy()[:, :cl], want[:, :cl],
                                   rtol=1e-5, atol=1e-5)
    qd = rng.standard_normal((3, H, h)).astype(np.float32)
    tb = np.array([[5, 2, 0, 0], [9, 0, 0, 0], [1, 3, 4, 6]], np.int32)
    lens = np.array([12, 1, 30], np.int32)
    want = np.asarray(J_PD_ATTN(jnp.asarray(qd), J[3], J[4],
                               jnp.asarray(tb), jnp.asarray(lens)))
    for got in (t_attn.paged_decode_attention(
                    torch.from_numpy(qd), T[3], T[4], torch.from_numpy(tb),
                    torch.from_numpy(lens)),
                ops.attention_paged_decode_op(
                    torch.from_numpy(qd), T[3], T[4], torch.from_numpy(tb),
                    torch.from_numpy(lens))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_arena_writes_and_summaries_match_reference():
    rng = np.random.default_rng(9)
    N, K, bs, h = 10, 2, 8, 16
    kp = rng.standard_normal((N, K, bs, h)).astype(np.float32)
    vp = rng.standard_normal((N, K, bs, h)).astype(np.float32)
    kn = rng.standard_normal((1, 12, K, h)).astype(np.float32)
    vn = rng.standard_normal((1, 12, K, h)).astype(np.float32)
    tables = np.array([[4, 7, 2, 0]], np.int32)
    jk, jv = J_PP_WRITE(jnp.asarray(kp), jnp.asarray(vp),
                                        jnp.asarray(kn), jnp.asarray(vn),
                                        jnp.asarray(tables), 5, 9)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    t_attn.paged_prefill_write(tk, tv, torch.from_numpy(kn),
                               torch.from_numpy(vn),
                               torch.from_numpy(tables), 5, 9)
    # block 0 takes the padded rows (duplicate writes, order unspecified)
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(jk)[1:])
    np.testing.assert_array_equal(tv.numpy()[1:], np.asarray(jv)[1:])
    blk = np.array([3, 6, 0], np.int32)
    off = np.array([2, 7, 5], np.int32)
    k1 = rng.standard_normal((3, K, h)).astype(np.float32)
    jk2, _ = J_PC_WRITE(jk, jv, jnp.asarray(k1),
                                      jnp.asarray(k1), jnp.asarray(blk),
                                      jnp.asarray(off))
    t_attn.paged_cache_write(tk, tv, torch.from_numpy(k1),
                             torch.from_numpy(k1), torch.from_numpy(blk),
                             torch.from_numpy(off))
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(jk2)[1:])
    z = np.zeros((N, K, h), np.float32)
    ids = np.array([4, 7, 3, 6, 4], np.int32)
    jmn, jmx, jme = J_SUMMARIES(
        jnp.asarray(z), jnp.asarray(z), jnp.asarray(z), jk2,
        jnp.asarray(ids))
    tz = [torch.zeros(N, K, h) for _ in range(3)]
    tk_j = torch.from_numpy(np.asarray(jk2).copy())
    t_attn.update_block_summaries(*tz, tk_j, torch.from_numpy(ids))
    np.testing.assert_array_equal(tz[0].numpy(), np.asarray(jmn))
    np.testing.assert_array_equal(tz[1].numpy(), np.asarray(jmx))
    np.testing.assert_allclose(tz[2].numpy(), np.asarray(jme), rtol=1e-6,
                               atol=1e-7)


FLASH_KW = [dict(causal=True), dict(causal=False),
            dict(causal=True, window=32),
            dict(causal=True, window=32, sink=8)]


@pytest.mark.parametrize("S", [64, 128, 256])
@pytest.mark.parametrize("h", [32, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", FLASH_KW, ids=["causal", "bidir", "window",
                                              "sink"])
def test_flash_prefill_plain_matches_reference(S, h, dtype, kw):
    """The reference sweep grid (tests/test_kernels.py:20); the Pallas
    kernel in interpret mode joins at S=64 (its cost grows as S²)."""
    rng = np.random.default_rng(S + h)
    BH = 3
    q, k, v = (_np(rng, (BH, S, h), dtype) for _ in range(3))
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    got = flash_prefill(tq, tk, tv, **kw)
    assert got.dtype == TDT[dtype]
    got = got.float().numpy()
    want = np.asarray(FP_REF(jq, jk, jv, **kw), np.float32)
    np.testing.assert_allclose(got, want, **TOL_DENSE[dtype])
    if S == 64:
        pallas = j_flash_prefill(jq, jk, jv, block_q=64, block_k=64,
                                 interpret=True, **kw)
        np.testing.assert_allclose(got, np.asarray(pallas, np.float32),
                                   **TOL_DENSE[dtype])


@pytest.mark.parametrize("kw", FLASH_KW, ids=["causal", "bidir", "window",
                                              "sink"])
def test_flash_prefill_gqa_rows_match_repeated_heads(kw):
    """GQA-native layout: row r of q [N, S·G, h] is token r // G; the same
    as the reference on kv heads repeated G times (what the TPU adapter
    does), with a ragged S that no tile divides."""
    rng = np.random.default_rng(11)
    N, S, G, h = 2, 45, 3, 32
    q = rng.standard_normal((N, S, G, h)).astype(np.float32)
    k = rng.standard_normal((N, S, h)).astype(np.float32)
    v = rng.standard_normal((N, S, h)).astype(np.float32)
    got = flash_prefill_plain(torch.from_numpy(q.reshape(N, S * G, h)),
                              torch.from_numpy(k), torch.from_numpy(v), **kw)
    qh = np.moveaxis(q, 2, 1).reshape(N * G, S, h)
    want = FP_REF(jnp.asarray(qh), jnp.asarray(np.repeat(k, G, 0)),
                  jnp.asarray(np.repeat(v, G, 0)), **kw)
    want = np.moveaxis(np.asarray(want).reshape(N, G, S, h), 1, 2)
    np.testing.assert_allclose(got.numpy().reshape(N, S, G, h), want,
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("W,bw", [(64, 16), (128, 64), (96, 32)])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sink_decode_plain_matches_reference(W, bw, G, dtype):
    """The reference sweep grid (tests/test_kernels.py:38), with the
    occupancies W//3 and W, plus a wrapped ring (t > W) on the plain side
    and the model layout read through a transposed view."""
    rng = np.random.default_rng(W + G)
    B, K, h = 2, 2, 32
    q = _np(rng, (B, K, G, h), dtype)
    kc = _np(rng, (B, K, W, h), dtype)
    vc = _np(rng, (B, K, W, h), dtype)
    t = np.array([W // 3, W], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, kc, vc))
    got = sink_decode(tq, tk, tv, torch.from_numpy(t))
    assert got.dtype == TDT[dtype]
    got = got.float().numpy()
    want = SD_REF(jq, jk, jv, jnp.asarray(t))
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **TOL_DENSE[dtype])
    pallas = j_sink_decode(jq, jk, jv, jnp.asarray(t), block_w=bw,
                           interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32),
                               **TOL_DENSE[dtype])
    # model layout [B, W, K, h] through a view; t past W reads every slot
    km, vm = (x.transpose(1, 2).contiguous().transpose(1, 2)
              for x in (tk, tv))
    wrapped = sink_decode(tq, km, vm,
                          torch.tensor([W + 5, W], dtype=torch.int32))
    full = SD_REF(jq, jk, jv, jnp.asarray([W, W], jnp.int32))
    np.testing.assert_allclose(wrapped.float().numpy(),
                               np.asarray(full, np.float32),
                               **TOL_DENSE[dtype])


def test_sink_decode_single_occupied_slot():
    """t=1 attends exactly slot 0 (tests/test_kernels.py:54)."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((1, 1, 2, 16)).astype(np.float32)
    kc = rng.standard_normal((1, 1, 32, 16)).astype(np.float32)
    vc = rng.standard_normal((1, 1, 32, 16)).astype(np.float32)
    got = sink_decode_plain(torch.from_numpy(q), torch.from_numpy(kc),
                            torch.from_numpy(vc),
                            torch.tensor([1], dtype=torch.int32)).numpy()
    np.testing.assert_allclose(got[0, 0], np.repeat(vc[0, 0, :1], 2, 0),
                               rtol=1e-5, atol=1e-5)
    pallas = j_sink_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                           jnp.array([1]), block_w=8, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-5, atol=1e-5)


def test_dense_adapters_match_reference_ops():
    """ops.attention_prefill_op (GQA-native) and ops.attention_decode_op
    (model-layout caches read through a view) against the reference's ops
    adapters, which run the Pallas kernels in interpret mode on the CPU."""
    rng = np.random.default_rng(4)
    B, S, H, K, h = 1, 40, 4, 2, 32
    q = rng.standard_normal((B, S, H, h)).astype(np.float32)
    k = rng.standard_normal((B, S, K, h)).astype(np.float32)
    v = rng.standard_normal((B, S, K, h)).astype(np.float32)
    for kw in (dict(), dict(window=16, sink=4)):
        want = np.asarray(j_ops.attention_prefill_op(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=8,
            block_k=8, **kw))
        got = ops.attention_prefill_op(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    W = 48
    qd = rng.standard_normal((3, H, h)).astype(np.float32)
    kc = rng.standard_normal((3, W, K, h)).astype(np.float32)
    vc = rng.standard_normal((3, W, K, h)).astype(np.float32)
    t = np.array([1, 20, 60], np.int32)
    want = np.asarray(j_ops.attention_decode_op(
        jnp.asarray(qd), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(t),
        block_w=16))
    got = ops.attention_decode_op(torch.from_numpy(qd), torch.from_numpy(kc),
                                  torch.from_numpy(vc), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        t_attn.decode_attention(torch.from_numpy(qd), torch.from_numpy(kc),
                                torch.from_numpy(vc),
                                torch.from_numpy(t)).numpy(), want,
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("S,true_len", [(16, 9), (32, 21), (64, 33),
                                        (128, 70), (24, None)])
def test_compress_prefill_kv_matches_reference(S, true_len):
    """Ring built from whole-prompt K/V, slot for slot: padded prompts
    (true_len < S) and rings wrapped once or more (sink 8 + recent 24)."""
    rng = np.random.default_rng(S)
    k = rng.standard_normal((1, S, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, S, 2, 16)).astype(np.float32)
    jk, jv = j_attn.compress_prefill_kv(
        jnp.asarray(k), jnp.asarray(v), sink=8, recent=24,
        true_len=None if true_len is None else jnp.int32(true_len))
    tk, tv = t_attn.compress_prefill_kv(torch.from_numpy(k),
                                        torch.from_numpy(v), sink=8,
                                        recent=24, true_len=true_len)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("sink,recent", [(8, 24), (0, 0)])
def test_cache_write_and_ring_slot_match_reference(sink, recent):
    """Per-slot writes into dense caches: ring slots (wrapped and not), and
    on a full cache a write past its end is dropped, as the reference's
    scatter drops it."""
    rng = np.random.default_rng(3)
    B, W, K, h = 4, 32, 2, 8
    kc = rng.standard_normal((B, W, K, h)).astype(np.float32)
    vc = rng.standard_normal((B, W, K, h)).astype(np.float32)
    kn = rng.standard_normal((B, K, h)).astype(np.float32)
    vn = rng.standard_normal((B, K, h)).astype(np.float32)
    t = np.array([3, 31, 57, 100], np.int32)
    jk, jv = j_attn.cache_write(jnp.asarray(kc), jnp.asarray(vc),
                                jnp.asarray(kn), jnp.asarray(vn),
                                jnp.asarray(t), sink=sink, recent=recent)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    t_attn.cache_write(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                       torch.from_numpy(t), sink=sink, recent=recent)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if sink or recent:
        np.testing.assert_array_equal(
            t_attn.ring_slot(torch.from_numpy(t), sink, recent).numpy(),
            np.asarray(j_attn.ring_slot(jnp.asarray(t), sink, recent)))
