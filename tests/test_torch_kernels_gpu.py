"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: they skip without a CUDA device (the kernels have no CPU
mode). This file imports neither jax nor the JAX package, so it also runs
on a GPU machine without them:

    PYTHONPATH=src python -m pytest --noconftest -o markers=gpu -q tests/test_torch_kernels_gpu.py

Tolerances: float32 1e-4 for the paged kernels (spec_verify among them;
paged_prefill and spec_verify run 3xTF32 tensor-core products)
and 2e-5 for flash_prefill and sink_decode (the same math, sums in another
order), bfloat16 2e-2 (one bf16 rounding of the output); block_topk scores
are float32 in both dtypes, 1e-5 relative and 1e-4 absolute (sums of h
products in another order), with NEG_INF entries equal exactly, and the
fused selection's tables, lens, counts and mask equal `select_kv_blocks`
on the launch's own scores exactly (integer work); moe_gmm
float32 1e-4 over weights of the model's scale (std 0.02), bfloat16 2e-2,
with rows past n_valid exactly zero. The int8 paths (QuantPlane) take the
float tolerances: the kernel and the plain version dequantize each element
with the same single float32 product, so only the sums' order differs.
Their arenas are written by the port's own int8 write path over stale
sealed blocks: sealed blocks, unsealed tails and blocks unsealed on open.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.block_topk import (
    TOPK_NB_MAX, block_topk_scores, block_topk_scores_plain,
    block_topk_select, block_topk_select_scores,
    block_topk_select_scores_plain, select_kv_blocks)
from repro_torch.kernels.flash_prefill import (flash_prefill,
                                               flash_prefill_plain)
from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_plain
from repro_torch.kernels.paged_decode import paged_decode, paged_decode_plain
from repro_torch.kernels.paged_prefill import (paged_prefill,
                                               paged_prefill_plain)
from repro_torch.kernels.sink_decode import sink_decode, sink_decode_plain
from repro_torch.kernels.spec_verify import spec_verify, spec_verify_plain
from repro_torch.models import attention as attn_mod

torch.set_num_threads(2)

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
TOL_DENSE = {torch.float32: dict(rtol=2e-5, atol=2e-5),
             torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _rand(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(dev, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,nb,G,h", [(8, 6, 1, 32), (16, 4, 4, 64),
                                       (16, 32, 6, 128)])
def test_paged_decode_kernel_matches_plain(cuda, dtype, bs, nb, G, h):
    rng = np.random.default_rng(bs + G + h)
    B, K, N = 3, 2, 3 * nb + 1
    q = _rand(rng, (B, K, G, h), dtype, cuda)
    kp = _rand(rng, (N, K, bs, h), dtype, cuda)
    vp = _rand(rng, (N, K, bs, h), dtype, cuda)
    kp[0] = 1e4                                   # poisoned null block
    vp[0] = 1e4
    tables = torch.from_numpy(rng.permutation(np.arange(1, N))[:B * nb]
                              .reshape(B, nb).astype(np.int32)).to(cuda)
    tables[0, 1:] = 0                             # slot 0: one block only
    lens = torch.tensor([1, nb * bs // 2 + 1, nb * bs], dtype=torch.int32,
                        device=cuda)
    n0 = paged_decode.launches
    got = paged_decode(q, kp, vp, tables, lens)
    assert paged_decode.launches == n0 + 1 and got.dtype == dtype
    torch.cuda.synchronize()
    want = paged_decode_plain(q, kp, vp, tables, lens)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,S,G,h,kw", [(8, 8, 1, 32, {}),
                                         (8, 32, 4, 32, dict(window=24)),
                                         (16, 8, 4, 64,
                                          dict(window=24, sink=8)),
                                         (16, 128, 6, 128, {}),
                                         (16, 5, 6, 128, {}),   # S·G = 30
                                         (8, 7, 3, 32,          # S·G = 21
                                          dict(window=20, sink=4))])
def test_paged_prefill_kernel_matches_plain(cuda, dtype, bs, S, G, h, kw):
    rng = np.random.default_rng(bs + S + G)
    B, K, nb = 2, 2, 5
    N = B * nb + 1
    q = _rand(rng, (B, K, S * G, h), dtype, cuda)
    kn = _rand(rng, (B, K, S, h), dtype, cuda)
    vn = _rand(rng, (B, K, S, h), dtype, cuda)
    kp = _rand(rng, (N, K, bs, h), dtype, cuda)
    vp = _rand(rng, (N, K, bs, h), dtype, cuda)
    tables = torch.from_numpy(rng.permutation(np.arange(1, N)).reshape(
        B, nb).astype(np.int32)).to(cuda)
    off = torch.tensor([0, nb * bs // 2 - 3], dtype=torch.int32, device=cuda)
    cl = torch.tensor([S, max(S - 3, 1)], dtype=torch.int32, device=cuda)
    n0 = paged_prefill.launches
    got = paged_prefill(q, kn, vn, kp, vp, tables, off, cl, **kw)
    assert paged_prefill.launches == n0 + 1
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()      # padded rows included
    want = paged_prefill_plain(q, kn, vn, kp, vp, tables, off, cl, **kw)
    for b in range(B):
        real = int(cl[b]) * G
        torch.testing.assert_close(got[b, :, :real].float(),
                                   want[b, :, :real].float(), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,G,h,kw", [
    (64, 1, 32, dict(causal=True)),
    (256, 1, 64, dict(causal=False)),
    (128, 4, 64, dict(causal=True, window=32)),
    (96, 4, 32, dict(causal=True, window=32, sink=8)),
    (200, 6, 128, dict(causal=True)),                # ragged tails
    (77, 5, 64, dict(causal=True)),                  # S, S·G off the tiles
    (300, 4, 128, dict(causal=True, window=40)),     # window edge in a tile
    (300, 4, 128, dict(causal=True, window=40, sink=24)),
    (512, 6, 128, dict(causal=False)),               # bidirectional
    (333, 3, 32, dict(causal=False, window=100, sink=16)),
    (4608, 6, 128, dict(causal=True))])              # full-width main path
def test_flash_prefill_kernel_matches_plain(cuda, dtype, S, G, h, kw):
    rng = np.random.default_rng(S + G + h)
    N = 2
    q = _rand(rng, (N, S * G, h), dtype, cuda)
    k = _rand(rng, (N, S, h), dtype, cuda)
    v = _rand(rng, (N, S, h), dtype, cuda)
    n0 = flash_prefill.launches
    got = flash_prefill(q, k, v, **kw)
    assert flash_prefill.launches == n0 + 1 and got.dtype == dtype
    torch.cuda.synchronize()
    want = flash_prefill_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **TOL_DENSE[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("W,G,h", [(64, 1, 32), (96, 4, 32), (128, 4, 64),
                                   (4224, 6, 128), (4608, 6, 128)])
def test_sink_decode_kernel_matches_plain(cuda, dtype, W, G, h):
    """Caches in the model layout [B, W, K, h], read through the transposed
    [B, K, W, h] view; occupancy 1, partial, exactly W and wrapped (> W)."""
    rng = np.random.default_rng(W + G + h)
    B, K = 4, 2
    q = _rand(rng, (B, K, G, h), dtype, cuda)
    kc = _rand(rng, (B, W, K, h), dtype, cuda).transpose(1, 2)
    vc = _rand(rng, (B, W, K, h), dtype, cuda).transpose(1, 2)
    t = torch.tensor([1, W // 3, W, W + 37], dtype=torch.int32, device=cuda)
    n0 = sink_decode.launches
    got = sink_decode(q, kc, vc, t)
    assert sink_decode.launches == n0 + 1 and got.dtype == dtype
    torch.cuda.synchronize()
    want = sink_decode_plain(q, kc, vc, t)
    torch.testing.assert_close(got.float(), want.float(), **TOL_DENSE[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,nb,G,h", [(8, 4, 1, 32), (16, 3, 3, 32),
                                       (8, 8, 3, 64), (16, 256, 6, 128)])
def test_block_topk_kernel_matches_plain(cuda, dtype, bs, nb, G, h):
    """Lens covering one block, a mid-block tail and full residency, with a
    poisoned null block behind the non-resident entries; NEG_INF entries
    equal exactly."""
    rng = np.random.default_rng(bs + nb + G + h)
    B, K, N = 3, 2, 3 * nb + 1
    q = _rand(rng, (B, K, G, h), dtype, cuda)
    kmin = _rand(rng, (N, K, h), torch.float32, cuda)
    kmax = kmin + _rand(rng, (N, K, h), torch.float32, cuda).relu()
    kmin[0] = kmax[0] = 1e4
    tables = torch.from_numpy(rng.permutation(np.arange(1, N))[:B * nb]
                              .reshape(B, nb).astype(np.int32)).to(cuda)
    tables[0, 1:] = 0
    lens = torch.tensor([1, nb * bs - bs // 2, nb * bs], dtype=torch.int32,
                        device=cuda)
    n0 = block_topk_scores.launches
    got = block_topk_scores(q, kmin, kmax, tables, lens, block_size=bs)
    assert block_topk_scores.launches == n0 + 1
    torch.cuda.synchronize()
    want = block_topk_scores_plain(q, kmin, kmax, tables, lens,
                                   block_size=bs)
    neg = want == -1e30
    assert torch.equal(got[neg], want[neg]) and not (got[~neg] == -1e30).any()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


# (budget kwargs of select_kv_blocks): absolute, fractional, a budget that
# degrades to every resident block, every resident block forced
TOPK_BUDGETS = {
    "absolute": lambda nb: dict(k_static=max(nb // 4, 3), frac=0.0),
    "frac": lambda nb: dict(k_static=max(-(-nb // 4), 3), frac=0.25),
    "degrade": lambda nb: dict(k_static=nb, frac=0.0),
    "forced": lambda nb: dict(k_static=min(nb, 5), frac=0.0, sink_blocks=3,
                              recent_blocks=nb),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("budget", sorted(TOPK_BUDGETS))
@pytest.mark.parametrize("nb", [8, 33, 256, 1000, 4097, TOPK_NB_MAX])
def test_block_topk_select_matches_selection(cuda, dtype, budget, nb):
    """One launch: the scores within the scores' tolerance of the plain
    version, the compacted table, lens, counts and mask equal to
    `select_kv_blocks` on those scores bit for bit, and the step's stats
    (blocks scored and attended over the live slots) exactly. Ties from
    summary rows copied across a third of each row, a poisoned null block
    behind the non-resident entries, lens of one block, a mid-block tail
    and the full table (h 128, G 6, K 2 as on the main path; h 64 and G 1
    at nb 33); the live mask drops slot 1 in all but the absolute case."""
    rng = np.random.default_rng(nb + len(budget))
    B, K, bs = 3, 2, 16
    G, h = (1, 64) if nb == 33 else (6, 128)
    N = B * nb + 1
    q = _rand(rng, (B, K, G, h), dtype, cuda)
    kmin = _rand(rng, (N, K, h), torch.float32, cuda)
    kmax = kmin + _rand(rng, (N, K, h), torch.float32, cuda).relu()
    tables = torch.from_numpy(rng.permutation(np.arange(1, N))[:B * nb]
                              .reshape(B, nb).astype(np.int32)).to(cuda)
    lens_l = [1, nb * bs // 2 + 5, nb * bs]
    for b, n in enumerate(lens_l):
        res = -(-n // bs)
        src, dst = tables[b, 0:res:3], tables[b, 1:res:3]
        k = min(len(src), len(dst))
        kmin[dst[:k].long()] = kmin[src[:k].long()]
        kmax[dst[:k].long()] = kmax[src[:k].long()]
        tables[b, res:] = 0
    kmin[0] = kmax[0] = 1e4
    lens = torch.tensor(lens_l, dtype=torch.int32, device=cuda)
    kw = dict(dict(sink_blocks=1, recent_blocks=2), **TOPK_BUDGETS[budget](nb))
    mask = None if budget == "absolute" else torch.tensor(
        [True, False, True], device=cuda)
    n0 = block_topk_scores.launches
    got = block_topk_select(q, kmin, kmax, tables, lens, block_size=bs,
                            token_mask=mask, **kw)
    assert block_topk_scores.launches == n0 + 1
    torch.cuda.synchronize()
    want = select_kv_blocks(got[0], tables, lens, block_size=bs, **kw)
    for g, w in zip(got[1:5], want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # the step's stats, folded into the launch: blocks scored and attended
    # over the live slots, as the model step sums them
    act = torch.ones(B, device=cuda) if mask is None else mask.float()
    n_res = torch.div(lens + bs - 1, bs, rounding_mode="floor")
    zero = torch.zeros((), device=cuda)
    assert torch.equal(got[5], torch.stack([(act * n_res).sum(),
                                            (act * want[2]).sum(), zero,
                                            zero]))
    if budget == "degrade":
        assert torch.equal(got[1], tables) and torch.equal(got[2], lens)
    plain = block_topk_scores_plain(q, kmin, kmax, tables, lens,
                                    block_size=bs)
    neg = plain == -1e30
    assert torch.equal(got[0][neg], plain[neg])
    assert not (got[0][~neg] == -1e30).any()
    torch.testing.assert_close(got[0], plain, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("budget", sorted(TOPK_BUDGETS))
@pytest.mark.parametrize("nb", [8, 33, 256, 276, 1000, TOPK_NB_MAX])
def test_block_topk_select_scores_matches_selection(cuda, budget, nb):
    """The scores-given entry (the tensor-parallel path: each rank's score
    pass, a max over `model`, then this launch): on given float32 scores
    with ties, NEG_INF past the residency and a live mask, its table,
    lens, counts, mask and stats equal `block_topk_select_scores_plain`
    (`select_kv_blocks` and the step's stats) bit for bit."""
    rng = np.random.default_rng(7 * nb + len(budget))
    B, bs = 4, 16
    N = B * nb + 1
    tables = torch.from_numpy(rng.permutation(np.arange(1, N))[:B * nb]
                              .reshape(B, nb).astype(np.int32)).to(cuda)
    lens = torch.tensor([1, nb * bs // 2 + 5, nb * bs, nb * bs - 3],
                        dtype=torch.int32, device=cuda)
    scores = torch.from_numpy(rng.integers(-4, 5, (B, nb)).astype(
        np.float32)).to(cuda)                       # ties everywhere
    res = torch.arange(nb, device=cuda)[None] * bs < lens[:, None]
    scores = torch.where(res, scores, torch.full_like(scores, -1e30))
    kw = dict(dict(sink_blocks=1, recent_blocks=2), **TOPK_BUDGETS[budget](nb))
    mask = None if budget == "absolute" else torch.tensor(
        [True, False, True, True], device=cuda)
    n0 = block_topk_select_scores.launches
    got = block_topk_select_scores(scores, tables, lens, block_size=bs,
                                   token_mask=mask, **kw)
    assert block_topk_select_scores.launches == n0 + 1
    torch.cuda.synchronize()
    want = block_topk_select_scores_plain(scores, tables, lens,
                                          block_size=bs, token_mask=mask,
                                          **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.gpu
def test_block_topk_select_rejects_unsupported_tables(cuda):
    q = torch.zeros((1, 1, 2, 32), device=cuda)
    kmin = torch.zeros((2, 1, 32), device=cuda)
    ln = torch.ones(1, dtype=torch.int32, device=cuda)
    wide = torch.ones((1, TOPK_NB_MAX + 1), dtype=torch.int32, device=cuda)
    n0 = block_topk_scores.launches
    with pytest.raises(ValueError):                   # past the limit
        block_topk_select(q, kmin, kmin, wide, ln, block_size=16,
                          k_static=4)
    with pytest.raises(ValueError):
        block_topk_scores(q, kmin, kmin, wide, ln, block_size=16)
    tb = torch.ones((1, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):                   # k_static > nb
        block_topk_select(q, kmin, kmin, tb, ln, block_size=16, k_static=5)
    assert block_topk_scores.launches == n0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,S,G,h,nb", [(8, 4, 1, 32, 4), (16, 5, 4, 32, 4),
                                         (8, 2, 4, 64, 4),
                                         (16, 5, 6, 128, 20),
                                         (16, 9, 6, 128, 4),   # 2 row tiles
                                         (16, 7, 3, 64, 40),   # S·G = 21
                                         (16, 5, 6, 128, 160)])  # off 2,560
def test_spec_verify_kernel_matches_plain(cuda, dtype, bs, S, G, h, nb):
    """Per-slot offsets covering an empty, a mid-block and a fully resident
    history, a poisoned null block past the residency, padded window rows
    (compared on real rows; finite everywhere)."""
    rng = np.random.default_rng(bs * S + G + h)
    B, K = 3, 2
    N = B * nb + 1
    q = _rand(rng, (B, K, S * G, h), dtype, cuda)
    kn = _rand(rng, (B, K, S, h), dtype, cuda)
    vn = _rand(rng, (B, K, S, h), dtype, cuda)
    kp = _rand(rng, (N, K, bs, h), dtype, cuda)
    vp = _rand(rng, (N, K, bs, h), dtype, cuda)
    kp[0] = vp[0] = 1e4
    tables = torch.from_numpy(rng.permutation(np.arange(1, N)).reshape(
        B, nb).astype(np.int32)).to(cuda)
    tables[1, 2:] = 0
    off = torch.tensor([0, bs + bs // 2 - 1, nb * bs], dtype=torch.int32,
                       device=cuda)
    cl = torch.tensor([S, max(S - 2, 1), 1], dtype=torch.int32, device=cuda)
    n0 = spec_verify.launches
    got = spec_verify(q, kn, vn, kp, vp, tables, off, cl)
    assert spec_verify.launches == n0 + 1 and got.dtype == dtype
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    want = spec_verify_plain(q, kn, vn, kp, vp, tables, off, cl)
    for b in range(B):
        real = int(cl[b]) * G
        torch.testing.assert_close(got[b, :, :real].float(),
                                   want[b, :, :real].float(), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,C,D,F,nv", [
    (2, 32, 64, 48, None), (4, 64, 128, 96, None), (1, 16, 32, 32, None),
    (3, 40, 50, 130, (0, 40, 33)),              # edges: n_valid 0 and C
    (60, 8, 2048, 1408, "decode"),              # full width, w1/w3 at decode
    (60, 8, 1408, 2048, "decode"),              # w2 at decode
    (60, 24, 2048, 1408, "prefill")])           # a 128-token prefill chunk
def test_moe_gmm_kernel_matches_plain(cuda, dtype, S, C, D, F, nv):
    from repro_torch.device import set_precision_policy
    set_precision_policy()
    rng = np.random.default_rng(S + C + D)
    x = _rand(rng, (S, C, D), dtype, cuda)
    w = (_rand(rng, (S, D, F), torch.float32, cuda) * 0.02).to(dtype)
    if nv is None:
        nv = rng.integers(0, C + 1, S)
    elif nv == "decode":            # 6 tokens x top-4 over 60 slots
        nv = np.zeros(S, np.int64)
        nv[rng.choice(S, 24, replace=False)] = rng.integers(1, 3, 24)
    elif nv == "prefill":           # 512 assignments, capacity 24
        nv = np.minimum(rng.multinomial(512, np.full(S, 1 / S)), C)
    n_valid = torch.tensor(np.asarray(nv), dtype=torch.int32, device=cuda)
    x = x * (torch.arange(C, device=cuda)[None, :, None]
             < n_valid.long()[:, None, None]).to(dtype)
    got = moe_gmm(x, w, n_valid)
    torch.cuda.synchronize()
    want = moe_gmm_plain(x, w, n_valid)
    assert got.dtype == dtype and got.shape == (S, C, F)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    for s in range(S):
        assert not got[s, int(nv[s]):].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,W,G,h,ts", [
    (6, 4224, 6, 128, [1] * 6),                 # t = 1: 21 of 22 splits empty
    (4, 100, 1, 64, [1, 99, 100, 250]),         # W off the 16-slot chunk
    (4, 4223, 6, 128, [1, 17, 4223, 9000]),     # and wrapped (t > W)
    (3, 4223, 1, 32, [4222, 16, 5000]),
    (2, 16, 6, 128, [1, 40]),                   # one chunk, one split
    (4, 4608, 6, 128, [4608, 4097, 2, 4609])])  # the full cache
def test_sink_decode_split_edges(cuda, dtype, B, W, G, h, ts):
    """Split-KV sink_decode: splits past the occupancy, W off the chunk,
    wrapped rings; every slot past a sequence's occupancy holds 1e4, so a
    read of one would show."""
    rng = np.random.default_rng(W + G + h + B)
    K = 2
    q = _rand(rng, (B, K, G, h), dtype, cuda)
    kc = _rand(rng, (B, W, K, h), dtype, cuda)
    vc = _rand(rng, (B, W, K, h), dtype, cuda)
    for b, t in enumerate(ts):
        kc[b, t:] = vc[b, t:] = 1e4
    kc, vc = kc.transpose(1, 2), vc.transpose(1, 2)
    t = torch.tensor(ts, dtype=torch.int32, device=cuda)
    n0 = sink_decode.launches
    got = sink_decode(q, kc, vc, t)
    assert sink_decode.launches == n0 + 1 and got.dtype == dtype
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    want = sink_decode_plain(q, kc, vc, t)
    torch.testing.assert_close(got.float(), want.float(), **TOL_DENSE[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,C,D,F,nv", [
    (8, 24, 256, 192, (0,) * 8),                # every slot empty
    (6, 24, 2048, 1408, (16, 17, 24, 0, 1, 15)),    # across 16-row tiles
    (5, 40, 50, 130, (16, 17, 24, 40, 0)),      # D, F off every tile
    (4, 24, 48, 136, (17, 24, 0, 3)),           # off the tiles, 16-byte rows
    (3, 70, 64, 64, (70, 33, 64))])             # three 32-row tiles
def test_moe_gmm_edges(cuda, dtype, S, C, D, F, nv):
    """Empty slots hold NaN weights and rows past n_valid NaN inputs: the
    kernel reads neither (rows past n_valid come out exactly zero)."""
    rng = np.random.default_rng(S + C + D + F)
    n_valid = torch.tensor(nv, dtype=torch.int32, device=cuda)
    live = torch.arange(C, device=cuda)[None, :, None] \
        < n_valid.long()[:, None, None]
    x = _rand(rng, (S, C, D), dtype, cuda) * live.to(dtype)
    w = (_rand(rng, (S, D, F), torch.float32, cuda) * 0.02).to(dtype)
    empty = n_valid == 0
    w[empty] = 0
    want = moe_gmm_plain(x, w, n_valid)
    x = torch.where(live, x, torch.full_like(x, float("nan")))
    w[empty] = float("nan")
    n0 = moe_gmm.launches
    got = moe_gmm(x, w, n_valid)
    assert moe_gmm.launches == n0 + 1
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (S, C, F)
    assert torch.isfinite(got.float()).all()
    for s, n in enumerate(nv):
        assert not got[s, n:].any()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,D,F,n_tok", [(8, 2048, 1408, 6),
                                         (8, 1408, 2048, 6),
                                         (24, 2048, 1408, 128)])
def test_moe_gmm_slot_order_bit_exact(cuda, dtype, C, D, F, n_tok):
    """A slot's output depends neither on its index nor on which CTA takes
    it: the call on x, w and n_valid in reversed slot order gives the
    forward output reversed, bit for bit (phase 8's forced migration)."""
    rng = np.random.default_rng(C + D + n_tok)
    S = 60
    nv = np.zeros(S, np.int64)
    for _ in range(n_tok):
        nv[rng.choice(S, 4, replace=False)] += 1
    n_valid = torch.tensor(np.minimum(nv, C), dtype=torch.int32, device=cuda)
    x = _rand(rng, (S, C, D), dtype, cuda) * (
        torch.arange(C, device=cuda)[None, :, None]
        < n_valid.long()[:, None, None]).to(dtype)
    w = (_rand(rng, (S, D, F), torch.float32, cuda) * 0.02).to(dtype)
    got = moe_gmm(x, w, n_valid)
    rev = moe_gmm(x.flip(0), w.flip(0), n_valid.flip(0))
    torch.cuda.synchronize()
    assert torch.equal(rev.flip(0), got)
    torch.testing.assert_close(got.float(),
                               moe_gmm_plain(x, w, n_valid).float(),
                               **TOL[dtype])


def _int8_arena(rng, N, K, bs, h, tables, lens, dev):
    """int8 pages + scale plane written by the port's write path: every
    block first holds a previous owner's sealed content, then each row of
    `tables` is rewritten from offset 0 with lens[b] tokens (opening each
    block unseals it; full blocks seal, the tail stays per-token). The null
    block 0 is poisoned."""
    e = {n: torch.zeros((N, K, bs, h), dtype=torch.int8, device=dev)
         for n in ("k", "v")}
    for n in ("k", "v"):
        e[n + "scale"] = torch.zeros((N, K, h), device=dev)
        e[n + "tok"] = torch.zeros((N, K, bs), device=dev)
    every = torch.arange(1, N, dtype=torch.int32, device=dev)[None]
    old = _rand(rng, (1, (N - 1) * bs, K, h), torch.float32, dev)
    attn_mod.quant_paged_prefill_write(e, old, -old, every, 0,
                                       (N - 1) * bs)
    for b, n_tok in enumerate(lens):
        if n_tok:
            x = _rand(rng, (1, int(n_tok), K, h), torch.float32, dev)
            attn_mod.quant_paged_prefill_write(e, x, x * 0.5,
                                               tables[b:b + 1], 0, n_tok)
    e["k"][0] = e["v"][0] = 127
    e["kscale"][0] = e["vscale"][0] = 1e4
    scales = dict(k_scale=e["kscale"], k_tok=e["ktok"],
                  v_scale=e["vscale"], v_tok=e["vtok"])
    return e["k"], e["v"], scales


def _tables(rng, B, nb, N, dev):
    return torch.from_numpy(rng.permutation(np.arange(1, N))[:B * nb]
                            .reshape(B, nb).astype(np.int32)).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("nb,lens,K,G,bs,h", [
    (264, [4224] * 4 + [20] * 2, 2, 6, 16, 128),     # phase 5's ring tables
    (200, [1, 16, 17, 3000, 3199, 5], 2, 6, 16, 128),    # empty splits
    (64, [1, 8, 9, 200, 512, 7], 4, 1, 8, 128),      # one-block rows, bs 8
    (40, [1, 31, 33, 640, 1279, 1280], 2, 4, 32, 128),   # 2 chunks a block
    (48, [1, 100, 383, 384, 7, 200], 2, 4, 8, 32),   # the merge at h 32
    (40, [640, 1, 33, 500, 639, 16], 2, 8, 16, 64)])     # and at h 64
def test_paged_decode_split_kv_matches_plain(cuda, dtype, int8, nb, lens, K,
                                             G, bs, h):
    """Split-KV paged_decode over long tables: splits that hold no resident
    block, one-block sequences, blocks longer than one chunk; every table
    entry past a sequence's residency points at the poisoned null block,
    float and int8 arenas."""
    rng = np.random.default_rng(nb + bs + G + int8)
    B = len(lens)
    N = B * nb + 1
    q = _rand(rng, (B, K, G, h), dtype, cuda)
    tables = _tables(rng, B, nb, N, cuda)
    for b, n in enumerate(lens):
        tables[b, -(-n // bs):] = 0
    if int8:
        kp, vp, sc = _int8_arena(rng, N, K, bs, h, tables, lens, cuda)
    else:
        kp = _rand(rng, (N, K, bs, h), dtype, cuda)
        vp = _rand(rng, (N, K, bs, h), dtype, cuda)
        kp[0] = vp[0] = 1e4
        sc = {}
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
    n0, i0 = paged_decode.launches, paged_decode.int8_launches
    got = paged_decode(q, kp, vp, tables, ln, **sc)
    assert paged_decode.launches == n0 + 1
    assert paged_decode.int8_launches == i0 + int(int8)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    want = paged_decode_plain(q, kp, vp, tables, ln, **sc)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,nb,G,h,K", [(8, 6, 1, 32, 2), (16, 4, 4, 32, 2),
                                         (16, 32, 6, 128, 2),
                                         (16, 32, 1, 128, 16)])
def test_paged_decode_int8_matches_plain(cuda, dtype, bs, nb, G, h, K):
    rng = np.random.default_rng(bs + G + h + K)
    B, N = 3, 3 * nb + 1
    q = _rand(rng, (B, K, G, h), dtype, cuda)
    tables = _tables(rng, B, nb, N, cuda)
    lens = [1, nb * bs // 2 + 1, nb * bs]
    kq, vq, sc = _int8_arena(rng, N, K, bs, h, tables, lens, cuda)
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
    n0, i0 = paged_decode.launches, paged_decode.int8_launches
    got = paged_decode(q, kq, vq, tables, ln, **sc)
    assert paged_decode.launches == n0 + 1
    assert paged_decode.int8_launches == i0 + 1 and got.dtype == dtype
    torch.cuda.synchronize()
    want = paged_decode_plain(q, kq, vq, tables, ln, **sc)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,S,G,h", [(8, 8, 1, 32), (16, 8, 4, 32),
                                      (16, 128, 6, 128), (16, 5, 6, 128),
                                      (8, 7, 3, 64)])
def test_paged_prefill_int8_matches_plain(cuda, dtype, bs, S, G, h):
    rng = np.random.default_rng(bs + S + G + 1)
    B, K, nb = 2, 2, 5
    N = B * nb + 1
    q = _rand(rng, (B, K, S * G, h), dtype, cuda)
    kn = _rand(rng, (B, K, S, h), dtype, cuda)
    vn = _rand(rng, (B, K, S, h), dtype, cuda)
    tables = _tables(rng, B, nb, N, cuda)
    offs = [0, nb * bs // 2 - 3]
    kq, vq, sc = _int8_arena(rng, N, K, bs, h, tables, offs, cuda)
    off = torch.tensor(offs, dtype=torch.int32, device=cuda)
    cl = torch.tensor([S, max(S - 3, 1)], dtype=torch.int32, device=cuda)
    i0 = paged_prefill.int8_launches
    got = paged_prefill(q, kn, vn, kq, vq, tables, off, cl, **sc)
    assert paged_prefill.int8_launches == i0 + 1
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    want = paged_prefill_plain(q, kn, vn, kq, vq, tables, off, cl, **sc)
    for b in range(B):
        real = int(cl[b]) * G
        torch.testing.assert_close(got[b, :, :real].float(),
                                   want[b, :, :real].float(), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,S,G,h,nb", [(8, 4, 1, 32, 4), (16, 5, 4, 32, 4),
                                         (16, 5, 6, 128, 20),
                                         (16, 5, 6, 128, 160),  # off 2,560
                                         (8, 7, 3, 32, 12)])    # S·G = 21
def test_spec_verify_int8_matches_plain(cuda, dtype, bs, S, G, h, nb):
    rng = np.random.default_rng(bs * S + G + h + 2)
    B, K = 3, 2
    N = B * nb + 1
    q = _rand(rng, (B, K, S * G, h), dtype, cuda)
    kn = _rand(rng, (B, K, S, h), dtype, cuda)
    vn = _rand(rng, (B, K, S, h), dtype, cuda)
    tables = _tables(rng, B, nb, N, cuda)
    offs = [0, bs + bs // 2 - 1, nb * bs]
    kq, vq, sc = _int8_arena(rng, N, K, bs, h, tables, offs, cuda)
    off = torch.tensor(offs, dtype=torch.int32, device=cuda)
    cl = torch.tensor([S, max(S - 2, 1), 1], dtype=torch.int32, device=cuda)
    i0 = spec_verify.int8_launches
    got = spec_verify(q, kn, vn, kq, vq, tables, off, cl, **sc)
    assert spec_verify.int8_launches == i0 + 1
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    want = spec_verify_plain(q, kn, vn, kq, vq, tables, off, cl, **sc)
    for b in range(B):
        real = int(cl[b]) * G
        torch.testing.assert_close(got[b, :, :real].float(),
                                   want[b, :, :real].float(), **TOL[dtype])


# The paged-history routine's edges (paged_prefill and spec_verify):
# (B, K, S, G, h, bs, nb, off, real rows, kwargs). Tables past each
# residency point at the poisoned null block.
HISTORY_EDGES = [
    # history spread over many splits, off not a multiple of bs
    (2, 2, 16, 6, 128, 16, 200, [2003, 1001], [16, 9], {}),
    # off = 0 in every row: every history split empty
    (2, 2, 8, 4, 64, 16, 12, [0, 0], [8, 3], {}),
    # chunk_len / n_tok < S: padded rows finite
    (3, 2, 32, 2, 32, 8, 10, [7, 40, 80], [1, 17, 31], {}),
    # S·G off the row tile (30 and 21 rows)
    (3, 2, 5, 6, 128, 16, 20, [0, 151, 320], [5, 2, 1], {}),
    (3, 2, 7, 3, 32, 8, 24, [5, 64, 191], [7, 4, 1], {}),
    # the MoE attention shape, K = 16, G = 1
    (2, 16, 5, 1, 128, 16, 32, [17, 511], [5, 3], {}),
    (1, 16, 128, 1, 128, 16, 32, [384], [128], {}),
    # off >= 2,000: topk-long's last chunk (S·G 768, nb 288)
    (1, 2, 128, 6, 128, 16, 288, [3840], [128], {}),
]
# window and sink edges inside a key tile (paged_prefill only)
PREFILL_WINDOW_EDGES = [
    (1, 2, 32, 4, 64, 8, 20, [77], [29], dict(window=45, sink=12)),
    (2, 2, 64, 2, 128, 16, 40, [600, 31], [64, 50],
     dict(window=100, sink=20)),
]


def _history_case(rng, dtype, int8, B, K, S, G, h, bs, nb, offs, cls, dev):
    N = B * nb + 1
    q = _rand(rng, (B, K, S * G, h), dtype, dev)
    kn = _rand(rng, (B, K, S, h), dtype, dev)
    vn = _rand(rng, (B, K, S, h), dtype, dev)
    tables = _tables(rng, B, nb, N, dev)
    for b, n in enumerate(offs):
        tables[b, -(-n // bs):] = 0
    if int8:
        kp, vp, sc = _int8_arena(rng, N, K, bs, h, tables, offs, dev)
    else:
        kp = _rand(rng, (N, K, bs, h), dtype, dev)
        vp = _rand(rng, (N, K, bs, h), dtype, dev)
        kp[0] = vp[0] = 1e4
        sc = {}
    off = torch.tensor(offs, dtype=torch.int32, device=dev)
    cl = torch.tensor(cls, dtype=torch.int32, device=dev)
    return (q, kn, vn, kp, vp, tables, off, cl), sc


def _check_history_case(kern, plain, args, sc, kw, dtype, int8):
    n0, i0 = kern.launches, kern.int8_launches
    got = kern(*args, **sc, **kw)
    assert kern.launches == n0 + 1
    assert kern.int8_launches == i0 + int(int8)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    want = plain(*args, **sc, **kw)
    G = args[0].shape[2] // args[1].shape[2]
    for b, c in enumerate(args[7].tolist()):
        torch.testing.assert_close(got[b, :, :c * G].float(),
                                   want[b, :, :c * G].float(), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,K,S,G,h,bs,nb,offs,cls,kw",
                         HISTORY_EDGES + PREFILL_WINDOW_EDGES)
def test_paged_prefill_history_edges(cuda, dtype, int8, B, K, S, G, h, bs,
                                     nb, offs, cls, kw):
    rng = np.random.default_rng(B * nb + S + G + h + int8)
    args, sc = _history_case(rng, dtype, int8, B, K, S, G, h, bs, nb, offs,
                             cls, cuda)
    _check_history_case(paged_prefill, paged_prefill_plain, args, sc, kw,
                        dtype, int8)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,K,S,G,h,bs,nb,offs,cls,kw", HISTORY_EDGES)
def test_spec_verify_history_edges(cuda, dtype, int8, B, K, S, G, h, bs, nb,
                                   offs, cls, kw):
    rng = np.random.default_rng(B * nb + S + G + h + int8 + 1)
    args, sc = _history_case(rng, dtype, int8, B, K, S, G, h, bs, nb, offs,
                             cls, cuda)
    _check_history_case(spec_verify, spec_verify_plain, args, sc, kw, dtype,
                        int8)


@pytest.mark.gpu
def test_int8_paths_refuse_casts_and_bad_scales(cuda):
    """int8 pages need their scale plane and the scale plane int8 pages:
    nothing is cast."""
    q = torch.zeros((1, 1, 2, 32), device=cuda)
    p8 = torch.zeros((3, 1, 8, 32), dtype=torch.int8, device=cuda)
    pf = torch.zeros((3, 1, 8, 32), device=cuda)
    tb = torch.ones((1, 1), dtype=torch.int32, device=cuda)
    ln = torch.ones(1, dtype=torch.int32, device=cuda)
    sc = dict(k_scale=torch.zeros((3, 1, 32), device=cuda),
              k_tok=torch.zeros((3, 1, 8), device=cuda),
              v_scale=torch.zeros((3, 1, 32), device=cuda),
              v_tok=torch.zeros((3, 1, 8), device=cuda))
    with pytest.raises(TypeError):                    # int8 without scales
        paged_decode(q, p8, p8, tb, ln)
    with pytest.raises(TypeError):                    # scales, float pages
        paged_decode(q, pf, pf, tb, ln, **sc)
    with pytest.raises(ValueError):                   # tok rows of bs 4
        paged_decode(q, p8, p8, tb, ln, **dict(
            sc, k_tok=torch.zeros((3, 1, 4), device=cuda)))


@pytest.mark.gpu
def test_kernel_rejects_unsupported_inputs(cuda):
    q = torch.zeros((1, 1, 2, 48), device=cuda)       # h=48: no kernel
    kp = torch.zeros((2, 1, 8, 48), device=cuda)
    tb = torch.ones((1, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        paged_decode(q, kp, kp, tb, torch.ones(1, dtype=torch.int32,
                                                device=cuda))
    with pytest.raises(ValueError):                   # pages on the CPU
        paged_decode(torch.zeros((1, 1, 2, 32), device=cuda),
                     torch.zeros((2, 1, 8, 32)), torch.zeros((2, 1, 8, 32)),
                     tb, torch.ones(1, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):                   # h=48: no kernel
        flash_prefill(torch.zeros((1, 8, 48), device=cuda),
                      torch.zeros((1, 8, 48), device=cuda),
                      torch.zeros((1, 8, 48), device=cuda))
    with pytest.raises(ValueError):                   # h not contiguous
        c = torch.zeros((1, 1, 32, 8), device=cuda).transpose(2, 3)
        sink_decode(torch.zeros((1, 1, 2, 32), device=cuda), c, c,
                    torch.ones(1, dtype=torch.int32, device=cuda))
    with pytest.raises(TypeError):                    # bf16 summaries
        block_topk_scores(torch.zeros((1, 1, 2, 32), device=cuda),
                          torch.zeros((2, 1, 32), device=cuda,
                                      dtype=torch.bfloat16),
                          torch.zeros((2, 1, 32), device=cuda,
                                      dtype=torch.bfloat16),
                          tb, torch.ones(1, dtype=torch.int32, device=cuda),
                          block_size=8)
    with pytest.raises(ValueError):                   # mixed dtypes
        moe_gmm(torch.zeros((1, 8, 32), device=cuda),
                torch.zeros((1, 32, 8), device=cuda, dtype=torch.bfloat16),
                torch.ones(1, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):                   # window rows % S
        spec_verify(torch.zeros((1, 1, 7, 32), device=cuda),
                    torch.zeros((1, 1, 2, 32), device=cuda),
                    torch.zeros((1, 1, 2, 32), device=cuda),
                    torch.zeros((2, 1, 8, 32), device=cuda),
                    torch.zeros((2, 1, 8, 32), device=cuda), tb, 0, 2)


# ---- gemma3-4b's head width (h 256) and granite-34b's GQA group (G 48) --
# (K, G, h): gemma3's global layers, granite's single kv head, qwen3-moe's
# group of 16; the decode routine's row-group edges: one group at its
# largest (16 rows at h 128, 8 at h 256), then two and three groups
WIDE = [(4, 2, 256), (1, 48, 128)]
ROW_GROUPS = [(1, 16, 128), (1, 17, 128), (1, 33, 128), (2, 8, 256),
              (2, 9, 256), (1, 48, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("K,G,h", WIDE + ROW_GROUPS)
def test_paged_decode_wide_shapes_match_plain(cuda, dtype, int8, K, G, h):
    """Row groups and h 256 over split tables: one-token, one-block and
    long rows, the poisoned null block behind every non-resident entry."""
    rng = np.random.default_rng(K * 100 + G + h + int8)
    lens, bs, nb = [1, 16, 17, 700, 1300, 2064], 16, 130
    B, N = len(lens), len(lens) * nb + 1
    q = _rand(rng, (B, K, G, h), dtype, cuda)
    tables = _tables(rng, B, nb, N, cuda)
    for b, n in enumerate(lens):
        tables[b, -(-n // bs):] = 0
    if int8:
        kp, vp, sc = _int8_arena(rng, N, K, bs, h, tables, lens, cuda)
    else:
        kp = _rand(rng, (N, K, bs, h), dtype, cuda)
        vp = _rand(rng, (N, K, bs, h), dtype, cuda)
        kp[0] = vp[0] = 1e4
        sc = {}
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
    n0, i0 = paged_decode.launches, paged_decode.int8_launches
    got = paged_decode(q, kp, vp, tables, ln, **sc)
    assert paged_decode.launches == n0 + 1
    assert paged_decode.int8_launches == i0 + int(int8)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    want = paged_decode_plain(q, kp, vp, tables, ln, **sc)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("W", [1024, 2304])
@pytest.mark.parametrize("K,G,h", WIDE + ROW_GROUPS)
def test_sink_decode_wide_shapes_match_plain(cuda, dtype, W, K, G, h):
    """gemma3's local ring (1,024) and full cache (2,304) in the model
    layout; occupancy 1, 17 (off the 8-slot stage at h 256), partial,
    exactly W and wrapped; slots past t poisoned."""
    rng = np.random.default_rng(W + K * 100 + G + h)
    ts = [1, 17, W // 3, W, W + 37]
    B = len(ts)
    q = _rand(rng, (B, K, G, h), dtype, cuda)
    kc = _rand(rng, (B, W, K, h), dtype, cuda)
    vc = _rand(rng, (B, W, K, h), dtype, cuda)
    for b, t_b in enumerate(ts):
        kc[b, t_b:] = vc[b, t_b:] = 1e4
    kc, vc = kc.transpose(1, 2), vc.transpose(1, 2)
    t = torch.tensor(ts, dtype=torch.int32, device=cuda)
    n0 = sink_decode.launches
    got = sink_decode(q, kc, vc, t)
    assert sink_decode.launches == n0 + 1 and got.dtype == dtype
    torch.cuda.synchronize()
    want = sink_decode_plain(q, kc, vc, t)
    torch.testing.assert_close(got.float(), want.float(), **TOL_DENSE[dtype])


# (B, K, S, G, h, bs, nb, off, real rows, kwargs) at the wide shapes: a
# prefill chunk over a long and an empty history, a padded chunk, a verify
# window per slot
WIDE_HISTORY = [
    (2, 4, 128, 2, 256, 16, 144, [1536, 0], [128, 100], {}),
    (2, 4, 64, 2, 256, 16, 144, [1100, 37], [64, 9],
     dict(window=1024)),
    (1, 1, 128, 48, 128, 16, 32, [384], [128], {}),
    (2, 1, 32, 48, 128, 16, 32, [200, 0], [32, 7], {}),
    (6, 4, 5, 2, 256, 16, 144, [0, 15, 16, 700, 1999, 2299],
     [5, 5, 3, 1, 5, 2], {}),
    (6, 1, 5, 48, 128, 16, 32, [0, 15, 16, 300, 470, 507],
     [5, 5, 3, 1, 5, 2], {}),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,K,S,G,h,bs,nb,offs,cls,kw", WIDE_HISTORY)
def test_paged_prefill_wide_shapes_match_plain(cuda, dtype, int8, B, K, S,
                                               G, h, bs, nb, offs, cls, kw):
    rng = np.random.default_rng(B * nb + S + G + h + int8 + 2)
    args, sc = _history_case(rng, dtype, int8, B, K, S, G, h, bs, nb, offs,
                             cls, cuda)
    _check_history_case(paged_prefill, paged_prefill_plain, args, sc, kw,
                        dtype, int8)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,K,S,G,h,bs,nb,offs,cls,kw",
                         [c for c in WIDE_HISTORY if not c[-1]])
def test_spec_verify_wide_shapes_match_plain(cuda, dtype, int8, B, K, S, G,
                                             h, bs, nb, offs, cls, kw):
    rng = np.random.default_rng(B * nb + S + G + h + int8 + 3)
    args, sc = _history_case(rng, dtype, int8, B, K, S, G, h, bs, nb, offs,
                             cls, cuda)
    _check_history_case(spec_verify, spec_verify_plain, args, sc, kw, dtype,
                        int8)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,S,G,h,kw", [
    (4, 2048, 2, 256, dict(causal=True, window=1024)),   # gemma3 local
    (4, 2048, 2, 256, dict(causal=True, window=1024, sink=128)),
    (4, 300, 2, 256, dict(causal=True)),                 # ragged tiles
    (2, 333, 2, 256, dict(causal=False, window=100, sink=16)),
    (1, 448, 48, 128, dict(causal=True)),                # granite
    (1, 77, 48, 128, dict(causal=True, window=40, sink=8))])
def test_flash_prefill_wide_shapes_match_plain(cuda, dtype, N, S, G, h, kw):
    rng = np.random.default_rng(S + G + h + len(kw))
    q = _rand(rng, (N, S * G, h), dtype, cuda)
    k = _rand(rng, (N, S, h), dtype, cuda)
    v = _rand(rng, (N, S, h), dtype, cuda)
    n0 = flash_prefill.launches
    got = flash_prefill(q, k, v, **kw)
    assert flash_prefill.launches == n0 + 1 and got.dtype == dtype
    torch.cuda.synchronize()
    want = flash_prefill_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **TOL_DENSE[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,G,h", WIDE + [(4, 16, 128), (1, 3, 256)])
def test_block_topk_wide_shapes_match_plain_and_selection(cuda, dtype, K, G,
                                                          h):
    """Scores against the plain version (a kv head's h 256 row spans two
    passes of the warp), then the fused select exactly against
    select_kv_blocks on its own scores."""
    rng = np.random.default_rng(K * 10 + G + h)
    bs, nb = 16, 144
    lens = [1, 100, 1000, 2048, 2300, 17]
    B, N = len(lens), len(lens) * nb + 1
    q = _rand(rng, (B, K, G, h), dtype, cuda)
    kmin = _rand(rng, (N, K, h), torch.float32, cuda)
    kmax = kmin + _rand(rng, (N, K, h), torch.float32, cuda).relu()
    kmin[0] = kmax[0] = 1e4
    tables = _tables(rng, B, nb, N, cuda)
    for b, n in enumerate(lens):
        tables[b, -(-n // bs):] = 0
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
    got = block_topk_scores(q, kmin, kmax, tables, ln, block_size=bs)
    torch.cuda.synchronize()
    want = block_topk_scores_plain(q, kmin, kmax, tables, ln, block_size=bs)
    neg = want == -1e30
    assert torch.equal(got[neg], want[neg]) and not (got[~neg] == -1e30).any()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    kw = dict(k_static=36, frac=0.25, sink_blocks=1, recent_blocks=2)
    sel = block_topk_select(q, kmin, kmax, tables, ln, block_size=bs, **kw)
    ref = select_kv_blocks(sel[0], tables, ln, block_size=bs, **kw)
    for a, b in zip(sel[1:5], ref):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.gpu
def test_head_dims_outside_the_kernels_raise(cuda):
    """h = 48 and 512 are in no kernel's list, and 80 / 96 are not in
    paged_prefill's, spec_verify's or block_topk's (ROADMAP B17b; the
    other three take them): each such wrapper raises on the card, nothing
    falls back and nothing is launched."""
    tb = torch.ones((1, 1), dtype=torch.int32, device=cuda)
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    counts = (paged_prefill.launches, spec_verify.launches,
              block_topk_scores.launches, paged_decode.launches,
              sink_decode.launches, flash_prefill.launches)
    for h in (48, 80, 96, 512):
        q = torch.zeros((1, 1, 2, h), device=cuda)
        kp = torch.zeros((2, 1, 16, h), device=cuda)
        if h not in (80, 96):
            with pytest.raises(ValueError):
                paged_decode(q, kp, kp, tb, one)
            with pytest.raises(ValueError):
                sink_decode(q, kp[:1], kp[:1], one)
            with pytest.raises(ValueError):
                flash_prefill(torch.zeros((1, 8, h), device=cuda),
                              torch.zeros((1, 4, h), device=cuda),
                              torch.zeros((1, 4, h), device=cuda))
        qc = torch.zeros((1, 1, 4, h), device=cuda)
        kn = torch.zeros((1, 1, 2, h), device=cuda)
        with pytest.raises(ValueError):
            paged_prefill(qc, kn, kn, kp, kp, tb, 0, 2)
        with pytest.raises(ValueError):
            spec_verify(qc, kn, kn, kp, kp, tb, 0, 2)
        with pytest.raises(ValueError):
            block_topk_scores(q, torch.zeros((2, 1, h), device=cuda),
                              torch.zeros((2, 1, h), device=cuda), tb, one,
                              block_size=16)
    assert counts == (paged_prefill.launches, spec_verify.launches,
                      block_topk_scores.launches, paged_decode.launches,
                      sink_decode.launches, flash_prefill.launches)


# ---- hubert-xlarge's h 80 and phi-3-vision's h 96 -----------------------
# (K, G, h): the two models' heads (G 1, fewer kv heads), GQA groups at the
# decode routine's row limit (25 rows at h 80, 21 at 96) and one row past it
FRONTEND = [(4, 1, 80), (4, 1, 96), (2, 4, 80), (2, 3, 96), (1, 25, 80),
            (1, 26, 80), (1, 21, 96), (1, 22, 96)]


def _channels_64_79_checked(got, want, dtype):
    """At h 80 a lane owns ceil(80/32) = 3 output channels of the decode
    routine (the last lanes masked): channels 64-79, which 80/32 = 2
    channels a lane would never accumulate, hold the plain version's
    values and are not zero."""
    tail = got[..., 64:80].float()
    torch.testing.assert_close(tail, want[..., 64:80].float(), **TOL[dtype])
    assert float(tail.abs().amax()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("K,G,h", FRONTEND)
def test_paged_decode_frontend_head_dims_match_plain(cuda, dtype, int8, K,
                                                     G, h):
    rng = np.random.default_rng(K * 100 + G + h + int8 + 7)
    lens, bs, nb = [1, 16, 17, 300, 1040, 1041], 16, 66
    B, N = len(lens), len(lens) * nb + 1
    q = _rand(rng, (B, K, G, h), dtype, cuda)
    tables = _tables(rng, B, nb, N, cuda)
    for b, n in enumerate(lens):
        tables[b, -(-n // bs):] = 0
    if int8:
        kp, vp, sc = _int8_arena(rng, N, K, bs, h, tables, lens, cuda)
    else:
        kp = _rand(rng, (N, K, bs, h), dtype, cuda)
        vp = _rand(rng, (N, K, bs, h), dtype, cuda)
        kp[0] = vp[0] = 1e4
        sc = {}
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
    n0, i0 = paged_decode.launches, paged_decode.int8_launches
    got = paged_decode(q, kp, vp, tables, ln, **sc)
    assert paged_decode.launches == n0 + 1
    assert paged_decode.int8_launches == i0 + int(int8)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    want = paged_decode_plain(q, kp, vp, tables, ln, **sc)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    if h == 80:
        _channels_64_79_checked(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,G,h", FRONTEND)
def test_sink_decode_frontend_head_dims_match_plain(cuda, dtype, K, G, h):
    """phi-3-vision's dense caches in the model layout: occupancy 1, 17,
    partial, exactly W and wrapped; slots past t poisoned; W 1,056 (a
    1,040-row prompt and 16 steps) off the 16-slot chunk by nothing and
    W 1,041 off it by one."""
    rng = np.random.default_rng(K * 100 + G + h + 11)
    for W in (1056, 1041):
        ts = [1, 17, W // 3, W, W + 37]
        B = len(ts)
        q = _rand(rng, (B, K, G, h), dtype, cuda)
        kc = _rand(rng, (B, W, K, h), dtype, cuda)
        vc = _rand(rng, (B, W, K, h), dtype, cuda)
        for b, t_b in enumerate(ts):
            kc[b, t_b:] = vc[b, t_b:] = 1e4
        kc, vc = kc.transpose(1, 2), vc.transpose(1, 2)
        t = torch.tensor(ts, dtype=torch.int32, device=cuda)
        n0 = sink_decode.launches
        got = sink_decode(q, kc, vc, t)
        assert sink_decode.launches == n0 + 1 and got.dtype == dtype
        torch.cuda.synchronize()
        want = sink_decode_plain(q, kc, vc, t)
        torch.testing.assert_close(got.float(), want.float(),
                                   **TOL_DENSE[dtype])
        if h == 80:
            _channels_64_79_checked(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,S,G,h,kw", [
    (4, 1024, 1, 80, dict(causal=False)),                # hubert
    (4, 333, 1, 80, dict(causal=False)),                 # ragged tiles
    (2, 300, 2, 80, dict(causal=True, window=100, sink=16)),
    (2, 200, 1, 80, dict(causal=False, window=64, sink=8)),
    (4, 1024, 1, 96, dict(causal=True)),                 # phi-3-vision
    (2, 1041, 1, 96, dict(causal=True)),
    (2, 300, 3, 96, dict(causal=True, window=100, sink=16)),
    (2, 77, 1, 96, dict(causal=False))])
def test_flash_prefill_frontend_head_dims_match_plain(cuda, dtype, N, S, G,
                                                      h, kw):
    rng = np.random.default_rng(S + G + h + len(kw) + 13)
    q = _rand(rng, (N, S * G, h), dtype, cuda)
    k = _rand(rng, (N, S, h), dtype, cuda)
    v = _rand(rng, (N, S, h), dtype, cuda)
    n0 = flash_prefill.launches
    got = flash_prefill(q, k, v, **kw)
    assert flash_prefill.launches == n0 + 1 and got.dtype == dtype
    torch.cuda.synchronize()
    want = flash_prefill_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **TOL_DENSE[dtype])
