"""QuantPlane slice of the PyTorch port against the JAX reference: int8
paged KV arenas with their scale plane.

- Formats and writes: `quant_tokens`, `seal_blocks` (null block exempt,
  duplicate ids) and the three writes (decode append with unseal-on-open
  and seal-on-full, chunk write with padded rows, the speculative commit
  with rejected rows) land the same int8 bytes and float32 scales as the
  reference, outside the null block 0 (duplicate writes land there in any
  order). The reference runs its writes under jit, where XLA folds the
  division by 127 into a product with float32(1/127); its jitted functions
  are the oracle, as in its servers.
- The kernels' plain versions with the scale plane against the Pallas
  kernels in interpret mode and the `kernels/ref.py` oracles (the
  tests/test_kernels.py quant sweeps: bs 8/16, G 1/4, half the blocks
  sealed), float32 within 1e-5; the model-layout plain paths, summaries and
  attention mass over dequantized content.
- `QuantController` validation, degradation and figures equal the
  reference's.
- Servers on the reduced 2-layer qwen2-1.5b (tests/test_quant.py's model)
  and reduced qwen2-moe-a2.7b, on the reference's bridged weights: greedy
  streams and quant stats equal to the JAX quant `Server`'s in six
  scenarios (end to end, prefix sharing under pressure, preemption with
  the sidecar, speculation, online top-k, MoE), with the pool, summary and
  scale invariants green at quiescence.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import reduced_config
from repro.core.proxy import OASConfig
from repro.distributed.ctx import MeshCtx, local_mesh_ctx
from repro.kernels import ref
from repro.kernels.paged_decode import paged_decode as j_paged_decode
from repro.kernels.paged_prefill import paged_prefill as j_paged_prefill
from repro.kernels.spec_verify import spec_verify as j_spec_verify
from repro.models import LM
from repro.models import attention as ja
from repro.serving import SamplingParams, Server, ServerConfig
from repro.serving.quant import QuantConfig, QuantController
from repro.serving.spec import SpecConfig
from repro_torch import bridge
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.core.proxy import OASConfig as TOASConfig
from repro_torch.core.proxy import SamplingParams as TSamplingParams
from repro_torch.kernels.paged_decode import paged_decode
from repro_torch.kernels.paged_prefill import paged_prefill
from repro_torch.kernels.spec_verify import spec_verify
from repro_torch.models import attention as ta
from repro_torch.models.lm import LM as TLM
from repro_torch.models.stack import alloc_arena_kv
from repro_torch.serving import DecodeEngine as TDecodeEngine
from repro_torch.serving import Server as TServer
from repro_torch.serving import ServerConfig as TServerConfig
from repro_torch.serving.arena import KVArena as TKVArena
from repro_torch.serving.quant import QuantConfig as TQuantConfig
from repro_torch.serving.quant import QuantController as TQuantController
from repro_torch.serving.spec import SpecConfig as TSpecConfig

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
QUANT_LEAVES = ("k", "v", "kscale", "vscale", "ktok", "vtok")
J_QUANT_TOKENS = jax.jit(ja.quant_tokens)
J_SEAL = jax.jit(ja.seal_blocks)
J_DECODE_WRITE = jax.jit(ja.quant_paged_cache_write)
J_PREFILL_WRITE = jax.jit(ja.quant_paged_prefill_write)
J_TOKENS_WRITE = jax.jit(ja.quant_paged_cache_write_tokens)
# the oracles run jitted (as tests/test_torch_kernels.py runs them); the
# Pallas kernels run in interpret mode at G = 4 (the slow path of the file)
PD_REF = jax.jit(ref.paged_decode_ref)
PP_REF = jax.jit(ref.paged_prefill_ref)
SV_REF = jax.jit(ref.spec_verify_ref)


def _t(x):
    return torch.from_numpy(np.array(x))


def _entry_np(rng, N, K, bs, h, n_sealed):
    """A used int8 arena entry: blocks 1..n_sealed sealed (a nonzero
    per-channel row, zero token row), the rest unsealed per-token content,
    block 0 empty."""
    x = rng.standard_normal((N, bs, K, h)).astype(np.float32)
    q, ts = (np.asarray(a) for a in J_QUANT_TOKENS(jnp.asarray(x)))
    e = {"k": q.transpose(0, 2, 1, 3).copy(), "ktok": ts.transpose(0, 2, 1)
         .copy(), "kscale": np.zeros((N, K, h), np.float32)}
    x = rng.standard_normal((N, bs, K, h)).astype(np.float32)
    q, ts = (np.asarray(a) for a in J_QUANT_TOKENS(jnp.asarray(x)))
    e.update(v=q.transpose(0, 2, 1, 3).copy(),
             vtok=ts.transpose(0, 2, 1).copy(),
             vscale=np.zeros((N, K, h), np.float32))
    blocks = np.arange(1, n_sealed + 1)
    for n in ("k", "v"):
        p, s, t = J_SEAL(jnp.asarray(e[n]), jnp.asarray(e[n + "scale"]),
                         jnp.asarray(e[n + "tok"]), jnp.asarray(blocks),
                         jnp.ones(len(blocks), bool))
        e[n], e[n + "scale"], e[n + "tok"] = (np.array(a) for a in (p, s, t))
    for n in QUANT_LEAVES:
        e[n][0] = 0
    return e


def _assert_entries_equal(tent, jent, what):
    for n in QUANT_LEAVES:
        np.testing.assert_array_equal(tent[n].numpy()[1:],
                                      np.asarray(jent[n])[1:],
                                      err_msg=f"{what}: {n}")


# ---- formats and writes ----------------------------------------------
def test_quant_tokens_bit_identical():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 2, 32)).astype(np.float32) \
        * rng.uniform(0.01, 20.0, (64, 2, 1)).astype(np.float32)
    x[3, 1] = 0.0                                   # a zero token
    # exact halves on the 127-step grid: ts = 1, rounding half to even
    x[5, 0, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -3.5]
    x[5, 0, 6:] = 0.0
    jq, jt = J_QUANT_TOKENS(jnp.asarray(x))
    tq, tt = ta.quant_tokens(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and tt.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tq[5, 0, :6].tolist() == [127, 0, 2, 2, 0, -4]
    assert not tq[3, 1].any() and float(tt[3, 1]) == 0.0
    # a pure per-token function: any split lands the same ints and scales
    a, b = ta.quant_tokens(torch.from_numpy(x[:7])), \
        ta.quant_tokens(torch.from_numpy(x[7:]))
    assert torch.equal(torch.cat([a[0], b[0]]), tq)
    assert torch.equal(torch.cat([a[1], b[1]]), tt)


def test_seal_blocks_bit_identical_null_exempt_and_duplicates():
    rng = np.random.default_rng(1)
    N, K, bs, h = 7, 2, 8, 32
    e = _entry_np(rng, N, K, bs, h, 0)
    e["k"][0] = rng.integers(-127, 128, (K, bs, h))    # null block content
    e["ktok"][0] = 0.5
    blocks = np.array([0, 2, 3, 2, 5, 0], np.int32)    # duplicate ids
    do = np.array([True, True, False, True, True, False])
    jp, js, jt = J_SEAL(jnp.asarray(e["k"]), jnp.asarray(e["kscale"]),
                        jnp.asarray(e["ktok"]), jnp.asarray(blocks),
                        jnp.asarray(do))
    tp, tsc, ttk = _t(e["k"]), _t(e["kscale"]), _t(e["ktok"])
    ta.seal_blocks(tp, tsc, ttk, _t(blocks), _t(do))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ttk.numpy(), np.asarray(jt))
    # the null block keeps its content and never seals; block 3 (do False)
    # is untouched; sealed blocks have a nonzero row and a zeroed token row
    np.testing.assert_array_equal(tp.numpy()[0], e["k"][0])
    assert not tsc[0].any() and not tsc[3].any()
    np.testing.assert_array_equal(tp.numpy()[3], e["k"][3])
    for b in (2, 5):
        assert tsc[b].any() and not ttk[b].any()
    # within one per-channel grid step of the per-token content it replaced
    pre = ta.dequant_pages(_t(e["k"]), _t(e["kscale"]), _t(e["ktok"]))
    post = ta.dequant_pages(tp, tsc, ttk)
    assert float((post[2] - pre[2]).abs().max()) <= float(tsc[2].max())


def test_three_writes_bit_identical():
    """Decode append (unseal-on-open on a stale sealed block, seal-on-full,
    a freed slot on the null block), chunk write (mid-block offset, padded
    rows, a block sealed by the chunk) and the speculative commit (rejected
    rows redirected to the null block, a seal inside the window), applied
    in turn to one used arena: the same bytes as the reference after each."""
    rng = np.random.default_rng(2)
    N, K, bs, h = 12, 2, 8, 32
    e = _entry_np(rng, N, K, bs, h, 4)
    jent = {n: jnp.asarray(x) for n, x in e.items()}
    tent = {n: _t(x) for n, x in e.items()}

    # chunk 1: 13 rows from offset 0 over table [3 (stale sealed), 6, 7]:
    # opens block 3 (unseal), fills and seals it, opens block 6
    S = 16
    tables = np.array([[3, 6, 7, 0]], np.int32)
    for off, cl in ((0, 13), (13, 7)):
        # chunk 2: 7 real rows of 16 from mid-block offset 13: seals block
        # 6, opens block 7; the padded rows go to the null block
        kn = rng.standard_normal((1, S, K, h)).astype(np.float32)
        vn = rng.standard_normal((1, S, K, h)).astype(np.float32)
        jent = J_PREFILL_WRITE(jent, jnp.asarray(kn), jnp.asarray(vn),
                               jnp.asarray(tables), off, cl)
        ta.quant_paged_prefill_write(tent, _t(kn), _t(vn), _t(tables), off,
                                     cl)
        _assert_entries_equal(tent, jent, f"chunk write at {off}")
    for b in (3, 6):
        assert tent["kscale"][b].any() and not tent["ktok"][b].any()
    assert not tent["kscale"][7].any()

    # decode: slot 0 opens stale sealed block 2 (offset 0), slot 1 fills
    # block 10 (offset bs - 1: seals), slot 2 is a freed slot on block 0
    B = 3
    kn = rng.standard_normal((B, K, h)).astype(np.float32)
    vn = rng.standard_normal((B, K, h)).astype(np.float32)
    blk = np.array([2, 10, 0], np.int32)
    offs = np.array([0, bs - 1, bs - 1], np.int32)
    assert tent["kscale"][2].any()                     # stale seal before
    jent = J_DECODE_WRITE(jent, jnp.asarray(kn), jnp.asarray(vn),
                          jnp.asarray(blk), jnp.asarray(offs))
    ta.quant_paged_cache_write(tent, _t(kn), _t(vn), _t(blk), _t(offs))
    _assert_entries_equal(tent, jent, "decode append")
    assert not tent["kscale"][2].any(), "stale seal survived the open"
    assert tent["kscale"][10].any() and not tent["ktok"][10].any()

    # commit: slot 0 lands rows at offsets 6, 7 of block 8 (seals it) and
    # 0, 1 of stale sealed block 4 (unseals it); slot 1's rejected rows go
    # to the null block
    S = 4
    kn = rng.standard_normal((2, S, K, h)).astype(np.float32)
    vn = rng.standard_normal((2, S, K, h)).astype(np.float32)
    blk = np.array([[8, 8, 4, 4], [0, 0, 0, 0]], np.int32)
    offs = np.array([[6, 7, 0, 1], [3, 4, 5, 6]], np.int32)
    assert tent["kscale"][4].any()
    jent = J_TOKENS_WRITE(jent, jnp.asarray(kn), jnp.asarray(vn),
                          jnp.asarray(blk), jnp.asarray(offs))
    ta.quant_paged_cache_write_tokens(tent, _t(kn), _t(vn), _t(blk),
                                      _t(offs))
    _assert_entries_equal(tent, jent, "commit")
    assert tent["kscale"][8].any() and not tent["kscale"][4].any()


# ---- kernels' plain versions with the scale plane ----------------------
def _quant_pages(rng, N, K, bs, h, n_sealed):
    """The reference sweep's int8 arenas (tests/test_kernels.py:
    _quantize_pages): blocks < n_sealed sealed with per-channel scales, the
    rest per-token."""
    e = _entry_np(rng, N, K, bs, h, 0)
    x = rng.standard_normal((N, K, bs, h)).astype(np.float32)
    sc_full = np.abs(x).max(axis=2) / np.float32(127)
    sealed = np.arange(N) < n_sealed
    qs = np.clip(np.round(x / np.where(sc_full > 0, sc_full, 1)[:, :, None]),
                 -127, 127).astype(np.int8)
    k = np.where(sealed[:, None, None, None], qs, e["k"])
    sc = np.where(sealed[:, None, None], sc_full, 0).astype(np.float32)
    tk = np.where(sealed[:, None, None], 0, e["ktok"]).astype(np.float32)
    return k, sc, tk


def _scales(rng, N, K, bs, h):
    kq, ks, kt = _quant_pages(rng, N, K, bs, h, N // 2)
    vq, vs, vt = _quant_pages(rng, N, K, bs, h, N // 2)
    return kq, vq, dict(k_scale=ks, k_tok=kt, v_scale=vs, v_tok=vt)


def _jt(d):
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: _t(v) for k, v in d.items()})


@pytest.mark.parametrize("bs,nb", [(8, 6), (16, 4)])
@pytest.mark.parametrize("G", [1, 4])
def test_paged_decode_quant_plain_matches_reference(bs, nb, G):
    rng = np.random.default_rng(bs * nb + G + 101)
    B, K, h, N = 3, 2, 32, 24
    q = rng.standard_normal((B, K, G, h)).astype(np.float32)
    kq, vq, sc = _scales(rng, N, K, bs, h)
    tables = rng.integers(1, N, (B, nb)).astype(np.int32)
    lens = np.array([1, max(nb * bs // 2 - 3, 1), nb * bs], np.int32)
    jsc, tsc = _jt(sc)
    args = [jnp.asarray(a) for a in (q, kq, vq, tables, lens)]
    want = PD_REF(*args, **jsc)
    got = paged_decode(*(_t(a) for a in (q, kq, vq, tables, lens)), **tsc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if G == 4:
        pallas = j_paged_decode(*args, **jsc, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    # the model-layout plain path over the same arenas
    got_m = ta.paged_decode_attention(_t(q).reshape(B, K * G, h),
                                      *(_t(a) for a in (kq, vq, tables,
                                                        lens)), **tsc)
    want_m = ja.paged_decode_attention(jnp.asarray(q).reshape(B, K * G, h),
                                       *args[1:], **jsc)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), **TOL)


@pytest.mark.parametrize("bs,S", [(8, 8), (16, 8)])
@pytest.mark.parametrize("G", [1, 4])
def test_paged_prefill_quant_plain_matches_reference(bs, S, G):
    rng = np.random.default_rng(bs + S * G + 202)
    B, K, h, N, nb = 2, 2, 32, 24, 5
    q = rng.standard_normal((B, K, S * G, h)).astype(np.float32)
    kn = rng.standard_normal((B, K, S, h)).astype(np.float32)
    vn = rng.standard_normal((B, K, S, h)).astype(np.float32)
    kq, vq, sc = _scales(rng, N, K, bs, h)
    tables = rng.integers(1, N, (B, nb)).astype(np.int32)
    off = np.array([0, nb * bs // 2 - 3], np.int32)
    cl = np.array([S, max(S - 3, 1)], np.int32)
    jsc, tsc = _jt(sc)
    arrs = (q, kn, vn, kq, vq, tables, off, cl)
    args = [jnp.asarray(a) for a in arrs]
    want = np.asarray(PP_REF(*args, **jsc))
    got = paged_prefill(*(_t(a) for a in arrs), **tsc).numpy()
    pallas = np.asarray(j_paged_prefill(*args, **jsc, interpret=True)) \
        if G == 4 else want
    for b in range(B):
        real = int(cl[b]) * G
        np.testing.assert_allclose(got[b, :, :real], want[b, :, :real],
                                   **TOL)
        np.testing.assert_allclose(got[b, :, :real], pallas[b, :, :real],
                                   **TOL)
    # the model-layout plain path (one chunk, B=1, off 11, 6 real rows)
    qm = rng.standard_normal((1, S, K * G, h)).astype(np.float32)
    knm = rng.standard_normal((1, S, K, h)).astype(np.float32)
    vnm = rng.standard_normal((1, S, K, h)).astype(np.float32)
    got_m = ta.paged_prefill_attention(
        *(_t(a) for a in (qm, knm, vnm, kq, vq, tables[:1])), 11, 6, **tsc)
    want_m = ja.paged_prefill_attention(
        *(jnp.asarray(a) for a in (qm, knm, vnm, kq, vq, tables[:1])), 11, 6,
        **jsc)
    np.testing.assert_allclose(got_m.numpy()[:, :6],
                               np.asarray(want_m)[:, :6], **TOL)


@pytest.mark.parametrize("bs,S", [(8, 4), (16, 5)])
@pytest.mark.parametrize("G", [1, 4])
def test_spec_verify_quant_plain_matches_reference(bs, S, G):
    rng = np.random.default_rng(bs * S + G + 303)
    B, K, h, N, nb = 3, 2, 32, 20, 4
    q = rng.standard_normal((B, K, S * G, h)).astype(np.float32)
    kn = rng.standard_normal((B, K, S, h)).astype(np.float32)
    vn = rng.standard_normal((B, K, S, h)).astype(np.float32)
    kq, vq, sc = _scales(rng, N, K, bs, h)
    tables = rng.integers(1, N, (B, nb)).astype(np.int32)
    off = np.array([0, bs + bs // 2 - 1, nb * bs], np.int32)
    nt = np.array([S, max(S - 2, 1), 1], np.int32)
    jsc, tsc = _jt(sc)
    arrs = (q, kn, vn, kq, vq, tables, off, nt)
    args = [jnp.asarray(a) for a in arrs]
    want = np.asarray(SV_REF(*args, **jsc))
    got = spec_verify(*(_t(a) for a in arrs), **tsc).numpy()
    pallas = np.asarray(j_spec_verify(*args, **jsc, interpret=True)) \
        if G == 4 else want
    for b in range(B):
        real = int(nt[b]) * G
        np.testing.assert_allclose(got[b, :, :real], want[b, :, :real],
                                   **TOL)
        np.testing.assert_allclose(got[b, :, :real], pallas[b, :, :real],
                                   **TOL)


def test_dequant_matches_reference_oracle():
    rng = np.random.default_rng(4)
    kq, ks, kt = _quant_pages(rng, 9, 2, 8, 32, 4)
    want = ref.dequant_pages_ref(*(jnp.asarray(a) for a in (kq, ks, kt)))
    got = ta.dequant_pages(_t(kq), _t(ks), _t(kt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_summaries_and_mass_over_dequantized_content():
    rng = np.random.default_rng(5)
    N, K, bs, h, B, nb, G = 14, 2, 8, 32, 3, 4, 3
    kq, ks, kt = _quant_pages(rng, N, K, bs, h, 6)
    zeros = np.zeros((N, K, h), np.float32)
    blocks = np.array([0, 3, 7, 7, 12], np.int32)
    want = jax.jit(ja.update_block_summaries)(
        *(jnp.asarray(zeros) for _ in range(3)), jnp.asarray(kq),
        jnp.asarray(blocks), k_scale=jnp.asarray(ks), k_tok=jnp.asarray(kt))
    got = ta.update_block_summaries(*(_t(zeros) for _ in range(3)), _t(kq),
                                    _t(blocks), k_scale=_t(ks),
                                    k_tok=_t(kt))
    for g, w in zip(got[:2], want[:2]):                 # min, max: exact
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-6, atol=1e-7)
    q = rng.standard_normal((B, K * G, h)).astype(np.float32)
    tables = rng.integers(1, N, (B, nb)).astype(np.int32)
    lens = np.array([5, 17, 32], np.int32)
    sel = rng.random((B, nb)) < 0.5
    wm = ja.selected_attention_mass(
        *(jnp.asarray(a) for a in (q, kq, tables, lens, sel)),
        k_scale=jnp.asarray(ks), k_tok=jnp.asarray(kt))
    gm = ta.selected_attention_mass(*(_t(a) for a in (q, kq, tables, lens,
                                                       sel)),
                                    k_scale=_t(ks), k_tok=_t(kt))
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), **TOL)


# ---- controller ------------------------------------------------------
def test_controller_matches_reference():
    kw = dict(compute_dtype="float32", param_dtype="float32", n_layers=2)
    cfg = reduced_config("qwen2-1.5b").with_updates(**kw)
    tcfg = t_reduced_config("qwen2-1.5b").with_updates(**kw)
    lm = LM.build(cfg, local_mesh_ctx(), pattern=[0, 0])
    tlm = TLM.build(tcfg, pattern=[0, 0], device="cpu")
    assert TQuantController.from_model(tcfg, tlm.plan, None, 16) is None
    for bad, kw2 in ((TQuantConfig(bits=4), {}),
                     (TQuantConfig(), dict(paged_kv=False))):
        with pytest.raises(ValueError):
            TQuantController.from_model(tcfg, tlm.plan, bad, 16, **kw2)
    for bs in (8, 16):
        j = QuantController.from_model(cfg, lm.plan, QuantConfig(), bs)
        t = TQuantController.from_model(tcfg, tlm.plan, TQuantConfig(), bs)
        assert vars(t.plan) == vars(j.plan)
        assert t.compression() == j.compression() > 1.9
        js, tst = QuantController.stats_keys(), TQuantController.stats_keys()
        j.note(js)
        t.note(tst)
        assert tst == js
    bf = tcfg.with_updates(compute_dtype="bfloat16")
    jb = QuantController.from_model(cfg.with_updates(
        compute_dtype="bfloat16"), lm.plan, QuantConfig(), 16)
    tb = TQuantController.from_model(bf, tlm.plan, TQuantConfig(), 16)
    assert vars(tb.plan) == vars(jb.plan)
    # an all-ring stack has nothing to quantize: quant off, no error
    ring = TLM.build(tcfg, pattern=[1, 1], device="cpu")
    assert TQuantController.from_model(tcfg, ring.plan, TQuantConfig(),
                                       16) is None


def test_quant_off_tree_has_no_scale_leaves():
    tcfg = t_reduced_config("qwen2-1.5b").with_updates(
        compute_dtype="float32", param_dtype="float32", n_layers=2)
    lm = TLM.build(tcfg, pattern=[0, 0], device="cpu")
    off, on = TKVArena.build(lm, 6), TKVArena.build(lm, 6, quant=True)
    assert not off.quant and on.quant
    for e in off.kv:
        assert set(e) == {"k", "v", "kmin", "kmax", "kmean"}
        assert e["k"].dtype == torch.float32
    for e in on.kv:
        assert set(e) == {"k", "v", "kmin", "kmax", "kmean", "kscale",
                          "vscale", "ktok", "vtok"}
        assert e["k"].dtype == torch.int8
        assert e["ktok"].shape == (7, tcfg.n_kv_heads, 16)
    ratio = on.block_nbytes / off.block_nbytes
    assert ratio < 0.55, ratio
    # plain trees from alloc_arena_kv are unchanged by the quant option
    plain = alloc_arena_kv(tcfg, lm.plan, 7, 16, "cpu")
    assert all(set(e) == set(off.kv[0]) for e in plain)


def test_copy_block_carries_the_scale_plane():
    tcfg = t_reduced_config("qwen2-1.5b").with_updates(
        compute_dtype="float32", param_dtype="float32", n_layers=2)
    arena = TKVArena.build(TLM.build(tcfg, pattern=[0, 0], device="cpu"), 6,
                           block_size=8, quant=True)
    rng = np.random.default_rng(6)
    for e in arena.kv:
        kn = torch.from_numpy(rng.standard_normal(
            (1, 8, tcfg.n_kv_heads, tcfg.head_dim)).astype(np.float32))
        ta.quant_paged_prefill_write(e, kn, -kn, torch.tensor([[2, 0]]), 0,
                                     8)                 # block 2 sealed
        ta.quant_paged_prefill_write(e, kn, kn, torch.tensor([[3, 0]]), 0,
                                     5)                 # block 3 unsealed;
        # its padded rows land in the null block
        ta.update_block_summaries(e["kmin"], e["kmax"], e["kmean"], e["k"],
                                  torch.tensor([0, 2, 3]),
                                  k_scale=e["kscale"],
                                  k_tok=e["ktok"])
    arena.copy_block(2, 4)
    arena.copy_block(3, 5)
    for e in arena.kv:
        for n, x in e.items():
            assert torch.equal(x[4], x[2]) and torch.equal(x[5], x[3]), n
        assert e["kscale"][4].any() and not e["kscale"][5].any()
    arena.check_summaries()


# ---- servers ---------------------------------------------------------
SCFG = dict(n_prefill=1, n_decode=1, decode_slots=4, max_len=96,
            chunk_tokens=16, prefill_tick_budget=64)
QSTATS = ("quant_layers", "quant_block_bytes", "quant_block_bytes_f32")


def auto_mesh():
    return MeshCtx(jax.make_mesh((1, 1), ("data", "model"),
                                 axis_types=(AxisType.Auto,) * 2))


def _pair(arch, scfg, cfg_kw=None, jspec=None, tspec=None, mesh=None):
    """The JAX quant Server and the port's on its bridged weights."""
    kw = dict(compute_dtype="float32", param_dtype="float32",
              **(cfg_kw or {}))
    if arch == "qwen2-1.5b":
        kw.setdefault("n_layers", 2)
    cfg = reduced_config(arch).with_updates(**kw)
    tcfg = t_reduced_config(arch).with_updates(**kw)
    pattern = [0] * cfg.n_layers
    jsrv = Server(cfg, ServerConfig(**scfg, spec=jspec, quant=QuantConfig(),
                                    oas=OASConfig(defer_window=0.0)),
                  mesh=mesh, pattern=pattern)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jsrv.params),
                                       tcfg, jsrv.lm.plan, device="cpu")
    tsrv = TServer(tcfg, TServerConfig(**scfg, spec=tspec,
                                       quant=TQuantConfig(),
                                       oas=TOASConfig(defer_window=0.0)),
                   pattern=pattern, params=tparams, device="cpu")
    return cfg, jsrv, tsrv


def _run_both(jsrv, tsrv, prompts, n_new):
    js = jsrv.run([(p, SamplingParams(max_tokens=n_new)) for p in prompts],
                  max_wall_s=600)
    ts = tsrv.run([(p, TSamplingParams(max_tokens=n_new)) for p in prompts],
                  max_wall_s=600)
    jout = {r.rid: tuple(r.output_tokens) for r in jsrv.metrics.done}
    tout = {r.rid: tuple(r.output_tokens) for r in tsrv.metrics.done}
    assert len(tout) == len(prompts) and tout == jout
    jd, td = js["decode_stats"][0], ts["decode_stats"][0]
    assert {k: td[k] for k in QSTATS} == {k: jd[k] for k in QSTATS}
    assert td["host_fetches"] == td["steps"] > 0
    assert tsrv.kv_arena.quant
    tsrv.kv_arena.pool.check_invariants(arena=tsrv.kv_arena)
    return js, ts


def _prompts(vocab, lens, seed, base=()):
    rng = np.random.default_rng(seed)
    return [tuple(base) + tuple(int(t) for t in rng.integers(0, vocab, n))
            for n in lens]


def test_server_quant_streams_match_jax():
    cfg, jsrv, tsrv = _pair("qwen2-1.5b", SCFG)
    _, ts = _run_both(jsrv, tsrv, _prompts(cfg.vocab_size, [12] * 4, 11),
                      18)                      # 30 tokens: crosses a seal
    ds = ts["decode_stats"][0]
    assert ds["quant_layers"] == 2
    assert ds["quant_block_bytes"] * 1.9 < ds["quant_block_bytes_f32"]
    assert any(e["kscale"][1:].any() for e in tsrv.kv_arena.kv)


def test_server_quant_prefix_sharing_under_pressure():
    rng = np.random.default_rng(12)
    cfg, jsrv, tsrv = _pair("qwen2-1.5b", dict(SCFG, kv_blocks=22))
    base = tuple(int(t) for t in rng.integers(0, cfg.vocab_size, 24))
    _, ts = _run_both(jsrv, tsrv, _prompts(cfg.vocab_size, [28] * 6, 13,
                                           base), 10)
    assert ts["prefill_stats"][0]["prefix_hits"] >= 1


def test_server_quant_preemption_round_trip():
    """A pool too small for every slot preempts: the extracted cache holds
    the dequantized view and the raw int8 sidecar, re-admission scatters
    the sidecar back verbatim, and the streams equal the JAX quant
    server's."""
    scfg = dict(SCFG, decode_slots=3, kv_blocks=12, kv_block_size=8)
    cfg, jsrv, tsrv = _pair("qwen2-1.5b", scfg)
    records = []
    de = tsrv.decodes[0]
    orig = de._preempt

    def spy(rid):
        rec = orig(rid)
        records.append(rec)
        return rec
    de._preempt = spy
    _, ts = _run_both(jsrv, tsrv, _prompts(cfg.vocab_size, [30] * 3, 14),
                      20)
    assert ts["decode_stats"][0]["preemptions"] > 0 and records
    for _, cache_one, _, _ in records:
        for e in cache_one["layers"]:
            assert {"kq", "kscale", "ktok", "vq", "vscale", "vtok"} <= set(e)
            assert e["kq"].dtype == torch.int8
            # the dense view is the dequantized sidecar
            deq = ta.dequant_pages(e["kq"][0], e["kscale"][0],
                                   e["ktok"][0])
            L = e["k"].shape[1]
            assert torch.equal(deq.transpose(1, 2).reshape(
                -1, deq.shape[1], deq.shape[3])[:L], e["k"][0])


def test_server_quant_spec_compose():
    rng = np.random.default_rng(15)
    cfg, jsrv, tsrv = _pair("qwen2-1.5b", SCFG, jspec=SpecConfig(k=4),
                            tspec=TSpecConfig(k=4))
    gram = tuple(int(t) for t in rng.integers(0, cfg.vocab_size, 6))
    prompts = [gram * 3, gram * 3] + _prompts(cfg.vocab_size, [18, 18], 16)
    js, ts = _run_both(jsrv, tsrv, prompts, 12)
    for k in ("spec_drafted", "spec_accepted", "spec_verifies"):
        assert ts[k] == js[k], k
    assert ts["spec_accepted"] > 0


def test_server_quant_topk_compose():
    topk = dict(vocab_size=128, omniattn_topk_blocks=3,
                omniattn_topk_measure_mass=True)
    cfg, jsrv, tsrv = _pair("qwen2-1.5b", dict(SCFG, max_len=128,
                                               kv_block_size=8), topk)
    js, ts = _run_both(jsrv, tsrv, _prompts(128, [50, 70, 33, 60], 17), 8)
    for k in ("blocks_scored", "blocks_attended"):
        assert ts[k] == js[k] > 0, k
    assert ts["blocks_attended"] < ts["blocks_scored"]
    assert ts["attn_mass_kept"] == pytest.approx(js["attn_mass_kept"],
                                                 rel=1e-5)


def test_server_quant_moe_matches_jax():
    """MoE and quant share `attn_sublayer`: reduced qwen2-moe-a2.7b on int8
    arenas (the reference built on an Auto mesh, ROADMAP C1)."""
    cfg, jsrv, tsrv = _pair("qwen2-moe-a2.7b", SCFG, mesh=auto_mesh())
    _run_both(jsrv, tsrv, _prompts(cfg.vocab_size, [20, 9, 26], 18), 8)


def test_dense_admission_quantizes_per_token_unsealed():
    """Dense admission into an int8 arena goes through quant_tokens (never a
    cast): a fresh float cache lands per-token quantized, every block
    unsealed, as the reference admits it."""
    tcfg = t_reduced_config("qwen2-1.5b").with_updates(
        compute_dtype="float32", param_dtype="float32", n_layers=2)
    lm = TLM.build(tcfg, pattern=[0, 0], device="cpu")
    params = lm.init(seed=3)
    arena = TKVArena.build(lm, 8, block_size=8, quant=True)
    de = TDecodeEngine(lm, params, 2, 32, arena=arena)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, tcfg.vocab_size, (1, 20)).astype(np.int32))
    cache, _, _ = lm.prefill(params, toks, max_len=32)
    assert de.admit_batch([(0, cache, 5, 20, 0)]) == {0: True}
    tbl = de.tables_h[de.rid_slot[0]][:3]
    for e, o in zip(arena.kv, cache["layers"]):
        q, ts = ta.quant_tokens(o["k"][0, :24])
        assert torch.equal(e["k"][tbl].transpose(1, 2).reshape(q.shape), q)
        assert not e["kscale"][tbl].any()
    arena.check_summaries()
