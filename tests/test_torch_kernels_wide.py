"""The kernels' plain versions at the shapes phase 13's decoders and phase
16's frontend families bring, on the CPU, against `repro.kernels.ref` and
(one small case each) the Pallas kernels in interpret mode: gemma3-4b's
head width (h 256, K 4, G 2), granite-34b's GQA group (K 1, G 48 at h
128), hubert-xlarge's h 80 (G 1, bidirectional in flash_prefill) and
phi-3-vision's h 96 (with a GQA group of 2 beside its G 1), float32 and
int8 where the
kernel has an int8 path (pages written as the QuantPlane writes them:
sealed blocks with per-channel scales, unsealed tails with per-token
scales). The CUDA kernels themselves are held to these plain versions on
the card (tests/test_torch_kernels_gpu.py, `chip_smoke.py` phase 2).
Tolerances: float32 1e-5 for the paged kernels and block_topk, 2e-5 for
flash_prefill and sink_decode (tests/test_torch_kernels.py's: the same
math, sums in another order); the reference's sums over 256 channels and
48-row groups keep that order of error.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.block_topk import block_topk_scores as j_block_topk
from repro.kernels.flash_prefill import flash_prefill as j_flash_prefill
from repro.kernels.paged_decode import paged_decode as j_paged_decode
from repro.kernels.paged_prefill import paged_prefill as j_paged_prefill
from repro.kernels.sink_decode import sink_decode as j_sink_decode
from repro.kernels.spec_verify import spec_verify as j_spec_verify
from repro_torch.kernels.block_topk import block_topk_scores_plain
from repro_torch.kernels.flash_prefill import flash_prefill_plain
from repro_torch.kernels.paged_decode import paged_decode_plain
from repro_torch.kernels.paged_prefill import paged_prefill_plain
from repro_torch.kernels.sink_decode import sink_decode_plain
from repro_torch.kernels.spec_verify import spec_verify_plain

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_DENSE = dict(rtol=2e-5, atol=2e-5)
# (K, G, h): gemma3-4b's global layers, granite-34b's single kv head,
# hubert-xlarge's and phi-3-vision's head dims (fewer heads)
SHAPES = {"h256": (4, 2, 256), "g48": (1, 48, 128), "h80": (2, 1, 80),
          "h96": (2, 2, 96)}
PD_REF = jax.jit(ref.paged_decode_ref)
PP_REF = jax.jit(ref.paged_prefill_ref, static_argnames=("window", "sink"))
SV_REF = jax.jit(ref.spec_verify_ref)
FP_REF = jax.jit(ref.flash_prefill_ref,
                 static_argnames=("causal", "window", "sink"))


def _f32(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _int8_plane(rng, N, K, bs, h):
    """int8 pages with a scale plane: even blocks sealed (per-channel
    scales), odd blocks an unsealed tail (per-token scales, channel row
    zero)."""
    kq = rng.integers(-127, 128, (N, K, bs, h)).astype(np.int8)
    vq = rng.integers(-127, 128, (N, K, bs, h)).astype(np.int8)
    sc = {}
    for n in ("k", "v"):
        seal = (rng.random((N, K, h)).astype(np.float32) + 0.1) / 127
        seal[1::2] = 0.0
        sc[f"{n}_scale"] = seal
        sc[f"{n}_tok"] = (rng.random((N, K, bs)).astype(np.float32)
                          + 0.1) / 127
    return kq, vq, sc


def _both(d):
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.from_numpy(v) for k, v in d.items()})


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_paged_decode_plain_matches_reference(shape, int8):
    K, G, h = SHAPES[shape]
    rng = np.random.default_rng(len(shape) + int8)
    B, bs, nb = 3, 16, 6
    N = B * nb + 1
    q = _f32(rng, (B, K, G, h))
    tables = rng.permutation(np.arange(1, N))[:B * nb].reshape(B, nb) \
        .astype(np.int32)
    lens = np.array([1, 40, nb * bs], np.int32)
    if int8:
        kp, vp, sc = _int8_plane(rng, N, K, bs, h)
    else:
        kp, vp, sc = _f32(rng, (N, K, bs, h)), _f32(rng, (N, K, bs, h)), {}
    jsc, tsc = _both(sc)
    args = (q, kp, vp, tables, lens)
    want = PD_REF(*map(jnp.asarray, args), **jsc)
    got = paged_decode_plain(*map(torch.from_numpy, args), **tsc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if not int8 and shape == "h256":
        pallas = j_paged_decode(*map(jnp.asarray, args), interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


def _history_case(rng, K, S, G, h, B=2, bs=16, nb=5):
    N = B * nb + 1
    q = _f32(rng, (B, K, S * G, h))
    kn, vn = _f32(rng, (B, K, S, h)), _f32(rng, (B, K, S, h))
    tables = rng.permutation(np.arange(1, N)).reshape(B, nb).astype(np.int32)
    return q, kn, vn, tables, N


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_paged_prefill_plain_matches_reference(shape, int8):
    K, G, h = SHAPES[shape]
    rng = np.random.default_rng(10 + len(shape) + int8)
    S, bs = 16, 16
    q, kn, vn, tables, N = _history_case(rng, K, S, G, h)
    if int8:
        kp, vp, sc = _int8_plane(rng, N, K, bs, h)
    else:
        kp, vp, sc = _f32(rng, (N, K, bs, h)), _f32(rng, (N, K, bs, h)), {}
    jsc, tsc = _both(sc)
    off = np.array([0, 37], np.int32)
    cl = np.array([S, 9], np.int32)
    kw = dict(window=24, sink=4) if shape == "h256" and not int8 else {}
    args = (q, kn, vn, kp, vp, tables, off, cl)
    want = np.asarray(PP_REF(*map(jnp.asarray, args), **kw, **jsc))
    got = paged_prefill_plain(*map(torch.from_numpy, args), **kw,
                              **tsc).numpy()
    pallas = None
    if not int8 and shape == "h256":
        pallas = np.asarray(j_paged_prefill(*map(jnp.asarray, args),
                                            interpret=True, **kw))
    for b in range(2):            # padded chunk rows are padding both sides
        real = int(cl[b]) * G
        np.testing.assert_allclose(got[b, :, :real], want[b, :, :real], **TOL)
        if pallas is not None:
            np.testing.assert_allclose(got[b, :, :real], pallas[b, :, :real],
                                       **TOL)
    assert np.all(np.isfinite(got))


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_spec_verify_plain_matches_reference(shape, int8):
    K, G, h = SHAPES[shape]
    rng = np.random.default_rng(20 + len(shape) + int8)
    S, bs = 5, 16
    q, kn, vn, tables, N = _history_case(rng, K, S, G, h, B=3, nb=4)
    if int8:
        kp, vp, sc = _int8_plane(rng, N, K, bs, h)
    else:
        kp, vp, sc = _f32(rng, (N, K, bs, h)), _f32(rng, (N, K, bs, h)), {}
    jsc, tsc = _both(sc)
    off = np.array([0, 23, 64], np.int32)
    ntok = np.array([S, 3, 1], np.int32)
    args = (q, kn, vn, kp, vp, tables, off, ntok)
    want = np.asarray(SV_REF(*map(jnp.asarray, args), **jsc))
    got = spec_verify_plain(*map(torch.from_numpy, args), **tsc).numpy()
    pallas = None
    if not int8 and shape == "g48":
        pallas = np.asarray(j_spec_verify(*map(jnp.asarray, args),
                                          interpret=True))
    for b in range(3):
        real = int(ntok[b]) * G
        np.testing.assert_allclose(got[b, :, :real], want[b, :, :real], **TOL)
        if pallas is not None:
            np.testing.assert_allclose(got[b, :, :real], pallas[b, :, :real],
                                       **TOL)


@pytest.mark.parametrize("kw", [dict(causal=True, window=32),
                                dict(causal=True, window=32, sink=8),
                                dict(causal=True), dict(causal=False)],
                         ids=["window", "sink", "causal", "bidir"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_flash_prefill_plain_matches_reference(shape, kw):
    """Row r of q [N, S·G, h] is token r // G: the reference on kv heads
    repeated G times; the Pallas kernel joins at h 256 and h 80."""
    K, G, h = SHAPES[shape]
    rng = np.random.default_rng(30 + len(shape) + len(kw))
    S = 64
    q = _f32(rng, (K, S, G, h))
    k, v = _f32(rng, (K, S, h)), _f32(rng, (K, S, h))
    got = flash_prefill_plain(torch.from_numpy(q.reshape(K, S * G, h)),
                              torch.from_numpy(k), torch.from_numpy(v),
                              **kw).numpy().reshape(K, S, G, h)
    qh = np.moveaxis(q, 2, 1).reshape(K * G, S, h)
    kr, vr = (jnp.asarray(np.repeat(x, G, 0)) for x in (k, v))
    want = np.moveaxis(np.asarray(FP_REF(jnp.asarray(qh), kr, vr, **kw))
                       .reshape(K, G, S, h), 1, 2)
    np.testing.assert_allclose(got, want, **TOL_DENSE)
    if shape in ("h256", "h80"):
        pallas = np.asarray(j_flash_prefill(jnp.asarray(qh), kr, vr,
                                            block_q=64, block_k=64,
                                            interpret=True, **kw))
        np.testing.assert_allclose(got, np.moveaxis(
            pallas.reshape(K, G, S, h), 1, 2), **TOL_DENSE)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_sink_decode_plain_matches_reference(shape):
    """Occupancy 1, partial, exactly W and a wrapped ring (t > W)."""
    K, G, h = SHAPES[shape]
    rng = np.random.default_rng(40 + len(shape))
    B, W = 4, 64
    q = _f32(rng, (B, K, G, h))
    kc, vc = _f32(rng, (B, K, W, h)), _f32(rng, (B, K, W, h))
    t = np.array([1, 21, W, W + 9], np.int32)
    got = sink_decode_plain(*map(torch.from_numpy, (q, kc, vc, t))).numpy()
    want = ref.sink_decode_ref(*map(jnp.asarray, (q, kc, vc,
                                                  np.minimum(t, W))))
    np.testing.assert_allclose(got, np.asarray(want), **TOL_DENSE)
    pallas = j_sink_decode(*map(jnp.asarray, (q, kc, vc, np.minimum(t, W))),
                           block_w=32, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL_DENSE)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_block_topk_scores_plain_matches_reference(shape):
    K, G, h = SHAPES[shape]
    rng = np.random.default_rng(50 + len(shape))
    B, bs, nb = 3, 16, 6
    N = B * nb + 1
    q = _f32(rng, (B, K, G, h))
    kmin = _f32(rng, (N, K, h))
    kmax = kmin + np.abs(_f32(rng, (N, K, h)))
    tables = rng.permutation(np.arange(1, N))[:B * nb].reshape(B, nb) \
        .astype(np.int32)
    lens = np.array([1, 40, nb * bs], np.int32)
    args = (q, kmin, kmax, tables, lens)
    got = block_topk_scores_plain(*map(torch.from_numpy, args),
                                  block_size=bs).numpy()
    want = np.asarray(ref.block_topk_scores_ref(*map(jnp.asarray, args),
                                                block_size=bs))
    np.testing.assert_array_equal(got == -1e30, want == -1e30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    pallas = np.asarray(j_block_topk(*map(jnp.asarray, args), block_size=bs,
                                     interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-4)
