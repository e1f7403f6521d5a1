"""The port's copy of JAX's sampling draw (src/repro_torch/serving/prng.py)
against jax itself on the CPU: threefry2x32 `fold_in`, the partitionable
`random_bits`, `uniform(minval=tiny)` bit for bit over seeds, folds and
vocabulary widths up to qwen2's 151,936, and the Gumbel noise within 2 ulp
(tests/test_torch_sampling.py holds the whole draw to the reference's).

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest tests/test_torch_prng.py -q
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core.proxy.params import seed_key
from repro_torch.serving import prng

torch.set_num_threads(2)

SEEDS = (0, 5, 901, 123456789, (1 << 40) + 3, -7)
FOLDS = np.array([0, 1, 17, 4400, 151935, 2 ** 31 - 1], np.int32)
TINY = float(jnp.finfo(jnp.float32).tiny)


def _keys():
    return np.stack([seed_key(s) for s in SEEDS])


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


@pytest.fixture(scope="module")
def folded():
    keys = _keys()
    jk = jax.vmap(jax.random.fold_in)(jnp.asarray(keys), jnp.asarray(FOLDS))
    tk = prng.fold_in(torch.from_numpy(keys.astype(np.int64)),
                      torch.from_numpy(FOLDS))
    return jk, tk


def test_threefry_partitionable_is_the_reference_setting():
    """random_bits32 copies the partitionable form: a jax upgrade that
    changes the default must fail here, not silently elsewhere."""
    assert jax.config.jax_threefry_partitionable is True


def test_threefry2x32_matches_jax():
    from jax._src import prng as jprng
    rng = np.random.default_rng(0)
    k = rng.integers(0, 1 << 32, 2, dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 1 << 32, (2, 64), dtype=np.uint64).astype(np.uint32)
    want = jprng.threefry_2x32(jnp.asarray(k), jnp.asarray(x.ravel()))
    want = np.asarray(want).reshape(2, 64)
    y0, y1 = prng.threefry2x32(
        *(torch.tensor(int(v)) for v in k),
        *(torch.from_numpy(r.astype(np.int64)) for r in
          np.split(x.ravel(), 2)))
    np.testing.assert_array_equal(
        np.concatenate([_u32(y0), _u32(y1)]), want.ravel())


def test_fold_in_matches_jax(folded):
    jk, tk = folded
    np.testing.assert_array_equal(_u32(tk), np.asarray(jk))
    # any integer dtype of the fold, taken mod 2^32
    tk64 = prng.fold_in(torch.from_numpy(_keys().astype(np.int64)),
                        torch.from_numpy(FOLDS.astype(np.int64)))
    assert torch.equal(tk64, tk)


@pytest.mark.parametrize("V", [1, 7, 1000, 151936])
def test_random_bits_and_uniform_match_jax(folded, V):
    jk, tk = folded
    jb = jax.vmap(lambda k: jax.random.bits(k, (V,), jnp.uint32))(jk)
    tb = prng.random_bits32(tk, V)
    assert tb.shape == (len(SEEDS), V)
    np.testing.assert_array_equal(_u32(tb), np.asarray(jb))
    ju = jax.vmap(lambda k: jax.random.uniform(k, (V,), minval=TINY))(jk)
    tu = prng.uniform(tb)
    assert tu.dtype == torch.float32
    np.testing.assert_array_equal(tu.numpy().view(np.int32),
                                  np.asarray(ju).view(np.int32))


@pytest.mark.parametrize("V", [7, 1000, 151936])
def test_gumbel_within_two_ulp(folded, V):
    """-log(-log(u)) on the same uniforms: `log` rounds differently in XLA
    and torch, so the noise agrees within 2 ulp. The ulp is taken at
    max(|g|, 1): torch's CPU log of u near 1 is accurate in absolute terms
    only (hundreds of ulp apart in relative terms where the noise is near
    0), and what the draw compares is the noise added to logits."""
    jk, tk = folded
    jg = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(jk))
    tg = prng.gumbel(tk, V).numpy()
    assert tg.dtype == np.float32 and np.isfinite(tg).all()
    ulp = np.spacing(np.maximum(np.abs(jg), np.float32(1.0)))
    assert (np.abs(tg - jg) <= 2 * ulp).all(), \
        float((np.abs(tg - jg) / ulp).max())
