"""Device-side sampling of the PyTorch port: greedy rows are the argmax,
draws are a pure function of (seed, position), every sampled token lies in
the set the JAX reference's top-k/top-p filter keeps, and the tokens equal
the reference's `sample_tokens` (threefry fold_in + Gumbel categorical),
with the smallest top-2 margin of masked logits + noise reported."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.proxy.params import seed_key as j_seed_key
from repro.serving.sampling import sample_tokens as j_sample_tokens
from repro_torch.core.proxy.params import seed_key
from repro_torch.serving.sampling import kept_mask, sample_tokens

torch.set_num_threads(2)


def _rows(n, V, seed=0, temp=0.9, top_k=64, top_p=0.95):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, V)).astype(np.float32) * 3.0
    temps = np.full(n, temp, np.float32)
    tks = np.full(n, top_k, np.int32)
    tps = np.full(n, top_p, np.float32)
    keys = np.stack([seed_key(900 + i) for i in range(n)])
    fold = (np.arange(n) * 7 + 11).astype(np.int32)
    return logits, temps, tks, tps, keys, fold


def _t(logits, temps, tks, tps, keys, fold):
    return (torch.from_numpy(logits), torch.from_numpy(temps),
            torch.from_numpy(tks), torch.from_numpy(tps),
            torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(fold))


@jax.jit
def _jax_kept(logits, temperature, top_k, top_p):
    """The keep mask of src/repro/serving/sampling.py:37-54, in jnp."""
    logits = jnp.asarray(logits, jnp.float32)
    n, V = logits.shape
    scaled = logits / jnp.maximum(jnp.asarray(temperature), 1e-6)[:, None]
    order = jnp.argsort(-scaled, axis=-1)
    ranked = jnp.take_along_axis(scaled, order, axis=-1)
    k = jnp.where(top_k > 0, jnp.clip(top_k, 1, V), V).astype(jnp.int32)
    kth = jnp.take_along_axis(ranked, (k - 1)[:, None], axis=-1)
    keep = scaled >= kth
    probs = jnp.exp(ranked - ranked.max(-1, keepdims=True))
    probs = probs / probs.sum(-1, keepdims=True)
    excl = jnp.cumsum(probs, axis=-1) - probs
    keep_ranked = excl < jnp.asarray(top_p)[:, None]
    rows = jnp.arange(n)[:, None]
    keep2 = keep & jnp.zeros_like(keep).at[rows, order].set(keep_ranked)
    return keep2


def test_seed_key_matches_reference():
    for s in (0, 7, 900, -3, 1 << 40):
        np.testing.assert_array_equal(seed_key(s), j_seed_key(s))


@pytest.mark.parametrize("all_greedy", [True, False])
def test_greedy_rows_are_argmax(all_greedy):
    logits, temps, tks, tps, keys, fold = _rows(6, 97)
    temps[:] = 0.0
    out = sample_tokens(*_t(logits, temps, tks, tps, keys, fold),
                        all_greedy=all_greedy)
    np.testing.assert_array_equal(out.numpy(), logits.argmax(-1))
    jout = j_sample_tokens(jnp.asarray(logits), jnp.asarray(temps),
                           jnp.asarray(tks), jnp.asarray(tps),
                           jnp.asarray(keys), jnp.asarray(fold))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_top_k_one_is_argmax():
    logits, temps, tks, tps, keys, fold = _rows(8, 97, temp=1.3, top_k=1,
                                                top_p=1.0)
    out = sample_tokens(*_t(logits, temps, tks, tps, keys, fold),
                        all_greedy=False)
    np.testing.assert_array_equal(out.numpy(), logits.argmax(-1))


def test_draw_is_a_function_of_seed_and_position():
    logits, temps, tks, tps, keys, fold = _rows(6, 257, temp=1.0, top_k=0,
                                                top_p=1.0)
    args = _t(logits, temps, tks, tps, keys, fold)
    a = sample_tokens(*args, all_greedy=False).numpy()
    b = sample_tokens(*args, all_greedy=False).numpy()
    np.testing.assert_array_equal(a, b)
    # the same row in another batch position and composition
    perm = np.array([3, 0, 5])
    sub = _t(logits[perm], temps[perm], tks[perm], tps[perm], keys[perm],
             fold[perm])
    np.testing.assert_array_equal(
        sample_tokens(*sub, all_greedy=False).numpy(), a[perm])
    # another position draws anew: over many positions the tokens differ
    many = []
    for pos in range(40):
        f = np.full(6, pos, np.int32)
        many.append(sample_tokens(*_t(logits, temps, tks, tps, keys, f),
                                  all_greedy=False).numpy())
    assert len({tuple(m) for m in many}) > 20


@pytest.mark.parametrize("temp,top_k,top_p", [(0.9, 64, 0.95), (1.5, 5, 1.0),
                                              (0.7, 0, 0.5), (2.0, 0, 0.3)])
def test_sampled_tokens_lie_in_reference_kept_set(temp, top_k, top_p):
    logits, temps, tks, tps, keys, fold = _rows(8, 211, seed=int(temp * 10),
                                                temp=temp, top_k=top_k,
                                                top_p=top_p)
    want = np.asarray(_jax_kept(logits, temps, tks, tps))
    args = _t(logits, temps, tks, tps, keys, fold)
    _, keep = kept_mask(*args[:4])
    np.testing.assert_array_equal(keep.numpy(), want)
    for pos in range(25):
        f = torch.full((8,), pos, dtype=torch.int32)
        out = sample_tokens(*args[:5], f, all_greedy=False).numpy()
        assert want[np.arange(8), out].all()


def test_draws_follow_the_filtered_distribution():
    """Over many positions the empirical token frequencies of one row match
    softmax(logits / T) over the kept set (a chi-square-free check: every
    kept token with mass > 5% appears, frequencies within 0.05)."""
    V = 12
    logits = np.linspace(2.0, -2.0, V, dtype=np.float32)[None]
    temps = np.array([1.0], np.float32)
    tks = np.array([6], np.int32)
    tps = np.array([1.0], np.float32)
    keys = seed_key(5)[None]
    n = 4000
    L = torch.from_numpy(np.repeat(logits, n, 0))
    out = sample_tokens(L, torch.from_numpy(np.repeat(temps, n)),
                        torch.from_numpy(np.repeat(tks, n)),
                        torch.from_numpy(np.repeat(tps, n)),
                        torch.from_numpy(np.repeat(keys, n, 0)
                                         .astype(np.int64)),
                        torch.arange(n, dtype=torch.int32),
                        all_greedy=False).numpy()
    p = np.exp(logits[0, :6] - logits[0, :6].max())
    p /= p.sum()
    freq = np.bincount(out, minlength=V) / n
    assert freq[6:].sum() == 0
    np.testing.assert_allclose(freq[:6], p, atol=0.05)


def _grid_rows(n, V, seed, temp, top_k, top_p):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, V)).astype(np.float32) * 3.0
    temps = np.full(n, temp, np.float32)
    temps[0] = 0.0                          # one greedy row in each batch
    return (logits, temps, np.full(n, top_k, np.int32),
            np.full(n, top_p, np.float32),
            np.stack([seed_key(300 + 7 * i + seed) for i in range(n)]),
            (np.arange(n) * 13 + seed).astype(np.int32))


def _margin(args) -> float:
    """The smallest gap between the top two of masked logits + noise over
    the sampled rows (the reference's own values)."""
    logits, temps, tks, tps, keys, fold = args
    scaled, keep = kept_mask(*(torch.from_numpy(a) for a in
                               (logits, temps, tks, tps)))
    masked = torch.where(keep, scaled, torch.full_like(scaled, -np.inf))
    jk = jax.vmap(jax.random.fold_in)(jnp.asarray(keys), jnp.asarray(fold))
    g = jax.vmap(lambda k: jax.random.gumbel(k, (logits.shape[1],)))(jk)
    z = np.asarray(g) + masked.numpy()
    top = -np.sort(-z, axis=-1)[:, :2]
    gap = top[:, 0] - top[:, 1]
    return float(gap[temps > 0].min())


@pytest.mark.parametrize("V", [211, 151936])
@pytest.mark.parametrize("temp,top_k,top_p", [(0.9, 64, 0.95), (1.5, 5, 1.0),
                                              (0.7, 0, 0.5), (1.0, 0, 1.0),
                                              (1.2, 40, 0.8)])
def test_sample_tokens_equal_reference(V, temp, top_k, top_p):
    n = 6 if V > 1000 else 16
    args = _grid_rows(n, V, int(temp * 10) + top_k, temp, top_k, top_p)
    want = np.asarray(jax.jit(j_sample_tokens)(*(jnp.asarray(a)
                                                 for a in args)))
    t = [torch.from_numpy(a) for a in args]
    t[4] = t[4].long()
    got = sample_tokens(*t, all_greedy=False).numpy()
    np.testing.assert_array_equal(
        got, want, err_msg=f"sampled tokens differ; smallest top-2 margin "
        f"of masked logits + noise {_margin(args):.3g}")
