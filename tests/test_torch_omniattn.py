"""OmniAttn's offline half in the PyTorch port (`core/omniattn`: pattern
search and attention fidelity) against the JAX reference on the same numpy
inputs: index subsets and KV byte counts equal exactly, the genetic search
takes the same path from the same seed and accuracy probe, and the fidelity
figures agree within 1e-5 (float32 softmax and norms summed in another
order)."""
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config
from repro.core.omniattn import fidelity as jfid
from repro.core.omniattn import search as jsearch
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced_config as t_reduced_config
from repro_torch.core.omniattn import fidelity as tfid
from repro_torch.core.omniattn import search as tsearch


@pytest.mark.parametrize("M,sink,recent", [(64, 4, 16), (10, 4, 16),
                                           (33, 0, 8), (5, 8, 0)])
def test_index_subsets_match(M, sink, recent):
    np.testing.assert_array_equal(tfid.sink_recent_indices(M, sink, recent),
                                  jfid.sink_recent_indices(M, sink, recent))
    blocks = [3, 0, 7, 5][:max(M // 16, 1)]
    np.testing.assert_array_equal(tfid.block_subset_indices(M, blocks, 8),
                                  jfid.block_subset_indices(M, blocks, 8))


@pytest.mark.parametrize("subset", ["sink_recent", "blocks"])
def test_attention_fidelity_matches(subset):
    rng = np.random.default_rng(1)
    Nq, M, d = 6, 96, 32
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((Nq, d), (M, d), (M, d)))
    kw = dict(indices=jfid.block_subset_indices(M, [0, 4, 9, 11], 8)) \
        if subset == "blocks" else {}
    want = jfid.attention_fidelity(q, k, v, 4, 24, **kw)
    got = tfid.attention_fidelity(q, k, v, 4, 24, **kw)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-5, abs=1e-6), key
    assert 0 < got["attn_mass"] <= 1 + 1e-6


def test_kv_bytes_for_pattern_matches():
    jcfg, tcfg = j_get_config("qwen2-1.5b"), t_get_config("qwen2-1.5b")
    rng = np.random.default_rng(2)
    for _ in range(4):
        pat = rng.integers(0, 2, jcfg.n_layers)
        for seq in (512, 4096, 32768):
            assert tsearch.kv_bytes_for_pattern(tcfg, pat, seq) == \
                jsearch.kv_bytes_for_pattern(jcfg, pat, seq)


@pytest.mark.parametrize("periodic", [None, 2])
def test_pattern_search_takes_the_reference_path(periodic):
    """The same seeded GA over the same accuracy probe (accuracy falls with
    each compressed layer, more for the early ones) finds the same pattern
    with the same per-generation log."""
    kw = dict(n_layers=8)
    jcfg = reduced_config("qwen2-1.5b").with_updates(**kw)
    tcfg = t_reduced_config("qwen2-1.5b").with_updates(**kw)
    weight = np.linspace(0.004, 0.0005, jcfg.n_layers)

    def probe(pat):
        return float(1.0 - (np.asarray(pat) * weight).sum())
    ga = dict(population=10, generations=8, seed=3, accuracy_tau=0.99,
              periodic=periodic)
    want = jsearch.PatternSearch(jcfg, probe, jsearch.GAConfig(**ga),
                                 seq_len=1024).run()
    got = tsearch.PatternSearch(tcfg, probe, tsearch.GAConfig(**ga),
                                seq_len=1024).run()
    np.testing.assert_array_equal(got["pattern"], want["pattern"])
    for key in ("accuracy", "base_accuracy", "kv_gain", "feasible", "log"):
        assert got[key] == want[key], key
    assert got["feasible"] and got["kv_gain"] > 0
