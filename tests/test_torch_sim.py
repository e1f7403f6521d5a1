"""The port's cluster simulator (src/repro_torch/sim/) against the
reference's (src/repro/sim/) on the CPU: the four arms of the reference's
tests/test_sim_and_dryrun.py fixture (250 requests, concurrency 200,
WorkloadConfig(seed=1)) give the same summary on every key, NaN equal to
NaN; the reference's behaviour assertions hold on the port's summaries;
the closed-loop workload is the same list. The simulator models the
paper's Ascend 910C / DeepSeek-R1 cluster: its figures are that model's."""
import math

import numpy as np
import pytest

from repro.sim import ClusterSim as RefSim
from repro.sim import SimConfig as RefConfig
from repro.sim.workload import WorkloadConfig as RefWorkload
from repro.sim.workload import closed_loop_requests as ref_requests
from repro_torch.sim import ClusterSim, SimConfig
from repro_torch.sim.workload import WorkloadConfig, closed_loop_requests

ARMS = {"full": {}, "wo_placement": dict(use_placement=False),
        "wo_attn": dict(use_omniattn=False),
        "wo_all": dict(use_placement=False, use_omniattn=False,
                       use_proxy=False)}


@pytest.fixture(scope="module")
def sims():
    port = {k: ClusterSim(SimConfig(n_requests=250, concurrency=200,
                                    workload=WorkloadConfig(seed=1),
                                    **kw)).run()
            for k, kw in ARMS.items()}
    ref = {k: RefSim(RefConfig(n_requests=250, concurrency=200,
                               workload=RefWorkload(seed=1), **kw)).run()
           for k, kw in ARMS.items()}
    return port, ref


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


@pytest.mark.parametrize("arm", list(ARMS))
def test_summary_equals_reference(sims, arm):
    port, ref = sims
    got, want = port[arm], ref[arm]
    assert sorted(got) == sorted(want)
    bad = {k: (got[k], want[k]) for k in want if not _same(got[k], want[k])}
    assert not bad, bad


def test_sim_completes_all(sims):
    for k, s in sims[0].items():
        assert s["n_done"] == 250, k


def test_ablation_ordering(sims):
    """Paper Table 2 ordering: full ≥ w/o attn > w/o placement ≥ w/o all."""
    s = sims[0]
    assert s["full"]["qpm"] >= s["wo_attn"]["qpm"] * 0.98
    assert s["wo_attn"]["qpm"] > s["wo_placement"]["qpm"]
    assert s["full"]["qpm"] > s["wo_all"]["qpm"] * 1.15


def test_placement_reduces_imbalance(sims):
    s = sims[0]
    assert s["full"]["moe_imbalance_final"] < \
        s["wo_placement"]["moe_imbalance_final"] - 0.3


def test_omniattn_reduces_tpot(sims):
    s = sims[0]
    assert s["full"]["tpot_mean_ms"] < s["wo_attn"]["tpot_mean_ms"]


def test_workload_equals_reference():
    got = closed_loop_requests(WorkloadConfig(seed=0), 4000)
    assert got == ref_requests(RefWorkload(seed=0), 4000)
    lin = np.array([r[0] for r in got])
    assert lin.max() > 4 * lin.mean()        # pronounced tail
