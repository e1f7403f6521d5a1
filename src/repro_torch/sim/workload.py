"""Synthetic workload matching the paper §6.1: long-tail lognormal lengths,
mean input ≈3500, mean output ≈1000, input+output capped at 16k, a fraction of
requests sharing long prefixes (system prompts → APC hits), closed-loop fixed
concurrency. A copy of the reference's src/repro/sim/workload.py."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class WorkloadConfig:
    mean_in: float = 3500.0
    mean_out: float = 1000.0
    sigma_in: float = 0.9         # lognormal shape → pronounced long tail
    sigma_out: float = 1.0
    cap_total: int = 16384
    shared_prefix_frac: float = 0.35
    n_prefix_groups: int = 8
    prefix_len: int = 1024
    seed: int = 0


def _lognormal(rng, mean, sigma, n):
    mu = np.log(mean) - sigma ** 2 / 2
    return np.maximum(rng.lognormal(mu, sigma, n).astype(np.int64), 16)


def closed_loop_requests(cfg: WorkloadConfig, n: int):
    """[(prompt_tokens_tuple_or_len, out_len, prefix_group)] — the simulator
    uses lengths + group ids; the real engine uses token tuples."""
    rng = np.random.default_rng(cfg.seed)
    lin = _lognormal(rng, cfg.mean_in, cfg.sigma_in, n)
    lout = _lognormal(rng, cfg.mean_out, cfg.sigma_out, n)
    total = lin + lout
    over = total > cfg.cap_total
    scale = np.where(over, cfg.cap_total / total, 1.0)
    lin = np.maximum((lin * scale).astype(np.int64), 16)
    lout = np.maximum((lout * scale).astype(np.int64), 16)
    groups = np.where(rng.random(n) < cfg.shared_prefix_frac,
                      rng.integers(0, cfg.n_prefix_groups, n), -1)
    return [(int(lin[i]), int(lout[i]), int(groups[i])) for i in range(n)]


def request_tokens(rng: np.random.Generator, lin: int, group: int,
                   prefix_len: int, vocab: int = 50000) -> tuple:
    """Materialize token ids (real engine): shared prefix per group."""
    if group >= 0:
        g = np.random.default_rng(group + 12345)
        prefix = g.integers(0, vocab, min(prefix_len, lin)).tolist()
        rest = rng.integers(0, vocab, max(lin - len(prefix), 0)).tolist()
        return tuple(prefix + rest)
    return tuple(rng.integers(0, vocab, lin).tolist())
