"""OmniAttn pattern search (paper §4.2).

Layer-wise compression pattern p ∈ {0,1}^L discovered by a genetic algorithm
at inference-only cost:

    min_p latency(p)   s.t.   accuracy(p) ≥ τ          (paper eq. 7)

Fitness: patterns meeting the accuracy budget are ranked by compression gain
(KV bytes saved → latency proxy); infeasible patterns are ranked below every
feasible one by their accuracy shortfall. Selection = tournament, crossover =
uniform, mutation = per-gene flip. Early stop when a pattern exceeds τ at the
target compression.

`periodic` restricts the search space to period-`q` patterns (a period
keeps the layer stack regular for the large architectures); the
engine-scale search runs unrestricted. Pure numpy: `evaluate` is the
caller's accuracy probe, run on whatever device it chooses.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


def kv_bytes_for_pattern(cfg: ModelConfig, pattern: np.ndarray, seq_len: int,
                         bytes_per_el: int = 2) -> int:
    """Total KV bytes per sequence under pattern p (1 = compressed)."""
    total = 0
    specs = cfg.layer_specs(list(int(x) for x in pattern))
    for s in specs:
        if s.kind != "attn":
            continue
        if s.compressed:
            W = cfg.omniattn.sink_tokens + cfg.omniattn.recent_tokens
        elif s.window > 0:
            W = min(s.window, seq_len)
        else:
            W = seq_len
        total += 2 * min(W, seq_len) * cfg.n_kv_heads * cfg.head_dim * bytes_per_el
    return total


@dataclass
class GAConfig:
    population: int = 24
    generations: int = 20
    tournament: int = 3
    crossover_rate: float = 0.8
    mutation_rate: float = 0.08
    accuracy_tau: float = 0.99    # relative to uncompressed accuracy
    seed: int = 0
    periodic: Optional[int] = None  # restrict to period-q patterns
    early_stop_patience: int = 5


@dataclass
class PatternSearch:
    cfg: ModelConfig
    evaluate: Callable[[np.ndarray], float]   # pattern → accuracy ∈ [0,1]
    ga: GAConfig
    seq_len: int = 4096

    def _expand(self, genes: np.ndarray) -> np.ndarray:
        """genes (period-q or full-length) → full per-layer pattern, zeroing
        non-candidate layers (mamba / local-window)."""
        L = self.cfg.n_layers
        if self.ga.periodic:
            pat = np.tile(genes, (L + len(genes) - 1) // len(genes))[:L]
        else:
            pat = genes.copy()
        specs = self.cfg.layer_specs()
        for i, s in enumerate(specs):
            if s.kind != "attn" or s.window > 0:
                pat[i] = 0
        return pat

    def _gene_len(self) -> int:
        return self.ga.periodic or self.cfg.n_layers

    def fitness(self, genes: np.ndarray, base_acc: float) -> tuple[float, dict]:
        pat = self._expand(genes)
        key = pat.tobytes()
        if not hasattr(self, "_cache"):
            self._cache = {}
        if key not in self._cache:                 # evaluations are expensive
            self._cache[key] = self.evaluate(pat)
        acc = self._cache[key]
        full = kv_bytes_for_pattern(self.cfg, np.zeros_like(pat), self.seq_len)
        kv = kv_bytes_for_pattern(self.cfg, pat, self.seq_len)
        gain = 1.0 - kv / max(full, 1)
        feasible = acc >= self.ga.accuracy_tau * base_acc
        score = gain if feasible else -1.0 + acc / max(base_acc, 1e-9)
        return score, {"acc": acc, "kv_gain": gain, "feasible": feasible,
                       "pattern": pat}

    # ------------------------------------------------------------------
    def run(self) -> dict:
        rng = np.random.default_rng(self.ga.seed)
        n = self._gene_len()
        base_acc = self.evaluate(self._expand(np.zeros(n, dtype=np.int64)))
        pop = (rng.random((self.ga.population, n)) < 0.5).astype(np.int64)
        pop[0] = 0                                  # keep the identity pattern
        best, best_info, best_score = None, None, -np.inf
        stale = 0
        log = []
        for gen in range(self.ga.generations):
            scored = []
            for ind in pop:
                s, info = self.fitness(ind, base_acc)
                scored.append((s, ind, info))
            scored.sort(key=lambda t: -t[0])
            if scored[0][0] > best_score + 1e-12:
                best_score, best, best_info = scored[0][0], scored[0][1].copy(), scored[0][2]
                stale = 0
            else:
                stale += 1
            log.append({"gen": gen, "best_score": float(best_score),
                        "best_acc": float(best_info["acc"]),
                        "kv_gain": float(best_info["kv_gain"])})
            if stale >= self.ga.early_stop_patience:
                break
            # --- evolve
            new_pop = [scored[0][1].copy()]         # elitism
            while len(new_pop) < self.ga.population:
                a = self._tournament(scored, rng)
                b = self._tournament(scored, rng)
                child = a.copy()
                if rng.random() < self.ga.crossover_rate:
                    m = rng.random(n) < 0.5
                    child = np.where(m, a, b)
                flip = rng.random(n) < self.ga.mutation_rate
                child = np.where(flip, 1 - child, child)
                new_pop.append(child.astype(np.int64))
            pop = np.stack(new_pop)
        return {"pattern": best_info["pattern"], "genes": best,
                "accuracy": best_info["acc"], "base_accuracy": base_acc,
                "kv_gain": best_info["kv_gain"], "feasible": best_info["feasible"],
                "log": log}

    def _tournament(self, scored, rng):
        idx = rng.integers(0, len(scored), size=self.ga.tournament)
        return max((scored[i] for i in idx), key=lambda t: t[0])[1]
