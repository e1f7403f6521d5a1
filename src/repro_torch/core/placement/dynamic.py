"""OmniPlacement — Dynamic Expert Scheduler (paper Algorithm 2).

Near-real-time closed loop:
  · UpdateActivationWindow: weighted-moving-average expert load from the
    activation counts emitted by the MoE layer (models/moe.py aux output);
  · trigger rebalancing when B_current > B_trigger;
  · PredictFutureActivations: linear trend extrapolation over the window;
  · re-run the static algorithm; accept only if simulated improvement > Δ;
  · plan a pipelined, non-blocking migration (migration.py) and atomically
    swap placement tables once weights have landed.

Pure-Python control plane: runs on the host beside the serving engine (the
paper runs it on a separate monitoring stream); all device work is the weight
re-slotting of a migration (migration.apply_migration, or the server's
in-place `_apply_migration`). A copy of the reference's
src/repro/core/placement/dynamic.py.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from repro_torch.core.placement.static import calculate_imbalance, static_expert_placement
from repro_torch.core.placement.migration import MigrationPlan, plan_migration


@dataclass
class SchedulerConfig:
    b_trigger: float = 1.3        # imbalance trigger threshold B_trigger
    delta: float = 0.05           # required improvement margin Δ
    window: int = 16              # activation sliding-window length
    ema_alpha: float = 0.3        # weighted moving average factor
    budget: int = 0               # extra slot rows across layers (M)
    max_slots: Optional[int] = None
    predict_horizon: float = 1.0  # trend extrapolation steps


@dataclass
class DynamicScheduler:
    ep: int
    n_experts: int
    n_layers: int
    cfg: SchedulerConfig = field(default_factory=SchedulerConfig)
    placements: Optional[list[np.ndarray]] = None

    def __post_init__(self):
        self._window: deque[np.ndarray] = deque(maxlen=self.cfg.window)
        self._ema: Optional[np.ndarray] = None
        self.n_rebalances = 0
        self.n_checks = 0
        self.history: list[dict] = []

    # ------------------------------------------------------------------
    def update_activation_window(self, counts: np.ndarray) -> np.ndarray:
        """counts [L, E] activation counts from the last interval."""
        counts = np.asarray(counts, dtype=np.float64)
        self._window.append(counts)
        if self._ema is None:
            self._ema = counts.copy()
        else:
            a = self.cfg.ema_alpha
            self._ema = a * counts + (1 - a) * self._ema
        return self._ema

    def predict_future_activations(self) -> np.ndarray:
        """Linear trend over the window, clipped at 0 (paper's
        PredictFutureActivations)."""
        if len(self._window) < 2:
            return self._ema.copy()
        recent = np.mean([self._window[i] for i in range(len(self._window) // 2,
                                                         len(self._window))], axis=0)
        older = np.mean([self._window[i] for i in range(len(self._window) // 2)],
                        axis=0)
        trend = (recent - older) / max(len(self._window) / 2, 1)
        return np.maximum(self._ema + self.cfg.predict_horizon *
                          trend * len(self._window) / 2, 0.0)

    def current_imbalance(self) -> float:
        if self._ema is None or self.placements is None:
            return 1.0
        return float(np.mean([calculate_imbalance(self.placements[l], self._ema[l])
                              for l in range(self.n_layers)]))

    # ------------------------------------------------------------------
    def step(self, counts: np.ndarray) -> Optional[list[MigrationPlan]]:
        """One monitoring tick. Returns migration plans if a rebalance was
        accepted, else None (paper Algorithm 2 lines 4-14)."""
        self.n_checks += 1
        self.update_activation_window(counts)
        if self.placements is None:
            return None
        b_current = self.current_imbalance()
        if b_current <= self.cfg.b_trigger:
            self.history.append({"b": b_current, "rebalanced": False})
            return None
        d_pred = self.predict_future_activations()
        cand, _ = static_expert_placement(
            d_pred, self.ep, self.cfg.budget, prev=self.placements,
            max_slots=self.cfg.max_slots)
        b_sim = float(np.mean([calculate_imbalance(cand[l], d_pred[l])
                               for l in range(self.n_layers)]))
        if b_sim < b_current - self.cfg.delta:
            plans = [plan_migration(self.placements[l], cand[l],
                                    self.cfg.max_slots or
                                    _slots_of(cand[l]))
                     for l in range(self.n_layers)]
            self.placements = cand
            self.n_rebalances += 1
            self.history.append({"b": b_current, "b_sim": b_sim, "rebalanced": True})
            return plans
        self.history.append({"b": b_current, "b_sim": b_sim, "rebalanced": False})
        return None


def _slots_of(placement: np.ndarray) -> int:
    return int(placement.sum(axis=1).max())
