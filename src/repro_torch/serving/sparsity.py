"""OmniAttn online-sparsity controller: budgets, validation, and stats.

The dynamic half of OmniAttn. The *static* half (core/omniattn/search.py)
fixes a layer-wise sink+recent compression pattern offline; this module
governs the *online*, query-aware half built on the paged-KV plane: every
resident full-attention KV block carries key summaries (per-kv-head mean +
min/max channel bounds, maintained by the same calls that write KV —
see ``models/stack.py::alloc_arena_kv``), each decode step scores resident
blocks with a Quest-style upper bound and compacts the per-slot budget of
them into a block table, in one launch of the block-topk kernel
(``kernels/block_topk.py::block_topk_select`` + ``kernels/csrc/
block_topk.cu``; plain version ``select_kv_blocks`` there), and attends only
those blocks — non-selected blocks are never read.

The controller maps ``ModelConfig.omniattn`` budget knobs (absolute
``topk_blocks`` or per-slot ``topk_frac`` of the resident block count) onto
the engine's paged geometry, validates them, and owns the stats contract:
the decode step accumulates a device-side ``[4]`` vector per sparse layer
(``blocks_scored``, ``blocks_attended``, ``mass_sum``, ``mass_n``);
``DecodeEngine.take_sparsity_stats`` drains it through ``note`` into the
engine stats dict (layer-averaged, so the figures are comparable to the
host-side per-slot ``blocks_touched`` metric), and the server feeds the
totals to ``MetricsAggregator.note_sparsity``. Selection degrades to exact
attention whenever the budget covers a slot's resident blocks — a server
with ``budget ≥ max_blocks`` is greedy bit-identical to the exact paged
engine.

Over ranks every rank builds the same controller from the same config and
geometry: the plan depends on neither tp nor ep. At tp > 1 each rank
scores its own heads, the scores are max-reduced over ``model`` before the
ranking (``models/stack.py::_select_blocks``), so every rank attends the
same blocks and drains the same stats; nothing is summed over ranks (the
mass, a mean over a rank's heads, is averaged over ``model`` on the
device).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models.stack import (StackPlan, full_attn_layer,
                                      topk_block_budget)


@dataclass(frozen=True)
class SparsityPlan:
    """Resolved online-sparsity geometry for one paged decode engine."""
    budget_blocks: int          # static budget vs the full-width table
    frac: float                 # per-slot fractional budget (0 → absolute)
    sink_blocks: int            # logical blocks always kept from the front
    recent_blocks: int          # logical blocks always kept from the tail
    measure_mass: bool          # compute exact attn_mass_kept (diagnostics)
    n_sparse_layers: int        # full-attention layers under selection


class SparsityController:
    """Per-engine owner of the online top-k selection policy + stats."""

    def __init__(self, plan: SparsityPlan):
        self.plan = plan

    # ---- construction -------------------------------------------------
    @staticmethod
    def from_model(cfg: ModelConfig, plan: StackPlan, block_size: int,
                   max_blocks: int) -> Optional["SparsityController"]:
        """→ a controller when cfg.omniattn configures online sparsity and
        the stack has at least one paged full-attention layer, else None.
        Raises on nonsensical budgets (a budget that cannot even hold the
        forced keeps would silently keep everything)."""
        oa = cfg.omniattn
        budget = topk_block_budget(oa, max_blocks)
        if budget is None:
            return None
        n_sparse = sum(1 for s in plan.all_specs() if full_attn_layer(cfg, s))
        if n_sparse == 0:
            return None
        if oa.topk_blocks > 0 and oa.topk_frac > 0:
            raise ValueError("set omniattn.topk_blocks OR topk_frac, not both")
        if oa.topk_frac > 1.0:
            raise ValueError(f"omniattn.topk_frac {oa.topk_frac} > 1")
        sink = max(oa.topk_sink_blocks, 0)
        recent = max(oa.topk_recent_blocks, 1)   # the tail block MUST stay
        return SparsityController(SparsityPlan(
            budget_blocks=budget,
            frac=0.0 if oa.topk_blocks > 0 else oa.topk_frac,
            sink_blocks=sink, recent_blocks=recent,
            measure_mass=oa.topk_measure_mass, n_sparse_layers=n_sparse))

    # ---- stats contract ----------------------------------------------
    @staticmethod
    def stats_keys() -> dict:
        """Engine-stats schema this controller maintains (benches reset
        these between warmup and measurement)."""
        return {"blocks_scored": 0, "blocks_attended": 0,
                "attn_mass_sum": 0.0, "attn_mass_n": 0.0}

    def note(self, stats: dict, vec) -> None:
        """Fold one drained device accumulator (layer-summed [4] float
        vector) into an engine stats dict. Block counts are divided by the
        sparse layer count so they read in the same per-slot-step units as
        the host-side `blocks_touched` column."""
        L = max(self.plan.n_sparse_layers, 1)
        stats["blocks_scored"] += int(round(float(vec[0]) / L))
        stats["blocks_attended"] += int(round(float(vec[1]) / L))
        stats["attn_mass_sum"] += float(vec[2]) / L
        stats["attn_mass_n"] += float(vec[3]) / L

    @staticmethod
    def mass_kept(stats: dict) -> float:
        """Mean exact attention mass captured by selected blocks across
        every (layer, slot, step) selection — NaN when mass measurement is
        off or no selection ran."""
        n = stats.get("attn_mass_n", 0.0)
        return stats.get("attn_mass_sum", 0.0) / n if n else float("nan")
