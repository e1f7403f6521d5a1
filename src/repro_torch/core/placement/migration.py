"""Expert-weight migration (paper §4.1 'Pipelined Expert Weight and
Placement Updates').

A plan names the slots whose expert changes between two placements;
applying it rebuilds the slot weights from canonical per-expert weights and
swaps in tables that keep the new slot assignment. `bytes_moved` quantifies
migration traffic for the simulator. The reference's
src/repro/core/placement/migration.py, with the tables as torch tensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.models.moe import (slots_from_canonical,
                                    tables_from_placement,
                                    tables_from_replicas)


@dataclass(frozen=True)
class MigrationPlan:
    old_slot_expert: np.ndarray   # [R, s]
    new_slot_expert: np.ndarray   # [R, s]
    moves: tuple                  # ((rank, slot, expert), ...) slots that change
    bytes_moved_per_param: int    # number of expert-rows fetched

    @property
    def n_moves(self) -> int:
        return len(self.moves)


def plan_migration(old_placement: np.ndarray, new_placement: np.ndarray,
                   n_slots: int) -> MigrationPlan:
    old_se = tables_from_placement(old_placement, n_slots)[
        "slot_expert"].numpy()
    new_se = tables_from_placement(new_placement, n_slots)[
        "slot_expert"].numpy()
    moves = []
    for r in range(new_se.shape[0]):
        for s in range(new_se.shape[1]):
            if new_se[r, s] != old_se[r, s] and new_se[r, s] >= 0:
                moves.append((r, s, int(new_se[r, s])))
    return MigrationPlan(old_se, new_se, tuple(moves), len(moves))


def apply_migration(plan: MigrationPlan, canonical_weights: dict,
                    device="cpu"):
    """Rebuild slot weights for the new layout. canonical_weights: dict of
    [E, ...] tensors. → (new slot weights {name: [R, s, ...]}, tables on
    `device`). Only the changed (rank, slot) rows would move in
    production (plan.moves); here the slot tensor is regathered."""
    new_tables = tables_from_placement_from_slots(plan.new_slot_expert,
                                                  device)
    new_slots = {k: slots_from_canonical(v, plan.new_slot_expert)
                 for k, v in canonical_weights.items()}
    return new_slots, new_tables


def tables_from_placement_from_slots(slot_expert: np.ndarray,
                                     device="cpu") -> dict:
    """Replica lookup tables (int32 tensors on `device`) built directly
    from a slot_expert map, preserving the given slot assignment.
    (Round-tripping through a binary placement would re-pack experts in
    ascending order and silently undo any slot permutation the weights
    were migrated to.)"""
    slot_expert = np.asarray(slot_expert)
    R, s = slot_expert.shape
    reps: list = [[] for _ in range(int(slot_expert.max()) + 1)]
    for r in range(R):
        for i in range(s):
            e = int(slot_expert[r, i])
            if e >= 0:
                reps[e].append((r, i))
    return tables_from_replicas(reps, slot_expert, device)
