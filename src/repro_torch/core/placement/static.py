"""OmniPlacement — Static Expert Placement (paper Algorithm 1).

Placement tensor P ∈ {0,1}^{L×R×E} subject to
  availability: Σ_r P[l,r,e] ≥ 1             (eq. 1)
  capacity:     Σ_e P[l,r,e] ≤ s_l           (eq. 2)
minimizing the per-layer load-imbalance ratio
  B(l,P,D) = max_r load_r / mean_r load_r    (eq. 4)
given the expert-load matrix D ∈ R^{L×E} (eq. 3 aggregates loads per device).

Components (paper §4.1):
  AllocateBudgetByImbalance — distribute the global redundancy budget M across
    layers proportional to their observed imbalance;
  DetermineReplicas — heap-greedy replica counts for the hottest experts;
  GeneratePlacement — greedy least-loaded device assignment + topology-aware
    remapping (minimize inter-device moves w.r.t. a previous placement);
  CalculateImbalance — eq. 4.

A copy of the reference's src/repro/core/placement/static.py (numpy only).
"""
from __future__ import annotations

import heapq
from typing import Optional

import numpy as np


def calculate_imbalance(placement: np.ndarray, loads: np.ndarray) -> float:
    """placement [R, E] binary; loads [E]. Replicated experts split their load
    evenly across replicas (balanced replica selection — see models/moe.py)."""
    n_rep = np.maximum(placement.sum(axis=0), 1)          # [E]
    per_replica = loads / n_rep
    device_load = placement @ per_replica                 # [R]
    mean = device_load.mean()
    if mean <= 0:
        return 1.0
    return float(device_load.max() / mean)


def allocate_budget_by_imbalance(D: np.ndarray, n_slots_base: int, budget: int,
                                 ep: int) -> np.ndarray:
    """Distribute `budget` extra slot-rows (one per layer unit of s_l beyond
    ceil(E/R)) to layers ∝ their imbalance under the unreplicated layout."""
    L, E = D.shape
    base = np.full(L, n_slots_base, dtype=np.int64)
    if budget <= 0:
        return base
    imb = np.zeros(L)
    rr = round_robin(E, ep, n_slots_base)
    for l in range(L):
        imb[l] = calculate_imbalance(rr, D[l]) - 1.0
    imb = np.maximum(imb, 1e-6)
    share = imb / imb.sum()
    extra = np.floor(share * budget).astype(np.int64)
    # hand out remaining units to the most imbalanced layers
    rem = budget - int(extra.sum())
    order = np.argsort(-imb)
    for i in range(rem):
        extra[order[i % L]] += 1
    return base + extra


def round_robin(E: int, ep: int, n_slots: int) -> np.ndarray:
    p = np.zeros((ep, E), dtype=np.int8)
    for e in range(E):
        p[(e // n_slots) % ep, e] = 1
    return p


def determine_replicas(loads: np.ndarray, extra_slots: int, ep: int,
                       n_slots: int) -> np.ndarray:
    """Heap-greedy replica counts [E]: repeatedly replicate the expert whose
    per-replica load is currently highest, until the slot budget (ep*n_slots)
    is used. Every expert gets ≥ 1 replica."""
    E = loads.shape[0]
    total_slots = ep * n_slots
    counts = np.ones(E, dtype=np.int64)
    free = total_slots - E
    if free < 0:
        raise ValueError(f"{total_slots} slots < {E} experts")
    heap = [(-loads[e], e) for e in range(E)]
    heapq.heapify(heap)
    for _ in range(min(free, extra_slots)):
        _, e = heapq.heappop(heap)
        counts[e] += 1
        heapq.heappush(heap, (-loads[e] / (counts[e] + 1.0), e))
    return counts


def generate_placement(counts: np.ndarray, loads: np.ndarray, ep: int,
                       n_slots: int,
                       prev: Optional[np.ndarray] = None) -> np.ndarray:
    """Greedy least-loaded assignment of expert replicas to devices, then a
    topology-aware remap: permute device rows to maximize overlap with `prev`
    (minimizes weight migration traffic — the analogue of the paper's
    inter-device communication remapping)."""
    E = counts.shape[0]
    per_rep = loads / np.maximum(counts, 1)
    # place replicas of heavy experts first
    order = np.argsort(-per_rep)
    device_load = np.zeros(ep)
    device_used = np.zeros(ep, dtype=np.int64)
    placement = np.zeros((ep, E), dtype=np.int8)
    for e in order:
        for _ in range(int(counts[e])):
            # least-loaded device that has a free slot and doesn't already
            # host this expert
            cand = [(device_load[r], r) for r in range(ep)
                    if device_used[r] < n_slots and placement[r, e] == 0]
            if not cand:      # all devices host it already or are full
                break
            _, r = min(cand)
            placement[r, e] = 1
            device_used[r] += 1
            device_load[r] += per_rep[e]
    if prev is not None:
        placement = _remap_to_prev(placement, prev)
    return placement


def _remap_to_prev(placement: np.ndarray, prev: np.ndarray) -> np.ndarray:
    """Greedy row permutation maximizing per-device overlap with prev."""
    ep = placement.shape[0]
    overlap = placement.astype(np.int32) @ prev.astype(np.int32).T   # [new_r, old_r]
    out = np.zeros_like(placement)
    used_new, used_old = set(), set()
    pairs = sorted(((overlap[i, j], i, j) for i in range(ep) for j in range(ep)),
                   reverse=True)
    assign = {}
    for _, i, j in pairs:
        if i in used_new or j in used_old:
            continue
        assign[j] = i
        used_new.add(i)
        used_old.add(j)
        if len(assign) == ep:
            break
    for old_r, new_i in assign.items():
        out[old_r] = placement[new_i]
    return out


def static_expert_placement(D: np.ndarray, ep: int, budget: int,
                            n_slots_base: Optional[int] = None,
                            prev: Optional[list[np.ndarray]] = None,
                            max_slots: Optional[int] = None):
    """Paper Algorithm 1. D [L, E] load matrix; budget M = total extra slot
    rows across layers. Returns (placements list of [R,E], n_slots [L])."""
    L, E = D.shape
    if n_slots_base is None:
        n_slots_base = int(np.ceil(E / ep))
    s = allocate_budget_by_imbalance(D, n_slots_base, budget, ep)
    if max_slots is not None:
        s = np.minimum(s, max_slots)
    placements = []
    for l in range(L):
        best, best_b = None, np.inf
        # iterate redundancy levels k = 0..(s_l - base): extra replica rows
        for k in range(int(s[l]) - n_slots_base + 1):
            n_slots_l = n_slots_base + k
            extra = n_slots_l * ep - E
            counts = determine_replicas(D[l], extra, ep, n_slots_l)
            cand = generate_placement(counts, D[l], ep, n_slots_l,
                                      prev[l] if prev is not None else None)
            b = calculate_imbalance(cand, D[l])
            if b < best_b:
                best, best_b = cand, b
        placements.append(best)
    return placements, s
