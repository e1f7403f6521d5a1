"""MoE FFN with OmniPlacement slot tables, on one device.

Layout (the reference's, src/repro/models/moe.py):
  · experts live in per-rank *slots*: slot weights w1/w3 [R, s, D, Fe],
    w2 [R, s, Fe, D]. The port serves one device, so R = ep = 1; the
    leading axis stays so that expert parallelism (ROADMAP A16) can shard
    it later;
  · a *placement* maps experts → (rank, slot) replicas, held as tables of
    int tensors (`tables_from_placement`); redundant slots host replicas of
    hot experts, and the replica of each (token, choice) is a deterministic
    round-robin over the replicas;
  · dispatch (the body of the reference's shard_map for one device):
    bucket the (token, choice) assignments per slot in token order, run the
    three expert products over the slot buffer [s, Cb, D] through the
    `moe_gmm` kernel with each slot's valid-row count (`torch.bmm` on the
    train path), then a weighted
    combine. Assignments past a slot's capacity Cb are dropped (they add 0;
    the kept gates are not renormalised).

Everything on the dispatch path is a fixed-shape tensor op: the counts and
valid-row counts are scatter-adds into [E] / [s] tensors and Cb, the chunk
size and the chunk count come from Python ints of the shapes, so no host
read enters a serving step.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_gmm import moe_gmm
from repro_torch.models.common import swiglu


# ----------------------------------------------------------------------
# Placement tables (rewritten in place at migration time)
def tables_from_replicas(reps: list, slot_expert: np.ndarray,
                         device) -> dict:
    """reps[e]: expert e's (rank, slot) replicas; slot_expert [R, s] → the
    int32 lookup tables on `device` (replica lists padded round-robin to
    the widest)."""
    E = len(reps)
    max_rep = max(1, max(len(x) for x in reps))
    rep_rank = np.zeros((E, max_rep), dtype=np.int32)
    rep_slot = np.zeros((E, max_rep), dtype=np.int32)
    n_rep = np.zeros((E,), dtype=np.int32)
    for e, lst in enumerate(reps):
        if not lst:
            raise ValueError(f"expert {e} unplaced")
        n_rep[e] = len(lst)
        for i in range(max_rep):
            r, sl = lst[i % len(lst)]
            rep_rank[e, i] = r
            rep_slot[e, i] = sl
    return {k: torch.from_numpy(v).to(device) for k, v in (
        ("rep_rank", rep_rank), ("rep_slot", rep_slot), ("n_rep", n_rep),
        ("slot_expert", slot_expert.astype(np.int32)))}


def pad_replicas(tables: dict) -> dict:
    """`tables` with the replica lists padded round-robin to R·s columns,
    the most replicas a placement over these slots can give an expert (the
    router reads only the first n_rep of a row, so the lookups are those of
    `tables`). The tables of every placement then have the same shapes: a
    migration rewrites the serving tables in place."""
    n = tables["n_rep"].long().clamp(min=1)
    width = tables["slot_expert"].numel()
    col = torch.arange(width, device=n.device)[None] % n[:, None]
    return dict(tables, **{k: torch.gather(tables[k], 1, col)
                           for k in ("rep_rank", "rep_slot")})


def tables_from_placement(placement: np.ndarray, n_slots: int,
                          device="cpu") -> dict:
    """placement: binary [R, E] (this layer) → replica lookup tables, int32
    tensors on `device`: rep_rank [E, max_rep], rep_slot [E, max_rep],
    n_rep [E], slot_expert [R, s] (-1 = empty slot). Each rank hosts its
    experts in ascending expert order."""
    R, E = placement.shape
    slot_expert = -np.ones((R, n_slots), dtype=np.int32)
    reps: list = [[] for _ in range(E)]
    for r in range(R):
        hosted = np.nonzero(placement[r])[0]
        if len(hosted) > n_slots:
            raise ValueError(f"rank {r} hosts {len(hosted)} experts > "
                             f"{n_slots} slots")
        for i, e in enumerate(hosted):
            slot_expert[r, i] = e
            reps[int(e)].append((r, i))
    return tables_from_replicas(reps, slot_expert, device)


def round_robin_placement(n_experts: int, ep: int, n_slots: int
                          ) -> np.ndarray:
    """Trivial (baseline) placement: expert e → rank e // s."""
    placement = np.zeros((ep, n_experts), dtype=np.int8)
    for e in range(n_experts):
        placement[(e // n_slots) % ep, e] = 1
    return placement


def default_slot_count(cfg: ModelConfig, ep: int) -> int:
    return math.ceil(cfg.moe.n_experts / ep) + cfg.moe.redundant_slots


def slots_from_canonical(canonical, slot_expert):
    """canonical [E, ...] + slot_expert [R, s] → slot weights [R, s, ...]
    (empty slots zero)."""
    se = slot_expert.to(canonical.device) if isinstance(
        slot_expert, torch.Tensor) else torch.tensor(
            np.asarray(slot_expert), device=canonical.device)
    w = canonical[se.clamp(0, canonical.shape[0] - 1).long()]
    mask = (se >= 0).to(w.dtype)
    return w.mul_(mask.reshape(tuple(se.shape) + (1,) * (w.ndim - 2)))


# ----------------------------------------------------------------------
def router(cfg: ModelConfig, x, router_w):
    """x [T, D] → (gates [T, k] f32, experts [T, k] int64, probs [T, E]
    f32). Ties rank the lower expert index first, as jax.lax.top_k does: a
    stable descending sort (torch.topk promises no order among equals)."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    vals, idx = vals[:, :k], idx[:, :k]
    if cfg.moe.norm_topk_prob:
        vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    return vals, idx, probs


def _bucket_capacity(tc: int, k: int, ep: int, s: int, cf: float) -> int:
    c = math.ceil(tc * k * cf / (ep * s))
    return max(8, ((c + 7) // 8) * 8)


# ----------------------------------------------------------------------
def moe_ffn(cfg: ModelConfig, x, router_w, w1, w3, w2, tables: dict,
            shared: Optional[tuple] = None, token_mask=None,
            train: bool = False):
    """x [T, D] → (y [T, D] in x's dtype, expert_counts [E] f32).

    Counts are the routed (token, choice) assignments per expert, taken
    before the capacity cut and weighted by token_mask [T] (inactive decode
    slots and padded prefill rows are routed and take capacity, exactly as
    in the reference, but do not count). w1/w3 [1, s, D, Fe], w2 [1, s,
    Fe, D]; shared (sw1, sw3, sw2) is the shared experts' SwiGLU, a plain
    product outside any kernel. With `train` the three expert products are
    `torch.bmm` over the slot buffers (what the reference's einsums
    compute; the moe_gmm kernel has no backward), so gradients reach the
    router, the slot weights and the shared experts; routing, capacity and
    counts are the serving path's."""
    R, s = w1.shape[0], w1.shape[1]
    if R != 1:
        raise NotImplementedError(
            f"expert parallelism over {R} ranks is not ported yet (one "
            f"device: slot weights [1, s, ...])")
    k = cfg.moe.top_k
    E = cfg.moe.n_experts
    T, D = x.shape
    dev = x.device
    gates, eidx, _ = router(cfg, x, router_w)                 # [T, k]
    cw = (token_mask.float().repeat_interleave(k)
          if token_mask is not None else
          torch.ones(T * k, dtype=torch.float32, device=dev))
    counts = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, eidx.reshape(-1), cw)

    # replica choice: round-robin over (token, choice) across the whole T
    tok_pos = (torch.arange(T, device=dev)[:, None] * k
               + torch.arange(k, device=dev)[None, :])
    n_rep = tables["n_rep"].long()[eidx]
    rr = tok_pos % torch.clamp(n_rep, min=1)
    # one rank: rep_rank is all 0 and the slot is the dispatch key
    dslot = tables["rep_slot"].long()[eidx, rr]               # [T, k]

    tc = min(cfg.moe_token_chunk, T)
    while T % tc:
        tc //= 2
    Cb = _bucket_capacity(tc, k, R, s, cfg.moe.capacity_factor)
    a = tc * k
    src = torch.arange(tc, device=dev).repeat_interleave(k)   # [a]
    slot_ids = torch.arange(s, device=dev)
    ys = []
    for c in range(T // tc):
        rows = slice(c * tc, (c + 1) * tc)
        xk = x[rows]
        key = dslot[rows].reshape(a)
        gate_f = gates[rows].reshape(a)
        # position of each assignment in its slot: the running count of
        # that slot's assignments in token order
        onehot = (key[:, None] == slot_ids[None, :]).to(torch.int32)
        pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
        valid = pos < Cb
        # dropped assignments land on a spare row past the buffer
        flat = torch.where(valid, key * Cb + pos,
                           torch.full_like(key, s * Cb))
        send = torch.zeros((s * Cb + 1, D), dtype=x.dtype, device=dev)
        send[flat] = xk[src]
        xe = send[:s * Cb].view(s, Cb, D)
        n_valid = torch.clamp(
            torch.zeros(s, dtype=torch.int32, device=dev).index_add_(
                0, key, torch.ones_like(key, dtype=torch.int32)), max=Cb)
        # rows past a slot's n_valid are zeros in xe, so the plain products
        # give them the kernel's zeros too
        gmm = (lambda a, w, _nv: torch.bmm(a, w)) if train else moe_gmm
        h = torch.nn.functional.silu(gmm(xe, w1[0], n_valid))
        h = h * gmm(xe, w3[0], n_valid)
        oe = gmm(h, w2[0], n_valid).view(s * Cb, D)
        res = oe[torch.where(valid, flat, torch.zeros_like(flat))]
        wgt = (gate_f * valid).to(res.dtype)[:, None]
        # src repeats each token k times in a row: the combine is a sum over
        # each token's k choices, in choice order
        ys.append((res * wgt).view(tc, k, D).sum(dim=1))
    y = torch.cat(ys, dim=0)
    if shared is not None:
        y = y + swiglu(x, *shared)
    return y, counts


# ----------------------------------------------------------------------
def moe_ffn_dense(cfg: ModelConfig, x, router_w, ew1, ew3, ew2,
                  shared=None):
    """Dense oracle over canonical expert weights [E, D, Fe] / [E, Fe, D]:
    every expert on every token, weighted by the routed gates (no
    capacity). Tests and chip_smoke.py's check only."""
    gates, eidx, _ = router(cfg, x, router_w)
    E = cfg.moe.n_experts
    T = x.shape[0]
    gmat = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    gmat[torch.arange(T, device=x.device)[:, None], eidx] += gates
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(E):
        h = torch.nn.functional.silu(x @ ew1[e]) * (x @ ew3[e])
        y = y + gmat[:, e:e + 1] * (h @ ew2[e]).float()
    if shared is not None:
        y = y + swiglu(x, *shared).float()
    return y.to(x.dtype)
