"""Expert-parallel MoE FFN with OmniPlacement slot tables.

Layout (the reference's, src/repro/models/moe.py):
  · experts live in per-rank *slots* over the EP ranks of a `RankCtx`:
    slot weights w1/w3 [R, s, D, Fe], w2 [R, s, Fe, D] with R = ep, each
    rank holding its [1, s, ...] part (and, at tp > 1, its Fe / tp columns
    of w1/w3 and rows of w2);
  · a *placement* maps experts → (rank, slot) replicas, held as tables of
    int tensors (`tables_from_placement`); redundant slots host replicas of
    hot experts, and the replica of each (token, choice) is a deterministic
    round-robin over the replicas;
  · dispatch (the body of the reference's shard_map): bucket the (token,
    choice) assignments per (rank, slot) in token order, exchange the
    buckets over `data` (all_to_all), run the three expert products over
    each local slot's rows through the `moe_gmm` kernel with the slot's
    valid-row count (`torch.bmm` on the train path), exchange the results
    back, then a weighted combine and a psum over `model`. Assignments past
    a bucket's capacity Cb are dropped (they add 0; the kept gates are not
    renormalised).

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
from repro_torch.distributed.ctx import RankCtx
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


# the capacity cut's drop tallies, one per device (`drop_tally`)
_DROP_TALLY: dict = {}


def drop_tally(device) -> torch.Tensor:
    """The running count of the live (token, choice) assignments that a
    bucket's capacity dropped in `moe_ffn` on `device` (weighted like the
    expert counts: inactive and padded rows count nothing): a float32
    scalar each call adds to in place on the device, so the replays of a
    captured step count too. It is created, and counts from then on, at
    the first call for the device (before the steps that should count are
    captured); zero it in place to restart. Read by tests and
    chip_smoke.py; nothing on the serving path reads it."""
    dev = torch.empty(0, device=device).device
    if dev not in _DROP_TALLY:
        _DROP_TALLY[dev] = torch.zeros((), dtype=torch.float32, device=dev)
    return _DROP_TALLY[dev]


def _bucket_capacity(tc: int, k: int, ep: int, s: int, cf: float) -> int:
    c = math.ceil(tc * k * cf / (ep * s))
    return max(8, ((c + 7) // 8) * 8)


# ----------------------------------------------------------------------
def _a2a(ctx: RankCtx, cfg: ModelConfig, x):
    """The tiled all_to_all over `data` of a dispatch or combine buffer
    [ep, n, D]; with cfg.moe_dispatch_int8 the rows travel as int8 with a
    float32 max-abs scale each and are dequantized on arrival (the
    reference's transport, src/repro/models/moe.py:174-184)."""
    if not cfg.moe_dispatch_int8:
        return ctx.all_to_all_data(x)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Int8Transport.apply(x, ctx, cfg)
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True) / 127.0,
                        min=1e-9)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    q = ctx.all_to_all_data(q)
    scale = ctx.all_to_all_data(scale.float())
    return q.to(x.dtype) * scale.to(x.dtype)


class _Int8Transport(torch.autograd.Function):
    """The int8 transport on the autograd path: the forward quantizes,
    exchanges and dequantizes as `_a2a` does; the backward carries the
    float cotangent through the same tiled all_to_all (straight through
    the rounding)."""

    @staticmethod
    def forward(fc, x, ctx, cfg):
        fc.ctx = ctx
        return _a2a(ctx, cfg, x)

    @staticmethod
    def backward(fc, g):
        return fc.ctx.all_to_all_data(g.contiguous()), None, None


def moe_ffn(cfg: ModelConfig, x, router_w, w1, w3, w2, tables: dict,
            shared: Optional[tuple] = None, token_mask=None,
            train: bool = False, ctx: Optional[RankCtx] = None,
            shard_tokens: bool = False):
    """x [T, D] → (y [T, D] in x's dtype, expert_counts [E] f32).

    w1/w3 [1, s, D, Fe'], w2 [1, s, Fe', D] are this rank's s expert slots
    (rank e of `ctx.ep`; Fe' = Fe / tp where the expert width shards over
    `model`). Counts are the routed (token, choice) assignments per expert,
    taken before the capacity cut and weighted by token_mask [T] (inactive
    decode slots and padded prefill rows are routed and take capacity,
    exactly as in the reference, but do not count). shared (sw1, sw3, sw2)
    is the shared experts' SwiGLU, a plain product outside any kernel.

    The reference's shard_map body (src/repro/models/moe.py:155-231): route;
    pick each (token, choice)'s replica round-robin; bucket the
    assignments per (rank, slot) in token order, Cb rows each; all_to_all
    over `data`; the rank's s slots run the three expert products over
    their received rows through the `moe_gmm` kernel (each slot's rows
    from every source rank compacted to a prefix first, so the kernel's
    n_valid holds); all_to_all back; the gate-weighted combine; psum over
    `model` of the expert-FFN width's partial sums (shared experts
    included); with `shard_tokens` (the batch rows split over `data`, as
    the reference's batch_part) this rank routes its T / ep rows, the
    counts are summed over `data` and y is gathered back to [T, D].
    Assignments past a bucket's capacity are dropped (they add 0; the kept
    gates are not renormalised; `drop_tally` counts them). With `train`
    the products are `torch.bmm` (the kernel has no backward) and the
    exchanges are differentiable: the rank routes its own rows (never
    `shard_tokens`), an expert slot's gradient stays on the rank that
    holds it, and where a width is sharded over `model` that branch's
    input enters it through `ctx.enter_model` (the router reads the
    routed branch's, so its gradient is each rank's share: the trainer
    sums it, `LM.grad_sync`)."""
    ctx = ctx if ctx is not None else RankCtx.local()
    if w1.shape[0] != 1:
        raise ValueError(
            f"slot weights {tuple(w1.shape)}: pass this rank's slots [1, s, "
            f"...] (DevicePlacement.place_params / transfer_params)")
    ep, s = ctx.ep, w1.shape[1]
    k = cfg.moe.top_k
    E = cfg.moe.n_experts
    dev = x.device
    T_all = x.shape[0]
    if shard_tokens and ep > 1:
        T_loc = T_all // ep
        x = x[ctx.e * T_loc:(ctx.e + 1) * T_loc]
        if token_mask is not None:
            token_mask = token_mask[ctx.e * T_loc:(ctx.e + 1) * T_loc]
    T, D = x.shape
    # the sharded branches' input ("f": a no-op without grad); the routed
    # branch (router, dispatch) and the shared experts each take it where
    # their width is split over `model`
    full_sh = cfg.moe.n_shared_experts * cfg.moe.d_ff_expert
    routed_split = w1.shape[-1] != cfg.moe.d_ff_expert
    shared_split = shared is not None and shared[0].shape[1] != full_sh
    xf = ctx.enter_model(x) if routed_split or shared_split else x
    x_shared = xf if shared_split else x
    x = xf if routed_split else x
    gates, eidx, _ = router(cfg, x, router_w)                 # [T, k]
    cw = (token_mask.float().repeat_interleave(k)
          if token_mask is not None else
          torch.ones(T * k, dtype=torch.float32, device=dev))
    counts = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, eidx.reshape(-1), cw)

    # replica choice: round-robin over (token, choice) across the rank's T
    tok_pos = (torch.arange(T, device=dev)[:, None] * k
               + torch.arange(k, device=dev)[None, :])
    n_rep = tables["n_rep"].long()[eidx]
    rr = tok_pos % torch.clamp(n_rep, min=1)
    # the dispatch key: the (rank, slot) bucket of each assignment
    dkey = (tables["rep_rank"].long()[eidx, rr] * s
            + tables["rep_slot"].long()[eidx, rr])            # [T, k]

    tc = min(cfg.moe_token_chunk, T)
    while T % tc:
        tc //= 2
    Cb = _bucket_capacity(tc, k, ep, s, cfg.moe.capacity_factor)
    a, nb = tc * k, ep * s
    src = torch.arange(tc, device=dev).repeat_interleave(k)   # [a]
    bucket_ids = torch.arange(nb, device=dev)
    gmm = (lambda a, w, _nv: torch.bmm(a, w)) if train else moe_gmm
    ys = []
    for c in range(T // tc):
        rows = slice(c * tc, (c + 1) * tc)
        xk = x[rows]
        key = dkey[rows].reshape(a)
        gate_f = gates[rows].reshape(a)
        # position of each assignment in its bucket: the running count of
        # that bucket's assignments in token order
        onehot = (key[:, None] == bucket_ids[None, :]).to(torch.int32)
        pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
        valid = pos < Cb
        tally = _DROP_TALLY.get(dev)
        if tally is not None:
            tally += (cw[c * a:(c + 1) * a] * ~valid).sum()
        # dropped assignments land on a spare row past the buffer
        flat = torch.where(valid, key * Cb + pos,
                           torch.full_like(key, nb * Cb))
        send = torch.zeros((nb * Cb + 1, D), dtype=x.dtype, device=dev)
        send[flat] = xk[src]
        n_send = torch.clamp(
            torch.zeros(nb, dtype=torch.int32, device=dev).index_add_(
                0, key, torch.ones_like(key, dtype=torch.int32)), max=Cb)
        if ep == 1:
            # one rank: each slot's rows are already a prefix of its bucket;
            # rows past n_valid are zeros, so the plain products give them
            # the kernel's zeros too
            xe = send[:s * Cb].view(s, Cb, D)
            h = torch.nn.functional.silu(gmm(xe, w1[0], n_send))
            h = h * gmm(xe, w3[0], n_send)
            ret = gmm(h, w2[0], n_send).view(s * Cb, D)
        else:
            recv = _a2a(ctx, cfg, send[:nb * Cb].view(ep, s * Cb, D))
            n_recv = ctx.all_to_all_data(n_send.view(ep, s))  # [src, s]
            # compact slot j's rows: source i's after those of sources < i;
            # a bucket's rows past its count go to a spare row
            width = ep * Cb
            off = torch.cumsum(n_recv, dim=0) - n_recv
            r = torch.arange(Cb, device=dev, dtype=torch.int32)
            dest = torch.where(r[None, None] < n_recv[..., None],
                               off[..., None] + r, width)      # [ep, s, Cb]
            j = torch.arange(s, device=dev)[None, :, None]
            cidx = torch.where(dest < width, j * width + dest,
                               s * width).reshape(-1).long()
            buf = torch.zeros((s * width + 1, D), dtype=x.dtype, device=dev)
            buf[cidx] = recv.reshape(-1, D)
            xe = buf[:s * width].view(s, width, D)
            n_valid = n_recv.sum(dim=0)
            h = torch.nn.functional.silu(gmm(xe, w1[0], n_valid))
            h = h * gmm(xe, w3[0], n_valid)
            oe = torch.cat([gmm(h, w2[0], n_valid).view(s * width, D),
                            torch.zeros((1, D), dtype=x.dtype, device=dev)])
            ret = _a2a(ctx, cfg, oe[cidx].view(ep, s * Cb, D)
                       ).view(nb * Cb, D)
        res = ret[torch.where(valid, flat, torch.zeros_like(flat))]
        wgt = (gate_f * valid).to(res.dtype)[:, None]
        # src repeats each token k times in a row: the combine is a sum over
        # each token's k choices, in choice order
        ys.append((res * wgt).view(tc, k, D).sum(dim=1))
    y = torch.cat(ys, dim=0)
    # partial sums over `model` where a width is sharded (the routed
    # experts', the shared experts'): one psum for both
    split, whole = [], []
    (split if routed_split else whole).append(y)
    if shared is not None:
        (split if shared_split else whole).append(swiglu(x_shared, *shared))
    y = ctx.psum_model(sum(split[1:], split[0])) if split else None
    for part in whole:
        y = part if y is None else y + part
    if shard_tokens and ep > 1:
        y = ctx.all_gather_data(y, dim=0)
        counts = ctx.psum_batch(counts)
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
