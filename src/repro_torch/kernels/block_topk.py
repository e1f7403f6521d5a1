"""Quest-style per-block upper-bound scores and the top-k block table for
online top-k KV sparsity.

`block_topk_scores` and `block_topk_select` launch the hand-written CUDA
kernel `csrc/block_topk.cu` (the port of the TPU kernel
src/repro/kernels/block_topk.py, and in select mode of the selection that
follows it, src/repro/models/attention.py::select_kv_blocks) for tensors
on a CUDA device, and run their plain PyTorch versions for tensors on the
CPU. `block_topk_scores.launches` counts the launches of its score pass
from either entry point (nothing else adds to it).
`block_topk_select_scores` ranks and compacts given scores — over several
`model` ranks, the max of each rank's score pass over its own heads — with
the kernel's scores-given entry; `block_topk_select_scores.launches`
counts those launches.

The score of tabled block j of sequence b bounds every key dot-product
inside the block from above:

    score[b, j] = max_{kv head, query head} Σ_c max(q_c·kmin_c, q_c·kmax_c)

and is NEG_INF for blocks whose logical slot range starts at or past
lens[b] (their table entries alias the null block).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels._common import (DTYPE_CODES, HEAD_DIMS, kernel_arg,
                                         meta_call, per_row, refuse_autograd)

NEG_INF = -1e30
# the kernel's grid (csrc/block_topk.cu::topk::plan): a cluster of CTAs per
# slot, each scoring about TOPK_MIN_SHARE tabled blocks, at most
# TOPK_MAX_CLUSTER of them; tables up to TOPK_NB_MAX entries (the ranking's
# keys live in one CTA's shared memory)
TOPK_MAX_CLUSTER = 8
TOPK_MIN_SHARE = 32
TOPK_NB_MAX = 8192


def topk_cluster_plan(nb: int) -> tuple:
    """The grid of a width-`nb` table → (cluster, per): `cluster` CTAs per
    slot, CTA r scoring tabled blocks [r·per, min((r+1)·per, nb)). Shapes
    only, so a launch needs no host read. Raises past TOPK_NB_MAX."""
    if not 1 <= nb <= TOPK_NB_MAX:
        raise ValueError(f"block_topk kernel takes tables of 1..{TOPK_NB_MAX}"
                         f" entries, got {nb}")
    c = min(-(-nb // TOPK_MIN_SHARE), TOPK_MAX_CLUSTER)
    return c, -(-nb // c)


def block_topk_scores_plain(q, kmin, kmax, tables, lens, *, block_size: int):
    """q [B,K,G,h]; kmin/kmax [N,K,h] float32; tables [B,nb]; lens [B] →
    scores [B,nb] float32. Gathers the tabled summaries and reduces in
    float32."""
    B, K, G, h = q.shape
    nb = tables.shape[1]
    tl = tables.long()
    lo = kmin[tl].float()[:, :, :, None, :]               # [B, nb, K, 1, h]
    hi = kmax[tl].float()[:, :, :, None, :]
    qg = q.float()[:, None]                               # [B, 1, K, G, h]
    ub = torch.maximum(qg * lo, qg * hi).sum(-1)          # [B, nb, K, G]
    s = ub.amax(dim=(2, 3))
    lens = per_row(lens, B, q.device)
    resident = (torch.arange(nb, device=q.device)[None] * block_size) \
        < lens[:, None]
    return torch.where(resident, s, torch.full_like(s, NEG_INF))


def select_kv_blocks(scores, tables, lens, *, block_size: int, k_static: int,
                     frac: float = 0.0, sink_blocks: int = 1,
                     recent_blocks: int = 2):
    """Per-slot top-k block selection → a compacted block table.

    scores [B, nb] upper-bound block scores (NEG_INF past residency);
    tables [B, nb]; lens [B] resident logical slots. Keeps up to `k_static`
    resident blocks per slot: the sink blocks (logical j < sink_blocks) and
    the `recent_blocks` most recent ones are forced, the rest ranked by
    score, equal scores by the lower index first (as jax.lax.top_k ranks
    them: a stable descending sort). With `frac > 0` the per-slot budget is
    ceil(frac · resident blocks), floored at the forced keeps; budgets at or
    above the resident count keep every resident block in logical order, so
    the compacted table equals the input table.

    Selected blocks land in logical order (ascending), so all entries but
    the last are full blocks and `new_lens = (m-1)·bs + tail fill` makes the
    paged-decode occupancy mask right on the compacted view; unused entries
    are the null block 0.

    → (new_tables [B, k_static] int32, new_lens [B] int32, m [B] selected
    block counts, selected [B, nb] bool over the original logical blocks)."""
    B, nb = tables.shape
    dev = tables.device
    lens = lens.to(torch.int32)
    n_res = torch.div(lens + block_size - 1, block_size,
                      rounding_mode="floor")                 # [B] >= 1
    j = torch.arange(nb, device=dev)
    resident = j[None] < n_res[:, None]
    keep = resident & ((j[None] < sink_blocks)
                       | (j[None] >= (n_res - recent_blocks)[:, None]))
    adj = torch.where(keep, torch.full_like(scores, float("inf")),
                      torch.where(resident, scores,
                                  torch.full_like(scores, float("-inf"))))
    idx = torch.sort(adj, dim=1, descending=True, stable=True).indices[
        :, :k_static]                                        # [B, k_static]
    if frac > 0:
        k_b = torch.ceil(frac * n_res.float()).to(torch.int32)
        k_b = torch.clamp(k_b, min=sink_blocks + recent_blocks)
    else:
        k_b = torch.full_like(n_res, k_static)
    k_b = torch.minimum(k_b, n_res)                          # degrade
    sel = (torch.arange(k_static, device=dev)[None] < k_b[:, None]) \
        & torch.gather(resident, 1, idx)
    sidx = torch.sort(torch.where(sel, idx, torch.full_like(idx, nb)),
                      dim=1).values                          # pad → nb
    gat = torch.gather(tables, 1, torch.clamp(sidx, max=nb - 1))
    new_tables = torch.where(sidx < nb, gat, torch.zeros_like(gat)) \
        .to(torch.int32)
    m = sel.sum(dim=1).to(torch.int32)
    tail_fill = lens - (n_res - 1) * block_size
    new_lens = (torch.clamp(m - 1, min=0) * block_size + tail_fill) \
        .to(torch.int32)
    selected = torch.zeros((B, nb), dtype=torch.bool, device=dev) \
        .scatter(1, idx, sel)                          # idx rows distinct
    return new_tables, new_lens, m, selected


def block_topk_select_scores_plain(scores, tables, lens, *, block_size: int,
                                   k_static: int, frac: float = 0.0,
                                   sink_blocks: int = 1,
                                   recent_blocks: int = 2, token_mask=None):
    """`select_kv_blocks` on given scores → (new_tables, new_lens, m,
    selected, aux): aux [4] float32 is the decode step's sparsity stats
    [Σ act·n_res, Σ act·m, 0, 0], act = token_mask [B] (bool; None: every
    slot live)."""
    B = scores.shape[0]
    dev = scores.device
    lens = per_row(lens, B, dev)
    sel = select_kv_blocks(scores, tables, lens, block_size=block_size,
                           k_static=k_static, frac=frac,
                           sink_blocks=sink_blocks,
                           recent_blocks=recent_blocks)
    act = token_mask.float() if token_mask is not None else \
        torch.ones(B, dtype=torch.float32, device=dev)
    n_res = torch.div(lens + block_size - 1, block_size,
                      rounding_mode="floor")
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    aux = torch.stack([(act * n_res).sum(), (act * sel[2]).sum(), zero,
                       zero])
    return (*sel, aux)


def block_topk_select_plain(q, kmin, kmax, tables, lens, *, block_size: int,
                            k_static: int, frac: float = 0.0,
                            sink_blocks: int = 1, recent_blocks: int = 2,
                            token_mask=None):
    """`block_topk_scores_plain` followed by `select_kv_blocks` → (scores,
    new_tables, new_lens, m, selected, aux), aux as
    `block_topk_select_scores_plain` gives it."""
    lens = per_row(lens, q.shape[0], q.device)
    scores = block_topk_scores_plain(q, kmin, kmax, tables, lens,
                                     block_size=block_size)
    return (scores, *block_topk_select_scores_plain(
        scores, tables, lens, block_size=block_size, k_static=k_static,
        frac=frac, sink_blocks=sink_blocks, recent_blocks=recent_blocks,
        token_mask=token_mask))


def _kernel_args(q, kmin, kmax, tables, lens):
    """Check the inputs of a launch → (q, kmin, kmax, tables, lens) ready
    for raw pointers."""
    B, K, G, h = q.shape
    N, Ks, hs = kmin.shape
    if (Ks, hs) != (K, h) or kmax.shape != kmin.shape:
        raise ValueError(f"summaries {tuple(kmin.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if q.dtype not in DTYPE_CODES or h not in HEAD_DIMS:
        raise ValueError(f"block_topk kernel takes float32/bfloat16 q and "
                         f"h in {HEAD_DIMS}, got {q.dtype}, h={h}")
    if tables.ndim != 2 or tables.shape[0] != B:
        raise ValueError(f"tables {tuple(tables.shape)} do not match q "
                         f"{tuple(q.shape)}")
    topk_cluster_plan(tables.shape[1])            # raises past the limit
    dev = q.device
    return (kernel_arg(q, dev), kernel_arg(kmin, dev, torch.float32),
            kernel_arg(kmax, dev, torch.float32),
            kernel_arg(tables, dev, torch.int32),
            kernel_arg(per_row(lens, B, dev), dev, torch.int32))


def block_topk_scores(q, kmin, kmax, tables, lens, *, block_size: int):
    """q [B,K,G,h] float32/bfloat16; kmin/kmax [N,K,h] float32; tables
    [B,nb] physical block ids; lens [B] resident logical slots → scores
    [B,nb] float32. Summaries of non-resident blocks are never read."""
    if q.device.type == "meta":
        from repro_torch.launch.cost import topk_bound
        return meta_call("block_topk_scores",
                         q.new_empty(tables.shape, dtype=torch.float32),
                         topk_bound(q, tables, lens, block_size),
                         torch.float32)
    if q.device.type != "cuda":
        return block_topk_scores_plain(q, kmin, kmax, tables, lens,
                                       block_size=block_size)
    refuse_autograd("block_topk_scores", q, kmin, kmax)
    q, lo, hi, tbl, ln = _kernel_args(q, kmin, kmax, tables, lens)
    B, K, G, h = q.shape
    nb = tbl.shape[1]
    dev = q.device
    out = torch.empty((B, nb), dtype=torch.float32, device=dev)
    lib = build.load("block_topk")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.block_topk_launch(
            DTYPE_CODES[q.dtype], q.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            tbl.data_ptr(), ln.data_ptr(), out.data_ptr(), B, K, G, h, nb,
            int(block_size), stream)
    build.check_launch("block_topk", rc)
    block_topk_scores.launches += 1
    return out


block_topk_scores.launches = 0


def block_topk_select(q, kmin, kmax, tables, lens, *, block_size: int,
                      k_static: int, frac: float = 0.0, sink_blocks: int = 1,
                      recent_blocks: int = 2, token_mask=None):
    """The scores and the top-k block table in one launch: q [B,K,G,h];
    kmin/kmax [N,K,h] float32; tables [B,nb]; lens [B]; token_mask [B]
    bool live slots (None: all) → (scores [B,nb] float32, new_tables
    [B,k_static] int32, new_lens [B] int32, m [B] int32, selected [B,nb]
    bool, aux [4] float32), the tables, lens, counts and mask those of
    `select_kv_blocks` on the returned scores and aux that of
    `block_topk_select_plain`, bit for bit. Every argument but the tensors
    is fixed by the config: nothing is read on the host."""
    if q.device.type == "meta":
        from repro_torch.launch.cost import topk_select_bound
        return meta_call("block_topk_scores",
                         (q.new_empty(tables.shape, dtype=torch.float32),
                          *_meta_select_outputs(tables, k_static)),
                         topk_select_bound(q, tables, lens, block_size,
                                           k_static), torch.float32)
    if q.device.type != "cuda":
        return block_topk_select_plain(
            q, kmin, kmax, tables, lens, block_size=block_size,
            k_static=k_static, frac=frac, sink_blocks=sink_blocks,
            recent_blocks=recent_blocks, token_mask=token_mask)
    refuse_autograd("block_topk_select", q, kmin, kmax)
    q, lo, hi, tbl, ln = _kernel_args(q, kmin, kmax, tables, lens)
    B, K, G, h = q.shape
    nb = tbl.shape[1]
    dev = q.device
    mask, new_tables, new_lens, m, selected, aux = _select_outputs(
        B, nb, k_static, token_mask, dev)
    scores = torch.empty((B, nb), dtype=torch.float32, device=dev)
    lib = build.load("block_topk")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.block_topk_select_launch(
            DTYPE_CODES[q.dtype], q.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            tbl.data_ptr(), ln.data_ptr(), scores.data_ptr(),
            new_tables.data_ptr(), new_lens.data_ptr(), m.data_ptr(),
            selected.data_ptr(), None if mask is None else mask.data_ptr(),
            aux.data_ptr(), B, K, G, h, nb,
            int(block_size), int(k_static), int(frac > 0), float(frac),
            int(sink_blocks), int(recent_blocks), stream)
    build.check_launch("block_topk", rc)
    block_topk_scores.launches += 1
    return scores, new_tables, new_lens, m, selected, aux


def _meta_select_outputs(tables, k_static) -> tuple:
    """(new_tables, new_lens, m, selected, aux), empty, on meta."""
    B, nb = tables.shape
    e = functools.partial(torch.empty, device=tables.device)
    return (e((B, k_static), dtype=torch.int32), e((B,), dtype=torch.int32),
            e((B,), dtype=torch.int32), e((B, nb), dtype=torch.bool),
            e((4,), dtype=torch.float32))


def _select_outputs(B, nb, k_static, token_mask, dev):
    """Check a select launch's budget and mask → (mask or None, new_tables,
    new_lens, m, selected, aux) allocated on dev."""
    if not 1 <= k_static <= nb:
        raise ValueError(f"k_static {k_static} outside 1..{nb}")
    if B * nb >= 1 << 24:
        # aux sums counts of up to B·nb blocks in float32: exact below 2^24
        raise ValueError(f"block_topk_select takes B·nb < 2^24, got "
                         f"{B}·{nb}")
    if token_mask is not None and tuple(token_mask.shape) != (B,):
        raise ValueError(f"token_mask {tuple(token_mask.shape)} is not [{B}]")
    mask = None if token_mask is None else kernel_arg(token_mask, dev,
                                                      torch.bool)
    return (mask,
            torch.empty((B, k_static), dtype=torch.int32, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev),
            torch.empty((B, nb), dtype=torch.bool, device=dev),
            torch.empty((4,), dtype=torch.float32, device=dev))


def block_topk_select_scores(scores, tables, lens, *, block_size: int,
                             k_static: int, frac: float = 0.0,
                             sink_blocks: int = 1, recent_blocks: int = 2,
                             token_mask=None):
    """The ranking and compaction of `block_topk_select` on given scores
    [B,nb] float32 (over several `model` ranks: the max of their score
    passes) → (new_tables [B,k_static] int32, new_lens [B] int32, m [B]
    int32, selected [B,nb] bool, aux [4] float32), bit for bit
    `block_topk_select_scores_plain`. One launch of the kernel's
    scores-given entry (a CTA per slot, no score pass); nothing is read on
    the host. `block_topk_select_scores.launches` counts its launches."""
    if scores.device.type == "meta":
        from repro_torch.launch.cost import topk_given_bound
        return meta_call("block_topk_select_scores",
                         _meta_select_outputs(tables, k_static),
                         topk_given_bound(tables, lens, block_size, k_static),
                         torch.float32)
    if scores.device.type != "cuda":
        return block_topk_select_scores_plain(
            scores, tables, lens, block_size=block_size, k_static=k_static,
            frac=frac, sink_blocks=sink_blocks, recent_blocks=recent_blocks,
            token_mask=token_mask)
    refuse_autograd("block_topk_select_scores", scores)
    B, nb = scores.shape
    if tables.shape != (B, nb):
        raise ValueError(f"tables {tuple(tables.shape)} do not match scores "
                         f"{tuple(scores.shape)}")
    topk_cluster_plan(nb)                         # raises past the limit
    dev = scores.device
    sc = kernel_arg(scores, dev, torch.float32)
    tbl = kernel_arg(tables, dev, torch.int32)
    ln = kernel_arg(per_row(lens, B, dev), dev, torch.int32)
    mask, new_tables, new_lens, m, selected, aux = _select_outputs(
        B, nb, k_static, token_mask, dev)
    lib = build.load("block_topk")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.block_topk_select_scores_launch(
            sc.data_ptr(), tbl.data_ptr(), ln.data_ptr(),
            new_tables.data_ptr(), new_lens.data_ptr(), m.data_ptr(),
            selected.data_ptr(), None if mask is None else mask.data_ptr(),
            aux.data_ptr(), B, nb, int(block_size), int(k_static),
            int(frac > 0), float(frac), int(sink_blocks), int(recent_blocks),
            stream)
    build.check_launch("block_topk", rc)
    block_topk_select_scores.launches += 1
    return new_tables, new_lens, m, selected, aux


block_topk_select_scores.launches = 0
