"""Quest-style per-block upper-bound scores for online top-k KV sparsity.

`block_topk_scores` launches the hand-written CUDA kernel
`csrc/block_topk.cu` (the port of the TPU kernel
src/repro/kernels/block_topk.py) for tensors on a CUDA device, and runs
`block_topk_scores_plain` — the same function in plain PyTorch — for
tensors on the CPU. `block_topk_scores.launches` counts kernel launches
(nothing else adds to it).

The score of tabled block j of sequence b bounds every key dot-product
inside the block from above:

    score[b, j] = max_{kv head, query head} Σ_c max(q_c·kmin_c, q_c·kmax_c)

and is NEG_INF for blocks whose logical slot range starts at or past
lens[b] (their table entries alias the null block).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels._common import (DTYPE_CODES, HEAD_DIMS, kernel_arg,
                                         per_row)

NEG_INF = -1e30


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


def block_topk_scores(q, kmin, kmax, tables, lens, *, block_size: int):
    """q [B,K,G,h] float32/bfloat16; kmin/kmax [N,K,h] float32; tables
    [B,nb] physical block ids; lens [B] resident logical slots → scores
    [B,nb] float32. Summaries of non-resident blocks are never read."""
    if q.device.type != "cuda":
        return block_topk_scores_plain(q, kmin, kmax, tables, lens,
                                       block_size=block_size)
    B, K, G, h = q.shape
    N, Ks, hs = kmin.shape
    if (Ks, hs) != (K, h) or kmax.shape != kmin.shape:
        raise ValueError(f"summaries {tuple(kmin.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if q.dtype not in DTYPE_CODES or h not in HEAD_DIMS:
        raise ValueError(f"block_topk kernel takes float32/bfloat16 q and "
                         f"h in {HEAD_DIMS}, got {q.dtype}, h={h}")
    dev = q.device
    q = kernel_arg(q, dev)
    lo = kernel_arg(kmin, dev, torch.float32)
    hi = kernel_arg(kmax, dev, torch.float32)
    tbl = kernel_arg(tables, dev, torch.int32)
    ln = kernel_arg(per_row(lens, B, dev), dev, torch.int32)
    nb = tbl.shape[1]
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
