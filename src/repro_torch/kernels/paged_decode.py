"""Decode-step attention over physically paged KV.

`paged_decode` launches the hand-written CUDA kernel `csrc/paged_decode.cu`
(the port of the TPU kernel src/repro/kernels/paged_decode.py) for tensors
on a CUDA device, and runs `paged_decode_plain` — the same function in plain
PyTorch — for tensors on the CPU. `paged_decode.launches` counts kernel
launches (nothing else adds to it).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels._common import (DTYPE_CODES, HEAD_DIMS, kernel_arg,
                                         per_row)

NEG_INF = -1e30


def paged_decode_plain(q, k_pages, v_pages, tables, lens):
    """q [B,K,G,h]; pages [N,K,bs,h]; tables [B,nb]; lens [B] → [B,K,G,h].
    Gathers the tabled blocks into a linear [B,K,nb·bs,h] cache and runs a
    float32 masked softmax over the first `lens` logical slots."""
    B, K, G, h = q.shape
    nb = tables.shape[1]
    bs = k_pages.shape[2]
    tl = tables.long()
    k_lin = k_pages[tl].permute(0, 2, 1, 3, 4).reshape(B, K, nb * bs, h)
    v_lin = v_pages[tl].permute(0, 2, 1, 3, 4).reshape(B, K, nb * bs, h)
    s = torch.einsum("bkgh,bkwh->bkgw", q.float(), k_lin.float()) * h ** -0.5
    lens = per_row(lens, B, q.device)
    occ = torch.arange(nb * bs, device=q.device)[None, None, None, :] \
        < lens[:, None, None, None]
    s = torch.where(occ, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgw,bkwh->bkgh", p, v_lin.float()).to(q.dtype)


def paged_decode(q, k_pages, v_pages, tables, lens):
    """q [B,K,G,h]; pages [N,K,bs,h]; tables [B,nb] physical block ids;
    lens [B] resident logical slots (≥ 1) → o [B,K,G,h] in q's dtype.
    Table entries past a sequence's resident blocks are never read."""
    if q.device.type != "cuda":
        return paged_decode_plain(q, k_pages, v_pages, tables, lens)
    B, K, G, h = q.shape
    N, Kp, bs, hp = k_pages.shape
    if (Kp, hp) != (K, h) or v_pages.shape != k_pages.shape:
        raise ValueError(f"pages {tuple(k_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if q.dtype not in DTYPE_CODES or h not in HEAD_DIMS:
        raise ValueError(f"paged_decode kernel takes float32/bfloat16 and "
                         f"h in {HEAD_DIMS}, got {q.dtype}, h={h}")
    dev = q.device
    q = kernel_arg(q, dev)
    kp = kernel_arg(k_pages, dev, q.dtype)
    vp = kernel_arg(v_pages, dev, q.dtype)
    tbl = kernel_arg(tables, dev, torch.int32)
    ln = kernel_arg(per_row(lens, B, dev), dev, torch.int32)
    nb = tbl.shape[1]
    out = torch.empty_like(q)
    lib = build.load("paged_decode")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.paged_decode_launch(
            DTYPE_CODES[q.dtype], q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
            tbl.data_ptr(), ln.data_ptr(), out.data_ptr(), B, K, G, h, bs, nb,
            h ** -0.5, stream)
    build.check_launch("paged_decode", rc)
    paged_decode.launches += 1
    return out


paged_decode.launches = 0
