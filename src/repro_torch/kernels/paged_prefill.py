"""Chunked-prefill attention over physically paged history KV.

`paged_prefill` launches the hand-written CUDA kernel
`csrc/paged_prefill.cu` (the port of the TPU kernel
src/repro/kernels/paged_prefill.py) for tensors on a CUDA device, and runs
`paged_prefill_plain` — the same function in plain PyTorch — for tensors on
the CPU. The kernel splits the history across CTAs (`prefill_splits`, from
shapes alone: the host never reads `off` or `chunk_len`) and merges the
splits by log-sum-exp. `paged_prefill.launches` counts calls that launch
the kernel (once per call, however many CUDA launches the split and its
merge take; nothing else adds to it), `paged_prefill.int8_launches` those
over int8 history (QuantPlane: int8 pages with the scale plane, dequantized
in the tile; the chunk's own keys are never quantized).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels._common import (DTYPE_CODES, HEAD_DIMS, gather_kv,
                                         kernel_arg, per_row,
                                         refuse_autograd, scale_plane_args)
from repro_torch.kernels.paged_decode import _sm_count, prefill_splits

NEG_INF = -1e30
PREFILL_ROWS = 64         # query rows per CTA of the kernel (csrc PP_WARPS)


def paged_prefill_plain(q, k_new, v_new, k_pages, v_pages, tables, off,
                        chunk_len, *, window: int = 0, sink: int = 0,
                        k_scale=None, k_tok=None, v_scale=None, v_tok=None):
    """q [B,K,S·G,h] (row r = chunk token r//G); k_new/v_new [B,K,S,h];
    pages [N,K,bs,h]; tables [B,nb]; off/chunk_len scalars or [B] →
    [B,K,S·G,h]. Gathers the tabled history into a linear cache (int8 pages
    dequantized through the scale plane), appends the chunk's keys and runs
    one float32 masked softmax: resident history (slot < off), real chunk
    keys (< chunk_len), causal on absolute positions, and the optional
    sink+window mask."""
    B, K, SG, h = q.shape
    S = k_new.shape[2]
    G = SG // S
    nb = tables.shape[1]
    bs = k_pages.shape[2]
    dev = q.device
    off = per_row(off, B, dev).long()
    cl = per_row(chunk_len, B, dev).long()
    k_hist = gather_kv(k_pages, tables, k_scale, k_tok)
    v_hist = gather_kv(v_pages, tables, v_scale, v_tok)
    k_all = torch.cat([k_hist.float(), k_new.float()], dim=2)
    v_all = torch.cat([v_hist.float(), v_new.float()], dim=2)
    ar_h = torch.arange(nb * bs, device=dev)
    ar_c = torch.arange(S, device=dev)
    tok = torch.cat([ar_h[None].expand(B, -1), off[:, None] + ar_c[None]],
                    dim=1)                                    # [B, L+S]
    res = torch.cat([ar_h[None] < off[:, None], ar_c[None] < cl[:, None]],
                    dim=1)
    p_row = off[:, None] + (torch.arange(SG, device=dev) // G)[None]
    ok = tok[:, None, :] <= p_row[:, :, None]
    if window > 0:
        win = (p_row[:, :, None] - tok[:, None, :]) < window
        if sink > 0:
            win = win | (tok < sink)[:, None, :]
        ok = ok & win
    mask = res[:, None, :] & ok                               # [B, SG, L+S]
    s = torch.einsum("bkrh,bkth->bkrt", q.float(), k_all) * h ** -0.5
    s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkrt,bkth->bkrh", p, v_all).to(q.dtype)


def paged_prefill(q, k_new, v_new, k_pages, v_pages, tables, off, chunk_len,
                  *, window: int = 0, sink: int = 0, k_scale=None,
                  k_tok=None, v_scale=None, v_tok=None):
    """q [B,K,S·G,h]; k_new/v_new [B,K,S,h]; arenas [N,K,bs,h]; tables
    [B,nb] physical block ids; off/chunk_len scalars or [B] (history length,
    real chunk rows) → o [B,K,S·G,h] in q's dtype. Rows ≥ chunk_len are
    padding: finite, but not meaningful. Int8 arenas pass their scale plane
    (k_scale/v_scale [N,K,h], k_tok/v_tok [N,K,bs] float32); k_new/v_new
    stay in q's dtype."""
    quant = k_scale is not None
    if q.device.type != "cuda":
        return paged_prefill_plain(q, k_new, v_new, k_pages, v_pages, tables,
                                   off, chunk_len, window=window, sink=sink,
                                   k_scale=k_scale, k_tok=k_tok,
                                   v_scale=v_scale, v_tok=v_tok)
    refuse_autograd("paged_prefill", q, k_new, v_new, k_pages, v_pages)
    B, K, SG, h = q.shape
    S = k_new.shape[2]
    if k_new.shape != (B, K, S, h) or v_new.shape != k_new.shape \
            or SG % S:
        raise ValueError(f"chunk keys {tuple(k_new.shape)} do not match q "
                         f"{tuple(q.shape)}")
    G = SG // S
    N, Kp, bs, hp = k_pages.shape
    if (Kp, hp) != (K, h) or v_pages.shape != k_pages.shape:
        raise ValueError(f"pages {tuple(k_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if q.dtype not in DTYPE_CODES or h not in HEAD_DIMS:
        raise ValueError(f"paged_prefill kernel takes float32/bfloat16 and "
                         f"h in {HEAD_DIMS}, got {q.dtype}, h={h}")
    dev = q.device
    q = kernel_arg(q, dev)
    kn = kernel_arg(k_new, dev, q.dtype)
    vn = kernel_arg(v_new, dev, q.dtype)
    kv_dtype = torch.int8 if quant else q.dtype
    kp = kernel_arg(k_pages, dev, kv_dtype)
    vp = kernel_arg(v_pages, dev, kv_dtype)
    tbl = kernel_arg(tables, dev, torch.int32)
    offs = kernel_arg(per_row(off, B, dev), dev, torch.int32)
    cls = kernel_arg(per_row(chunk_len, B, dev), dev, torch.int32)
    nb = tbl.shape[1]
    out = torch.empty_like(q)
    n_split, per = prefill_splits(B, K, -(-SG // PREFILL_ROWS), nb,
                                  _sm_count(dev.index))
    ws = None if n_split == 1 else torch.empty(
        B * K * n_split * SG * (h + 2), dtype=torch.float32, device=dev)
    ws_ptr = None if ws is None else ws.data_ptr()
    lib = build.load("paged_prefill")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if quant:
            sp = scale_plane_args(kp, (k_scale, k_tok, v_scale, v_tok), dev)
            rc = lib.paged_prefill_int8_launch(
                DTYPE_CODES[q.dtype], q.data_ptr(), kn.data_ptr(),
                vn.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                *(t.data_ptr() for t in sp), tbl.data_ptr(),
                offs.data_ptr(), cls.data_ptr(), out.data_ptr(), ws_ptr, B,
                K, S, G, h, bs, nb, n_split, per, h ** -0.5, int(window),
                int(sink), stream)
        else:
            rc = lib.paged_prefill_launch(
                DTYPE_CODES[q.dtype], q.data_ptr(), kn.data_ptr(),
                vn.data_ptr(), kp.data_ptr(), vp.data_ptr(), tbl.data_ptr(),
                offs.data_ptr(), cls.data_ptr(), out.data_ptr(), ws_ptr, B,
                K, S, G, h, bs, nb, n_split, per, h ** -0.5, int(window),
                int(sink), stream)
    build.check_launch("paged_prefill", rc)
    paged_prefill.launches += 1
    paged_prefill.int8_launches += int(quant)
    return out


paged_prefill.launches = 0
paged_prefill.int8_launches = 0
