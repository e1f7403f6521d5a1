"""Decode-step attention over physically paged KV.

`paged_decode` launches the hand-written CUDA kernel `csrc/paged_decode.cu`
(the port of the TPU kernel src/repro/kernels/paged_decode.py) for tensors
on a CUDA device, and runs `paged_decode_plain` — the same function in plain
PyTorch — for tensors on the CPU. The kernel splits each sequence's table
across CTAs (split-KV) and merges the splits by log-sum-exp; the split plan
(`decode_splits`) depends on shapes only, never on `lens`. A CTA holds at
most DECODE_ROW_FLOATS / h query rows of a GQA group; a wider group is cut
into row groups (`decode_row_groups`), a further grid axis.
`prefill_splits` is the same kind of plan for the paged-history kernels
of paged_prefill and spec_verify.
`paged_decode.launches` (and `.int8_launches` for int8 arenas) advance once
per `paged_decode` call on a CUDA device, however many CUDA launches the
split and its merge take; nothing else adds to them.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels._common import (DTYPE_CODES, WIDE_HEAD_DIMS,
                                         gather_kv, kernel_arg, meta_call,
                                         per_row, refuse_autograd,
                                         scale_plane_args)

NEG_INF = -1e30
DECODE_WARPS = 4          # warps per CTA of the kernel (csrc DEC_WARPS)
DECODE_ROW_FLOATS = 2048  # query rows × h a decode CTA holds (csrc
                          # dec_gmax = MAXR·NT/h: ceil(h/32) accumulators a
                          # lane for each row; 16 rows at h 128, 8 at h 256,
                          # 25 at h 80, 21 at h 96)


def decode_row_groups(G: int, h: int) -> tuple[int, int]:
    """The row groups of a GQA group of G query rows from shapes alone →
    (n_grp, rows): CTA gi of a (slot, kv head, split) holds rows
    [gi·rows, min((gi+1)·rows, G)). The fewest groups of at most
    DECODE_ROW_FLOATS / h rows, balanced, none empty (G = 48 at h = 128:
    three groups of 16; G = 17: 9 + 8)."""
    n = -(-G // (DECODE_ROW_FLOATS // h))
    rows = -(-G // n)
    return -(-G // rows), rows


def decode_splits(B: int, K: int, nb: int, n_sm: int) -> tuple[int, int]:
    """The kernel's split plan from shapes alone → (n_split, per): grid
    (B, K, n_split), split s taking table entries [s·per, min((s+1)·per,
    nb)); the wrapper passes K·n_grp for K when a GQA group goes in row
    groups (`decode_row_groups`). About two CTAs per SM (B·K·n_split ≈
    2·n_sm) while every warp of a CTA can take at least one entry (per ≥
    DECODE_WARPS where nb allows); n_split = ceil(nb / per), so every split
    has an entry and every entry one split. Splits past a sequence's
    resident blocks add nothing."""
    want = -(-2 * n_sm // (B * K))
    n = max(1, min(want, nb // DECODE_WARPS, 65535))
    per = -(-nb // n)
    return -(-nb // per), per


def prefill_splits(B: int, K: int, n_row_tiles: int, nb: int,
                   n_sm: int) -> tuple[int, int]:
    """The split plan of the paged-history kernels (paged_prefill,
    spec_verify) from shapes alone → (n_split, per): grid (n_split,
    n_row_tiles, B·K), split s taking table entries [s·per, min((s+1)·per,
    nb)); the last split also takes the chunk's (or window's) own keys.
    About two CTAs per SM (B·K·n_row_tiles·n_split ≈ 2·n_sm); n_split =
    ceil(nb / per), so every split has an entry and every entry one split.
    Splits past a sequence's resident blocks add nothing."""
    want = -(-2 * n_sm // (B * K * n_row_tiles))
    n = max(1, min(want, nb, 65535))
    per = -(-nb // n)
    return -(-nb // per), per


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def paged_decode_plain(q, k_pages, v_pages, tables, lens, *, k_scale=None,
                       k_tok=None, v_scale=None, v_tok=None):
    """q [B,K,G,h]; pages [N,K,bs,h]; tables [B,nb]; lens [B] → [B,K,G,h].
    Gathers the tabled blocks into a linear [B,K,nb·bs,h] cache (int8
    pages dequantized through the scale plane) and runs a float32 masked
    softmax over the first `lens` logical slots."""
    B, K, G, h = q.shape
    nb = tables.shape[1]
    bs = k_pages.shape[2]
    k_lin = gather_kv(k_pages, tables, k_scale, k_tok)
    v_lin = gather_kv(v_pages, tables, v_scale, v_tok)
    s = torch.einsum("bkgh,bkwh->bkgw", q.float(), k_lin.float()) * h ** -0.5
    lens = per_row(lens, B, q.device)
    occ = torch.arange(nb * bs, device=q.device)[None, None, None, :] \
        < lens[:, None, None, None]
    s = torch.where(occ, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgw,bkwh->bkgh", p, v_lin.float()).to(q.dtype)


def paged_decode(q, k_pages, v_pages, tables, lens, *, k_scale=None,
                 k_tok=None, v_scale=None, v_tok=None):
    """q [B,K,G,h]; pages [N,K,bs,h]; tables [B,nb] physical block ids;
    lens [B] resident logical slots (≥ 1) → o [B,K,G,h] in q's dtype.
    Table entries past a sequence's resident blocks are never read. Int8
    arenas pass their scale plane: k_scale/v_scale [N,K,h], k_tok/v_tok
    [N,K,bs] float32; the pages then must be int8 (never cast)."""
    quant = k_scale is not None
    if q.device.type == "meta":
        from repro_torch.launch.cost import decode_bound
        return meta_call("paged_decode", torch.empty_like(q),
                         decode_bound(q, k_pages, tables, lens), q.dtype)
    if q.device.type != "cuda":
        return paged_decode_plain(q, k_pages, v_pages, tables, lens,
                                  k_scale=k_scale, k_tok=k_tok,
                                  v_scale=v_scale, v_tok=v_tok)
    refuse_autograd("paged_decode", q, k_pages, v_pages)
    B, K, G, h = q.shape
    N, Kp, bs, hp = k_pages.shape
    if (Kp, hp) != (K, h) or v_pages.shape != k_pages.shape:
        raise ValueError(f"pages {tuple(k_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if q.dtype not in DTYPE_CODES or h not in WIDE_HEAD_DIMS:
        raise ValueError(f"paged_decode kernel takes float32/bfloat16 and "
                         f"h in {WIDE_HEAD_DIMS}, got {q.dtype}, h={h}")
    dev = q.device
    q = kernel_arg(q, dev)
    kv_dtype = torch.int8 if quant else q.dtype
    kp = kernel_arg(k_pages, dev, kv_dtype)
    vp = kernel_arg(v_pages, dev, kv_dtype)
    tbl = kernel_arg(tables, dev, torch.int32)
    ln = kernel_arg(per_row(lens, B, dev), dev, torch.int32)
    nb = tbl.shape[1]
    out = torch.empty_like(q)
    n_grp, rows = decode_row_groups(G, h)
    n_split, per = decode_splits(B, K * n_grp, nb, _sm_count(dev.index))
    ws = None if n_split == 1 else torch.empty(
        B * K * n_split * G * (h + 2), dtype=torch.float32, device=dev)
    ws_ptr = None if ws is None else ws.data_ptr()
    lib = build.load("paged_decode")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if quant:
            sp = scale_plane_args(kp, (k_scale, k_tok, v_scale, v_tok), dev)
            rc = lib.paged_decode_int8_launch(
                DTYPE_CODES[q.dtype], q.data_ptr(), kp.data_ptr(),
                vp.data_ptr(), *(t.data_ptr() for t in sp), tbl.data_ptr(),
                ln.data_ptr(), out.data_ptr(), ws_ptr, B, K, G, h, n_grp,
                rows, bs, nb, n_split, per, h ** -0.5, stream)
        else:
            rc = lib.paged_decode_launch(
                DTYPE_CODES[q.dtype], q.data_ptr(), kp.data_ptr(),
                vp.data_ptr(), tbl.data_ptr(), ln.data_ptr(), out.data_ptr(),
                ws_ptr, B, K, G, h, n_grp, rows, bs, nb, n_split, per,
                h ** -0.5, stream)
    build.check_launch("paged_decode", rc)
    paged_decode.launches += 1
    paged_decode.int8_launches += int(quant)
    return out


paged_decode.launches = 0
paged_decode.int8_launches = 0
