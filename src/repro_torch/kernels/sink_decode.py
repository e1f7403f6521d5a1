"""Decode-step attention over a dense sink‖ring (or full) KV cache.

`sink_decode` launches the hand-written CUDA kernel `csrc/sink_decode.cu`
(the port of the TPU kernel src/repro/kernels/sink_decode.py) for tensors on
a CUDA device, and runs `sink_decode_plain` — the same function in plain
PyTorch — for tensors on the CPU. The kernel splits each cache across CTAs
(split-KV, on the routine it shares with paged_decode) and merges the splits
by log-sum-exp; the split plan (`sink_splits`) depends on shapes only,
never on the occupancy `t`. `sink_decode.launches` advances once per
`sink_decode` call on a CUDA device, however many CUDA launches the split
and its merge take; nothing else adds to it.

The caches are [B, K, W, h] views of any strides with a contiguous h: the
model's [B, W, K, h] cache transposed is read in place, without a copy.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels._common import (DTYPE_CODES, WIDE_HEAD_DIMS,
                                         kernel_arg, meta_call, per_row,
                                         refuse_autograd)
from repro_torch.kernels.paged_decode import (_sm_count, decode_row_groups,
                                              decode_splits)

NEG_INF = -1e30
SINK_CHUNK = 16           # cache slots per chunk of the kernel's split plan
                          # (csrc SINK_CHUNK; staged 8 at a time at h = 256)


def sink_splits(B: int, K: int, W: int, n_sm: int) -> tuple[int, int]:
    """The kernel's split plan from shapes alone → (n_split, per): grid
    (B, K, n_split), split s taking the SINK_CHUNK-slot chunks [s·per,
    min((s+1)·per, ceil(W / SINK_CHUNK))) of the cache — paged_decode's
    plan (`decode_splits`) with the chunks in place of table entries.
    Chunks past a sequence's occupancy add nothing. A GQA group wider than
    a CTA holds goes in row groups as in paged_decode (`decode_row_groups`),
    the wrapper handing this plan K·n_grp in place of K."""
    return decode_splits(B, K, -(-W // SINK_CHUNK), n_sm)


def sink_decode_plain(q, k_cache, v_cache, t):
    """q [B,K,G,h]; caches [B,K,W,h]; t scalar or [B] occupancy → [B,K,G,h]
    in q's dtype: a float32 softmax over the slots w < t (all W once
    t > W, a wrapped ring)."""
    B, K, G, h = q.shape
    W = k_cache.shape[2]
    s = torch.einsum("bkgh,bkwh->bkgw", q.float(), k_cache.float()) \
        * h ** -0.5
    t = per_row(t, B, q.device)
    occ = torch.arange(W, device=q.device)[None, None, None, :] \
        < t[:, None, None, None]
    s = torch.where(occ, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgw,bkwh->bkgh", p, v_cache.float()).to(q.dtype)


def _strides(c: torch.Tensor, name: str) -> tuple:
    """Element strides (batch, kv head, slot) of a [B,K,W,h] cache view whose
    rows the kernel can load 16 bytes at a time."""
    align = 16 // c.element_size()
    st = c.stride()
    if st[3] != 1 or any(x % align for x in st[:3]) or c.data_ptr() % 16:
        raise ValueError(f"sink_decode: {name} needs a contiguous, 16-byte "
                         f"aligned h axis, got strides {st}")
    return st[0], st[1], st[2]


def sink_decode(q, k_cache, v_cache, t):
    """q [B,K,G,h]; caches [B,K,W,h] (strided views allowed); t [B]
    occupancy (≥ 1: slots < min(t, W) are live) → o [B,K,G,h] in q's
    dtype."""
    if q.device.type == "meta":
        from repro_torch.launch.cost import sink_bound
        return meta_call("sink_decode", torch.empty_like(q),
                         sink_bound(q, k_cache, t), q.dtype)
    if q.device.type != "cuda":
        return sink_decode_plain(q, k_cache, v_cache, t)
    refuse_autograd("sink_decode", q, k_cache, v_cache)
    B, K, G, h = q.shape
    Bc, Kc, W, hc = k_cache.shape
    if (Bc, Kc, hc) != (B, K, h) or v_cache.shape != k_cache.shape:
        raise ValueError(f"caches {tuple(k_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if q.dtype not in DTYPE_CODES or h not in WIDE_HEAD_DIMS:
        raise ValueError(f"sink_decode kernel takes float32/bfloat16 and "
                         f"h in {WIDE_HEAD_DIMS}, got {q.dtype}, h={h}")
    dev = q.device
    q = kernel_arg(q, dev)
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        if c.device != dev or c.dtype != q.dtype:
            raise ValueError(f"sink_decode: {name} is {c.dtype} on "
                             f"{c.device}, q is {q.dtype} on {dev}")
    ks, vs = _strides(k_cache, "k_cache"), _strides(v_cache, "v_cache")
    tt = kernel_arg(per_row(t, B, dev), dev, torch.int32)
    out = torch.empty_like(q)
    n_grp, rows = decode_row_groups(G, h)
    n_split, per = sink_splits(B, K * n_grp, W, _sm_count(dev.index))
    ws = None if n_split == 1 else torch.empty(
        B * K * n_split * G * (h + 2), dtype=torch.float32, device=dev)
    lib = build.load("sink_decode")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sink_decode_launch(
            DTYPE_CODES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), tt.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), B, K, G, h, n_grp, rows, W,
            *ks, *vs, n_split, per, h ** -0.5, stream)
    build.check_launch("sink_decode", rc)
    sink_decode.launches += 1
    return out


sink_decode.launches = 0
