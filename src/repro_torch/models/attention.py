"""Attention caches and the plain (model-layout) attention paths: paged
arenas with their block-summary plane, and dense (sink‖ring or full) caches.

Layouts (as in src/repro/models/attention.py):
  q        [B, S, H, h]       (H = n_heads)
  k, v     [B, S, K, h]       (K = n_kv_heads, G = H // K)
  arenas   [N, K, bs, h]      kv-head-major blocks; block 0 is the null block
  summaries kmin/kmax/kmean [N, K, h] float32
  dense    [B, W, K, h]       W = sink + recent (ring) or max_len (full)

Cache writes update the tensors IN PLACE and return them: the arenas are
large, shared by the prefill and decode engines, and never copied; a dense
cache is owned by the decode engine that writes it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._common import per_row
from repro_torch.models.common import apply_rope  # noqa: F401 (layer code)

NEG_INF = -1e30


def decode_attention(q, k_cache, v_cache, t):
    """Single-token attention over a linear cache. q [B,H,h]; caches
    [B,W,K,h]; t [B] (or scalar) = valid slots (slots < min(t, W))."""
    B, H, h = q.shape
    W, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, h).float()
    s = torch.einsum("bkgh,bwkh->bkgw", qg, k_cache.float()) * h ** -0.5
    lim = torch.clamp(per_row(t, B, q.device), max=W)
    valid = torch.arange(W, device=q.device)[None, None, None, :] \
        < lim[:, None, None, None]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgw,bwkh->bkgh", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, H, h)


def paged_decode_attention(q, k_pages, v_pages, tables, lens):
    """Single-token attention over paged KV (plain path). q [B,H,h]; arenas
    [N,K,bs,h]; tables [B,nb]; lens [B] resident logical slots. Gathers the
    tabled blocks into a linear [B, nb·bs, K, h] view (non-resident entries
    alias the null block and are masked by lens)."""
    B = q.shape[0]
    nb = tables.shape[1]
    K, bs, h = k_pages.shape[1], k_pages.shape[2], k_pages.shape[3]
    tl = tables.long()
    k_lin = k_pages[tl].permute(0, 1, 3, 2, 4).reshape(B, nb * bs, K, h)
    v_lin = v_pages[tl].permute(0, 1, 3, 2, 4).reshape(B, nb * bs, K, h)
    return decode_attention(q, k_lin, v_lin, lens)


def paged_prefill_attention(q, k_new, v_new, k_pages, v_pages, tables, off,
                            chunk_len, *, mask_window: int = 0,
                            mask_sink: int = 0):
    """Chunked-prefill attention over paged history (plain path). q
    [B,S,H,h] is one prompt chunk at absolute positions off + arange(S)
    (only the first chunk_len rows real); k_new/v_new [B,S,K,h]; history
    (tokens < off) lives in arena blocks mapped by tables [B,nb]. Queries
    attend resident history plus causal in-chunk keys, optionally under the
    sink+window mask."""
    B, S, H, h = q.shape
    K = k_new.shape[2]
    G = H // K
    nb = tables.shape[1]
    bs = k_pages.shape[2]
    L = nb * bs
    dev = q.device
    off = per_row(off, B, dev).long()
    cl = per_row(chunk_len, B, dev).long()
    tl = tables.long()
    k_hist = k_pages[tl].permute(0, 1, 3, 2, 4).reshape(B, L, K, h)
    v_hist = v_pages[tl].permute(0, 1, 3, 2, 4).reshape(B, L, K, h)
    ar_l = torch.arange(L, device=dev)
    ar_s = torch.arange(S, device=dev)
    pos = off[:, None] + ar_s[None]                          # [B, S]
    tok = torch.cat([ar_l[None].expand(B, L), pos], dim=1)
    res = torch.cat([ar_l[None] < off[:, None], ar_s[None] < cl[:, None]],
                    dim=1)
    ok = tok[:, None, :] <= pos[:, :, None]
    if mask_window > 0:
        win = (pos[:, :, None] - tok[:, None, :]) < mask_window
        if mask_sink > 0:
            win = win | (tok < mask_sink)[:, None, :]
        ok = ok & win
    mask = res[:, None, :] & ok                              # [B, S, L+S]
    qg = q.reshape(B, S, K, G, h).float()
    k_all = torch.cat([k_hist, k_new], dim=1).float()
    v_all = torch.cat([v_hist, v_new], dim=1).float()
    s = torch.einsum("bskgh,btkh->bskgt", qg, k_all) * h ** -0.5
    s = torch.where(mask[:, :, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bskgt,btkh->bskgh", p, v_all)
    return out.reshape(B, S, H, h).to(q.dtype)


def paged_prefill_write(k_pages, v_pages, k_new, v_new, tables, off,
                        chunk_len):
    """Scatter one chunk's K/V [B,S,K,h] (B == 1) into arena blocks, in
    place. Chunk token i lands at absolute position off + i → block
    tables[0, (off+i)//bs] at offset (off+i) % bs; padded rows
    (i >= chunk_len) are redirected to the null block 0."""
    B, S, K, h = k_new.shape
    bs = k_pages.shape[2]
    nb = tables.shape[1]
    dev = k_pages.device
    ar = torch.arange(S, device=dev)
    pos = int(off) + ar
    blk = torch.where(ar < int(chunk_len),
                      tables[0].long()[torch.clamp(pos // bs, 0, nb - 1)],
                      torch.zeros_like(pos))
    offi = pos % bs
    ki = torch.arange(K, device=dev)[None, :]
    k_pages[blk[:, None], ki, offi[:, None]] = k_new[0].to(k_pages.dtype)
    v_pages[blk[:, None], ki, offi[:, None]] = v_new[0].to(v_pages.dtype)
    return k_pages, v_pages


def paged_cache_write(k_pages, v_pages, k_new, v_new, blk, off):
    """Write one token's K/V per sequence into arena blocks, in place.
    arenas [N,K,bs,h]; k_new/v_new [B,K,h]; blk/off [B] physical block id
    and in-block offset. Freed slots are redirected to the null block by the
    caller, where duplicate writes are harmless."""
    K = k_pages.shape[1]
    ki = torch.arange(K, device=k_pages.device)[None, :]
    b = blk.long()[:, None]
    o = off.long()[:, None]
    k_pages[b, ki, o] = k_new.to(k_pages.dtype)
    v_pages[b, ki, o] = v_new.to(v_pages.dtype)
    return k_pages, v_pages


def ring_slot(t, sink: int, recent: int):
    """Cache slot of the token written at absolute position t (sink+ring):
    tokens < sink + recent fill the slots in order, later ones cycle through
    the recent ring."""
    W = sink + recent
    return torch.where(t < W, t, sink + (t - sink) % recent)


def cache_write(k_cache, v_cache, k_new, v_new, t, *, sink: int = 0,
                recent: int = 0):
    """Write one token's K/V per sequence into dense caches, in place.
    caches [B, W, K, h]; k_new/v_new [B, K, h]; t [B] absolute positions.
    Full cache when sink == recent == 0 (slot t), else the sink+ring layout.
    A write past the cache (slot >= W, a full cache at max_len) is dropped,
    as the reference's scatter drops it: the clamped slot is rewritten with
    its own content, so no host sync is needed."""
    B, W = k_cache.shape[0], k_cache.shape[1]
    t = t.long()
    idx = ring_slot(t, sink, recent) if (sink or recent) else t
    ok = (idx < W)[:, None, None]
    idx = torch.clamp(idx, max=W - 1)
    b = torch.arange(B, device=k_cache.device)
    for c, new in ((k_cache, k_new), (v_cache, v_new)):
        c[b, idx] = torch.where(ok, new.to(c.dtype), c[b, idx])
    return k_cache, v_cache


def compress_prefill_kv(k, v, *, sink: int, recent: int, true_len=None):
    """Build a sink+recent ring cache [B, sink+recent, K, h] from whole-prompt
    K/V [B, S, K, h]. Token i >= sink lives at slot sink + (i - sink) %
    recent, so after `true_len` tokens (a right-padded prompt; default S)
    each ring slot holds the latest token of its residue class; ring slots
    no real token reached are zero. The sink slots copy rows :sink as they
    are (padded rows included), as the reference does."""
    B, S, K, h = k.shape
    W = sink + recent
    if true_len is None and S <= W:
        pad = (0, 0, 0, 0, 0, W - S)
        return (torch.nn.functional.pad(k, pad),
                torch.nn.functional.pad(v, pad))
    tl = S if true_len is None else int(true_len)
    dev = k.device
    base = sink + torch.arange(recent, device=dev)
    n_wraps = torch.clamp(torch.div(tl - 1 - base, recent,
                                    rounding_mode="floor"), min=0)
    p = torch.clamp(base + n_wraps * recent, 0, S - 1)    # token at slot j
    valid = (base < tl).to(k.dtype)[None, :, None, None]
    out = []
    for x in (k, v):
        sink_x = x[:, :min(sink, S)]
        if sink_x.shape[1] < sink:
            sink_x = torch.nn.functional.pad(
                sink_x, (0, 0, 0, 0, 0, sink - sink_x.shape[1]))
        out.append(torch.cat([sink_x, x[:, p] * valid], dim=1))
    return out[0], out[1]


def update_block_summaries(kmin, kmax, kmean, k_pages, blocks):
    """Recompute the per-block key summaries of `blocks` ([M] ids,
    duplicates fine) from the arena, in place: min, max and mean over all bs
    slots of each block, zeros of unwritten slots included (they only widen
    the [kmin, kmax] interval). Every path that writes arena K calls this
    for the blocks it touched, so no summary is ever stale."""
    blocks = blocks.long()
    k = k_pages[blocks].float()                      # [M, K, bs, h]
    kmin[blocks] = k.amin(dim=-2)
    kmax[blocks] = k.amax(dim=-2)
    kmean[blocks] = k.mean(dim=-2)
    return kmin, kmax, kmean
