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


# ----------------------------------------------------------------------
# OmniAttn online top-k block selection (the scores come from the
# block_topk kernel, kernels/block_topk.py)
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


def selected_attention_mass(q, k_pages, tables, lens, selected):
    """Exact attention mass the selected blocks capture, per slot.

    q [B, H, h]; k_pages [N, K, bs, h]; tables/selected [B, nb] over the
    original logical blocks; lens [B] resident slots. Computes the full
    resident softmax (a diagnostics pass, gated by
    `omniattn.topk_measure_mass`) and sums the probability landing in
    selected blocks, averaged over heads → [B] float32 in [0, 1]."""
    B, H, h = q.shape
    K, bs = k_pages.shape[1], k_pages.shape[2]
    G = H // K
    nb = tables.shape[1]
    k_lin = k_pages[tables.long()].permute(0, 1, 3, 2, 4) \
        .reshape(B, nb * bs, K, h).float()
    qg = q.reshape(B, K, G, h).float()
    s = torch.einsum("bkgh,bwkh->bkgw", qg, k_lin) * h ** -0.5
    valid = torch.arange(nb * bs, device=q.device)[None] \
        < per_row(lens, B, q.device)[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    slot_sel = selected.repeat_interleave(bs, dim=1)         # [B, nb·bs]
    return (p * slot_sel[:, None, None, :]).sum(-1).mean(dim=(1, 2))


# ----------------------------------------------------------------------
# SpecPlane: the verify window's commit and its ring-layer attention
def paged_cache_write_tokens(k_pages, v_pages, k_new, v_new, blk, off):
    """Write a per-sequence token window into arena blocks, in place.

    arenas [N, K, bs, h]; k_new/v_new [B, S, K, h]; blk/off [B, S] physical
    block id and in-block offset per row. The speculative-verify commit: the
    caller redirects rejected and padded rows to the null block 0, so only
    the accepted prefix lands in a real block — rollback is a write that
    never happens. Live rows of distinct sequences occupy distinct (block,
    offset) slots; rows sharing the null block may land in any order."""
    K = k_pages.shape[1]
    ki = torch.arange(K, device=k_pages.device)[None, None, :]
    b = blk.long()[:, :, None]
    o = off.long()[:, :, None]
    k_pages[b, ki, o] = k_new.to(k_pages.dtype)
    v_pages[b, ki, o] = v_new.to(v_pages.dtype)
    return k_pages, v_pages


def paged_cache_write_tokens_masked(k_pages, v_pages, k_new, v_new, blk,
                                    off, write):
    """`paged_cache_write_tokens` for arenas without a null block (the ring
    block runs): rows with write[b, s] False write back their slot's current
    content, so a rejected draft row is a bit-exact no-op on its target
    slot. Callers keep each sequence's rows on distinct (blk, off) slots."""
    K = k_pages.shape[1]
    ki = torch.arange(K, device=k_pages.device)[None, None, :]
    b = blk.long()[:, :, None]
    o = off.long()[:, :, None]
    wm = write[:, :, None, None]
    for pages, new in ((k_pages, k_new), (v_pages, v_new)):
        cur = pages[b, ki, o]                                # [B, S, K, h]
        pages[b, ki, o] = torch.where(wm, new.to(pages.dtype), cur)
    return k_pages, v_pages


def spec_verify_ring_attention(q, k_new, v_new, k_cache, v_cache, positions,
                               *, sink: int, recent: int):
    """Read-only speculative-verify attention over a ring (sink+recent)
    cache (the reference has no TPU kernel for it).

    q [B,S,H,h] is each slot's draft window at absolute positions [B,S]
    (row i of slot b at positions[b, 0] + i); k_new/v_new [B,S,K,h] are the
    window's rope'd keys; caches [B,W,K,h] hold the frozen ring history —
    tokens < positions[:, 0], each ring slot its residue class's largest
    member below the window. A row at position p drops a frozen token with
    p - tok >= recent (its evicting class member lies inside the window and
    is attended instead), which is exactly the resident set single-token
    ring decode would see at p; in-window keys take the causal mask only
    (S <= recent). Nothing is written."""
    B, S, H, h = q.shape
    K = k_new.shape[2]
    G = H // K
    W = k_cache.shape[1]
    dev = q.device
    pos = positions.to(torch.int32)                          # [B, S]
    off = pos[:, 0]
    j = torch.arange(W, device=dev, dtype=torch.int32)[None]    # [1, W]
    if sink or recent:
        wraps = torch.clamp(torch.div(off[:, None] - 1 - j, recent,
                                      rounding_mode="floor"), min=0)
        tok = torch.where(j < sink, j, j + wraps * recent)
    else:
        tok = j.expand(B, W)
    res = tok < off[:, None]                                 # [B, W]

    def allowed(p, t):
        ok = t <= p
        if recent > 0:
            ok = ok & (((p - t) < recent) | (t < sink))
        return ok

    m_old = res[:, None, :] & allowed(pos[:, :, None], tok[:, None, :])
    m_new = allowed(pos[:, :, None], pos[:, None, :])
    qg = q.reshape(B, S, K, G, h).float()
    s_old = torch.einsum("bskgh,bwkh->bskgw", qg, k_cache.float()) \
        * h ** -0.5
    s_old = torch.where(m_old[:, :, None, None, :], s_old,
                        torch.full_like(s_old, NEG_INF))
    s_new = torch.einsum("bskgh,bukh->bskgu", qg, k_new.float()) * h ** -0.5
    s_new = torch.where(m_new[:, :, None, None, :], s_new,
                        torch.full_like(s_new, NEG_INF))
    p_att = torch.softmax(torch.cat([s_old, s_new], dim=-1), dim=-1)
    v_all = torch.cat([v_cache.float(), v_new.float()], dim=1)
    out = torch.einsum("bskgw,bwkh->bskgh", p_att, v_all)
    return out.reshape(B, S, H, h).to(q.dtype)
