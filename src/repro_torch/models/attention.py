"""Attention caches and the plain (model-layout) attention paths: paged
arenas with their block-summary plane, and dense (sink‖ring or full) caches.

Layouts (as in src/repro/models/attention.py):
  q        [B, S, H, h]       (H = n_heads)
  k, v     [B, S, K, h]       (K = n_kv_heads, G = H // K)
  arenas   [N, K, bs, h]      kv-head-major blocks; block 0 is the null block
  summaries kmin/kmax/kmean [N, K, h] float32
  scale plane (QuantPlane, int8 arenas) kscale/vscale [N, K, h] float32
           per-channel seal scales (a nonzero row marks a sealed block),
           ktok/vtok [N, K, bs] float32 per-token scales of unsealed content
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


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      sink: int = 0, q_offset: int = 0,
                      fp32_scores: bool = True):
    """Whole-sequence attention of the train path (the reference's jnp
    `chunked_attention`), plain and differentiable PyTorch. q [B,S,H,h];
    k/v [B,Skv,K,h] → [B,S,H,h] in v's dtype. Query row i sits at position
    q_offset + i, key j at j. causal masks keys past the query; window > 0
    keeps keys with q_pos - k_pos < window, and with sink > 0 also the
    first `sink` keys (OmniAttn sparse prefill).

    It computes the whole masked score matrix [B, K, G, S, Skv] at once,
    each kv head's G query heads batched against it (no kv head is
    repeated), not blockwise over attn_q_chunk / attn_kv_chunk: the train
    path's sequences are short enough that the matrix fits. Masked scores
    are NEG_INF, as in the reference, so a row with no visible key would
    average every key; scores and softmax are float32 unless fp32_scores
    is False."""
    B, S, H, h = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    sd = torch.float32 if fp32_scores else q.dtype
    qg = q.reshape(B, S, K, G, h).to(sd)
    s = torch.einsum("bqkgh,bckh->bkgqc", qg, k.to(sd)) * h ** -0.5
    q_pos = q_offset + torch.arange(S, device=q.device)
    k_pos = torch.arange(Skv, device=q.device)
    mask = torch.ones((S, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        in_win = (q_pos[:, None] - k_pos[None, :]) < window
        if sink > 0:
            in_win |= k_pos[None, :] < sink
        mask &= in_win
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s.float(), dim=-1)
    out = torch.einsum("bkgqc,bckh->bqkgh", p.to(v.dtype), v)
    return out.reshape(B, S, H, h)


def _gather_linear(pages, tables, scale=None, tok=None):
    """Tabled blocks of an arena [N,K,bs,h] as a linear [B, nb·bs, K, h]
    view; int8 pages with their scale plane come out dequantized (f32)."""
    B, nb = tables.shape
    K, bs, h = pages.shape[1:]
    tl = tables.long()
    g = pages[tl]
    if scale is not None:
        g = dequant_pages(g, scale[tl], tok[tl])
    return g.permute(0, 1, 3, 2, 4).reshape(B, nb * bs, K, h)


def paged_decode_attention(q, k_pages, v_pages, tables, lens, *,
                           k_scale=None, k_tok=None, v_scale=None,
                           v_tok=None):
    """Single-token attention over paged KV (plain path). q [B,H,h]; arenas
    [N,K,bs,h]; tables [B,nb]; lens [B] resident logical slots. Gathers the
    tabled blocks into a linear [B, nb·bs, K, h] view (non-resident entries
    alias the null block and are masked by lens). With the scale-plane
    kwargs the arenas are int8 and the gathered view is dequantized."""
    k_lin = _gather_linear(k_pages, tables, k_scale, k_tok)
    v_lin = _gather_linear(v_pages, tables, v_scale, v_tok)
    return decode_attention(q, k_lin, v_lin, lens)


def paged_prefill_attention(q, k_new, v_new, k_pages, v_pages, tables, off,
                            chunk_len, *, mask_window: int = 0,
                            mask_sink: int = 0, k_scale=None, k_tok=None,
                            v_scale=None, v_tok=None):
    """Chunked-prefill attention over paged history (plain path). q
    [B,S,H,h] is one prompt chunk at absolute positions off + arange(S)
    (only the first chunk_len rows real); k_new/v_new [B,S,K,h]; history
    (tokens < off) lives in arena blocks mapped by tables [B,nb]. Queries
    attend resident history plus causal in-chunk keys, optionally under the
    sink+window mask. Int8 arenas (the scale-plane kwargs) dequantize only
    the gathered history; the chunk's own k_new/v_new are not quantized."""
    B, S, H, h = q.shape
    K = k_new.shape[2]
    G = H // K
    nb = tables.shape[1]
    bs = k_pages.shape[2]
    L = nb * bs
    dev = q.device
    off = per_row(off, B, dev).long()
    cl = per_row(chunk_len, B, dev).long()
    k_hist = _gather_linear(k_pages, tables, k_scale, k_tok)
    v_hist = _gather_linear(v_pages, tables, v_scale, v_tok)
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
    (i >= chunk_len) are redirected to the null block 0. off and chunk_len
    are ints or 0-d device tensors (a captured chunk reads them from the
    device, never from the host)."""
    B, S, K, h = k_new.shape
    bs = k_pages.shape[2]
    nb = tables.shape[1]
    dev = k_pages.device
    ar = torch.arange(S, device=dev)
    pos = off + ar
    blk = torch.where(ar < chunk_len,
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


def resident_token_positions(W: int, off, *, sink: int, recent: int):
    """Token position resident at each of W cache slots after `off` tokens
    were written (an int, a 0-d device tensor, or per sequence [B, 1]).
    Full cache (sink == recent == 0): slot j holds token j iff j < off.
    Ring layout: slots < sink hold the sink tokens; ring slot j >= sink
    hosts the residue class {j, j + recent, ...} and holds its largest
    member < off. → (tok, resident bool), both [W] or [B, W]."""
    off = torch.as_tensor(off)
    j = torch.arange(W, device=off.device)
    if sink or recent:
        wraps = torch.clamp(torch.div(off - 1 - j, recent,
                                      rounding_mode="floor"), min=0)
        tok = torch.where(j < sink, j, j + wraps * recent)
    else:
        tok = j
    return torch.broadcast_tensors(tok, tok < off)


def prefill_resume_attention(q, k_new, v_new, k_cache, v_cache, positions,
                             *, chunk_len, sink: int, recent: int,
                             mask_window: int = 0, mask_sink: int = 0):
    """Continuation-prefill attention of one chunk over a dense cache (the
    reference has no TPU kernel for it), with the chunk written into the
    cache in place.

    q [B,S,H,h], k_new/v_new [B,S,K,h] at absolute positions [S] (off +
    arange(S), a device tensor); caches [B,W,K,h] hold the tokens < off.
    Queries attend the resident cache tokens plus causal in-chunk keys,
    under the sink+window mask when mask_window > 0 (else dense causal).
    chunk_len (an int or a 0-d device tensor) counts the real rows: padded
    query rows give outputs callers ignore, padded keys are neither
    attended nor written. The chunk lands at ring slots (`ring_slot`), or at
    linear slots when sink == recent == 0, where rows past the cache are
    dropped. Ring callers keep S <= recent, so the chunk's slots are
    distinct. → out [B,S,H,h]."""
    B, S, H, h = q.shape
    K = k_new.shape[2]
    G = H // K
    W = k_cache.shape[1]
    dev = q.device
    pos = positions
    off = pos[0]
    ar = torch.arange(S, device=dev)
    valid_q = ar < chunk_len

    def allowed(p, t):
        ok = t <= p
        if mask_window > 0:
            ok = ok & (((p - t) < mask_window) | (t < mask_sink))
        return ok

    tok_old, res_old = resident_token_positions(W, off, sink=sink,
                                                recent=recent)
    qg = q.reshape(B, S, K, G, h).float()
    s_old = torch.einsum("bskgh,bwkh->bskgw", qg, k_cache.float()) \
        * h ** -0.5
    m_old = res_old[None, :] & allowed(pos[:, None], tok_old[None, :])
    s_old = torch.where(m_old[None, :, None, None, :], s_old,
                        torch.full_like(s_old, NEG_INF))
    s_new = torch.einsum("bskgh,bukh->bskgu", qg, k_new.float()) * h ** -0.5
    m_new = allowed(pos[:, None], pos[None, :]) & valid_q[None, :]
    s_new = torch.where(m_new[None, :, None, None, :], s_new,
                        torch.full_like(s_new, NEG_INF))
    p_att = torch.softmax(torch.cat([s_old, s_new], dim=-1), dim=-1)
    v_all = torch.cat([v_cache.float(), v_new.float()], dim=1)
    out = torch.einsum("bskgw,bwkh->bskgh", p_att, v_all)

    # the write: each target slot takes the chunk row that owns it if that
    # row is real, else keeps its content. Linear rows past the cache clamp
    # onto slot W - 1 and carry the same value as the row that owns it, so
    # duplicate targets write identical bytes
    if sink or recent:
        slots, src = ring_slot(pos, sink, recent), ar
    else:
        slots = torch.clamp(pos, max=W - 1)
        src = slots - off
    slots = slots.long()
    keep = (src < chunk_len)[None, :, None, None]
    src = src.long()
    for c, new in ((k_cache, k_new), (v_cache, v_new)):
        c[:, slots] = torch.where(keep, new.index_select(1, src).to(c.dtype),
                                  c[:, slots])
    return out.reshape(B, S, H, h).to(q.dtype)


def compress_prefill_kv(k, v, *, sink: int, recent: int, true_len=None):
    """Build a sink+recent ring cache [B, sink+recent, K, h] from whole-prompt
    K/V [B, S, K, h]. Token i >= sink lives at slot sink + (i - sink) %
    recent, so after `true_len` tokens (a right-padded prompt; default S)
    each ring slot holds the latest token of its residue class; ring slots
    no real token reached are zero. The sink slots copy rows :sink as they
    are (padded rows included), as the reference does. `true_len` is an int
    or a 0-d device tensor, read on the device."""
    B, S, K, h = k.shape
    W = sink + recent
    if true_len is None and S <= W:
        pad = (0, 0, 0, 0, 0, W - S)
        return (torch.nn.functional.pad(k, pad),
                torch.nn.functional.pad(v, pad))
    tl = S if true_len is None else true_len
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


def update_block_summaries(kmin, kmax, kmean, k_pages, blocks, *,
                           k_scale=None, k_tok=None):
    """Recompute the per-block key summaries of `blocks` ([M] ids,
    duplicates fine) from the arena, in place: min, max and mean over all bs
    slots of each block, zeros of unwritten slots included (they only widen
    the [kmin, kmax] interval). Every path that writes arena K calls this
    for the blocks it touched, so no summary is ever stale. Int8 arenas pass
    their key scale plane: the summaries reduce the dequantized content,
    which is what attention reads."""
    blocks = blocks.long()
    k = k_pages[blocks].float()                      # [M, K, bs, h]
    if k_scale is not None:
        k = k * quant_effective_scale(k_scale[blocks], k_tok[blocks])
    kmin[blocks] = k.amin(dim=-2)
    kmax[blocks] = k.amax(dim=-2)
    kmean[blocks] = k.mean(dim=-2)
    return kmin, kmax, kmean


# ----------------------------------------------------------------------
# OmniAttn online top-k: the selection (`select_kv_blocks`) lives beside
# the kernel that fuses it with the block scores, kernels/block_topk.py;
# the mass diagnostics stay here
def selected_attention_mass(q, k_pages, tables, lens, selected, *,
                            k_scale=None, k_tok=None):
    """Exact attention mass the selected blocks capture, per slot.

    q [B, H, h]; k_pages [N, K, bs, h]; tables/selected [B, nb] over the
    original logical blocks; lens [B] resident slots. Computes the full
    resident softmax (a diagnostics pass, gated by
    `omniattn.topk_measure_mass`) and sums the probability landing in
    selected blocks, averaged over heads → [B] float32 in [0, 1]. Int8
    arenas pass the key scale plane (the mass over dequantized keys)."""
    B, H, h = q.shape
    K, bs = k_pages.shape[1], k_pages.shape[2]
    G = H // K
    nb = tables.shape[1]
    k_lin = _gather_linear(k_pages, tables, k_scale, k_tok).float()
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
    pos = positions.to(torch.int32)                          # [B, S]
    tok, res = resident_token_positions(W, pos[:, :1], sink=sink,
                                        recent=recent)       # [B, W]

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


# ----------------------------------------------------------------------
# QuantPlane: int8 arena payloads and their float32 scale plane (the
# reference's models/attention.py:214-382). Sealed (full) blocks hold int8
# with per-block, per-channel scales kscale/vscale [N, K, h]; unsealed
# content holds the per-token quantization with scalar scales ktok/vtok
# [N, K, bs]. A nonzero scale row marks a sealed block, and one elementwise
# rule dequantizes both: q · where(scale != 0, scale, tok). Both
# quantizations are pure functions of the written content, so the arena
# bytes do not depend on how writes were grouped into chunks or windows.
#
# absmax/127 is computed as absmax · float32(1/127): the reference runs its
# writes under jit, where XLA folds a division by a constant into a product
# with the constant's float32 reciprocal, so this is the value its arenas
# hold. The quantization itself, x / scale, stays a true division.
INV_127 = 1.0 / 127.0


def quant_tokens(x):
    """Per-token int8 quantization (the unsealed format). x [..., h] → (q
    int8 [..., h], ts float32 [...]): ts = absmax/127 per (token, kv head),
    q = round(x / ts) clipped to ±127, rounding half to even; a zero token
    gets ts = 0 and q = 0."""
    x = x.float()
    ts = x.abs().amax(dim=-1) * INV_127
    safe = torch.where(ts > 0, ts, 1.0)
    q = torch.clamp(torch.round(x / safe[..., None]), -127, 127)
    return q.to(torch.int8), ts


def quant_effective_scale(scale, tok):
    """Elementwise dequant scale [..., bs, h] from the per-channel seal
    scales [..., h] and the per-token scales [..., bs]."""
    sc = scale[..., None, :]
    return torch.where(sc != 0, sc, tok[..., None])


def dequant_pages(pages, scale, tok):
    """int8 payload [..., bs, h] → float32 content (one product per
    element)."""
    return pages.float() * quant_effective_scale(scale, tok)


def seal_blocks(pages, scale, tok, blocks, do_seal):
    """Seal freshly filled blocks, in place: re-quantize each block's stored
    per-token payload with per-channel scales and zero its per-token row.
    pages int8 [N, K, bs, h]; scale [N, K, h]; tok [N, K, bs]; blocks [M]
    ids; do_seal [M] bool. Rows that do not seal are redirected to the null
    block 0, which is never sealed and gets its own content back, so every
    real target of the whole-block scatter is unique."""
    blocks = blocks.long()
    do_seal = do_seal & (blocks != 0)
    tgt = blocks.masked_fill(~do_seal, 0)
    praw = pages[tgt]                                # [M, K, bs, h] int8
    ts = tok[tgt]                                    # [M, K, bs]
    deq = praw.float() * ts[..., None]
    sc = deq.abs().amax(dim=-2) * INV_127            # [M, K, h]
    safe = torch.where(sc > 0, sc, 1.0)
    q2 = torch.clamp(torch.round(deq / safe[..., None, :]), -127, 127) \
        .to(torch.int8)
    m4 = do_seal[:, None, None]
    pages[tgt] = torch.where(m4[..., None], q2, praw)
    scale[tgt] = torch.where(m4, sc, scale[tgt])
    tok[tgt] = ts.masked_fill(m4, 0.0)
    return pages, scale, tok


def _quant_scatter(entry, k_new, v_new, blk, off, opened, filled):
    """The three scatters of every int8 write, in order, in place: unseal
    the blocks in `opened` (a block's offset-0 token lands: a reallocated
    block may still carry its previous owner's seal scale), land the
    per-token payload and scales at (blk, off) [R] for rows k_new/v_new
    [R, K, h], then seal the blocks whose last slot (`filled` [R]) landed.
    blk/off/opened are long tensors; redirected rows point at block 0."""
    K = entry["k"].shape[1]
    ki = torch.arange(K, device=blk.device)[None, :]
    b, o = blk[:, None], off[:, None]
    for name, new in (("k", k_new), ("v", v_new)):
        q, ts = quant_tokens(new)
        entry[name + "scale"].index_fill_(0, opened, 0.0)
        entry[name][b, ki, o] = q
        entry[name + "tok"][b, ki, o] = ts
        seal_blocks(entry[name], entry[name + "scale"], entry[name + "tok"],
                    blk, filled)
    return entry


def quant_paged_cache_write(entry, k_new, v_new, blk, off):
    """Decode append into an int8 arena entry, in place (the int8 twin of
    `paged_cache_write`): k_new/v_new [B, K, h]; blk/off [B]. Unseals a
    block receiving its offset-0 token, writes the per-token payload, seals
    a block whose last slot (off == bs - 1) landed."""
    bs = entry["k"].shape[2]
    blk, off = blk.long(), off.long()
    opened = torch.where(off == 0, blk, torch.zeros_like(blk))
    return _quant_scatter(entry, k_new, v_new, blk, off, opened,
                          off == bs - 1)


def quant_paged_prefill_write(entry, k_new, v_new, tables, off, chunk_len):
    """Chunk scatter into an int8 arena entry, in place (the int8 twin of
    `paged_prefill_write`): the chunk k_new/v_new [1, S, K, h] at absolute
    positions off + arange(S); padded rows (>= chunk_len) go to the null
    block."""
    S = k_new.shape[1]
    bs = entry["k"].shape[2]
    nb = tables.shape[1]
    ar = torch.arange(S, device=entry["k"].device)
    pos = off + ar
    valid = ar < chunk_len
    blk = torch.where(valid,
                      tables[0].long()[torch.clamp(pos // bs, 0, nb - 1)],
                      torch.zeros_like(pos))
    offi = pos % bs
    opened = torch.where(valid & (offi == 0), blk, torch.zeros_like(blk))
    return _quant_scatter(entry, k_new[0], v_new[0], blk, offi, opened,
                          valid & (offi == bs - 1))


def quant_paged_cache_write_tokens(entry, k_new, v_new, blk, off):
    """Window scatter into an int8 arena entry, in place (the int8 twin of
    `paged_cache_write_tokens`, the speculative commit): k_new/v_new
    [B, S, K, h]; blk/off [B, S] with rejected and idle rows already
    redirected to the null block, so a rollback is a write that never
    happens, for the payload and the scale plane alike."""
    B, S, K, h = k_new.shape
    bs = entry["k"].shape[2]
    blk, off = blk.long().reshape(-1), off.long().reshape(-1)
    opened = torch.where(off == 0, blk, torch.zeros_like(blk))
    return _quant_scatter(entry, k_new.reshape(B * S, K, h),
                          v_new.reshape(B * S, K, h), blk, off, opened,
                          off == bs - 1)
