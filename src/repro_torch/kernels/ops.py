"""Layout adapters between the model stack's tensors and the kernels'
kv-head-major layouts (the counterparts of src/repro/kernels/ops.py)."""
from __future__ import annotations

from repro_torch.kernels.block_topk import block_topk_scores, block_topk_select
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.paged_decode import paged_decode
from repro_torch.kernels.paged_prefill import paged_prefill
from repro_torch.kernels.sink_decode import sink_decode
from repro_torch.kernels.spec_verify import spec_verify


def attention_prefill_op(q, k, v, *, causal=True, window=0, sink=0):
    """Whole-prompt attention. q [B,S,H,h]; k/v [B,S,K,h] → [B,S,H,h].
    GQA is native: the G = H/K query heads of each kv head become the rows
    of one [S·G, h] matrix (row r = token r // G); no kv head is repeated."""
    B, S, H, h = q.shape
    K = k.shape[2]
    G = H // K
    qf = q.reshape(B, S, K, G, h).permute(0, 2, 1, 3, 4) \
        .reshape(B * K, S * G, h)
    kf = k.permute(0, 2, 1, 3).reshape(B * K, S, h)
    vf = v.permute(0, 2, 1, 3).reshape(B * K, S, h)
    o = flash_prefill(qf, kf, vf, causal=causal, window=window, sink=sink)
    return o.reshape(B, K, S, G, h).permute(0, 2, 1, 3, 4) \
        .reshape(B, S, H, h)


def attention_decode_op(q, k_cache, v_cache, t):
    """q [B,H,h]; caches [B,W,K,h] (the model layout, read in place through
    a transposed view); t scalar or [B] occupancy → [B,H,h]."""
    B, H, h = q.shape
    K = k_cache.shape[2]
    G = H // K
    o = sink_decode(q.reshape(B, K, G, h), k_cache.transpose(1, 2),
                    v_cache.transpose(1, 2), t)
    return o.reshape(B, H, h)


def attention_paged_decode_op(q, k_pages, v_pages, tables, lens, **scales):
    """q [B,H,h]; arenas [N,K,bs,h]; tables [B,nb] physical block ids;
    lens [B] resident logical slots → [B,H,h]. `scales`: the scale plane of
    int8 arenas (k_scale=, k_tok=, v_scale=, v_tok=)."""
    B, H, h = q.shape
    K = k_pages.shape[1]
    G = H // K
    o = paged_decode(q.reshape(B, K, G, h), k_pages, v_pages, tables, lens,
                     **scales)
    return o.reshape(B, H, h)


def attention_paged_prefill_op(q, k_new, v_new, k_pages, v_pages, tables,
                               off, chunk_len, *, window=0, sink=0,
                               **scales):
    """Chunked prefill over paged history. q [B,S,H,h]; k_new/v_new
    [B,S,K,h]; arenas [N,K,bs,h]; tables [B,nb]; off/chunk_len scalars or
    [B] → [B,S,H,h]. Rows are regrouped per kv head: row r of the kernel's
    [B,K,S·G,h] query is chunk token r // G. `scales`: the scale plane of
    int8 arenas."""
    B, S, H, h = q.shape
    K = k_new.shape[2]
    G = H // K
    qf = q.reshape(B, S, K, G, h).permute(0, 2, 1, 3, 4) \
        .reshape(B, K, S * G, h)
    kf = k_new.permute(0, 2, 1, 3)
    vf = v_new.permute(0, 2, 1, 3)
    o = paged_prefill(qf, kf, vf, k_pages, v_pages, tables, off, chunk_len,
                      window=window, sink=sink, **scales)
    return o.reshape(B, K, S, G, h).permute(0, 2, 1, 3, 4) \
        .reshape(B, S, H, h)


def block_topk_select_op(q, kmin, kmax, tables, lens, *, block_size,
                         k_static, frac, sink_blocks, recent_blocks,
                         token_mask=None):
    """q [B,H,h]; kmin/kmax [N,K,h] per-block key channel bounds; tables
    [B,nb]; lens [B] resident logical slots; token_mask [B] live slots →
    (scores [B,nb] float32, NEG_INF past the residency; new_tables
    [B,k_static], new_lens [B], m [B], selected [B,nb]; aux [4]: blocks
    scored and attended over the live slots, 0, 0): the scores, the
    compacted top-k block table and the stats of one decode step, one
    kernel launch on the card."""
    B, H, h = q.shape
    K = kmin.shape[1]
    return block_topk_select(q.reshape(B, K, H // K, h), kmin, kmax, tables,
                             lens, block_size=block_size, k_static=k_static,
                             frac=frac, sink_blocks=sink_blocks,
                             recent_blocks=recent_blocks,
                             token_mask=token_mask)


def block_topk_scores_op(q, kmin, kmax, tables, lens, *, block_size):
    """q [B,H,h]; kmin/kmax [N,K,h]; tables [B,nb]; lens [B] → scores
    [B,nb] float32 (NEG_INF past the residency): the score pass alone, over
    the heads q holds."""
    B, H, h = q.shape
    K = kmin.shape[1]
    return block_topk_scores(q.reshape(B, K, H // K, h), kmin, kmax, tables,
                             lens, block_size=block_size)


def spec_verify_op(q, k_new, v_new, k_pages, v_pages, tables, off, n_tok,
                   **scales):
    """Batched multi-token speculative verify over paged history
    (read-only). q [B,S,H,h], S = k+1 window rows per slot; k_new/v_new
    [B,S,K,h] the window's rope'd keys (not yet in any block); arenas
    [N,K,bs,h]; tables [B,nb]; off [B] per-slot resident-history length;
    n_tok [B] real window rows → [B,S,H,h]. The GQA regroup of the
    chunked-prefill adapter. `scales`: the scale plane of int8 arenas."""
    B, S, H, h = q.shape
    K = k_new.shape[2]
    G = H // K
    qf = q.reshape(B, S, K, G, h).permute(0, 2, 1, 3, 4) \
        .reshape(B, K, S * G, h)
    o = spec_verify(qf, k_new.permute(0, 2, 1, 3), v_new.permute(0, 2, 1, 3),
                    k_pages, v_pages, tables, off, n_tok, **scales)
    return o.reshape(B, K, S, G, h).permute(0, 2, 1, 3, 4) \
        .reshape(B, S, H, h)
