"""Shared paged-KV arena + PD handoff record.

KVArena owns the per-layer full-attention block arenas and their allocator
(KVPool), shared by every paged engine of one host. Prefill writes chunk KV
straight into the arenas through per-task block tables, decode reads and
extends them through per-slot tables, and admission is a zero-copy
block-table transfer (BlockHandoff: pool ownership renames from the handoff
key to the decode rid). The arena tensors are updated in place by every
engine, so there is no compose/split of donated buffers to keep in step.
With QuantPlane (`KVArena.build(quant=True)`) the arenas are int8 with their
scale plane; every block-level operation (CoW copy, prefix-store sharing,
handoff) carries the scale rows with the payload.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.models.attention import dequant_pages
from repro_torch.models.lm import LM
from repro_torch.models.stack import alloc_arena_kv
from repro_torch.serving.kvpool import KVPool
from repro_torch.serving.placement import DevicePlacement
from repro_torch.tree import tree_leaves


def _bucket(n: int, lo: int = 32) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _pow2_floor(n: int) -> int:
    b = 1
    while b * 2 <= n:
        b *= 2
    return b


def kv_bytes(cache) -> int:
    """Bytes of every tensor in a KV tree (an arena's `kv`, a dense cache;
    non-tensor leaves such as "pos" count nothing)."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(cache)
               if isinstance(x, torch.Tensor))


def dense_kv_to_blocks(x, n_blocks: int, block_size: int):
    """[L, K, h] (dense token-major KV) → [n_blocks, K, bs, h] (kv-head-major
    arena blocks); the tail is zero-padded to n_blocks · block_size."""
    L, K, h = x.shape
    pad = n_blocks * block_size - L
    if pad:
        x = torch.cat([x, x.new_zeros((pad, K, h))], dim=0)
    return x.reshape(n_blocks, block_size, K, h).transpose(1, 2)


def blocks_to_dense_kv(x, L: int):
    """Inverse of dense_kv_to_blocks: [nb, K, bs, h] → [L, K, h]."""
    nb, K, bs, h = x.shape
    return x.transpose(1, 2).reshape(nb * bs, K, h)[:L]


@dataclass
class KVArena:
    """Per-layer full-attention block arenas (`kv`: one entry per layer,
    None for layers without one) plus their pool. `reclaimers` are
    backpressure callbacks (prefix stores registering `evict_for_blocks`):
    when an allocation cannot be served, the caller asks the arena to
    reclaim before deferring or preempting."""
    lm: LM
    pool: KVPool
    kv: list
    block_size: int
    reclaimers: list = field(default_factory=list)
    placement: Optional[DevicePlacement] = None

    @staticmethod
    def build(lm: LM, n_blocks: int, block_size: int = 16,
              placement: Optional[DevicePlacement] = None,
              quant: bool = False) -> "KVArena":
        pool = KVPool(n_blocks=n_blocks, block_size=block_size)
        # +1: arena block 0 is the reserved null block (never allocated)
        kv = alloc_arena_kv(lm.cfg, lm.plan, n_blocks + 1, block_size,
                            lm.device, quant=quant, tp=lm.ctx.tp)
        return KVArena(lm, pool, kv, block_size, placement=placement)

    @property
    def quant(self) -> bool:
        """An arena is int8 iff its entries carry the scale plane."""
        return any(e is not None and "kscale" in e for e in self.kv)

    def __post_init__(self):
        if self.placement is None:
            self.placement = DevicePlacement(self.lm.device)
        n = self.pool.n_blocks + 1
        # bytes one arena block pins across every full-attention layer
        self.block_nbytes = sum(t.numel() // n * t.element_size()
                                for e in self.kv if e is not None
                                for t in e.values())

    def copy_block(self, src: int, dst: int):
        """Copy one physical block across every layer arena — content,
        summaries and (int8 arenas) scale rows together (the partial-tail
        copy-on-write of a prefix-store resume): a copied block's summary is
        its source's, so no summary goes stale."""
        for e in self.kv:
            if e is None:
                continue
            for t in e.values():
                t[dst] = t[src]

    def read_block(self, b: int) -> list:
        """A copy of physical block `b` across every layer arena: per layer
        None or {leaf: [...] one block's rows} (content, summaries and, on
        int8 arenas, the scale rows)."""
        return [None if e is None else {n: t[b].clone() for n, t in e.items()}
                for e in self.kv]

    def write_block(self, rows: list, dst: int):
        """Write a `read_block` copy into physical block `dst` of every
        layer arena."""
        for e, r in zip(self.kv, rows):
            if e is None:
                continue
            for n, t in e.items():
                t[dst] = r[n]

    def scrub_block(self, b: int):
        """Zero one physical block in every leaf of every layer arena, in
        place: content, summaries and (int8 arenas) the scale and per-token
        rows (corruption quarantine: the block leaves circulation, and
        all-zero keys reduce to all-zero min/max/mean, so `check_summaries`
        holds; a stale nonzero scale row would mark it sealed)."""
        for e in self.kv:
            if e is None:
                continue
            for t in e.values():
                t[b] = 0

    @torch.no_grad()
    def corrupt_mask(self) -> torch.Tensor:
        """[N+1] bool device mask of the blocks whose stored kmin/kmax differ
        from a fresh min/max of the block's (dequantized) keys, OR-ed over
        every full-attention layer; int8 keys are dequantized with the one
        float32 product of `_dense_k`. Computed on the device; min and max
        do not depend on the reduction order, so the comparison is exact."""
        bad = torch.zeros(self.pool.n_blocks + 1, dtype=torch.bool,
                          device=self.lm.device)
        for e in self.kv:
            if e is None or "kmin" not in e:
                continue
            k = (dequant_pages(e["k"], e["kscale"], e["ktok"])
                 if "kscale" in e else e["k"].float())   # [N, K, bs, h]
            mism = (e["kmin"] != k.amin(dim=-2)) | \
                (e["kmax"] != k.amax(dim=-2))             # [N, K, h]
            bad |= mism.flatten(1).any(dim=1)
        return bad

    def find_corrupt_blocks(self, ctx=None) -> list:
        """Summary-plane corruption scan: the block ids whose stored key
        summaries disagree with their content (a fault that changed K
        without going through a summary-maintaining write). The scan runs
        on the device; one fetch of the [N+1] mask. Call at recovery
        points, not per step. With `ctx` (a RankCtx) the mask is first
        max-reduced over every rank of its world (`pmax_world`), so each
        rank gets the union of what any rank's KV heads show: a collective,
        which every rank must call at the same step."""
        mask = self.corrupt_mask()
        if ctx is not None:
            mask = ctx.pmax_world(mask)
        return [int(b) for b in torch.nonzero(mask.cpu()).flatten()]

    @staticmethod
    def _dense_k(entry) -> np.ndarray:
        """Host float32 view of an entry's key content, dequantized through
        the scale plane on int8 arenas (one float32 product per element, as
        the device computes it), so the checks read what attention reads."""
        k = entry["k"].float().cpu().numpy()
        if "kscale" in entry:
            sc = entry["kscale"].cpu().numpy()[..., None, :]
            tk = entry["ktok"].cpu().numpy()[..., None]
            k = k * np.where(sc != 0, sc, tk)
        return k

    def check_summaries(self):
        """Zero-stale-summary invariant: for every block of every
        full-attention layer, the stored key summaries equal a fresh
        reduction of the block's key content (min/max exactly, mean to
        rounding); on int8 arenas the dequantized content. Int8 arenas add
        the zero-stale-scale checks: every scale is finite and >= 0, and a
        sealed block (nonzero scale row) has its per-token row zeroed — the
        null block 0, a redirect target of duplicate writes, is exempt.
        Test/diagnostic helper — fetches the arenas."""
        for e in self.kv:
            if e is None:
                continue
            k = self._dense_k(e)
            np.testing.assert_array_equal(e["kmin"].cpu().numpy(),
                                          k.min(axis=-2),
                                          err_msg="stale kmin summary")
            np.testing.assert_array_equal(e["kmax"].cpu().numpy(),
                                          k.max(axis=-2),
                                          err_msg="stale kmax summary")
            np.testing.assert_allclose(e["kmean"].cpu().numpy(),
                                       k.mean(axis=-2), rtol=1e-5, atol=1e-6,
                                       err_msg="stale kmean summary")
            if "kscale" not in e:
                continue
            for sck, tkk in (("kscale", "ktok"), ("vscale", "vtok")):
                sc = e[sck].cpu().numpy()
                tk = e[tkk].cpu().numpy()
                assert np.all(np.isfinite(sc)) and np.all(sc >= 0), \
                    f"invalid {sck} seal scales"
                assert np.all(np.isfinite(tk)) and np.all(tk >= 0), \
                    f"invalid {tkk} per-token scales"
                sealed = (sc != 0).any(axis=-1)              # [N, K]
                sealed[0] = False                            # null block
                assert not (sealed[..., None] & (tk != 0)).any(), \
                    f"sealed block retains nonzero {tkk} row"

    def reclaim(self, n_blocks: int) -> int:
        """Free up to `n_blocks` pool blocks by evicting shared cache state
        (LRU prefix-store entries first). → blocks actually freed."""
        freed = 0
        for cb in self.reclaimers:
            if freed >= n_blocks:
                break
            freed += cb(n_blocks - freed)
        return freed


@dataclass
class BlockHandoff:
    """Zero-copy PD handoff record: a finished prefill's pool-owned block
    table plus the bounded private leaves and the position. Admission
    transfers pool ownership from `key` to the decode rid; no
    full-attention KV byte is copied (`handoff_copy_bytes == 0`)."""
    key: tuple                         # pool ownership key ("handoff", i)
    blocks: tuple                      # physical block ids, logical order
    private: dict                      # B=1 cache without full-attn entries
    pos: int                           # resident tokens
