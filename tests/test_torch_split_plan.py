"""The grid plans of the port's kernels: `decode_splits` and
`decode_row_groups` (paged_decode and sink_decode: splits of the table and
row groups of a GQA group wider than a CTA holds),
`prefill_splits` (the paged-history routine of paged_prefill and
spec_verify), `sink_splits` (sink_decode), `gmm_ctas` (moe_gmm) and
`topk_cluster_plan` (block_topk's cluster per slot).

The plans are pure Python and run here on the CPU: each must cover every
table entry, cache slot or work item exactly once, depend on shapes only
(never on `lens`, `off`, `chunk_len`, `n_tok`, `t`, `n_valid` or a top-k
budget, so a step
needs no host read and a captured launch stays valid), and keep the grid
within the card's limits.
"""
import inspect

import pytest

from repro_torch.kernels.block_topk import (TOPK_MAX_CLUSTER, TOPK_MIN_SHARE,
                                            TOPK_NB_MAX, topk_cluster_plan)
from repro_torch.kernels.moe_gmm import (GMM_COLS, GMM_CTAS_PER_SM, GMM_ROWS,
                                         gmm_ctas)
from repro_torch.kernels.paged_decode import (DECODE_ROW_FLOATS, DECODE_WARPS,
                                              decode_row_groups,
                                              decode_splits, prefill_splits)
from repro_torch.kernels.paged_prefill import PREFILL_ROWS
from repro_torch.kernels.sink_decode import SINK_CHUNK, sink_splits
from repro_torch.kernels.spec_verify import VERIFY_ROWS

SHAPES = [(6, 2, 264, 132), (6, 2, 32, 132), (6, 16, 32, 132),
          (1, 1, 1, 132), (3, 2, 6, 132), (1, 2, 4608 // 16, 132),
          (64, 8, 7, 132), (2, 1, 200000, 132), (6, 2, 256, 114),
          (1, 1, 3, 1)]


@pytest.mark.parametrize("B,K,nb,n_sm", SHAPES)
def test_every_table_entry_in_exactly_one_split(B, K, nb, n_sm):
    n, per = decode_splits(B, K, nb, n_sm)
    covered = [0] * nb
    for s in range(n):
        lo, hi = s * per, min((s + 1) * per, nb)
        assert lo < hi, f"split {s} holds no table entry"
        for j in range(lo, hi):
            covered[j] += 1
    assert covered == [1] * nb


@pytest.mark.parametrize("B,K,nb,n_sm", SHAPES)
def test_grid_within_card_limits(B, K, nb, n_sm):
    n, per = decode_splits(B, K, nb, n_sm)
    assert 1 <= n <= 65535 and per >= 1          # gridDim.z
    assert n * per >= nb and (n - 1) * per < nb
    # about two CTAs per SM, never more than the target plus one row of B·K
    assert B * K * n <= max(2 * n_sm + B * K - 1, B * K)
    if nb >= DECODE_WARPS:                       # every warp takes an entry
        assert per >= DECODE_WARPS


def test_split_count_depends_on_shapes_only():
    assert list(inspect.signature(decode_splits).parameters) == [
        "B", "K", "nb", "n_sm"]
    first = [decode_splits(*s) for s in SHAPES]
    assert [decode_splits(*s) for s in SHAPES] == first
    # the main path's shapes on a 132-SM card
    assert decode_splits(6, 2, 264, 132) == (22, 12)   # ring tables
    assert decode_splits(6, 2, 32, 132) == (8, 4)      # all-full decode
    assert decode_splits(6, 16, 32, 132) == (3, 11)    # MoE attention


# (B, K, row tiles, nb, n_sm): the main chunk (S·G = 768 → 12 row tiles of
# 64) over a 32- and a 288-wide table (topk-long's last chunk), phase 7's
# verify window (30 rows → one 32-row tile) over 32 and 256 entries, the
# MoE shapes (K = 16, G = 1), a huge table, a one-entry table, a small card
PREFILL_SHAPES = [(1, 2, 12, 32, 132), (1, 2, 12, 288, 132),
                  (6, 2, 1, 32, 132), (6, 2, 1, 256, 132),
                  (1, 16, 2, 32, 132), (6, 16, 1, 32, 132),
                  (1, 2, 12, 200000, 132), (6, 2, 1, 200000, 132),
                  (3, 2, 1, 1, 132), (64, 8, 3, 7, 132), (1, 1, 1, 5, 1),
                  (2, 2, 700, 40, 132)]


@pytest.mark.parametrize("B,K,rt,nb,n_sm", PREFILL_SHAPES)
def test_prefill_every_table_entry_in_exactly_one_split(B, K, rt, nb, n_sm):
    n, per = prefill_splits(B, K, rt, nb, n_sm)
    covered = [0] * nb
    for s in range(n):
        lo, hi = s * per, min((s + 1) * per, nb)
        assert lo < hi, f"split {s} holds no table entry"
        for j in range(lo, hi):
            covered[j] += 1
    assert covered == [1] * nb


@pytest.mark.parametrize("B,K,rt,nb,n_sm", PREFILL_SHAPES)
def test_prefill_grid_within_card_limits(B, K, rt, nb, n_sm):
    n, per = prefill_splits(B, K, rt, nb, n_sm)
    assert 1 <= n <= 65535 and per >= 1          # gridDim.x, kept small
    assert rt <= 65535 and B * K <= 65535        # gridDim.y, gridDim.z
    assert n * per >= nb and (n - 1) * per < nb
    # about two CTAs per SM, never more than the target plus one split row
    cta = B * K * rt
    assert cta * n <= max(2 * n_sm + cta - 1, cta)


def test_prefill_split_count_depends_on_shapes_only():
    assert list(inspect.signature(prefill_splits).parameters) == [
        "B", "K", "n_row_tiles", "nb", "n_sm"]
    first = [prefill_splits(*s) for s in PREFILL_SHAPES]
    assert [prefill_splits(*s) for s in PREFILL_SHAPES] == first
    # the main path's shapes on a 132-SM card (row tiles from the kernels'
    # tile heights: 64 rows for a prefill chunk, 32 for a verify window)
    assert (PREFILL_ROWS, VERIFY_ROWS) == (64, 32)
    assert prefill_splits(1, 2, 768 // PREFILL_ROWS, 32, 132) == (11, 3)
    assert prefill_splits(1, 2, 768 // PREFILL_ROWS, 288, 132) == (11, 27)
    assert prefill_splits(6, 2, 1, 32, 132) == (16, 2)      # verify, main
    assert prefill_splits(6, 2, 1, 256, 132) == (22, 12)    # verify, long


# (B, K, W, n_sm): phase 5's ring (sink 128 + recent 4096) and full cache,
# W off the 16-slot chunk (100, 4223), one-chunk caches, many kv heads,
# a huge cache, a small card
SINK_SHAPES = [(6, 2, 4224, 132), (6, 2, 4608, 132), (4, 2, 100, 132),
               (4, 2, 4223, 132), (1, 1, 1, 132), (2, 2, 16, 132),
               (4, 2, 64, 132), (64, 8, 96, 132), (1, 2, 1_000_000, 132),
               (6, 2, 4224, 114), (1, 1, 33, 1)]


@pytest.mark.parametrize("B,K,W,n_sm", SINK_SHAPES)
def test_sink_every_slot_in_exactly_one_split(B, K, W, n_sm):
    n, per = sink_splits(B, K, W, n_sm)
    covered = [0] * W
    for s in range(n):
        lo, hi = s * per * SINK_CHUNK, min((s + 1) * per * SINK_CHUNK, W)
        assert lo < hi, f"split {s} holds no cache slot"
        for w in range(lo, hi):
            covered[w] += 1
    assert covered == [1] * W


@pytest.mark.parametrize("B,K,W,n_sm", SINK_SHAPES)
def test_sink_grid_within_card_limits(B, K, W, n_sm):
    n, per = sink_splits(B, K, W, n_sm)
    chunks = -(-W // SINK_CHUNK)
    assert 1 <= n <= 65535 and per >= 1          # gridDim.z
    assert B <= 2**31 - 1 and K <= 65535         # gridDim.x, gridDim.y
    assert n * per >= chunks and (n - 1) * per < chunks
    assert B * K * n <= max(2 * n_sm + B * K - 1, B * K)
    if chunks >= DECODE_WARPS:                   # every warp takes a chunk
        assert per >= DECODE_WARPS


def test_sink_split_count_depends_on_shapes_only():
    assert list(inspect.signature(sink_splits).parameters) == [
        "B", "K", "W", "n_sm"]
    first = [sink_splits(*s) for s in SINK_SHAPES]
    assert [sink_splits(*s) for s in SINK_SHAPES] == first
    # the main path's shapes on a 132-SM card: the ring's plan is the ring
    # tables' (264 blocks of 16) in paged_decode
    assert sink_splits(6, 2, 4224, 132) == decode_splits(6, 2, 264, 132) \
        == (22, 12)
    assert sink_splits(6, 2, 4608, 132) == (21, 14)


# (S, C, F, n_sm): phase 8's decode w1/w3 and w2 and its prefill chunk, the
# reference sweep shapes, F off the column tile, C over two row tiles, a
# huge expert count, one slot of one row, a small card
GMM_SHAPES = [(60, 8, 1408, 132), (60, 8, 2048, 132), (60, 24, 1408, 132),
              (2, 32, 48, 132), (4, 64, 96, 132), (3, 40, 130, 132),
              (1, 1, 1, 132), (16384, 8, 1408, 132), (60, 24, 1408, 114),
              (2, 33, 65, 1)]


@pytest.mark.parametrize("S,C,F,n_sm", GMM_SHAPES)
def test_gmm_every_work_item_in_exactly_one_cta(S, C, F, n_sm):
    n = gmm_ctas(S, C, F, n_sm)
    items = S * -(-C // GMM_ROWS) * -(-F // GMM_COLS)
    # whichever row tiles are live, item i of the live list goes to CTA
    # i mod n, and output row r to CTA r mod n for the zero pass
    for live in sorted({0, 1, items // 3, items}):
        taken = [0] * live
        for b in range(n):
            for i in range(b, live, n):
                taken[i] += 1
        assert taken == [1] * live
    rows = [0] * (S * C)
    for b in range(n):
        for r in range(b, S * C, n):
            rows[r] += 1
    assert rows == [1] * (S * C)


@pytest.mark.parametrize("S,C,F,n_sm", GMM_SHAPES)
def test_gmm_grid_within_card_limits(S, C, F, n_sm):
    n = gmm_ctas(S, C, F, n_sm)
    items = S * -(-C // GMM_ROWS) * -(-F // GMM_COLS)
    assert 1 <= n <= 2**31 - 1                  # gridDim.x
    assert n <= GMM_CTAS_PER_SM * n_sm          # one wave, all resident
    assert n == min(items, GMM_CTAS_PER_SM * n_sm)


def test_gmm_grid_depends_on_shapes_only():
    assert list(inspect.signature(gmm_ctas).parameters) == [
        "S", "C", "F", "n_sm"]
    first = [gmm_ctas(*s) for s in GMM_SHAPES]
    assert [gmm_ctas(*s) for s in GMM_SHAPES] == first
    # the main path's shapes on a 132-SM card: four CTAs per SM
    assert (GMM_COLS, GMM_ROWS, GMM_CTAS_PER_SM) == (64, 32, 4)
    assert gmm_ctas(60, 8, 1408, 132) == gmm_ctas(60, 24, 1408, 132) == 528


# table widths nb: the pow2 buckets the decode engine hands the kernel
# (8 .. 8192), widths off them (max_blocks caps a bucket), the edges of a
# CTA's share and of the cluster's growth
TOPK_WIDTHS = [1, 7, 8, 31, 32, 33, 64, 100, 255, 256, 257, 288, 1000,
               4096, 4097, 8191, 8192]


@pytest.mark.parametrize("nb", TOPK_WIDTHS)
def test_topk_every_table_entry_in_exactly_one_cta(nb):
    cluster, per = topk_cluster_plan(nb)
    covered = [0] * nb
    for r in range(cluster):
        lo, hi = r * per, min((r + 1) * per, nb)
        assert lo < hi, f"CTA {r} scores no tabled block"
        for j in range(lo, hi):
            covered[j] += 1
    assert covered == [1] * nb


@pytest.mark.parametrize("nb", TOPK_WIDTHS)
def test_topk_cluster_within_limits(nb):
    cluster, per = topk_cluster_plan(nb)
    assert 1 <= cluster <= TOPK_MAX_CLUSTER == 8    # a portable cluster
    assert cluster * per >= nb and (cluster - 1) * per < nb
    # a CTA takes about TOPK_MIN_SHARE blocks until the cluster is full
    assert cluster == min(-(-nb // TOPK_MIN_SHARE), TOPK_MAX_CLUSTER)


def test_topk_plan_depends_on_shapes_only():
    assert list(inspect.signature(topk_cluster_plan).parameters) == ["nb"]
    first = [topk_cluster_plan(nb) for nb in TOPK_WIDTHS]
    assert [topk_cluster_plan(nb) for nb in TOPK_WIDTHS] == first
    # the main path's widths: topk-long's 256-wide decode table, the
    # reduced tests' 8- and 16-wide ones, qwen2-1.5b's 32,768-token context
    assert topk_cluster_plan(256) == (8, 32)
    assert topk_cluster_plan(8) == (1, 8)
    assert topk_cluster_plan(16) == (1, 16)
    assert topk_cluster_plan(2048) == (8, 256)
    assert (TOPK_MIN_SHARE, TOPK_NB_MAX) == (32, 8192)


@pytest.mark.parametrize("nb", [0, TOPK_NB_MAX + 1, 200000])
def test_topk_plan_rejects_tables_past_limit(nb):
    with pytest.raises(ValueError):
        topk_cluster_plan(nb)


# (G, h): one group at its largest (16 rows at h 128, 8 at h 256), one row
# past it, granite-34b's 48 rows over one kv head, gemma3-4b's 2 at h 256,
# the main path's 6, qwen3-moe's 16 and qwen3-32b's 8, groups at h 32/64,
# a group far past the row limit; hubert's and phi-3-vision's G 1 at h 80
# and 96, and groups at their limits (25 rows at h 80, 21 at 96) and past
ROW_GROUP_SHAPES = [(16, 128), (17, 128), (33, 128), (48, 128), (2, 256),
                    (8, 256), (9, 256), (48, 256), (6, 128), (8, 128),
                    (1, 32), (64, 32), (65, 32), (33, 64), (300, 256),
                    (1, 80), (25, 80), (26, 80), (1, 96), (21, 96),
                    (22, 96)]


@pytest.mark.parametrize("G,h", ROW_GROUP_SHAPES)
def test_every_query_row_in_exactly_one_row_group(G, h):
    n_grp, rows = decode_row_groups(G, h)
    covered = [0] * G
    for gi in range(n_grp):
        lo, hi = gi * rows, min((gi + 1) * rows, G)
        assert lo < hi, f"row group {gi} holds no row"
        for r in range(lo, hi):
            covered[r] += 1
    assert covered == [1] * G
    # a CTA keeps ceil(h/32) accumulators of each of its rows: at most
    # 2048 / h rows (csrc dec_gmax), and no more groups than the limit needs
    assert DECODE_ROW_FLOATS == 2048
    assert 1 <= rows <= DECODE_ROW_FLOATS // h
    assert n_grp == -(-G // (DECODE_ROW_FLOATS // h))
    # balanced and none empty: the last group holds 1..rows rows
    assert 0 < G - (n_grp - 1) * rows <= rows


@pytest.mark.parametrize("B,K,nb,n_sm", SHAPES[:6])
@pytest.mark.parametrize("G,h", [(48, 128), (2, 256), (17, 128)])
def test_row_groups_grid_within_card_limits(B, K, nb, n_sm, G, h):
    """The decode grid (B, K·n_grp, n_split): the split plan takes the row
    groups as further kv heads, so its CTA budget counts them."""
    n_grp, _ = decode_row_groups(G, h)
    n, per = decode_splits(B, K * n_grp, nb, n_sm)
    assert K * n_grp <= 65535 and 1 <= n <= 65535
    assert B * K * n_grp * n <= max(2 * n_sm + B * K * n_grp - 1,
                                    B * K * n_grp)
    assert n * per >= nb and (n - 1) * per < nb


def test_row_groups_depend_on_shapes_only():
    assert list(inspect.signature(decode_row_groups).parameters) == [
        "G", "h"]
    assert [decode_row_groups(*s) for s in ROW_GROUP_SHAPES] == \
        [decode_row_groups(*s) for s in ROW_GROUP_SHAPES]
    # this slice's shapes: granite's group in three CTAs of 16 rows, the
    # boundaries balanced, gemma3's groups in one CTA
    assert decode_row_groups(48, 128) == (3, 16)
    assert decode_row_groups(17, 128) == (2, 9)
    assert decode_row_groups(33, 128) == (3, 11)
    assert decode_row_groups(2, 256) == (1, 2)
    assert decode_row_groups(9, 256) == (2, 5)
    assert decode_row_groups(6, 128) == (1, 6)     # the main path: unchanged
    # granite's decode on a 132-SM card: six slots over phase 3's 32-entry
    # tables, three row groups
    assert decode_splits(6, 1 * 3, 32, 132) == (8, 4)
