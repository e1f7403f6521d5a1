"""The split-KV plans of the port's paged kernels: `decode_splits`
(paged_decode) and `prefill_splits` (the paged-history routine of
paged_prefill and spec_verify).

The plans are pure Python and run here on the CPU: each must cover every
table entry exactly once, depend on shapes only (never on `lens`, `off`,
`chunk_len` or `n_tok`, so a step needs no host read and a captured launch
stays valid), and keep the grid within the card's limits.
"""
import inspect

import pytest

from repro_torch.kernels.paged_decode import (DECODE_WARPS, decode_splits,
                                              prefill_splits)
from repro_torch.kernels.paged_prefill import PREFILL_ROWS
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
