"""The split-KV plan of the port's paged_decode kernel (`decode_splits`).

The plan is pure Python and runs here on the CPU: it must cover every table
entry exactly once, depend on shapes only (never on `lens`, so the decode
step needs no host read and a captured launch stays valid), and keep the
grid within the card's limits.
"""
import inspect

import pytest

from repro_torch.kernels.paged_decode import DECODE_WARPS, decode_splits

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
