"""The harness's repair of a race in the JAX reference (ROADMAP C7), for
the port's test modules whose JAX `Server` preempts a paged engine:
test_torch_distributed_planes, _quant, _ring, _serving and _ssm_serving.

The reference's `DecodeEngine._preempt` hands its extraction
`jnp.asarray(self.tables_h[slot])` and then frees the slot, zeroing that
row in place (src/repro/serving/decode.py:1004-1031). On the CPU the
`jnp.asarray` of a 64-byte-aligned row aliases it and the extraction runs
asynchronously, so under load the reference can extract the null block's
KV (tests/test_torch_jax_preempt_race.py reproduces it). The repair
leaves src/repro/ untouched: `_free_slot` first rebinds the table to a
copy, so the extraction in flight keeps the row it was handed; the table
values are the same. A test module imports `jax_preempt_repaired` to run
every one of its tests under it.

The engine's device table `_tbl_dev` (decode.py:111, :610) can alias
`tables_h` as well, where the bucket is max_blocks wide, but it cannot
part a stream, so the repair leaves it: the step and the verify window
that read it are each followed by the host fetch of their tokens before
the engine writes `tables_h` again, and every write marks the table
dirty, so the next step uploads it anew
(tests/test_torch_jax_preempt_race.py::test_table_writes_wait_for_the_step).
The extraction's row is the one read that can outlive a write."""
import contextlib

import pytest

from repro.serving import decode as jdec


@contextlib.contextmanager
def reference_copy_on_free():
    """The reference's `DecodeEngine._free_slot` rebinding a paged
    engine's `tables_h` to a copy before it zeroes the freed row."""
    orig = jdec.DecodeEngine._free_slot

    def free_slot(self, rid, slot):
        if hasattr(self, "tables_h"):         # a paged engine's
            self.tables_h = self.tables_h.copy()
        return orig(self, rid, slot)
    jdec.DecodeEngine._free_slot = free_slot
    try:
        yield
    finally:
        jdec.DecodeEngine._free_slot = orig


@pytest.fixture(scope="module", autouse=True)
def jax_preempt_repaired():
    """The importing module's tests, and its module fixtures' JAX runs,
    under `reference_copy_on_free`."""
    with reference_copy_on_free():
        yield
