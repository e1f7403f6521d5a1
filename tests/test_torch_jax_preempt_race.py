"""ROADMAP C7: why a four-rank int8 case of
tests/test_torch_distributed_planes.py (`quant_preempt`) parted from the
JAX `Server` only under load, reproduced deterministically on the CPU.

The reference preempts a request by extracting its KV through its block
table row, handed over as `jnp.asarray(self.tables_h[slot])`, and frees
the slot right after, which zeroes that row in place
(src/repro/serving/decode.py:1004-1031). On the CPU `jnp.asarray` of a
64-byte-aligned numpy row aliases its memory (zero copy), and the
extraction is dispatched asynchronously. Where the row happens to be
aligned (the numpy heap's state) and the extraction runs after the write
(the host's pace), the reference extracts the null block instead of the
request's KV, and its stream parts from the port's at the first token
after re-admission: request 1's token 3, at a one-rank top-2 margin of
0.0121 — the parting C7 recorded. The port copies the row
(`DecodeEngine._extract_dense`), so its streams never depend on the race.

`jax_preempt_repair.reference_copy_on_free` is the harness's repair, the
reference unedited: its `_free_slot` first rebinds the table to a copy,
so an extraction in flight keeps the row it was handed. Every port test
module whose JAX Server preempts a paged engine runs under it
(`jax_preempt_repair.jax_preempt_repaired`).

The engine's device table `_tbl_dev = jnp.asarray(self.tables_h[:, :nb])`
(decode.py:111, :610) aliases `tables_h` too where nb is max_blocks, but
it cannot part a stream: the step and the verify window that read it are
each followed by the host fetch of their tokens (`np.asarray(nxt)`,
`np.asarray(packed)`) before the engine writes `tables_h` again, and every
write sets `_tbl_dirty`, so the next step uploads the table anew.
`test_table_writes_wait_for_the_step` holds the first half: every write
to a paged engine's `tables_h` comes after the host fetch of the last
step's or verify's tokens.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest \\
        tests/test_torch_jax_preempt_race.py -q
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_dist_worker as W
from repro.serving import Server
from repro.serving import decode as jdec
from repro_torch import bridge
from repro_torch.serving import DevicePlacement
from jax_preempt_repair import reference_copy_on_free
from test_torch_distributed import auto_mesh

torch.set_num_threads(2)

CASE = "quant_preempt"
# the C7 parting: request 1 at its token 3, the first after re-admission
PARTED = (1, 3)


@contextlib.contextmanager
def late_table_read():
    """The reference's `_preempt` in the order a lost race runs it: the
    extraction reads its table row (the view `jnp.asarray` aliases) only
    after `_free_slot` has written it."""
    orig = jdec.DecodeEngine._preempt

    def preempt(self, rid):
        slot = self.rid_slot[rid]
        row = self.tables_h[slot]
        tok, pos = int(self.tok_h[slot]), int(self.pos_h[slot])
        self._free_slot(rid, slot)
        cache_one = self._extract(self._full_cache(), jnp.int32(slot),
                                  jnp.asarray(row))
        return rid, cache_one, tok, pos
    jdec.DecodeEngine._preempt = preempt
    try:
        yield
    finally:
        jdec.DecodeEngine._preempt = orig


def _jax_run() -> tuple:
    """→ (the JAX Server's greedy streams, the Server)."""
    cfg = W.planes_cfg(CASE, port=False)
    srv = Server(cfg, W.planes_server_config(CASE, port=False),
                 mesh=auto_mesh(), pattern=W.PLANES_CASES[CASE][2])
    s = srv.run(W.planes_requests(CASE, cfg.vocab_size, port=False),
                max_wall_s=300)
    assert s["n_done"] == 2 and s["decode_stats"][0]["preemptions"] >= 1
    return {r.rid: tuple(r.output_tokens) for r in srv.metrics.done}, srv


def test_aligned_row_aliases_and_sees_the_later_write():
    """jnp.asarray of a 64-byte-aligned int32 row on the CPU is a view of
    its memory: zeroing the row afterwards changes the JAX array."""
    buf = np.zeros(4 * 16 + 16, np.int32)
    off = (-buf.ctypes.data % 64) // 4
    table = buf[off:off + 64].reshape(4, 16)
    table[:] = np.arange(64, dtype=np.int32).reshape(4, 16) + 1
    assert table[1].ctypes.data % 64 == 0
    row = jnp.asarray(table[1])
    table[1] = 0
    np.testing.assert_array_equal(np.asarray(row), 0)


class _Fetched:
    """A step's or verify's token output, which marks `last["fetched"]`
    when the engine fetches it to the host (`np.asarray`)."""

    def __init__(self, out, last):
        self.out, self.last = out, last

    def __array__(self, dtype=None, copy=None):
        self.last["fetched"] = True
        return np.asarray(self.out, dtype)


class _WatchedTable(np.ndarray):
    """A paged engine's `tables_h`: each write records whether the token
    output of the engine's last step or verify call had been fetched."""

    def __array_finalize__(self, obj):
        self.watch = getattr(obj, "watch", None)

    def __setitem__(self, key, value):
        if self.watch is not None:
            last, log = self.watch
            log.append(last["fetched"])
        super().__setitem__(key, value)


@contextlib.contextmanager
def watched_tables(log: list):
    """Every paged DecodeEngine built inside: its `_step` / `_verify`
    return their tokens as `_Fetched`, and its `tables_h` is a
    `_WatchedTable` appending to `log` at each write."""
    orig = jdec.DecodeEngine.__post_init__

    def recording(fn, last):
        def call(*a, **k):
            *rest, out = fn(*a, **k)
            last["fetched"] = False
            return (*rest, _Fetched(out, last))
        return call

    def post_init(self):
        orig(self)
        if not self.paged:
            return
        last = {"fetched": True}
        self._step = recording(self._step, last)
        if self._verify is not None:
            self._verify = recording(self._verify, last)
        table = self.tables_h.view(_WatchedTable)
        table.watch = (last, log)
        self.tables_h = table
    jdec.DecodeEngine.__post_init__ = post_init
    try:
        yield
    finally:
        jdec.DecodeEngine.__post_init__ = orig


def test_table_writes_wait_for_the_step():
    """The JAX quant_preempt Server (which preempts): every write to its
    paged engine's `tables_h` comes after the host fetched the last
    step's tokens, so no step reading an aliased `_tbl_dev` is in flight;
    its streams are the repaired run's."""
    log = []
    with reference_copy_on_free():
        base = _jax_run()[0]
        with watched_tables(log):
            got = _jax_run()[0]
    assert got == base
    assert len(log) > 0 and all(log), (len(log), log.count(False))


def test_lost_race_parts_the_stream_and_copy_on_free_keeps_it():
    """The JAX quant_preempt Server, repaired: its streams equal the port's
    one-rank Server's on the same weights; with the extraction
    reading its row after the slot is freed, request 1 parts at token 3
    (the C7 parting, from the null block's KV); with the repair, the same
    late read gives the streams back."""
    with reference_copy_on_free():
        base, srv = _jax_run()
    params = bridge.params_from_numpy(
        jax.tree.map(np.asarray, srv.params), W.planes_cfg(CASE),
        srv.lm.plan, device="cpu")
    one = W.serve_planes(CASE, params, DevicePlacement.of("cpu"))
    assert one["streams"] == base
    with late_table_read():
        lost = _jax_run()[0]
        with reference_copy_on_free():
            repaired = _jax_run()[0]
    rid, i = PARTED
    assert lost[0] == base[0]
    assert W.first_diff(lost[rid], base[rid]) == i, (lost, base)
    assert repaired == base
