"""Back-compat shim: the serving engine's public names, re-exported from
the per-phase modules they live in (the reference's
src/repro/serving/engine.py, with the same `__all__`).

  serving/placement.py — DevicePlacement (the torch device, the RankCtx,
                         the hot-loop choke point)
  serving/arena.py     — KVArena, BlockHandoff, block/dense interchange,
                         kv_bytes
  serving/prefill.py   — PrefillEngine, PrefillTask, PrefillResult (and
                         their helpers StagedUpload, clone_tree)
  serving/decode.py    — DecodeEngine

Every public name keeps resolving from here; new code should import from
the per-phase modules directly. tests/test_torch_engine_shim.py asserts
this module stays a ≤100-line re-export surface in sync with the real
modules.
"""
from repro_torch.serving.arena import (BlockHandoff, KVArena, _bucket,
                                       _pow2_floor, blocks_to_dense_kv,
                                       dense_kv_to_blocks, kv_bytes)
from repro_torch.serving.decode import DecodeEngine
from repro_torch.serving.placement import DevicePlacement
from repro_torch.serving.prefill import (PrefillEngine, PrefillResult,
                                         PrefillTask, StagedUpload,
                                         clone_tree)

__all__ = [
    "BlockHandoff",
    "DecodeEngine",
    "DevicePlacement",
    "KVArena",
    "PrefillEngine",
    "PrefillResult",
    "PrefillTask",
    "blocks_to_dense_kv",
    "dense_kv_to_blocks",
    "kv_bytes",
]
