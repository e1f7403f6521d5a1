"""The port's serving/engine.py is a back-compat shim over the per-phase
modules, as the reference's is (tests/test_engine_shim.py): it stays one
(≤ 100 lines), keeps re-exporting the same objects the real modules
define under the reference's `__all__`, and covers their public surface.
`kv_bytes` counts what the reference's counts on the same arena, carried
into JAX through numpy."""
import inspect

import jax.numpy as jnp
import pytest
import torch

import repro.serving.engine as ref_engine
import repro_torch.serving.arena as arena
import repro_torch.serving.decode as decode
import repro_torch.serving.engine as engine
import repro_torch.serving.placement as placement
import repro_torch.serving.prefill as prefill
from repro.serving.arena import kv_bytes as ref_kv_bytes


def test_shim_stays_thin():
    src = inspect.getsource(engine)
    assert len(src.splitlines()) <= 100


def test_shim_reexports_are_identical_objects():
    homes = {
        "BlockHandoff": arena, "KVArena": arena,
        "blocks_to_dense_kv": arena, "dense_kv_to_blocks": arena,
        "kv_bytes": arena,
        "DecodeEngine": decode,
        "DevicePlacement": placement,
        "PrefillEngine": prefill, "PrefillResult": prefill,
        "PrefillTask": prefill,
    }
    assert set(engine.__all__) == set(homes) == set(ref_engine.__all__)
    for name, mod in homes.items():
        assert getattr(engine, name) is getattr(mod, name), name


def test_shim_covers_module_public_surface():
    """Every public class/function defined in a per-phase module is reachable
    through the shim (private helpers exempt)."""
    for mod in (arena, decode, prefill):
        for name, obj in vars(mod).items():
            if name.startswith("_") or not (inspect.isclass(obj)
                                            or inspect.isfunction(obj)):
                continue
            if getattr(obj, "__module__", None) != mod.__name__:
                continue        # imported, not defined here
            assert getattr(engine, name, None) is obj, \
                f"{mod.__name__}.{name} missing from engine shim"


@pytest.mark.parametrize("quant", [False, True], ids=["float32", "int8"])
def test_kv_bytes_matches_the_reference(quant):
    """The bytes of a reduced qwen2-1.5b arena (float32, or int8 with its
    scale plane) equal the reference's `kv_bytes` over the same leaves as
    JAX arrays; a cache's non-tensor leaves count nothing."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.lm import LM
    from repro_torch.models.stack import alloc_cache
    cfg = reduced_config("qwen2-1.5b").with_updates(
        compute_dtype="float32", param_dtype="float32", n_layers=2)
    lm = LM.build(cfg, device="cpu", pattern=[0, 1])
    kv = arena.KVArena.build(lm, n_blocks=12, block_size=8, quant=quant).kv
    bridged = [None if e is None else
               {n: jnp.asarray(t.numpy()) for n, t in e.items()} for e in kv]
    got = engine.kv_bytes(kv)
    assert got == ref_kv_bytes(bridged) > 0
    per_block = sum(t[0].numel() * t.element_size() for e in kv if e
                    for t in e.values())
    assert got == 13 * per_block
    cache = alloc_cache(cfg, lm.plan, 2, 32, "cpu")
    assert cache["pos"] == 0 and engine.kv_bytes(cache) == sum(
        t.numel() * t.element_size() for e in cache["layers"]
        for t in e.values() if isinstance(t, torch.Tensor))
