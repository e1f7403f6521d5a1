"""The port's checkpoint store (`repro_torch.checkpoint`) on the
reference's six checkpoint cases (tests/test_checkpoint.py) — roundtrip,
no partial write visible, keep-last-N rotation, restore onto a device,
a missing leaf raises, dtype cast on restore — plus bfloat16 leaves bit
for bit, the zlib codec, and an optimizer state that restores onto "meta"
templates. The port's format is its own (raw chunk files, the standard
library only); these cases hold its protocol to the reference's."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import reduced_config
from repro_torch.models.lm import LM
from repro_torch.training.optim import adamw_init
from repro_torch.tree import tree_items, tree_leaves, tree_map


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(8, 16, generator=g),
            "nested": {"b": torch.randint(0, 10, (4,), generator=g,
                                          dtype=torch.int32),
                       "tup": (torch.ones(2, 2, dtype=torch.bfloat16),
                               torch.zeros(3))}}


def _meta(tree):
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def test_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, 5, t, extra={"note": "x"})
    got, step, extra = load_checkpoint(tmp_path, template=_meta(t))
    assert step == 5 and extra == {"note": "x"}
    assert isinstance(got["nested"]["tup"], tuple)
    for a, b in zip(tree_leaves(t), tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    flat, _, _ = load_checkpoint(tmp_path)
    assert sorted(flat) == sorted(k for k, _ in tree_items(t))
    manifest = json.loads((tmp_path / "step_00000005" /
                           "manifest.json").read_text())
    assert manifest["format"].startswith("repro_torch")


def test_atomic_commit_no_partial_visible(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, 1, t)
    crash = tmp_path / "step_00000002.tmp"          # a crashed write
    crash.mkdir()
    (crash / "chunk_00000.bin").write_bytes(b"garbage")
    _, step, _ = load_checkpoint(tmp_path)           # ignores .tmp
    assert step == 1
    mgr = CheckpointManager(tmp_path)                # cleanup removes it
    assert not crash.exists()
    assert mgr.latest_step() == 1


def test_rotation_keeps_last_n(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.full((2,), float(s))})
    dirs = sorted(p.name for p in Path(tmp_path).iterdir() if p.is_dir())
    assert dirs == ["step_00000003", "step_00000004"]
    assert mgr.latest_step() == 4
    got, step, _ = mgr.restore(template={"x": torch.empty(2)})
    assert step == 4 and torch.equal(got["x"], torch.full((2,), 4.0))


def test_restore_onto_device(tmp_path):
    """The one-device form of the reference's elastic restore: the leaves
    land on the caller's device whatever the template's."""
    t = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    save_checkpoint(tmp_path, 7, t)
    got, step, _ = load_checkpoint(tmp_path, template=_meta(t),
                                   device="cpu")
    assert step == 7 and got["w"].device == torch.device("cpu")
    assert torch.equal(got["w"], t["w"])
    flat, _, _ = load_checkpoint(tmp_path, device="cpu")
    assert flat["w"].device == torch.device("cpu")


def test_missing_leaf_raises(tmp_path):
    save_checkpoint(tmp_path, 1, {"a": torch.ones(2)})
    with pytest.raises(KeyError):
        load_checkpoint(tmp_path, template={"a": torch.empty(2),
                                            "b": torch.empty(2)})


def test_dtype_cast_on_restore(tmp_path):
    save_checkpoint(tmp_path, 1, {"a": torch.ones(4)})
    got, _, _ = load_checkpoint(
        tmp_path, template={"a": torch.empty(4, dtype=torch.bfloat16)})
    assert got["a"].dtype == torch.bfloat16
    assert torch.equal(got["a"], torch.ones(4, dtype=torch.bfloat16))


@pytest.mark.parametrize("compress", [False, True])
def test_bfloat16_roundtrip_bit_exact(tmp_path, compress):
    """Every bfloat16 bit pattern survives (numpy has none: the leaf's
    16-bit words are stored as they are), NaNs and infinities included."""
    words = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32) \
        .to(torch.int16)
    t = {"all": words.view(torch.bfloat16).reshape(256, 256),
         "w": torch.randn(33, 7).to(torch.bfloat16),
         "s": torch.tensor(3, dtype=torch.int32)}
    save_checkpoint(tmp_path, 3, t, compress=compress, chunk_mb=0)
    got, _, _ = load_checkpoint(tmp_path, template=_meta(t))
    for k in t:
        assert got[k].dtype == t[k].dtype and got[k].shape == t[k].shape
        assert torch.equal(got[k].view(torch.int16) if k != "s" else got[k],
                           t[k].view(torch.int16) if k != "s" else t[k])
    # chunk_mb=0: one chunk file per leaf
    assert len(list((tmp_path / "step_00000003").glob("chunk_*"))) == 3


def test_train_state_restores_onto_meta_templates(tmp_path):
    """A reduced model's parameters and AdamW state (bfloat16 parameters,
    float32 moments, the int32 step) restore bit for bit onto the
    launcher's template: `LM.shapes()` and `adamw_init` over it."""
    cfg = reduced_config("qwen2-1.5b")
    lm = LM.build(cfg, device="cpu")
    params = lm.init(3)
    opt = adamw_init(params, cfg.optimizer_dtype)
    opt["m"]["embed"].normal_()
    opt["step"].fill_(11)
    mgr = CheckpointManager(tmp_path)
    mgr.save(11, {"params": params, "opt": opt})
    shapes = lm.shapes()
    tmpl = {"params": shapes, "opt": adamw_init(shapes, cfg.optimizer_dtype)}
    got, step, _ = mgr.restore(template=tmpl, device="cpu")
    assert step == 11
    for a, b in zip(tree_leaves({"params": params, "opt": opt}),
                    tree_leaves(got)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
